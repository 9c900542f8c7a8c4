// Segmented gather shrink-expand (SGMV) for Hopper (sm_90a), bound through a
// plain C interface (kernels/sgmv.py and kernels/fused.py load it with
// ctypes). One source serves four TPU kernels:
//
//   src/repro/kernels/sgmv.py::sgmv               (E = 1, no rank)
//   src/repro/kernels/sgmv.py::sgmv_ranked        (E = 1, per-segment rank)
//   src/repro/kernels/fused.py::fused_sgmv        ((slot, expert) segments)
//   src/repro/kernels/fused.py::fused_sgmv_ranked ((slot, expert) + rank)
//
//   h[i]        = x[s, i] . A[slot[s], eid[s]]      (f32, (cap, r))
//   h[i, c]     = 0 where c >= rank[s]              (ranked forms)
//   out[s, i]   = h[i] . B[slot[s], eid[s]]         (f32, (cap, d_out))
//   out[s]      = 0 where slot[s] < 0, and such a segment reads no factor
//
//   x (S, cap, d_in) | A (M, E, d_in, r_pool) | B (M, E, r_pool, d_out)
//   | slot, eid, rank (S,) int32 -> out (S, cap, d_out) f32
//
// The kernel uses the first r <= r_pool rank columns of the pool: a rank
// bucket of ops.sgmv_rank_grouped reads its columns in place, with the
// pool's row stride, instead of copying a narrower pool.
//
// What bounds it: bytes. A segment's rows share one factor slice, so the
// factors are read once per segment (the point of SGMV), and the layout
// writes every one of its S * cap * d_out f32 outputs: at the LoRA-kernel
// path's Fig. 19 shapes that output (537 MB) is the largest term. The
// operations are few: a segment holds on average 4 rows with data of its
// cap = 64 (the rest are build_segments' zero padding).
//
// Design. One launch per call. Block (s, w, y) owns rows [8w, 8w + 8) of
// segment s and a run of d_out tiles of 32 * VEC columns; the grid's y
// splits d_out when there are too few row windows to fill 132 SMs (each
// such block redoes the shrink). Windows, not whole segments, are the unit
// so that a full segment's rows run on several SMs at once.
//  0. Warp i checks row 8w + i for a nonzero value (one 16-byte load
//     settles a row with data; a zero row is read through). A zero row's
//     output is exact +0 (every product is +-0 and every sum starts at +0),
//     so those rows are written as zeros and take no further part, and a
//     window without data reads no factor. The TPU kernel computes all cap
//     rows; the values are the same.
//  1. shrink, over the window's rows with data: thread t owns the group
//     of VEC rank columns g = t % (r / VEC) and the d_in rows
//     t / (r / VEC) + j * (256 / (r / VEC)) (when r / VEC does not divide
//     256, the last 256 % (r / VEC) threads sit the shrink out, so any
//     rank bucket's width is taken); it streams A in 16-byte vectors
//     (neighbouring threads on neighbouring addresses, four loads in
//     flight) and keeps 8 x VEC sums in registers. The threads' sums of a
//     column are added in thread order through shared memory. The (rows, r)
//     result stays in shared memory: it never goes to device memory, as it
//     stays in VMEM on the TPU.
//  2. expand: thread t owns VEC consecutive output columns, streams B's
//     rows c = 0, 1, ... as 16-byte vectors (four in flight) and adds
//     h[row, c] * b for the window's rows, then writes them as float4 stores.
// Ranked forms: threads whose column group starts at or past the rank read
// no A, h is forced to 0 at c >= rank, and the expand reads only B's first
// rank rows. The d_in partition depends only on r, never on the rank, so
// every output element is summed in the same order in both forms: on a
// prefix-zero pool (columns past an adapter's rank are zero) ranked and
// padded give the same values bit for bit. Slot and expert ids are clamped
// into range, as the reference's gathers clamp them.

#include "vec.cuh"

namespace {

using repro::to_f32;
using repro::Vec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kP = kWarps;     // rows of a window, one warp each
constexpr int kMaxRank = 256;
constexpr int kMaxVec = 8;

// dynamic shared memory: h (kP x r floats) and the shrink's reduction
// buffer (kThreads x kMaxVec floats)
inline size_t smem_bytes(int r) {
  return sizeof(float) * ((size_t)kP * r + (size_t)kThreads * kMaxVec);
}

template <typename TX, typename TW, bool kRanked>
__global__ void __launch_bounds__(kThreads) sgmv_kernel(
    const TX* __restrict__ x, const TW* __restrict__ A,
    const TW* __restrict__ Bm, const int* __restrict__ slots,
    const int* __restrict__ eids, const int* __restrict__ ranks,
    float* __restrict__ out, int cap, int M, int E, int d_in, int r,
    int r_pool, int d_out, int tiles_per_block) {
  constexpr int VEC = Vec<TW>::N;
  constexpr int XV = Vec<TX>::N;
  constexpr int kTile = 32 * VEC;
  const int n_win = (cap + kP - 1) / kP;
  const int s = blockIdx.x / n_win, w0 = (blockIdx.x % n_win) * kP;
  const int wrows = min(kP, cap - w0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.y * tiles_per_block * kTile;
  const int col1 = min(d_out, col0 + tiles_per_block * kTile);
  const int w4 = (col1 - col0) / 4;   // d_out is a multiple of VEC (>= 4)
  float* o = out + ((size_t)s * cap + w0) * d_out + col0;
  int slot = slots[s];
  if (slot < 0) {
    for (int i = tid; i < wrows * w4; i += kThreads)
      *reinterpret_cast<float4*>(o + (size_t)(i / w4) * d_out +
                                 (i % w4) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  slot = min(slot, M - 1);
  const int e = eids ? min(max(eids[s], 0), E - 1) : 0;
  const int rank = kRanked ? min(max(ranks[s], 0), r) : r;

  extern __shared__ float smem[];
  float* hs = smem;                            // kP x r
  float* red = hs + kP * r;                    // kThreads x VEC
  __shared__ int flags[kP];
  __shared__ int rows[kP];                     // window rows with data
  __shared__ int n_rows;
  const TX* xseg = x + ((size_t)s * cap + w0) * d_in;
  const TW* a = A + ((size_t)slot * E + e) * d_in * r_pool;
  const TW* b = Bm + ((size_t)slot * E + e) * r_pool * d_out;

  // 0. rows with data; zero rows written as zeros
  if (warp < wrows) {
    const TX* xr = xseg + (size_t)warp * d_in;
    int found = 0;
    for (int base = 0; base < d_in && !found; base += 32 * XV) {
      const int i = base + lane * XV;
      bool nz = false;
      if (i < d_in) {
        float v[XV];
        Vec<TX>::load(xr + i, v);
#pragma unroll
        for (int k = 0; k < XV; ++k) nz |= v[k] != 0.f;
      }
      found = __any_sync(0xffffffffu, nz);
    }
    if (lane == 0) flags[warp] = found;
  }
  __syncthreads();
  if (warp == 0) {
    const bool f = lane < wrows && flags[lane];
    const unsigned mask = __ballot_sync(0xffffffffu, f);
    if (f) rows[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) n_rows = __popc(mask);
  }
  for (int i = tid; i < wrows * w4; i += kThreads) {
    const int row = i / w4;
    if (!flags[row])
      *reinterpret_cast<float4*>(o + (size_t)row * d_out + (i % w4) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int n = n_rows;

  const int groups = r / VEC;
  const int g = tid % groups, c0 = g * VEC;
  const int dstep = kThreads / groups;   // the last kThreads % groups idle
  const bool live = c0 < rank && tid < dstep * groups;
  const int P = n;
  if (P > 0) {
    int roff[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) roff[p] = (p < P ? rows[p] : rows[0]) * d_in;

    // 1. shrink
    float acc[kP][VEC];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[p][k] = 0.f;
    if (live) {
#pragma unroll 4
      for (int d = tid / groups; d < d_in; d += dstep) {
        float av[VEC];
        Vec<TW>::load(a + (size_t)d * r_pool + c0, av);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          if (p < P) {
            const float xv = to_f32(xseg[roff[p] + d]);
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[p][k] = fmaf(xv, av[k], acc[p][k]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p < P) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) red[tid * VEC + k] = acc[p][k];
        __syncthreads();
        for (int c = tid; c < r; c += kThreads) {
          const int gg = c / VEC, kk = c % VEC;
          float h = 0.f;
          for (int j = 0; j < dstep; ++j)
            h += red[(j * groups + gg) * VEC + kk];
          hs[p * r + c] = c < rank ? h : 0.f;
        }
        __syncthreads();
      }
    }

    // 2. expand
    for (int col = col0 + tid * VEC; col < col1; col += kThreads * VEC) {
      float y[kP][VEC];
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int k = 0; k < VEC; ++k) y[p][k] = 0.f;
#pragma unroll 4
      for (int c = 0; c < rank; ++c) {
        float bv[VEC];
        Vec<TW>::load(b + (size_t)c * d_out + col, bv);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          if (p < P) {
            const float h = hs[p * r + c];
#pragma unroll
            for (int k = 0; k < VEC; ++k) y[p][k] = fmaf(h, bv[k], y[p][k]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (p < P) {
          float* dst = o + (size_t)rows[p] * d_out + (col - col0);
#pragma unroll
          for (int k = 0; k < VEC; k += 4)
            *reinterpret_cast<float4*>(dst + k) =
                make_float4(y[p][k], y[p][k + 1], y[p][k + 2], y[p][k + 3]);
        }
      }
    }
  }
}

template <typename TX, typename TW, bool kRanked>
int launch(const void* x, const void* A, const void* B, const int* slots,
           const int* eids, const int* ranks, float* out, int S, int cap,
           int M, int E, int d_in, int r, int r_pool, int d_out,
           int tiles_per_block, cudaStream_t stream) {
  constexpr int VEC = Vec<TW>::N;
  const int n_tiles = (d_out + 32 * VEC - 1) / (32 * VEC);
  const dim3 grid(S * ((cap + kP - 1) / kP),
                  (n_tiles + tiles_per_block - 1) / tiles_per_block);
  const size_t smem = smem_bytes(r);
  auto kern = sgmv_kernel<TX, TW, kRanked>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(A),
      static_cast<const TW*>(B), slots, eids, ranks, out, cap, M, E, d_in, r,
      r_pool, d_out, tiles_per_block);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_ranked(int ranked, const void* x, const void* A, const void* B,
                  const int* slots, const int* eids, const int* ranks,
                  float* out, int S, int cap, int M, int E, int d_in, int r,
                  int r_pool, int d_out, int tpb, cudaStream_t st) {
  if (ranked)
    return launch<TX, TW, true>(x, A, B, slots, eids, ranks, out, S, cap, M,
                                E, d_in, r, r_pool, d_out, tpb, st);
  return launch<TX, TW, false>(x, A, B, slots, eids, nullptr, out, S, cap, M,
                               E, d_in, r, r_pool, d_out, tpb, st);
}

}  // namespace

// The largest rank column count the kernel takes; the wrapper checks that
// r is a multiple of VEC and r <= this.
extern "C" int sgmv_max_rank() { return kMaxRank; }
// Rows of one window (the unit of the grid's x with the segment).
extern "C" int sgmv_window_rows() { return kP; }
// d_out columns of one tile (the unit of the grid's y split).
extern "C" int sgmv_tile_cols(int w_dtype) { return w_dtype ? 256 : 128; }

// dtype codes: 0 = float32, 1 = bfloat16. eids null means E = 1; ranks is
// read only when ranked != 0. d_in must be a multiple of x's 16-byte
// vector and x 16-byte aligned. Returns a cudaError_t (0 = ok).
extern "C" int sgmv_launch(int x_dtype, int w_dtype, int ranked,
                           const void* x, const void* A, const void* B,
                           const int* slots, const int* eids,
                           const int* ranks, float* out, int S, int cap,
                           int M, int E, int d_in, int r, int r_pool,
                           int d_out, int tiles_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SGMV_ARGS                                                     \
  ranked, x, A, B, slots, eids, ranks, out, S, cap, M, E, d_in, r, r_pool, \
      d_out, tiles_per_block, st
  if (x_dtype == 0 && w_dtype == 0)
    return launch_ranked<float, float>(REPRO_SGMV_ARGS);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_ranked<float, __nv_bfloat16>(REPRO_SGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_ranked<__nv_bfloat16, float>(REPRO_SGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_ranked<__nv_bfloat16, __nv_bfloat16>(REPRO_SGMV_ARGS);
#undef REPRO_SGMV_ARGS
  return (int)cudaErrorInvalidValue;
}
