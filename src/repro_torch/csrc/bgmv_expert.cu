// Expert-LoRA shrink-expand (BGMV) for Hopper (sm_90a): the disaggregated
// LoRA Server's hook kernel and the coupled plane's expert deltas, bound
// through a plain C interface (kernels/bgmv.py loads it with ctypes).
//
// Replaces the TPU kernel src/repro/kernels/bgmv.py::bgmv_expert and carries
// the serving hook's true-rank mask, which the reference computes in jnp
// (src/repro/core/lora_server.py, the body of LoRAServer._step):
//
//   h      = x[t] . A[ids[t], eids[t]]                       (f32, width r)
//   h[c]   = 0 where (c % r_mod) >= ranks[t]                 (when ranks given)
//   out[t] = h . B[ids[t], eids[t]]                          (f32, width d_out)
//   out[t] = 0 where ids[t] < 0
//
//   x (T, d_in) | A (N, E, d_in, r) | B (N, E, r, d_out) | ids, eids,
//   ranks (T,) int32 -> out (T, d_out) f32; meta (T + 1, 4) int32 and
//   part (T, S, r) f32 are the wrapper's scratch, S from bgmv_expert_splits
//
// What bounds it: bytes. An active row reads its (d_in x r) A slice and its
// (r x d_out) B slice once and does 2 operations for each factor element,
// one operation a byte in bf16. At decode the hooks see E*C rows of which
// only T*K are active (8192 rows, 64 active at batch 8), so writing the f32
// output rows, zeros for the rest, is 64-86% of the bytes.
//
// The first design, one block per row, took 0.1523 ms for the up
// hook (bound 0.0469) and 0.0892 ms for the down hook (bound 0.0467) on an
// NVIDIA H100 80GB HBM3 at 700 W: each of the 64 active rows streamed its
// whole 512 KB A and 384 KB B slices from one SM, as a chain of 128 + 64
// dependent 16-byte loads a thread, while 8128 blocks only stored zeros.
//
// Design. Three launches; the active rows are found on the card, so the
// host needs no sync:
//  1. scan + zeros: block 0 lists the active rows in ascending order with
//     their factor slice and rank (meta); blocks 1.. each store the zeros
//     of one 64-row x 32*VEC-column tile at its inactive rows in float4
//     stores. The zeros are most of the bytes and run at the store rate
//     beside the one scan block.
//  2. shrink: a fixed grid of two blocks a SM whose warps stride over the
//     (active row, d_in split) items, one warp an item: lane (dl, g) owns
//     column group g of VEC rank columns (any r: when VEC does not divide
//     r, A is read one value at a time) and walks the split's rows dl,
//     dl + 32/ceil(r/VEC), ..., kLoads A loads in flight before it uses
//     any (kBatches batches a split, at most kMaxSplits splits: this file's
//     bgmv_expert_splits, which the wrapper asks to size part); a group that
//     the rank
//     mask zeroes entirely is not read; the lanes' sums of a column are
//     added in lane order and written to part[a, s, :].
//  3. expand: a fixed grid of four blocks a SM striding over the (active
//     row, d_out tile of 32*VEC columns) items: h = part[a, :, c] summed
//     over s in ascending order (one batch of loads), masked; warp w takes
//     the unmasked rank rows c = w, w+8, ..., kBLoads 16-byte B loads in
//     flight (a warp reads 512 contiguous bytes of a B row); the warps' sums
//     are added in warp order and written.
// Without a block per row, the work follows the active rows, not the E*C
// dispatch rows, and every chain of dependent loads is a few loads deep.
// Every sum runs in a fixed order and no float atomic is used, so two runs
// give the same bits. Slot and expert ids are clamped into range, as the
// reference's gathers clamp them.

#include "vec.cuh"

namespace {

using repro::to_f32;
using repro::Vec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kRowTile = 64;   // rows of a zero tile
constexpr int kLoads = 16;     // 16-byte A loads a shrink lane issues at once
constexpr int kBLoads = 8;     // 16-byte B loads an expand lane issues at once
constexpr int kSumLoads = 32;  // h's partial sums a thread loads at once
constexpr int kBatches = 2;    // batches of kLoads a shrink lane runs a split
constexpr int kMaxSplits = kSumLoads;  // so h sums its splits in one batch
constexpr int kShrinkBlocksPerSm = 2;
constexpr int kItemBlocksPerSm = 4;

// Block zb stores the zeros of zero tile zb, 64 rows x 32 * VEC columns,
// at the tile's inactive rows, in float4 stores that nothing waits on.
template <int VEC, bool kFull>
__device__ __forceinline__ void store_zeros(int zb,
                                            const int* __restrict__ ids,
                                            float* __restrict__ out, int T,
                                            int d_out) {
  constexpr int kTile = 32 * VEC;
  __shared__ unsigned char act_s[kRowTile];
  const int tid = threadIdx.x;
  const int col_tiles = (d_out + kTile - 1) / kTile;
  const int row0 = (zb / col_tiles) * kRowTile;
  const int tile0 = (zb % col_tiles) * kTile;
  const int width = min(kTile, d_out - tile0), n4 = (width + 3) / 4;
  const int n_rows = min(kRowTile, T - row0);
  if (tid < n_rows) act_s[tid] = ids[row0 + tid] >= 0;
  __syncthreads();
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < n_rows * n4; i += blockDim.x)
    if (!act_s[i / n4])
      repro::store4(out + (size_t)(row0 + i / n4) * d_out + tile0 +
                        (i % n4) * 4,
                    zero, width - (i % n4) * 4, kFull);
}

// Block 0: meta[0].x = n, the number of active rows (ids >= 0); meta[1 + a]
// = (t, slot * E + expert, rank, 0) of the a-th of them in ascending row
// order, ids clamped as the reference's gathers clamp them; a thread scans
// a run of ids. Block 1 + zb stores the zeros of zero tile zb
// (store_zeros): the zero stores, most of the kernel's bytes, run beside the
// scan, whose one block holds few registers.
//
// kFull (this kernel and the expand): d_out is a whole number of B's
// 16-byte vectors (every serving shape), so B is read and out written in
// vectors; else one value at a time. The launch picks the instantiation.
template <int VEC, bool kFull>
__global__ void __launch_bounds__(kScanThreads) bgmv_expert_scan_kernel(
    const int* __restrict__ ids, const int* __restrict__ eids,
    const int* __restrict__ ranks, int4* __restrict__ meta,
    float* __restrict__ out, int T, int N, int E, int r_mod, int d_out) {
  if (blockIdx.x > 0) {
    store_zeros<VEC, kFull>(blockIdx.x - 1, ids, out, T, d_out);
    return;
  }
  __shared__ int warp_s[32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (T + kScanThreads - 1) / kScanThreads;
  const int lo = min(T, tid * per), hi = min(T, lo + per);
  int cnt = 0;
  for (int t = lo; t < hi; ++t) cnt += ids[t] >= 0;
  int incl = cnt;  // inclusive prefix of cnt over the warp
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_s[lane];
    int w = v;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    warp_s[lane] = w - v;  // rows before warp `lane`
    if (lane == 31) meta[0] = make_int4(w, 0, 0, 0);
  }
  __syncthreads();
  int at = 1 + warp_s[warp] + incl - cnt;
  for (int t = lo; t < hi; ++t) {
    const int slot = ids[t];
    if (slot >= 0)
      meta[at++] = make_int4(
          t, min(slot, N - 1) * E + min(max(eids[t], 0), E - 1),
          ranks != nullptr ? ranks[t] : r_mod, 0);
  }
}

// Is any column of the group [c0, c0 + n) kept by the rank mask?
__device__ __forceinline__ bool group_kept(int c0, int n, int r_mod,
                                           int rank) {
  for (int k = 0; k < n; ++k)
    if ((c0 + k) % r_mod < rank) return true;
  return false;
}

// part[a, s, :] = x[t] . A[slot, e][rows of split s] for the a-th active
// row t: one warp an (a, s) item, the grid's warps striding over all items.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) bgmv_expert_shrink_kernel(
    const TX* __restrict__ x, const TW* __restrict__ A,
    const int4* __restrict__ meta, float* __restrict__ part, int d_in,
    int r, int r_mod, int chunk, int S) {
  constexpr int VEC = Vec<TW>::N;
  __shared__ float red[kWarps][32 * VEC];
  const int n_items = meta[0].x * S;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // any r: a group past r's last multiple of VEC, or every group when VEC
  // does not divide r, is read one value at a time
  const int groups = (r + VEC - 1) / VEC;
  const bool full = r % VEC == 0;
  // lane (dl, g) owns column group g and rows d0 + dl + k * dlanes; with 32
  // groups or more, one lane walks all rows of groups lane, lane + 32, ...
  const int dlanes = groups >= 32 ? 1 : 32 / groups;
  const int dl = groups >= 32 ? 0 : lane / groups;
  float* rw = red[warp];

  for (int item = blockIdx.x * kWarps + warp; item < n_items;
       item += gridDim.x * kWarps) {
    const int a = item / S, s = item % S;
    const int4 m = meta[1 + a];
    const int t = m.x, slice = m.y, rank = m.z;
    const int d0 = s * chunk, d_end = min(d_in, d0 + chunk);
    const TW* ab = A + (size_t)slice * d_in * r;
    const TX* xr = x + (size_t)t * d_in;
    float* p = part + ((size_t)a * S + s) * r;
    for (int g = groups >= 32 ? lane : lane % groups; g < groups; g += 32) {
      // lanes past dlanes * groups, and groups the mask zeroes, read nothing
      const bool mine = dl < dlanes;
      const int nv = min(VEC, r - g * VEC);
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      if (mine && group_kept(g * VEC, nv, r_mod, rank)) {
        const TW* ap = ab + g * VEC;
        for (int d = d0 + dl; d < d_end; d += kLoads * dlanes) {
          uint4 av[kLoads];
          float xv[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int du = d + u * dlanes;
            av[u] = make_uint4(0u, 0u, 0u, 0u);  // the bits of +0.0
            xv[u] = 0.f;
            if (du < d_end) {
              av[u] = full ? Vec<TW>::raw(ap + (size_t)du * r)
                           : Vec<TW>::raw_n(ap + (size_t)du * r, nv);
              xv[u] = to_f32(xr[du]);
            }
          }
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            float w[VEC];
            Vec<TW>::widen(av[u], w);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = fmaf(xv[u], w[k], acc[k]);
          }
        }
      }
      if (dlanes == 1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (k < nv) p[g * VEC + k] = acc[k];
        continue;
      }
      // the dlanes sums of a column, added in lane order
#pragma unroll
      for (int k = 0; k < VEC; ++k) rw[lane * VEC + k] = acc[k];
      __syncwarp();
      if (dl == 0) {
#pragma unroll
        for (int k = 0; k < nv; ++k) {
          float h = 0.f;
          for (int j = 0; j < dlanes; ++j) h += rw[(j * groups + g) * VEC + k];
          p[g * VEC + k] = h;
        }
      }
      __syncwarp();
    }
  }
}

// out at the active rows: each block strides over the (active row, d_out
// tile of 32 * VEC columns) items.
template <typename TW, bool kFull>
__global__ void __launch_bounds__(kThreads) bgmv_expert_expand_kernel(
    const TW* __restrict__ Bm, const int4* __restrict__ meta,
    const float* __restrict__ part, float* __restrict__ out, int r,
    int d_out, int r_mod, int S) {
  constexpr int VEC = Vec<TW>::N;
  constexpr int kTile = 32 * VEC;
  __shared__ __align__(16) float red[kWarps * kTile];
  extern __shared__ float h_s[];  // r
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col_tiles = (d_out + kTile - 1) / kTile;

  const int n_items = meta[0].x * col_tiles;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int a = item / col_tiles;
    const int tile0 = (item % col_tiles) * kTile;
    const int width = min(kTile, d_out - tile0);
    const int4 m = meta[1 + a];
    const int t = m.x, slice = m.y, rank = m.z;
    // h = part[a, :, c] summed over s in ascending order, then masked
    const float* pa = part + (size_t)a * S * r;
    for (int c = tid; c < r; c += kThreads) {
      const float* pp = pa + c;
      float h = 0.f;
      int s = 0;
      for (; s + kSumLoads <= S; s += kSumLoads) {
        float v[kSumLoads];
#pragma unroll
        for (int u = 0; u < kSumLoads; ++u) v[u] = pp[(size_t)(s + u) * r];
#pragma unroll
        for (int u = 0; u < kSumLoads; ++u) h += v[u];
      }
      for (; s < S; ++s) h += pp[(size_t)s * r];
      h_s[c] = (c % r_mod) < rank ? h : 0.f;
    }
    __syncthreads();

    // warp w takes the unmasked rank rows c = w, w + 8, ...
    float y[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = 0.f;
    if (lane * VEC < width) {
      const TW* b = Bm + (size_t)slice * r * d_out + tile0 +
                    lane * VEC;
      for (int c = warp; c < r; c += kBLoads * kWarps) {
        uint4 bv[kBLoads];
        float hv[kBLoads];
#pragma unroll
        for (int u = 0; u < kBLoads; ++u) {
          const int cu = c + u * kWarps;
          bv[u] = make_uint4(0u, 0u, 0u, 0u);
          hv[u] = 0.f;
          // a column the mask zeroes is not read: h is 0 there
          if (cu < r && (cu % r_mod) < rank) {
            bv[u] = repro::raw_at(b + (size_t)cu * d_out, width - lane * VEC,
                                  kFull);
            hv[u] = h_s[cu];
          }
        }
#pragma unroll
        for (int u = 0; u < kBLoads; ++u) {
          float w[VEC];
          Vec<TW>::widen(bv[u], w);
#pragma unroll
          for (int k = 0; k < VEC; ++k) y[k] = fmaf(hv[u], w[k], y[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[warp * kTile + lane * VEC + k] = y[k];
    __syncthreads();
    float* o = out + (size_t)t * d_out + tile0;
    for (int i = tid; i < (width + 3) / 4; i += kThreads) {
      float4 v = reinterpret_cast<const float4*>(red)[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 u = reinterpret_cast<const float4*>(red + w * kTile)[i];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      repro::store4(o + 4 * i, v, width - 4 * i, kFull);
    }
    __syncthreads();  // h_s and red are reused by the next item
  }
}

// Splits of d_in for the shrink, where one warp contracts one split of one
// row: 32 / ceil(r / vec) lanes walk the split's rows (one lane if r / vec >=
// 32), kBatches batches of kLoads loads each, at most kMaxSplits splits.
// Split s holds rows [s * chunk, (s + 1) * chunk), chunk = ceil(d_in / S).
int shrink_splits(int d_in, int r, int vec) {
  const int groups = (r + vec - 1) / vec;
  const int lanes = groups >= 32 ? 1 : 32 / (groups > 0 ? groups : 1);
  const int rows = kLoads * kBatches * lanes;  // rows of one split
  const int splits = (d_in + rows - 1) / rows;
  return splits < 1 ? 1 : splits > kMaxSplits ? kMaxSplits : splits;
}

template <typename TX, typename TW>
int launch(const void* x, const void* A, const void* B, const int* ids,
           const int* eids, const int* ranks, int* meta, float* part,
           float* out, int T, int N, int E, int d_in, int r, int d_out,
           int r_mod, cudaStream_t stream) {
  constexpr int VEC = Vec<TW>::N;
  const int S = shrink_splits(d_in, r, VEC);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int4* m4 = reinterpret_cast<int4*>(meta);
  const int col_tiles = (d_out + 32 * VEC - 1) / (32 * VEC);
  const int zeros = (T + kRowTile - 1) / kRowTile * col_tiles;
  const bool full = d_out % VEC == 0;
  auto scan = full ? bgmv_expert_scan_kernel<VEC, true>
                   : bgmv_expert_scan_kernel<VEC, false>;
  scan<<<1 + zeros, kScanThreads, 0, stream>>>(ids, eids, ranks, m4, out, T,
                                               N, E, r_mod, d_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bgmv_expert_shrink_kernel<TX, TW>
      <<<kShrinkBlocksPerSm * n_sm, kThreads, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(A), m4, part,
          d_in, r, r_mod, (d_in + S - 1) / S, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)r;
  auto kern = full ? bgmv_expert_expand_kernel<TW, true>
                   : bgmv_expert_expand_kernel<TW, false>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<kItemBlocksPerSm * n_sm, kThreads, smem, stream>>>(
      static_cast<const TW*>(B), m4, part, out, r, d_out, r_mod, S);
  return (int)cudaGetLastError();
}

}  // namespace

// The shrink's number of d_in splits S for factors of dtype w_dtype: part
// holds T * S * r floats.
extern "C" int bgmv_expert_splits(int w_dtype, int d_in, int r) {
  return shrink_splits(d_in, r, w_dtype == 1 ? Vec<__nv_bfloat16>::N
                                             : Vec<float>::N);
}

// dtype codes: 0 = float32, 1 = bfloat16. ranks may be null (no rank mask;
// then r_mod is r). meta holds 4 * (T + 1) ints, part T * S * r floats with
// S = bgmv_expert_splits(w_dtype, d_in, r) (the wrapper's scratch, 16-byte
// aligned). Returns a cudaError_t (0 = ok).
extern "C" int bgmv_expert_launch(int x_dtype, int w_dtype, const void* x,
                                  const void* A, const void* B,
                                  const int* ids, const int* eids,
                                  const int* ranks, int* meta, float* part,
                                  float* out, int T, int N, int E, int d_in,
                                  int r, int d_out, int r_mod,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BGMV_ARGS                                                      \
  x, A, B, ids, eids, ranks, meta, part, out, T, N, E, d_in, r, d_out, r_mod, \
      st
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(REPRO_BGMV_ARGS);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(REPRO_BGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(REPRO_BGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(REPRO_BGMV_ARGS);
#undef REPRO_BGMV_ARGS
  return (int)cudaErrorInvalidValue;
}
