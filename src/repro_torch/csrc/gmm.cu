// Grouped GEMM over MoE experts for Hopper (sm_90a), bound through a plain
// C interface (kernels/gmm.py loads it with ctypes). Both serving planes'
// base expert GEMMs (gate, up, down) run through it.
//
// Replaces the TPU kernel src/repro/kernels/gmm.py::gmm:
//
//   out[e, m] = xe[e, m] . w[e]             (f32) for m < group_sizes[e]
//   out[e, m] = 0                           for m >= group_sizes[e]
//
//   xe (E, C, d) | w (E, d, f) | group_sizes (E,) int32 or null (all C)
//   -> out (E, C, f) f32
//
// What bounds it: bytes. At decode an expert holds a few routed rows of
// its capacity C (at most one a token: 1-8 rows at 8 tokens), so each
// weight element read feeds at most 2 * rows operations, far below the ~295
// a byte where the tensor cores would be the limit. The least the card can
// move is the weights of the experts that hold a row, their rows of xe, and
// the f32 output; an expert without rows costs only its zeros.
//
// The first design (f32 FMA on the CUDA cores, a block of 8 rows x 256
// columns on a grid of (f tiles, C / 8, E) blocks, each walking d one w row
// at a time) took 0.485 / 0.485 / 0.425 ms for the decode dispatch's gate,
// up and down GEMMs (bound 0.21 / 0.21 / 0.24 ms) on an NVIDIA H100 80GB
// HBM3 at 700 W: each live block waited on its own loads, and thousands of
// blocks existed only to store zeros or to exit.
//
// Design of the bf16 x bf16 kernel (tensor cores, f32 sums):
//  * Items: (expert, column tile of kBN, group of kRows rows) for the rows
//    below group_sizes[e]; an empty expert has none. Every block reads
//    group_sizes, counts each expert's items and takes a prefix sum in
//    shared memory, so the list is built on the card with no host sync. A
//    persistent grid (as many blocks as fit the SMs) walks the items in the
//    order (expert, column tile, row group); blocks that run at the same
//    time read neighbouring columns of one expert's weights.
//  * Before its items, each block stores the exact zeros of its share of
//    the dead rows (row >= group_sizes[e], every row of an empty expert),
//    reading no weight: the stores drain while the first loads fly.
//  * An item streams w[e][:, n0:n0+kBN] and its rows of xe through a ring
//    of kStages stages in shared memory (cp.async, 16 bytes a copy; k past
//    d is zero-filled), so each block keeps ~5 stages of loads in flight.
//    Rows are 128 bytes in both tiles and 16-byte chunk c of row k lies at
//    c ^ (k % 8), so ldmatrix reads 32 distinct banks.
//  * mma.sync m16n8k16 (bf16 in, f32 accumulate): the expert's rows are
//    the A operand (one or two 16-row tiles; rows past the group are never
//    written), w's tile the B operand, read with ldmatrix.trans from its
//    row-major [k][n] layout; warp w owns columns [16w, 16w + 16). The
//    products are exact in f32, but one accumulator chained through all
//    of d = 4096 on the tensor cores ended up to 2.0e-5 (rms 4.4e-6, at
//    outputs up to ~5) from the f64 sum, enough to flip many bf16
//    roundings of the activations downstream. So each stage's 64-deep sum
//    starts from zero on the tensor cores and is added to an f32 total in
//    round-to-nearest: 1.8e-6 (rms 1.6e-7), closer than the plain f32
//    version's own 7.7e-6. d is summed in one fixed order, so two runs give
//    the same bits. No split of d is needed: at the decode dispatch the
//    gate GEMM has 52 x 24 = 1248 items of 512 KB.
// Other operand types (f32 x or w, or a d that is not a multiple of 8) take
// the first design's kernel, which keeps IEEE f32 FMA on the CUDA cores.

#include <cstdint>

#include "vec.cuh"

namespace {

using repro::to_f32;
using repro::Vec;
using bf16 = __nv_bfloat16;

// ---------------------- tensor-core kernel (bf16) ------------------------
constexpr int kMmaThreads = 128;   // 4 warps, 16 columns each
constexpr int kBN = 64;            // columns of an item
constexpr int kBK = 64;            // d rows of a stage
constexpr int kRows = 32;          // rows of an item: two m16 tiles
constexpr int kStages = 6;
constexpr int kWTile = kBK * kBN * 2;     // bytes of w a stage
constexpr int kXTile = kRows * kBK * 2;   // bytes of xe a stage
constexpr int kStageBytes = kWTile + kXTile;
constexpr int kMaxExperts = 1024;
constexpr int kMaxDevices = 64;   // devices whose launch plans are kept

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with bytes = 0 the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// byte offset of 16-byte chunk c of 128-byte row k, swizzled
__device__ __forceinline__ int swz(int k, int c) {
  return k * 128 + ((c ^ (k & 7)) << 4);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads) gmm_mma_kernel(
    const bf16* __restrict__ xe, const bf16* __restrict__ w,
    const int* __restrict__ group_sizes, float* __restrict__ out, int E,
    int C, int d, int f) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* gsz = reinterpret_cast<int*>(smem + kStages * kStageBytes);  // E
  int* pre = gsz + E;                                               // E + 1
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_ct = (f + kBN - 1) / kBN;

  // each expert's live rows and items; pre = exclusive prefix of items
  for (int e = tid; e < E; e += kMmaThreads) {
    const int g = group_sizes ? min(max(group_sizes[e], 0), C) : C;
    gsz[e] = g;
    pre[e + 1] = (g + kRows - 1) / kRows * n_ct;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      int v = e0 + lane < E ? pre[e0 + lane + 1] : 0;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (e0 + lane < E) pre[e0 + lane + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();

  // the zeros of the dead rows, one row a block at a time
  const int f4 = f / 4;  // f is a multiple of 8
  for (int row = blockIdx.x; row < E * C; row += gridDim.x) {
    if (row % C < gsz[row / C]) continue;
    float4* o = reinterpret_cast<float4*>(out + (size_t)row * f);
    for (int i = tid; i < f4; i += kMmaThreads)
      o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const unsigned s0 = smem_addr(smem);
  const int n_items = pre[E];
  const int KT = (d + kBK - 1) / kBK;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int lo = 0, hi = E;  // pre[lo] <= item < pre[lo + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (pre[mid] <= item) lo = mid; else hi = mid;
    }
    const int e = lo, g = gsz[e];
    const int rgs = (g + kRows - 1) / kRows, j = item - pre[e];
    const int n0 = (j / rgs) * kBN, m0 = (j % rgs) * kRows;
    const int rows = min(kRows, g - m0);
    const bf16* wb = w + (size_t)e * d * f + n0;
    const bf16* xb = xe + ((size_t)e * C + m0) * d;

    auto load_stage = [&](int kt) {
      const unsigned st = s0 + (kt % kStages) * kStageBytes;
      const int k0 = kt * kBK;
      for (int i = tid; i < kBK * 8; i += kMmaThreads) {
        const int k = i >> 3, c = i & 7;
        const bool ok = k0 + k < d && n0 + c * 8 < f;
        cp_async16(st + swz(k, c), ok ? wb + (size_t)(k0 + k) * f + c * 8 : w,
                   ok ? 16 : 0);
      }
      for (int i = tid; i < rows * 8; i += kMmaThreads) {
        const int m = i >> 3, c = i & 7;
        const bool ok = k0 + c * 8 < d;
        cp_async16(st + kWTile + swz(m, c),
                   ok ? xb + (size_t)m * d + k0 + c * 8 : xe, ok ? 16 : 0);
      }
    };

    // acc: one stage's sums on the tensor cores; tot: their IEEE f32 sum
    float acc[2][2][4], tot[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) tot[mt][nt][v] = 0.f;
    const int n_mt = rows > 16 ? 2 : 1;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load_stage(s);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int kt = 0; kt < KT; ++kt) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
      __syncthreads();  // stage kt landed; stage kt - 1 is free again
      if (kt + kStages - 1 < KT) load_stage(kt + kStages - 1);
      asm volatile("cp.async.commit_group;\n" ::);
      const unsigned ws = s0 + (kt % kStages) * kStageBytes;
      const unsigned xs = ws + kWTile;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const int q = lane >> 3;
        uint32_t b[4];  // (k 0-7, 8-15) x (n tile 0, 1) of this warp
        {
          const int k = ks * 16 + (q & 1) * 8 + (lane & 7);
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0,%1,%2,%3}, [%4];\n"
              : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
              : "r"(ws + swz(k, warp * 2 + (q >> 1))));
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt < n_mt) {
            uint32_t a[4];
            const int m = mt * 16 + (q & 1) * 8 + (lane & 7);
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                "{%0,%1,%2,%3}, [%4];\n"
                : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                : "r"(xs + swz(m, ks * 2 + (q >> 1))));
            mma_bf16(acc[mt][0], a, b[0], b[1]);
            mma_bf16(acc[mt][1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            tot[mt][nt][v] = __fadd_rn(tot[mt][nt][v], acc[mt][nt][v]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the next item's prologue reuses every stage

    // c0, c1 at (row g, cols 2t, 2t + 1); c2, c3 at row g + 8
    const int gr = lane >> 2, tc = (lane & 3) * 2;
    float* ob = out + ((size_t)e * C + m0) * f + n0 + warp * 16 + tc;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + warp * 16 + nt * 8 + tc;
        if (col >= f) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + gr + h * 8;
          if (m < rows)
            *reinterpret_cast<float2*>(ob + (size_t)m * f + nt * 8) =
                make_float2(tot[mt][nt][2 * h], tot[mt][nt][2 * h + 1]);
        }
      }
  }
}

size_t mma_smem(int E) {
  return (size_t)kStages * kStageBytes + sizeof(int) * (2 * (size_t)E + 1);
}

// The persistent grid for E experts on the current device: every block the
// SMs hold at the kernel's shared memory. Asked once a device and E.
cudaError_t mma_grid(int E, int* grid) {
  struct Plan {
    int E = -1, grid = 0;
  };
  static Plan cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev].E != E) {
    const size_t smem = mma_smem(E);
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gmm_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gmm_mma_kernel, kMmaThreads, smem);
    if (err != cudaSuccess) return err;
    cache[dev].grid = n_sm * (per_sm > 0 ? per_sm : 1);
    cache[dev].E = E;
  }
  *grid = cache[dev].grid;
  return cudaSuccess;
}

int launch_mma(const bf16* xe, const bf16* w, const int* group_sizes,
               float* out, int E, int C, int d, int f, cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err = mma_grid(E, &grid);
  if (err != cudaSuccess) return (int)err;
  gmm_mma_kernel<<<grid, kMmaThreads, mma_smem(E), stream>>>(
      xe, w, group_sizes, out, E, C, d, f);
  return (int)cudaGetLastError();
}

// ------------------- CUDA-core kernel (f32 operands) ---------------------
// Block (j, i, e) owns columns [j * 32 * VEC, (j + 1) * 32 * VEC) of rows
// [i * 8, i * 8 + 8) of expert e. A block whose rows all lie at or past
// group_sizes[e] writes zeros and reads no weight. Otherwise, in chunks of
// 256 along d, the block stages its rows of xe in shared memory as f32;
// warp w takes d rows k = w, w + 8, ... of the chunk, and lane l streams
// VEC consecutive columns of w's row k as one 16-byte vector, adding
// xe[m, k] * w into its 8 x VEC sums. The warps' sums are added in warp
// order through shared memory, so two runs give the same bits.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 8;      // rows of xe a block
constexpr int kKC = 256;    // d chunk staged in shared memory

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) gmm_kernel(
    const TX* __restrict__ xe, const TW* __restrict__ w,
    const int* __restrict__ group_sizes, float* __restrict__ out, int C,
    int d, int f) {
  constexpr int VEC = Vec<TW>::N;
  constexpr int kTile = 32 * VEC;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int width = min(kTile, f - n0);
  const int mrows = min(kBM, C - m0);
  const int g = group_sizes ? min(max(group_sizes[e], 0), C) : C;
  const int rows = max(0, min(mrows, g - m0));
  float* o = out + ((size_t)e * C + m0) * f + n0;
  // rows [rows, mrows) are zeros; f is a multiple of VEC (>= 4)
  for (int i = rows * (width / 4) + tid; i < mrows * (width / 4);
       i += kThreads)
    *reinterpret_cast<float4*>(o + (size_t)(i / (width / 4)) * f +
                               (i % (width / 4)) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  if (rows == 0) return;

  __shared__ float xs[kBM][kKC];
  __shared__ float red[kWarps][kTile];
  float acc[kBM][VEC];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.f;
  const bool on = lane * VEC < width;
  const TX* xb = xe + ((size_t)e * C + m0) * d;
  const TW* wb = w + (size_t)e * d * f + n0 + lane * VEC;
  for (int k0 = 0; k0 < d; k0 += kKC) {
    const int kw = min(kKC, d - k0);
    for (int i = tid; i < kBM * kKC; i += kThreads) {
      const int m = i / kKC, k = i % kKC;
      xs[m][k] = (m < rows && k < kw) ? to_f32(xb[(size_t)m * d + k0 + k])
                                      : 0.f;
    }
    __syncthreads();
    if (on) {
#pragma unroll 4
      for (int k = warp; k < kw; k += kWarps) {
        float wv[VEC];
        Vec<TW>::load(wb + (size_t)(k0 + k) * f, wv);
#pragma unroll
        for (int m = 0; m < kBM; ++m) {
          if (m < rows) {
            const float xv = xs[m][k];
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[m][v] = fmaf(xv, wv[v], acc[m][v]);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int m = 0; m < rows; ++m) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[warp][lane * VEC + v] = acc[m][v];
    __syncthreads();
    for (int i = tid; i < width; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) s += red[ww][i];
      o[(size_t)m * f + i] = s;
    }
    __syncthreads();
  }
}

template <typename TX, typename TW>
int launch(const void* xe, const void* w, const int* group_sizes, float* out,
           int E, int C, int d, int f, cudaStream_t stream) {
  constexpr int VEC = Vec<TW>::N;
  const dim3 grid((f + 32 * VEC - 1) / (32 * VEC), (C + kBM - 1) / kBM, E);
  gmm_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(xe), static_cast<const TW*>(w), group_sizes,
      out, C, d, f);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; group_sizes may be null (every
// row of every expert); f is a multiple of the 16-byte vector. Returns a
// cudaError_t (0 = ok).
extern "C" int gmm_launch(int x_dtype, int w_dtype, const void* xe,
                          const void* w, const int* group_sizes, float* out,
                          int E, int C, int d, int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the tensor-core kernel where its 16-byte copies and its tables fit
  if (x_dtype == 1 && w_dtype == 1 && d % 8 == 0 && E <= kMaxExperts &&
      aligned16(xe) && aligned16(w))
    return launch_mma(static_cast<const bf16*>(xe),
                      static_cast<const bf16*>(w), group_sizes, out, E, C, d,
                      f, st);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(xe, w, group_sizes, out, E, C, d, f, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, bf16>(xe, w, group_sizes, out, E, C, d, f, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<bf16, float>(xe, w, group_sizes, out, E, C, d, f, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<bf16, bf16>(xe, w, group_sizes, out, E, C, d, f, st);
  return (int)cudaErrorInvalidValue;
}
