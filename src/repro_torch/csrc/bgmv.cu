// Per-row LoRA shrink-expand (BGMV) for Hopper (sm_90a): the coupled
// (S-LoRA) plane's attention-projection LoRA (q, k, v, o), bound through a
// plain C interface (kernels/bgmv.py loads it with ctypes).
//
// Replaces the TPU kernels src/repro/kernels/bgmv.py::bgmv (the contract of
// src/repro/core/lora_math.py::bgmv) and, with a ranks pointer,
// src/repro/kernels/bgmv.py::bgmv_ranked:
//
//   h      = x[t] . A[ids[t]]                          (f32, width r)
//   h[c]   = 0 where c >= ranks[ids[t]]                (ranked form only)
//   out[t] = h . B[ids[t]]                             (f32, width d_out)
//   out[t] = 0 where ids[t] < 0, and such a row reads no factor
//
//   x (T, d_in) | A (N, d_in, r) | B (N, r, d_out) | ids (T,) int32
//   | ranks (N,) int32 or null -> out (T, d_out) f32; part (T, S, r) f32 is
//   the wrapper's scratch
//
// What bounds it: bytes, and at decode the launch. An active row reads its
// adapter's (d_in x r) A and (r x d_out) B and does 2 operations per factor
// element: at most one operation a byte in bf16, far below the ~295 where
// the tensor cores would be the limit. At decode T <= 8 rows over 4
// adapters read ~3 MB of unique factors for q or o, ~1 us at 3.35 TB/s.
//
// Design. The parallelism has to come from the width: one block per row
// (the bgmv_expert kernel's layout) would put at most 8 blocks on 132 SMs.
// Two launches, with every sum taken in a fixed order, so two runs give the
// same bits:
//  1. shrink, grid (T, S): block (t, s) contracts rows [s*chunk, (s+1)*chunk)
//     of d_in. Each thread owns one group of VEC rank columns and walks rows
//     of A in 16-byte vectors, neighbouring threads on neighbouring
//     addresses; the threads' sums of one column are added in thread order
//     through shared memory and written to part[t, s, :].
//  2. expand, grid (T, d_out tiles of 32*VEC columns): block (t, j) adds
//     part[t, :, c] over s in ascending order, then its 8 warps split the
//     rank: warp w takes c = w, w+8, ..., and its lane l streams VEC
//     consecutive columns of B's row c as one 16-byte vector (one warp reads
//     512 contiguous bytes). The warps' sums are added in warp order through
//     shared memory and written.
// A row with ids < 0 returns at once in the shrink and writes its zeros in
// the expand. Adapter ids past N - 1 are clamped, as the reference's gather
// clamps them.
// Ranked form: a thread whose column group starts at or past the row's rank
// reads no A (its partial sum stays 0), the expand masks h at c >= rank and
// reads only B's first rank rows. Every sum keeps the padded form's order,
// so on a pool whose columns past each adapter's rank are zero (the
// prefix-zero contract) ranked and padded give the same values bit for bit;
// only the skipped reads differ (at rank 4 of 64 in bf16 an A row is still
// read as one 32-byte sector, a quarter of its 128 bytes).

#include "vec.cuh"

namespace {

using repro::to_f32;
using repro::Vec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) bgmv_shrink_kernel(
    const TX* __restrict__ x, const TW* __restrict__ A,
    const int* __restrict__ ids, const int* __restrict__ ranks,
    float* __restrict__ part, int N, int d_in, int r, int chunk) {
  constexpr int VEC = Vec<TW>::N;
  const int t = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  int slot = ids[t];
  if (slot < 0) return;  // the expand writes this row's zeros
  slot = min(slot, N - 1);
  const int tid = threadIdx.x;
  const int groups = r / VEC;
  const int c0 = (tid % groups) * VEC;
  const int stride = kThreads / groups;
  const int rank = ranks ? ranks[slot] : r;
  const int d_end = c0 < rank ? min(d_in, (s + 1) * chunk) : 0;
  const TW* a = A + (size_t)slot * d_in * r + c0;
  const TX* xr = x + (size_t)t * d_in;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int d = s * chunk + tid / groups; d < d_end; d += stride) {
    float av[VEC];
    Vec<TW>::load(a + (size_t)d * r, av);
    const float xv = to_f32(xr[d]);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = fmaf(xv, av[k], acc[k]);
  }
  __shared__ float red[kThreads * Vec<TW>::N];
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[tid * VEC + k] = acc[k];
  __syncthreads();
  float* p = part + ((size_t)t * S + s) * r;
  for (int c = tid; c < r; c += kThreads) {
    const int g = c / VEC, k = c % VEC;
    float h = 0.f;
    for (int j = g; j < kThreads; j += groups) h += red[j * VEC + k];
    p[c] = h;
  }
}

template <typename TW>
__global__ void __launch_bounds__(kThreads) bgmv_expand_kernel(
    const TW* __restrict__ Bm, const int* __restrict__ ids,
    const int* __restrict__ ranks, const float* __restrict__ part,
    float* __restrict__ out, int N, int r, int d_out, int S) {
  constexpr int VEC = Vec<TW>::N;
  constexpr int kTile = 32 * VEC;
  const int t = blockIdx.x;
  const int tile0 = blockIdx.y * kTile;
  const int width = min(kTile, d_out - tile0);
  const int tid = threadIdx.x;
  float* o = out + (size_t)t * d_out + tile0;
  int slot = ids[t];
  if (slot < 0) {
    for (int i = tid; i < width; i += kThreads) o[i] = 0.f;
    return;
  }
  slot = min(slot, N - 1);
  const int rank = ranks ? min(max(ranks[slot], 0), r) : r;

  extern __shared__ float smem[];
  float* h_s = smem;       // r
  float* red = smem + r;   // kWarps x kTile
  const float* p = part + (size_t)t * S * r;
  for (int c = tid; c < r; c += kThreads) {
    float h = 0.f;
    for (int s = 0; s < S; ++s) h += p[(size_t)s * r + c];
    h_s[c] = c < rank ? h : 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  float y[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) y[k] = 0.f;
  // d_out is a multiple of VEC, so a lane's vector lies wholly inside d_out
  if (lane * VEC < width) {
    const TW* b = Bm + (size_t)slot * r * d_out + tile0 + lane * VEC;
    for (int c = warp; c < rank; c += kWarps) {
      float bv[VEC];
      Vec<TW>::load(b + (size_t)c * d_out, bv);
      const float hc = h_s[c];
#pragma unroll
      for (int k = 0; k < VEC; ++k) y[k] = fmaf(hc, bv[k], y[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[warp * kTile + lane * VEC + k] = y[k];
  __syncthreads();
  for (int i = tid; i < width; i += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * kTile + i];
    o[i] = v;
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* A, const void* B, const int* ids,
           const int* ranks, float* part, float* out, int T, int N, int d_in,
           int r, int d_out, int S, cudaStream_t stream) {
  constexpr int VEC = Vec<TW>::N;
  const int chunk = (d_in + S - 1) / S;
  bgmv_shrink_kernel<TX, TW><<<dim3(T, S), kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(A), ids, ranks, part,
      N, d_in, r, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (d_out + 32 * VEC - 1) / (32 * VEC);
  const size_t smem = sizeof(float) * ((size_t)r + (size_t)kWarps * 32 * VEC);
  auto kern = bgmv_expand_kernel<TW>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(T, tiles), kThreads, smem, stream>>>(
      static_cast<const TW*>(B), ids, ranks, part, out, N, r, d_out, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Threads per block; the wrapper checks that (r / VEC) divides it and sizes
// the d_in split from it.
extern "C" int bgmv_threads() { return kThreads; }

// dtype codes: 0 = float32, 1 = bfloat16. part holds T * S * r floats;
// ranks is null (padded) or N per-adapter true ranks (ranked).
// Returns a cudaError_t (0 = ok).
extern "C" int bgmv_launch(int x_dtype, int w_dtype, const void* x,
                           const void* A, const void* B, const int* ids,
                           const int* ranks, float* part, float* out, int T,
                           int N, int d_in, int r, int d_out, int S,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BGMV_ARGS \
  x, A, B, ids, ranks, part, out, T, N, d_in, r, d_out, S, st
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(REPRO_BGMV_ARGS);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(REPRO_BGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(REPRO_BGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(REPRO_BGMV_ARGS);
#undef REPRO_BGMV_ARGS
  return (int)cudaErrorInvalidValue;
}
