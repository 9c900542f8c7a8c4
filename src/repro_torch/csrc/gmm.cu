// Grouped GEMM over MoE experts for Hopper (sm_90a), bound through a plain
// C interface (kernels/gmm.py loads it with ctypes).
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
// its capacity C, so each weight element read feeds at most 2 * rows
// operations: far below the ~295 a byte where the tensor cores would be the
// limit. The least the card can move is the weights of the experts that
// hold a row, their rows of xe, and the f32 output; an expert without rows
// costs only its zeros.
//
// Design. Block (j, i, e) owns columns [j * 32 * VEC, (j + 1) * 32 * VEC) of
// rows [i * 8, i * 8 + 8) of expert e. A block whose rows all lie at or
// past group_sizes[e] writes zeros and reads no weight: the TPU kernel's
// skip of empty experts, on row tiles, with its mask of the ragged tail.
// Otherwise, in chunks of 256 along d, the block stages its rows of xe in
// shared memory as f32; warp w takes d rows k = w, w + 8, ... of the chunk,
// and lane l streams VEC consecutive columns of w's row k as one 16-byte
// vector (a warp reads 512 contiguous bytes of bf16), adding xe[m, k] * w
// into its 8 x VEC sums. The warps' sums are added in warp order through
// shared memory, so two runs give the same bits. Rows at or past
// group_sizes[e] inside a live tile are written as exact zeros. A simple
// kernel on the CUDA cores; wgmma and TMA are later work.

#include "vec.cuh"

namespace {

using repro::to_f32;
using repro::Vec;

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

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; group_sizes may be null (every
// row of every expert). Returns a cudaError_t (0 = ok).
extern "C" int gmm_launch(int x_dtype, int w_dtype, const void* xe,
                          const void* w, const int* group_sizes, float* out,
                          int E, int C, int d, int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(xe, w, group_sizes, out, E, C, d, f, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(xe, w, group_sizes, out, E, C, d, f,
                                        st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(xe, w, group_sizes, out, E, C, d, f,
                                        st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(xe, w, group_sizes, out, E,
                                                 C, d, f, st);
  return (int)cudaErrorInvalidValue;
}
