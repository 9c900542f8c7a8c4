// Expert-LoRA shrink-expand (BGMV) for Hopper (sm_90a): the disaggregated
// LoRA Server's hook kernel, bound through a plain C interface
// (kernels/bgmv.py loads it with ctypes).
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
//   ranks (T,) int32 -> out (T, d_out) f32
//
// What bounds it: bytes. An active row reads its (d_in x r) A slice and its
// (r x d_out) B slice once and does 2 operations for each factor element,
// one operation a byte in bf16. At decode the hooks see E*C rows of which
// only T*K are active (8192 rows, 64 active at batch 8), so writing the
// f32 output rows is the other large share of the bytes.
//
// Design. One block per row. An inactive row writes its zeros and returns
// before it touches A or B. An active row stages x in shared memory as f32,
// then streams A in 16-byte vectors: each thread owns a fixed group of VEC
// rank columns and walks rows of A, so neighbouring threads read
// neighbouring addresses; the partial sums of one column group are reduced
// through shared memory. The masked h stays in shared memory and the expand
// streams B in 16-byte vectors along d_out. Slot and expert ids are clamped
// into range, as the reference's gathers clamp them.

#include "vec.cuh"

namespace {

using repro::to_f32;
using repro::Vec;

constexpr int kThreads = 256;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) bgmv_expert_kernel(
    const TX* __restrict__ x, const TW* __restrict__ A,
    const TW* __restrict__ Bm, const int* __restrict__ ids,
    const int* __restrict__ eids, const int* __restrict__ ranks,
    float* __restrict__ out, int N, int E, int d_in, int r, int d_out,
    int r_mod) {
  constexpr int VEC = Vec<TW>::N;
  const int t = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* o = out + (size_t)t * d_out;
  int slot = ids[t];
  if (slot < 0) {
    for (int i = tid * 4; i < d_out; i += nt * 4)
      *reinterpret_cast<float4*>(o + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  slot = min(slot, N - 1);
  const int e = min(max(eids[t], 0), E - 1);

  extern __shared__ float smem[];
  float* x_s = smem;               // d_in
  float* part = x_s + d_in;        // nt x VEC partial sums
  float* h_s = part + nt * VEC;    // r
  const TX* xr = x + (size_t)t * d_in;
  for (int i = tid; i < d_in; i += nt) x_s[i] = to_f32(xr[i]);
  __syncthreads();

  // shrink: thread tid owns columns c0..c0+VEC-1 and rows d = tid/groups + k*stride
  const TW* a = A + ((size_t)slot * E + e) * (size_t)d_in * r;
  const int groups = r / VEC;
  const int c0 = (tid % groups) * VEC;
  const int stride = nt / groups;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int d = tid / groups; d < d_in; d += stride) {
    float av[VEC];
    Vec<TW>::load(a + (size_t)d * r + c0, av);
    const float xv = x_s[d];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = fmaf(xv, av[k], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) part[tid * VEC + k] = acc[k];
  __syncthreads();
  const int rank = ranks != nullptr ? ranks[t] : r_mod;
  for (int c = tid; c < r; c += nt) {
    const int g = c / VEC, k = c % VEC;
    float h = 0.f;
    for (int j = g; j < nt; j += groups) h += part[j * VEC + k];
    h_s[c] = (c % r_mod) < rank ? h : 0.f;
  }
  __syncthreads();

  // expand: thread tid owns output columns o0..o0+VEC-1
  const TW* bm = Bm + ((size_t)slot * E + e) * (size_t)r * d_out;
  for (int o0 = tid * VEC; o0 < d_out; o0 += nt * VEC) {
    float y[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = 0.f;
    for (int c = 0; c < r; ++c) {
      float bv[VEC];
      Vec<TW>::load(bm + (size_t)c * d_out + o0, bv);
      const float hc = h_s[c];
#pragma unroll
      for (int k = 0; k < VEC; ++k) y[k] = fmaf(hc, bv[k], y[k]);
    }
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(o + o0 + k) =
          make_float4(y[k], y[k + 1], y[k + 2], y[k + 3]);
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* A, const void* B, const int* ids,
           const int* eids, const int* ranks, float* out, int T, int N, int E,
           int d_in, int r, int d_out, int r_mod, cudaStream_t stream) {
  constexpr int VEC = Vec<TW>::N;
  const size_t smem =
      sizeof(float) * ((size_t)d_in + (size_t)kThreads * VEC + (size_t)r);
  auto kern = bgmv_expert_kernel<TX, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<T, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(A),
      static_cast<const TW*>(B), ids, eids, ranks, out, N, E, d_in, r, d_out,
      r_mod);
  return (int)cudaGetLastError();
}

}  // namespace

// Threads per block; the wrapper checks that (r / VEC) divides it.
extern "C" int bgmv_expert_threads() { return kThreads; }

// dtype codes: 0 = float32, 1 = bfloat16. ranks may be null (no rank mask;
// then r_mod is r). Returns a cudaError_t (0 = ok).
extern "C" int bgmv_expert_launch(int x_dtype, int w_dtype, const void* x,
                                  const void* A, const void* B,
                                  const int* ids, const int* eids,
                                  const int* ranks, float* out, int T, int N,
                                  int E, int d_in, int r, int d_out,
                                  int r_mod, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BGMV_ARGS \
  x, A, B, ids, eids, ranks, out, T, N, E, d_in, r, d_out, r_mod, st
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
