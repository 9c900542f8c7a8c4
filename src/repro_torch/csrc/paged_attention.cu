// Paged flash-decode attention for Hopper (sm_90a), bound through a plain C
// interface (kernels/paged.py loads it with ctypes).
//
// Replaces the TPU kernel src/repro/kernels/paged.py::paged_attention: one
// query token per row attends over its keys 0..pos[b], which live in pages
// of a shared pool (P, page_size, KV, hd) named by the row's block table
// (-1 = unallocated). Masked keys are kept out of the exp-sum, so a row with
// no valid key (pos < 0, every page unallocated) gives exact zeros.
//
//   q (B, KV, G, hd) | k/v pool (P, ps, KV, hd) | block_tables (B, nb) int32
//   pos (B,) int32 | window (0 = full) -> out (B, KV, G, hd) f32
//
// What bounds it: bytes. Every cached key and value of a row is read once
// and takes 4*G*hd operations for 4*hd bytes (bf16 K+V): G = 16 operations
// a byte on the main path, far below the ~295 where the tensor cores would
// be the limit.
//
// Design. The TPU kernel walks a row's pages along a sequential grid axis
// and carries the softmax state in VMEM scratch. Blocks on Hopper run in no
// order, so the page axis is split (flash-decoding): grid (B, KV, n_split),
// each block loops over its own run of pages, reads the block table itself,
// and carries the running max m, sum-exp l and weighted values acc in
// shared memory. A second kernel merges the splits with the log-sum-exp
// rule. The main path has only B*KV = 32 (row, kv-head) pairs, so the split
// is what puts enough blocks in flight to fill the 132 SMs. A page with no
// valid key (past pos, wholly before the window, unallocated) is skipped
// before it is loaded: it would leave m, l and acc exactly as they were.
// All arithmetic is f32; K/V rows are staged in shared memory with a padded
// row stride so that the score loop reads without bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool key_valid(int kp, int pos, int window) {
  return kp <= pos && (window <= 0 || kp > pos - window);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attn_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ pos, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int KV, int G,
    int hd, int P, int ps, int nb, int window, int pps, int n_split,
    float scale) {
  const int b = blockIdx.x, kv = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hdp = hd + 1;  // padded stride: rows start in distinct banks
  extern __shared__ float smem[];
  float* q_s = smem;              // G x hdp
  float* k_s = q_s + G * hdp;     // ps x hdp
  float* v_s = k_s + ps * hdp;    // ps x hd
  float* p_s = v_s + ps * hd;     // G x ps scores, then probabilities
  float* acc_s = p_s + G * ps;    // G x hd
  float* m_s = acc_s + G * hd;    // G
  float* l_s = m_s + G;           // G
  float* c_s = l_s + G;           // G rescale factor of this page

  const int row_pos = pos[b];
  const TQ* qb = q + (size_t)(b * KV + kv) * G * hd;
  for (int i = tid; i < G * hd; i += nt) {
    q_s[(i / hd) * hdp + i % hd] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += nt) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int j_end = min(nb, (sp + 1) * pps);
  for (int j = sp * pps; j < j_end; ++j) {
    int page = block_tables[(size_t)b * nb + j];
    const int first = j * ps;  // position of the page's first key
    // uniform over the block: every thread takes the same branch
    if (page < 0 || row_pos < 0 || first > row_pos) continue;
    if (window > 0 && first + ps - 1 <= row_pos - window) continue;
    page = min(page, P - 1);  // the reference gathers with clamped ids
    const size_t base = ((size_t)page * ps * KV + kv) * hd;
    for (int i = tid; i < ps * hd; i += nt) {
      const int t = i / hd, d = i % hd;
      const size_t off = base + (size_t)t * KV * hd + d;
      k_s[t * hdp + d] = to_f32(k_pool[off]);
      v_s[t * hd + d] = to_f32(v_pool[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * ps; i += nt) {
      const int g = i / ps, t = i % ps;
      const float* qr = q_s + g * hdp;
      const float* kr = k_s + t * hdp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[i] = s * scale;
    }
    __syncthreads();
    for (int g = tid; g < G; g += nt) {
      float m_cur = kNegInf;
      for (int t = 0; t < ps; ++t)
        if (key_valid(first + t, row_pos, window))
          m_cur = fmaxf(m_cur, p_s[g * ps + t]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, m_cur);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = key_valid(first + t, row_pos, window)
                            ? expf(p_s[g * ps + t] - m_new)
                            : 0.f;
        p_s[g * ps + t] = p;
        sum += p;
      }
      const float corr = expf(m_old - m_new);
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
      c_s[g] = corr;
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += nt) {
      const int g = i / hd, d = i % hd;
      float pv = 0.f;
      for (int t = 0; t < ps; ++t) pv = fmaf(p_s[g * ps + t], v_s[t * hd + d], pv);
      acc_s[i] = acc_s[i] * c_s[g] + pv;
    }
    __syncthreads();
  }

  const size_t prow = ((size_t)(b * KV + kv) * n_split + sp) * G;
  for (int g = tid; g < G; g += nt) {
    m_part[prow + g] = m_s[g];
    l_part[prow + g] = l_s[g];
  }
  for (int i = tid; i < G * hd; i += nt) acc_part[prow * hd + i] = acc_s[i];
}

// Merge the splits of one (row, kv-head): out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-20). A split with no valid key holds
// m = -1e30, l = 0, acc = 0 and adds nothing; a row with no valid key at
// all gives 0 / 1e-20 = 0.
__global__ void __launch_bounds__(kThreads) paged_attn_combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, float* __restrict__ out, int KV,
    int G, int hd, int n_split) {
  const size_t row = (size_t)blockIdx.x * KV + blockIdx.y;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, m_part[(row * n_split + s) * G + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t ps_row = (row * n_split + s) * G + g;
      const float w = expf(m_part[ps_row] - M);
      num += acc_part[ps_row * hd + i % hd] * w;
      den += l_part[ps_row] * w;
    }
    out[row * G * hd + i] = num / fmaxf(den, 1e-20f);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* pos, float* m_part, float* l_part, float* acc_part,
           float* out, int B, int KV, int G, int hd, int P, int ps, int nb,
           int window, int pps, int n_split, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * (hd + 1) +
                                       (size_t)ps * (hd + 1) + (size_t)ps * hd +
                                       (size_t)G * ps + (size_t)G * hd + 3 * G);
  auto kern = paged_attn_split_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, KV, n_split), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), bt, pos, m_part, l_part, acc_part, KV, G,
      hd, P, ps, nb, window, pps, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attn_combine_kernel<<<dim3(B, KV), kThreads, 0, stream>>>(
      m_part, l_part, acc_part, out, KV, G, hd, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int paged_attention_launch(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const int* block_tables, const int* pos, float* m_part, float* l_part,
    float* acc_part, float* out, int B, int KV, int G, int hd, int P, int ps,
    int nb, int window, int pps, int n_split, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED_ARGS                                                    \
  q, k, v, block_tables, pos, m_part, l_part, acc_part, out, B, KV, G, hd, \
      P, ps, nb, window, pps, n_split, scale, st
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(REPRO_PAGED_ARGS);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(REPRO_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(REPRO_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(REPRO_PAGED_ARGS);
#undef REPRO_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}
