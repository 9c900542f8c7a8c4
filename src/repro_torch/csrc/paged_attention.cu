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
// a byte on the main path. That is far below the tensor cores' ~295, but
// 80% of the f32 CUDA cores' ~20 (67 TFLOP/s over 3.35 TB/s): a kernel that
// keeps both products on the CUDA cores cannot reach the byte bound.
//
// The first design took 0.1983 ms at 2048-token contexts against a
// 0.0048 ms bound and SDPA's 0.0370 ms (NVIDIA H100 80GB HBM3, 700 W): each
// block walked ~15 pages in series, each page one round of 2-byte loads and
// four barriers, the softmax ran on 16 of 256 threads, and the score loop
// read two shared-memory operands for every f32 FMA.
//
// Design. The page axis is split over blocks (flash-decoding), grid
// (B, KV, n_split), at a fixed 4 or 8 pages a split (kernels/paged.py's
// split_plan). A split past the row's last valid key, or wholly before its
// window, exits at once, so the plan needs neither pos nor a host sync. A
// second kernel merges a row's live splits by the log-sum-exp rule in a
// fixed order (no float atomics), one block per (row, kv-head, query head).
// The bf16 path (G <= 16, hd 16, 32, 64 or 128) works warp by warp, as
// FlashAttention-2 does: warp w of a split's block takes its 16-key units
// w, w + 4, ... (a unit is one page of 16), each staged in shared memory
// with 16-byte cp.async copies into one of the warp's two slots, so the
// next unit's K and V rows (16 rows of 256 B at a stride of KV*hd) load
// while the warp computes this one; a unit whose pages hold no valid key
// is never loaded. With no barrier between warps, on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate):
//  1. S = Q K^T: the G query heads of one KV head are the 16-row A tile
//     (rows >= G zero, held in registers), the K rows, key-major in shared
//     memory, the .col B operand. Products of two bf16 values are exact in
//     f32: only the order of the sum differs from the plain version.
//  2. online softmax in registers: each lane holds two keys of two rows,
//     the row's max comes from its 4 lanes by shuffles; masked keys are
//     kept out of the max and the sum.
//  3. O = O * rescale + P V: the score accumulators are, as they stand,
//     the A fragments of P; P is split into three bf16 terms hi + mid + lo
//     (P - hi - mid - lo is below 2^-26 |P|), each multiplied by V
//     (ldmatrix.trans of the key-major V rows), so the product keeps f32
//     accuracy; one bf16 rounding of P (2^-9) would not meet the
//     tolerances. O stays in registers.
// The block's four warps then merge their (max, sum, O) in warp order
// through shared memory into the split's partial. Shared rows are padded by
// 16 bytes so that fragment loads and ldmatrix hit 32 distinct banks. The
// other dtypes (and a bf16 shape outside the MMA tile) take a CUDA-core
// kernel of the same split and merge, which walks the split's pages one
// after another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;     // CUDA-core split kernel
constexpr int kMmaThreads = 128;  // tensor-core split kernel: 4 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kPad = 8;           // bf16 padding of a shared row (16 bytes)
constexpr int kCombineThreads = 128;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool key_valid(int kp, int pos, int window) {
  return kp <= pos && (window <= 0 || kp > pos - window);
}

// Does split s (keys s*span .. s*span+span-1) hold a key that row position
// pos may attend to? The split kernels exit when it does not and write
// nothing; the merge reads only the splits for which it holds.
__device__ __forceinline__ bool split_live(int s, int span, int pos,
                                           int window) {
  const int first = s * span, last = first + span - 1;
  return pos >= 0 && first <= pos && (window <= 0 || last > pos - window);
}

// The split's page ids, -1 where a page is unallocated or holds no valid key
// (it is then skipped before it is loaded), others clamped to P - 1 as the
// reference's gather clamps them.
__device__ __forceinline__ void split_pages(int* page_s, const int* bt_row,
                                            int sp, int pps, int ps, int nb,
                                            int P, int pos, int window) {
  for (int j = threadIdx.x; j < pps; j += blockDim.x) {
    const int jj = sp * pps + j;
    int page = jj < nb ? bt_row[jj] : -1;
    const int first = jj * ps, last = first + ps - 1;
    if (first > pos || (window > 0 && last <= pos - window)) page = -1;
    page_s[j] = page < 0 ? -1 : min(page, P - 1);
  }
}

// ------------------------- tensor-core split kernel ----------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi + mid + lo == x to within 2^-26 |x|: three bf16 terms of an f32.
__device__ __forceinline__ void split3(float x, float* t) {
  t[0] = __bfloat162float(__float2bfloat16_rn(x));
  const float r1 = x - t[0];
  t[1] = __bfloat162float(__float2bfloat16_rn(r1));
  t[2] = r1 - t[1];  // rounded to bf16 when packed
}

// Shared memory of the tensor-core kernel: each warp's two 16-key slots of
// K and V, which the block's merge of its warps reuses.
template <int HD>
struct MmaSmem {
  static constexpr int kLd = HD + kPad;  // bf16 row stride of a K/V slot
  static constexpr int kSlot = 16 * kLd;  // bf16 elements of one K or V slot
  static constexpr size_t kKv = sizeof(bf16) * (size_t)kMmaWarps * 2 * 2 *
                                kSlot;
  static constexpr size_t kMerge =
      sizeof(float) * (size_t)kMmaWarps * (2 * 16 + 16 * HD);
  static constexpr size_t kFixed = kKv > kMerge ? kKv : kMerge;
  static size_t bytes(int pps) { return kFixed + sizeof(int) * pps; }
};

// One block per (row, kv-head, split); warp w takes the split's 16-key
// units w, w + 4, ... (units whose pages are all skipped are not loaded),
// each through two shared-memory slots: the copies of the next unit are in
// flight while the warp computes this one.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) paged_attn_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ pos, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int KV, int G,
    int P, int ps, int nb, int window, int pps, int n_split, float scale) {
  using L = MmaSmem<HD>;
  constexpr int NT = HD / 8;   // 8-column tiles of O
  constexpr int KS = HD / 16;  // 16-deep steps of Q K^T
  constexpr int CPR = HD / 8;  // 16-byte chunks of a K/V row
  const int b = blockIdx.x, kv = blockIdx.y, sp = blockIdx.z;
  const int span = pps * ps;
  const int row_pos = pos[b];
  if (!split_live(sp, span, row_pos, window)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = 2 * (lane % 4);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* slots = reinterpret_cast<bf16*>(smem_raw) + warp * 4 * L::kSlot;
  int* page_s = reinterpret_cast<int*>(smem_raw + L::kFixed);  // pps

  split_pages(page_s, block_tables + (size_t)b * nb, sp, pps, ps, nb, P,
              row_pos, window);
  // Q as the A fragments of the 16-row tile (rows >= G zero), from memory
  uint32_t qa[KS][4];
  const bf16* qb = q + (size_t)(b * KV + kv) * G * HD;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = ks * 16 + c;
    qa[ks][0] = g < G ? ld32(qb + g * HD + col) : 0u;
    qa[ks][1] = g + 8 < G ? ld32(qb + (g + 8) * HD + col) : 0u;
    qa[ks][2] = g < G ? ld32(qb + g * HD + col + 8) : 0u;
    qa[ks][3] = g + 8 < G ? ld32(qb + (g + 8) * HD + col + 8) : 0u;
  }
  __syncthreads();

  const int n_units = (span + 15) / 16;
  // the page of key kk of the split, -1 if skipped or past the split
  auto page_of = [&](int kk) { return kk < span ? page_s[kk / ps] : -1; };
  // the first unit at or after u (stepping by the warps) with a page to read
  auto next_unit = [&](int u) {
    for (; u < n_units; u += kMmaWarps)
      if (__any_sync(0xffffffffu, lane < 16 && page_of(u * 16 + lane) >= 0))
        return u;
    return n_units;
  };
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto issue = [&](int u, int slot) {
    bf16* k_s = slots + slot * 2 * L::kSlot;
    bf16* v_s = k_s + L::kSlot;
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int key = i / CPR, ch = (i % CPR) * 8;
      const int kk = u * 16 + key;
      const int page = page_of(kk);
      bf16* kd = k_s + key * L::kLd + ch;
      bf16* vd = v_s + key * L::kLd + ch;
      if (page >= 0) {
        const size_t off = ((size_t)(page * ps + kk % ps) * KV + kv) * HD + ch;
        cp_async16(kd, k_pool + off);
        cp_async16(vd, v_pool + off);
      } else {  // P is 0 there; V must hold no NaN pattern
        *reinterpret_cast<uint4*>(kd) = zero;
        *reinterpret_cast<uint4*>(vd) = zero;
      }
    }
  };

  // running state of query rows g and g + 8: max, this lane's share of the
  // sum-exp, and O's tiles
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int u = next_unit(warp), slot = 0;
  if (u < n_units) issue(u, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  while (u < n_units) {
    const int un = next_unit(u + kMmaWarps);
    if (un < n_units) issue(un, slot ^ 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    const bf16* k_s = slots + slot * 2 * L::kSlot;
    const bf16* v_s = k_s + L::kSlot;

    // 1. S = Q K^T * scale for 16 keys: two 8-key tiles
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const bf16* kr = k_s + (nt * 8 + g) * L::kLd + c;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(sc[nt], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }
    // 2. online softmax: lane holds keys c, c+1 of each tile for rows g and
    // g + 8; the 4 lanes of a row group share its max by shuffles
    const int kp0 = (sp * pps) * ps + u * 16;  // position of the unit's key 0
    bool ok[2][2];
    float cur0 = kNegInf, cur1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = u * 16 + nt * 8 + c + e;
        ok[nt][e] = page_of(kk) >= 0 && key_valid(kp0 + nt * 8 + c + e,
                                                  row_pos, window);
        sc[nt][e] *= scale;
        sc[nt][2 + e] *= scale;
        if (ok[nt][e]) {
          cur0 = fmaxf(cur0, sc[nt][e]);
          cur1 = fmaxf(cur1, sc[nt][2 + e]);
        }
      }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      cur0 = fmaxf(cur0, __shfl_xor_sync(0xffffffffu, cur0, off));
      cur1 = fmaxf(cur1, __shfl_xor_sync(0xffffffffu, cur1, off));
    }
    const float mn0 = fmaxf(m0, cur0), mn1 = fmaxf(m1, cur1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float pr[2][4];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[nt][e] = ok[nt][e] ? expf(sc[nt][e] - mn0) : 0.f;
        pr[nt][2 + e] = ok[nt][e] ? expf(sc[nt][2 + e] - mn1) : 0.f;
        s0 += pr[nt][e];
        s1 += pr[nt][2 + e];
      }
    l0 = l0 * corr0 + s0;
    l1 = l1 * corr1 + s1;
    // P (16 x 16 keys) as three bf16 A fragments: the two score tiles are
    // the A tile's column halves, in the accumulator's own layout
    uint32_t pa[3][4];
    {
      float t[4][2][3];  // (a register, element, term)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        split3(pr[0][e], t[0][e]);
        split3(pr[0][2 + e], t[1][e]);
        split3(pr[1][e], t[2][e]);
        split3(pr[1][2 + e], t[3][e]);
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          pa[term][a] = pack_bf16(t[a][0][term], t[a][1][term]);
    }
    // 3. O = O * corr + (hi + mid + lo) V, two tiles of O a ldmatrix
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t v0, v1, v2, v3;
      const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
          v_s + (lane & 15) * L::kLd + (j + lane / 16) * 8));
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
          : "r"(addr));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* oj = o[j + h];
        oj[0] *= corr0;
        oj[1] *= corr0;
        oj[2] *= corr1;
        oj[3] *= corr1;
      }
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        mma_bf16(o[j], pa[term], v0, v1);
        mma_bf16(o[j + 1], pa[term], v2, v3);
      }
    }
    __syncwarp();  // this slot is refilled two units on
    u = un;
    slot ^= 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // merge the warps' states (warp order, log-sum-exp) into the split's
  __syncthreads();  // every warp is done with the K/V slots
  float* ws = reinterpret_cast<float*>(smem_raw);  // warp x (m 16, l 16, O)
  float* mine = ws + warp * (32 + 16 * HD);
  if (lane % 4 == 0) {
    mine[g] = m0;
    mine[g + 8] = m1;
    mine[16 + g] = l0;
    mine[16 + g + 8] = l1;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* oc = mine + 32 + j * 8 + c;
    oc[g * HD] = o[j][0];
    oc[g * HD + 1] = o[j][1];
    oc[(g + 8) * HD] = o[j][2];
    oc[(g + 8) * HD + 1] = o[j][3];
  }
  __syncthreads();
  const size_t prow = ((size_t)(b * KV + kv) * n_split + sp) * G;
  for (int i = tid; i < G * HD; i += kMmaThreads) {
    const int r = i / HD, d = i % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      M = fmaxf(M, ws[w * (32 + 16 * HD) + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float* st = ws + w * (32 + 16 * HD);
      const float wt = expf(st[r] - M);
      num += st[32 + r * HD + d] * wt;
      den += st[16 + r] * wt;
    }
    acc_part[(prow + r) * HD + d] = num;
    if (d == 0) {
      m_part[prow + r] = M;
      l_part[prow + r] = den;
    }
  }
}

// -------------------------- CUDA-core split kernel -----------------------
// f32 operands, or a bf16 shape outside the MMA tile: the split's pages one
// after another, K/V rows staged as f32 with a padded stride, the running
// max m, sum-exp l and weighted values acc carried in shared memory.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attn_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ pos, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int KV, int G,
    int hd, int P, int ps, int nb, int window, int pps, int n_split,
    float scale) {
  const int b = blockIdx.x, kv = blockIdx.y, sp = blockIdx.z;
  const int row_pos = pos[b];
  if (!split_live(sp, pps * ps, row_pos, window)) return;
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
  int* page_s = reinterpret_cast<int*>(c_s + G);  // pps

  split_pages(page_s, block_tables + (size_t)b * nb, sp, pps, ps, nb, P,
              row_pos, window);
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

  for (int j = 0; j < pps; ++j) {
    const int page = page_s[j];
    if (page < 0) continue;  // uniform over the block
    const int first = (sp * pps + j) * ps;
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

// Merge the live splits of one (row, kv-head, query head) in ascending
// order: out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-20).
// The live splits (split_live) are the run s_lo..s_hi: s_hi holds pos, s_lo
// the window's first key. A live split with no valid key (only unallocated
// pages) holds m = -1e30, l = 0, acc = 0 and adds nothing; a row with no
// valid key at all gives 0 / 1e-20 = 0.
__global__ void __launch_bounds__(kCombineThreads) paged_attn_combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, const int* __restrict__ pos,
    float* __restrict__ out, int KV, int G, int hd, int span, int window,
    int n_split) {
  const int row = blockIdx.x, g = blockIdx.y;  // row = b * KV + kv
  const int row_pos = pos[row / KV];
  const int s_lo = window > 0 ? max(0, row_pos - window + 1) / span : 0;
  const int s_hi = row_pos < 0 ? -1 : min(n_split - 1, row_pos / span);
  const size_t base = (size_t)row * n_split * G + g;  // split s at + s * G
  float M = kNegInf;
#pragma unroll 4
  for (int s = s_lo; s <= s_hi; ++s)
    M = fmaxf(M, m_part[base + (size_t)s * G]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float num = 0.f, den = 0.f;
#pragma unroll 4
    for (int s = s_lo; s <= s_hi; ++s) {
      const size_t i = base + (size_t)s * G;
      const float w = expf(m_part[i] - M);
      num += acc_part[i * hd + d] * w;
      den += l_part[i] * w;
    }
    out[((size_t)row * G + g) * hd + d] = num / fmaxf(den, 1e-20f);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* bt, const int* pos, float* m_part,
                       float* l_part, float* acc_part, int B, int KV, int G,
                       int P, int ps, int nb, int window, int pps, int n_split,
                       float scale, cudaStream_t stream) {
  const size_t smem = MmaSmem<HD>::bytes(pps);
  auto kern = paged_attn_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(B, KV, n_split), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bt, pos, m_part, l_part, acc_part, KV, G,
      P, ps, nb, window, pps, n_split, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* bt, const int* pos, float* m_part,
                         float* l_part, float* acc_part, int B, int KV, int G,
                         int hd, int P, int ps, int nb, int window, int pps,
                         int n_split, float scale, cudaStream_t stream) {
  // the tensor-core kernel, where its tile and its 16-byte copies fit
  if (sizeof(TQ) == 2 && sizeof(TKV) == 2 && G <= 16 && aligned16(k) &&
      aligned16(v) && (reinterpret_cast<uintptr_t>(q) & 3u) == 0) {
#define REPRO_MMA(HD)                                                       \
  if (hd == HD)                                                             \
    return launch_mma<HD>(q, k, v, bt, pos, m_part, l_part, acc_part, B, KV, \
                          G, P, ps, nb, window, pps, n_split, scale, stream);
    REPRO_MMA(16)
    REPRO_MMA(32)
    REPRO_MMA(64)
    REPRO_MMA(128)
#undef REPRO_MMA
  }
  const dim3 grid(B, KV, n_split);
  const size_t smem = sizeof(float) * ((size_t)G * (hd + 1) +
                                       (size_t)ps * (hd + 1) + (size_t)ps * hd +
                                       (size_t)G * ps + (size_t)G * hd + 3 * G) +
                      sizeof(int) * (size_t)pps;
  auto kern = paged_attn_split_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), bt, pos, m_part, l_part, acc_part, KV, G,
      hd, P, ps, nb, window, pps, n_split, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* pos, float* m_part, float* l_part, float* acc_part,
           float* out, int B, int KV, int G, int hd, int P, int ps, int nb,
           int window, int pps, int n_split, float scale,
           cudaStream_t stream) {
  cudaError_t err =
      launch_split<TQ, TKV>(q, k, v, bt, pos, m_part, l_part, acc_part, B, KV,
                            G, hd, P, ps, nb, window, pps, n_split, scale,
                            stream);
  if (err != cudaSuccess) return (int)err;
  paged_attn_combine_kernel<<<dim3(B * KV, G), kCombineThreads, 0, stream>>>(
      m_part, l_part, acc_part, pos, out, KV, G, hd, pps * ps, window,
      n_split);
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
    return launch<float, bf16>(REPRO_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<bf16, float>(REPRO_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<bf16, bf16>(REPRO_PAGED_ARGS);
#undef REPRO_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}
