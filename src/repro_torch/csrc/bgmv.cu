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
//   | ranks (N,) int32 or null -> out (T, d_out) f32
//
// What bounds it: bytes, and at decode the launch. An active row reads its
// adapter's (d_in x r) A and (r x d_out) B and does 2 operations per factor
// element: at most one operation a byte in bf16, far below the ~295 where
// the tensor cores would be the limit. At decode T <= 8 rows over 4
// adapters read ~3 MB of unique factors for q or o, ~1 us at 3.35 TB/s.
//
// The first design, two launches a call (a (T, S) split shrink, then a (T,
// d_out tile) expand), took 0.0607 ms for q + k + v + o at T = 8 (bound
// 0.0028) on an NVIDIA H100 80GB HBM3 at 700 W: ~7.6 us a launch against
// ~0.7 us of bytes a call. It needed r / VEC to divide its 256 threads.
//
// Design: one launch a call below kPairRows rows, the decode case.
// A cluster of kc blocks per row (Hopper's thread block clusters). A block
// streams only ~16-20 GB/s with its loads in flight, so a row's A and B
// have to spread over many SMs: kc is the power of two (at most 16; 8
// where a 16-block cluster does not fit) that puts about one block on
// each SM for T rows. The row's partial sums meet in distributed shared
// memory: no scratch in device memory, no wait on a counter.
//  0. each block arrives at the cluster barrier (relaxed) and each warp
//     issues the B loads of its first rank rows for each of the block's
//     first kMaxT tiles: they do not depend on h, so they fly during the
//     shrink (at decode they are all the B the block reads).
//  1. block q of the row's cluster contracts its split of d_in, rows
//     [q * chunk, (q + 1) * chunk): thread (dl, g) owns group g of VEC rank
//     columns (any r: when VEC does not divide r, A is read one value at a
//     time) and walks the split's rows dl, dl + dlanes, ..., kLoads loads of
//     A and x in flight; the threads' sums of a column are added in thread
//     order into the block's own partial h.
//  2. the block waits at the barrier of step 0 (every block of the cluster
//     has started, so its shared memory may be written), stores its partial
//     into slot q of every cluster block's shared memory, and meets the
//     cluster at a second barrier; each block adds the kc partials in slot
//     order and masks h.
//  3. block q expands the d_out tiles q, q + kc, ... of 32 * VEC columns,
//     kMaxT at a time: warp w takes the rank rows c = w, w + 8, ..., kPerT
//     rows of each tile a batch, and the warps' sums are added in warp
//     order.
// From kPairRows rows on (the LoRA-kernel path's 1024 rows) the rows fill
// the card and the launch no longer counts: two launches, every row's A
// read while the rows run together, then every row's B, so rows of a
// popular adapter meet in L2. The shrink gives a block to each row over
// all of d_in and writes h to scratch; the expand gives a block to each
// (row, d_out tile), one load in flight a thread. At T = 1024 (Fig. 19's
// rows) this pair beat one launch (a block a ticket, the expand items
// waiting on the shrink's flags), per-row clusters, and two or four loads
// in flight a thread on an H100 (PERF.md gives the times).
// No float atomic is used and every sum runs in a fixed order, so two runs
// give the same bits. A row with ids < 0 reads nothing and writes zeros;
// adapter ids past N - 1 are clamped, as the reference's gather clamps them.
// Ranked form: a column group at or past the row's rank reads no A, the
// expand masks h at c >= rank and reads only B's first rank rows. Every sum
// keeps the padded form's order, so on a pool whose columns past each
// adapter's rank are zero (the prefix-zero contract) ranked and padded give
// the same values bit for bit.

#include <cooperative_groups.h>

#include "vec.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::to_f32;
using repro::Vec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // blocks a row at most (a non-portable size)
constexpr int kPairRows = 128;   // from T rows on: the shrink/expand pair
constexpr int kMaxDevices = 64;  // devices whose launch plans are kept

constexpr int kLoads = 8;       // A loads a decode shrink thread issues at once
constexpr int kPairLoads = 1;   // A loads a pair shrink thread issues at once
constexpr int kMaxT = 4;        // d_out tiles a decode block expands at once
constexpr int kPerT = 4;        // B rows of each tile a lane loads at once

// The split barrier of step 0 and 2: arrive without ordering memory, wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// acc += x[d] * A[d, c0 : c0 + VEC] over the rows d = d0, d0 + dlanes, ...
// < d_end (ap: A at column c0), LOADS loads in flight; nv < VEC columns
// are read one at a time (full: 16 bytes).
template <int LOADS, typename TX, typename TW>
__device__ __forceinline__ void shrink_group(const TX* __restrict__ xr,
                                             const TW* __restrict__ ap,
                                             int r, int nv, bool full,
                                             int d0, int d_end, int dlanes,
                                             float* acc) {
  constexpr int VEC = Vec<TW>::N;
  for (int d = d0; d < d_end; d += LOADS * dlanes) {
    uint4 av[LOADS];
    float xv[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
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
    for (int u = 0; u < LOADS; ++u) {
      float wv[VEC];
      Vec<TW>::widen(av[u], wv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(xv[u], wv[k], acc[k]);
    }
  }
}

// h[c] over rows [d0, d_end) of A (ab: the adapter's A) for row xr: thread
// (dl, g) owns column group g and the rows d0 + dl, d0 + dl + dlanes, ...;
// the dlanes sums of a column are added in thread order; store(c, h)
// receives each column once (red: kThreads * VEC floats of scratch).
template <int LOADS, typename TX, typename TW, typename Store>
__device__ __forceinline__ void shrink_rows(const TX* __restrict__ xr,
                                            const TW* __restrict__ ab,
                                            int r, int rank, int d0,
                                            int d_end, float* red,
                                            Store store) {
  constexpr int VEC = Vec<TW>::N;
  const int tid = threadIdx.x;
  const int groups = (r + VEC - 1) / VEC;
  const bool full = r % VEC == 0;
  // thread (dl, g): with kThreads groups or more, one thread a group
  const int dlanes = groups >= kThreads ? 1 : kThreads / groups;
  const int dl = groups >= kThreads ? 0 : tid / groups;
  for (int g0 = 0; g0 < groups; g0 += kThreads) {
    const int g = groups >= kThreads ? g0 + tid : tid % groups;
    const int c0 = g * VEC, nv = min(VEC, r - c0);
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    if (g < groups && dl < dlanes && c0 < rank)
      shrink_group<LOADS>(xr, ab + c0, r, nv, full, d0 + dl, d_end, dlanes,
                          acc);
    if (dlanes == 1) {  // one thread a group: its sums are h
      if (g < groups)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (k < nv) store(c0 + k, acc[k]);
      continue;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[tid * VEC + k] = acc[k];
    __syncthreads();
    for (int c = tid; c < r; c += kThreads) {
      const int gg = c / VEC, k = c % VEC;
      float h = 0.f;
      for (int j = 0; j < dlanes; ++j) h += red[(j * groups + gg) * VEC + k];
      store(c, h);
    }
    __syncthreads();  // red is free again
  }
}

// kFull: d_out is a whole number of B's 16-byte vectors (every serving
// shape), so B is read and out written in vectors; else one value at a
// time. The launch picks the instantiation.
template <typename TX, typename TW, bool kFull>
__global__ void __launch_bounds__(kThreads)
    bgmv_cluster_kernel(const TX* __restrict__ x, const TW* __restrict__ A,
                const TW* __restrict__ Bm, const int* __restrict__ ids,
                const int* __restrict__ ranks, float* __restrict__ out, int N,
                int d_in, int r, int d_out) {
  constexpr int VEC = Vec<TW>::N;
  constexpr int kTile = 32 * VEC;
  __shared__ __align__(16) float red[kMaxT * kWarps * kTile];
  extern __shared__ float smem[];
  float* parts = smem;                 // kc x r: the cluster's partials
  float* h_s = smem + kMaxCluster * r;  // r
  cg::cluster_group cluster = cg::this_cluster();
  const int kc = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int t = blockIdx.x / kc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = (d_out + kTile - 1) / kTile;
  int slot = ids[t];
  if (slot < 0) {  // the whole cluster leaves here, before the barriers
    for (int j = q; j < tiles; j += kc) {
      float* o = out + (size_t)t * d_out + j * kTile;
      for (int i = tid; i < min(kTile, d_out - j * kTile); i += kThreads)
        o[i] = 0.f;
    }
    return;
  }
  slot = min(slot, N - 1);
  const int rank = ranks ? min(max(ranks[slot], 0), r) : r;
  cluster_arrive_relaxed();  // 0. this block has started

  // 0. B rows c = warp + (ub + u) * kWarps of the tiles tg + i * kc
  const TW* bb = Bm + (size_t)slot * r * d_out + lane * VEC;
  uint4 bv[kMaxT][kPerT];
  auto load_b = [&](int tg, int ub) {
#pragma unroll
    for (int i = 0; i < kMaxT; ++i) {
      const int tile0 = (tg + i * kc) * kTile;
      const bool on = tg + i * kc < tiles && lane * VEC < d_out - tile0;
#pragma unroll
      for (int u = 0; u < kPerT; ++u) {
        const int c = warp + (ub + u) * kWarps;
        bv[i][u] = make_uint4(0u, 0u, 0u, 0u);  // the bits of +0.0
        if (on && c < rank)
          bv[i][u] = repro::raw_at(bb + (size_t)c * d_out + tile0,
                                   d_out - tile0 - lane * VEC, kFull);
      }
    }
  };
  load_b(q, 0);

  // 1. this block's split of d_in: its partial h, in h_s
  const int chunk = (d_in + kc - 1) / kc;
  const int d0 = min(d_in, q * chunk);
  shrink_rows<kLoads>(x + (size_t)t * d_in, A + (size_t)slot * d_in * r, r,
                      rank, d0, min(d_in, d0 + chunk), red,
                      [&](int c, float h) { h_s[c] = h; });
  __syncthreads();

  // 2. once every cluster block has started, the partial goes to slot q of
  // each; h = the cluster's partials added in slot order, masked
  cluster_wait();
  for (int c = tid; c < r; c += kThreads)
    for (int p = 0; p < kc; ++p)
      cluster.map_shared_rank(parts, p)[q * r + c] = h_s[c];
  cluster.sync();
  for (int c = tid; c < r; c += kThreads) {
    float h = 0.f;
    for (int p = 0; p < kc; ++p) h += parts[p * r + c];
    h_s[c] = c < rank ? h : 0.f;
  }
  __syncthreads();

  // 3. this block's tiles of d_out, kMaxT at a time
  const int nrow = rank > warp ? (rank - warp + kWarps - 1) / kWarps : 0;
  for (int tg = q; tg < tiles; tg += kc * kMaxT) {
    float y[kMaxT][VEC];
#pragma unroll
    for (int i = 0; i < kMaxT; ++i)
#pragma unroll
      for (int k = 0; k < VEC; ++k) y[i][k] = 0.f;
    for (int ub = 0; ub < nrow; ub += kPerT) {
      if (tg != q || ub != 0) load_b(tg, ub);  // the first batch is loaded
#pragma unroll
      for (int u = 0; u < kPerT; ++u) {
        const int c = warp + (ub + u) * kWarps;
        if (c < rank) {
          const float hv = h_s[c];
#pragma unroll
          for (int i = 0; i < kMaxT; ++i) {
            float wv[VEC];
            Vec<TW>::widen(bv[i][u], wv);
#pragma unroll
            for (int k = 0; k < VEC; ++k) y[i][k] = fmaf(hv, wv[k], y[i][k]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxT; ++i)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        red[(i * kWarps + warp) * kTile + lane * VEC + k] = y[i][k];
    __syncthreads();
    for (int idx = tid; idx < kMaxT * kTile / 4; idx += kThreads) {
      const int i = idx / (kTile / 4), c4 = (idx % (kTile / 4)) * 4;
      const int tile0 = (tg + i * kc) * kTile;
      if (tg + i * kc >= tiles || c4 >= d_out - tile0) continue;
      const float* rd = red + i * kWarps * kTile + c4;
      float4 v = *reinterpret_cast<const float4*>(rd);
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 u = *reinterpret_cast<const float4*>(rd + w * kTile);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      repro::store4(out + (size_t)t * d_out + tile0 + c4, v,
                    d_out - tile0 - c4, kFull);
    }
    __syncthreads();  // red is reused by the next tiles
  }
}

// The pair's shrink: block t contracts row t over all of d_in into h_g[t].
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) bgmv_shrink_kernel(
    const TX* __restrict__ x, const TW* __restrict__ A,
    const int* __restrict__ ids, const int* __restrict__ ranks,
    float* __restrict__ h_g, int N, int d_in, int r) {
  __shared__ __align__(16) float red[kThreads * Vec<TW>::N];
  const int t = blockIdx.x;
  const int slot = min(ids[t], N - 1);
  if (slot < 0) return;  // the expand writes this row's zeros
  const int rank = ranks ? min(max(ranks[slot], 0), r) : r;
  shrink_rows<kPairLoads>(x + (size_t)t * d_in, A + (size_t)slot * d_in * r,
                          r, rank, 0, d_in, red,
                          [&](int c, float h) { h_g[(size_t)t * r + c] = h; });
}

// The pair's expand: block (t, j) writes d_out tile j of row t; warp w
// takes the rank rows c = w, w + 8, ..., one load in flight a lane.
template <typename TW, bool kFull>
__global__ void __launch_bounds__(kThreads) bgmv_expand_kernel(
    const TW* __restrict__ Bm, const int* __restrict__ ids,
    const int* __restrict__ ranks, const float* __restrict__ h_g,
    float* __restrict__ out, int N, int r, int d_out) {
  constexpr int VEC = Vec<TW>::N;
  constexpr int kTile = 32 * VEC;
  __shared__ __align__(16) float red[kWarps * kTile];
  extern __shared__ float h_s[];  // r
  const int t = blockIdx.x, tile0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int width = min(kTile, d_out - tile0);
  float* o = out + (size_t)t * d_out + tile0;
  const int slot = min(ids[t], N - 1);
  if (slot < 0) {
    for (int i = tid; i < width; i += kThreads) o[i] = 0.f;
    return;
  }
  const int rank = ranks ? min(max(ranks[slot], 0), r) : r;
  for (int c = tid; c < r; c += kThreads)
    h_s[c] = c < rank ? h_g[(size_t)t * r + c] : 0.f;
  __syncthreads();
  const bool on = lane * VEC < width;
  const TW* b = Bm + (size_t)slot * r * d_out + tile0 + lane * VEC;
  float y[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) y[k] = 0.f;
  if (on)
    for (int c = warp; c < rank; c += kWarps) {
      float wv[VEC];
      Vec<TW>::widen(
          repro::raw_at(b + (size_t)c * d_out, width - lane * VEC, kFull), wv);
      const float hv = h_s[c];
#pragma unroll
      for (int k = 0; k < VEC; ++k) y[k] = fmaf(hv, wv[k], y[k]);
    }
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[warp * kTile + lane * VEC + k] = y[k];
  __syncthreads();
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
}

// The SM count of device dev, asked once.
cudaError_t sm_count(int dev, int* n_sm) {
  static int cache[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &cache[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *n_sm = cache[dev];
  return cudaSuccess;
}

// Lets kern take smem bytes of dynamic shared memory: only past the 48 KiB
// every kernel may take is an attribute to be set.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t cluster_smem(int r) {
  return sizeof(float) * (kMaxCluster + 1) * (size_t)r;
}

// kc for T rows of rank r on n_sm SMs of the current device: the power of
// two at most kMaxCluster that puts about one block on each SM, 8 where a
// 16-block cluster does not fit. The fit is asked once a device and rank.
template <typename TX, typename TW, bool kFull>
cudaError_t cluster_size(int T, int r, int n_sm, int* kc_out) {
  int kc = 1;
  while (kc < kMaxCluster && 2 * kc * T <= n_sm) kc *= 2;
  *kc_out = kc;
  if (kc <= 8) return cudaSuccess;
  struct Fit {
    int r = -1, fits = 0;
  };
  static Fit cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev].r != r) {
    auto kern = bgmv_cluster_kernel<TX, TW, kFull>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) err = allow_smem(kern, cluster_smem(r));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kMaxCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kMaxCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = cluster_smem(r);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    cache[dev].fits = err == cudaSuccess && clusters >= 1;
    cache[dev].r = r;
    cudaGetLastError();  // a size that does not fit is no launch error
  }
  if (!cache[dev].fits) *kc_out = 8;
  return cudaSuccess;
}

template <typename TX, typename TW, bool kFull>
cudaError_t launch_cluster(const void* x, const void* A, const void* B,
                           const int* ids, const int* ranks, float* out,
                           int T, int N, int d_in, int r, int d_out,
                           cudaStream_t stream) {
  int dev = 0, n_sm = 0, kc = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &n_sm);
  if (err == cudaSuccess) err = cluster_size<TX, TW, kFull>(T, r, n_sm, &kc);
  if (err != cudaSuccess) return err;
  const size_t smem = cluster_smem(r);
  auto kern = bgmv_cluster_kernel<TX, TW, kFull>;
  err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T * kc);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const TX*>(x),
                           static_cast<const TW*>(A),
                           static_cast<const TW*>(B), ids, ranks, out, N,
                           d_in, r, d_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TX, typename TW, bool kFull>
int launch(const void* x, const void* A, const void* B, const int* ids,
           const int* ranks, float* h_g, float* out, int T, int N, int d_in,
           int r, int d_out, cudaStream_t stream) {
  if (T < kPairRows)
    return (int)launch_cluster<TX, TW, kFull>(x, A, B, ids, ranks, out, T, N,
                                              d_in, r, d_out, stream);
  constexpr int kTile = 32 * Vec<TW>::N;
  bgmv_shrink_kernel<TX, TW><<<T, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(A), ids, ranks, h_g,
      N, d_in, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)r;
  auto kern = bgmv_expand_kernel<TW, kFull>;
  err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(T, (d_out + kTile - 1) / kTile), kThreads, smem, stream>>>(
      static_cast<const TW*>(B), ids, ranks, h_g, out, N, r, d_out);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_any(const void* x, const void* A, const void* B, const int* ids,
               const int* ranks, float* h_g, float* out, int T, int N,
               int d_in, int r, int d_out, cudaStream_t stream) {
  if (d_out % Vec<TW>::N == 0)
    return launch<TX, TW, true>(x, A, B, ids, ranks, h_g, out, T, N, d_in, r,
                                d_out, stream);
  return launch<TX, TW, false>(x, A, B, ids, ranks, h_g, out, T, N, d_in, r,
                               d_out, stream);
}

}  // namespace

// Rows from which bgmv_launch takes the shrink/expand pair, which needs
// scratch.
extern "C" int bgmv_pair_rows() { return kPairRows; }

// The cluster size bgmv_launch gives T < bgmv_pair_rows() rows of rank r
// on n_sm SMs of the current device (dtype codes as below), or minus a
// cudaError_t.
extern "C" int bgmv_cluster_size(int x_dtype, int w_dtype, int T, int r,
                                 int n_sm) {
  int kc = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0)
    err = cluster_size<float, float, true>(T, r, n_sm, &kc);
  if (x_dtype == 0 && w_dtype == 1)
    err = cluster_size<float, __nv_bfloat16, true>(T, r, n_sm, &kc);
  if (x_dtype == 1 && w_dtype == 0)
    err = cluster_size<__nv_bfloat16, float, true>(T, r, n_sm, &kc);
  if (x_dtype == 1 && w_dtype == 1)
    err = cluster_size<__nv_bfloat16, __nv_bfloat16, true>(T, r, n_sm, &kc);
  return err == cudaSuccess ? kc : -(int)err;
}

// dtype codes: 0 = float32, 1 = bfloat16; ranks is null (padded) or N
// per-adapter true ranks (ranked); any r and d_out. From bgmv_pair_rows()
// rows on, h_g holds T * r floats of scratch; below, it may be null.
// Returns a cudaError_t (0 = ok).
extern "C" int bgmv_launch(int x_dtype, int w_dtype, const void* x,
                           const void* A, const void* B, const int* ids,
                           const int* ranks, float* h_g, float* out, int T,
                           int N, int d_in, int r, int d_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BGMV_ARGS \
  x, A, B, ids, ranks, h_g, out, T, N, d_in, r, d_out, st
  if (x_dtype == 0 && w_dtype == 0)
    return launch_any<float, float>(REPRO_BGMV_ARGS);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_any<float, __nv_bfloat16>(REPRO_BGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_any<__nv_bfloat16, float>(REPRO_BGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_any<__nv_bfloat16, __nv_bfloat16>(REPRO_BGMV_ARGS);
#undef REPRO_BGMV_ARGS
  return (int)cudaErrorInvalidValue;
}
