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
//   | slot, eid, rank (S,) int32 | index (n,) int32 or null
//   -> out (S, cap, d_out) f32; part: the wrapper's f32 scratch
//
// The kernel takes the segments index[0..n) (all S in order when index is
// null) and the first r <= r_pool rank columns of the pool: a rank bucket
// of ops.sgmv_rank_grouped is a list of segment indices in any order, and
// reads its columns in place with the pool's row stride. Any r, d_in and
// d_out: a 16-byte piece that is not aligned or not whole is read one
// value at a time.
//
// What bounds it: bytes. A segment's rows share one factor slice, so the
// factors are read once per segment (the point of SGMV), and the layout
// writes every one of its S * cap * d_out f32 outputs: at the LoRA-kernel
// path's Fig. 19 shapes that output (537 MB) is the largest term, 332 MB of
// it the zeros of inactive segments. A segment's x is read whole (a padding
// row is all zero, which only a read can tell).
//
// The port's first design gave each 8-row window of a segment a block on
// the CUDA cores: 0.4616 ms for sgmv at Fig. 19 (bound 0.2233 ms) on an
// NVIDIA H100 80GB HBM3 at 700 W. Every window re-read its segment's
// factors, and each phase of a block (row scan, shrink, a reduction through
// shared memory, expand) ran after the last with few loads in flight.
//
// Design: one launch of a persistent grid, sgmv_kernel, whose blocks walk
// two lists of items in turn (PERF.md gives the times of the designs tried
// on the way: clusters that exchange h through distributed shared memory,
// two kernels, expand items between shrink items, deeper rings).
//  1. The shrink items (segment, row group of at most 64 rows, split of
//     d_in into at most SPLIT_ROWS rows: kernels/sgmv.py's split_plan). An
//     inactive segment's item stores its share of the zeros as bulk copies
//     on the TMA (cp.async.bulk from a zeroed shared buffer), which keeps
//     the threads free. An active item streams its x rows and A's rows of
//     the split, one 64-row k tile a stage, through a ring of kStages
//     shared-memory stages that runs on across items: bf16 tiles come by
//     3-D tensor maps (cp.async.bulk.tensor with the 128-byte swizzle, one
//     mbarrier a stage; rows past cap and k past d_in read as zeros), the
//     rest (f32, unaligned shapes, A's columns of a low rank) as 16-byte
//     cp.async pieces. 16-byte cp.async alone streamed ~2.3 TB/s however
//     deep the ring. bf16 x and factors multiply on the tensor cores
//     (mma.sync m16n8k16, the group's rows as the A operand, A's tile as
//     the B operand through ldmatrix.trans, as gmm.cu), each 64-deep stage
//     summed from zero and added to an f32 total in round-to-nearest; other
//     operand types use f32 FMA on the CUDA cores. The item's partial h
//     (rows x r f32) goes to part, with a 64-bit mask of its rows that hold
//     a nonzero, and then adds one to its row group's completion count. A
//     row group of one 16 x 64 unit a warp (16 rows, r <= 64: the server
//     hook) builds with fewer registers, so more blocks fit.
//  2. The expand items (segment, 16-row slice, run of kThreads column
//     vectors of B). An item of an active segment first waits until its
//     row group's count reaches the splits: every block runs at once (the
//     grid is what the SMs hold) and a shrink item never waits, so the
//     counts always arrive; a block that is done shrinking expands while
//     others still shrink, and no launch boundary lies between the two.
//     A slice whose rows' partials are all zero (the masks) stores +0, the
//     value its products give, as bulk copies and reads nothing else.
//     Otherwise h = the splits' partials added in split order, masked at
//     c < rank; its all-zero rows store +0 in bulk, and each thread
//     expands one 16-byte column vector of B for the other rows, kRows at
//     a time on the CUDA cores, two batches of kBLoads rank rows in flight
//     (the first issued before h is summed). 16-row slices spread a
//     segment with many rows over several blocks.
// Because its blocks wait on each other, two launches must not run at
// once on different streams. No float atomic is used and every sum runs in
// a fixed order, so two runs give the same bits. Ranked forms: h is forced
// to 0 at c >= rank, A's 16-byte column pieces at or past the rank are not
// read, nor B's rows from the rank on. The split of d_in depends only on
// d_in and every skipped term is an exact zero of the padded form, so on a
// prefix-zero pool (columns past an adapter's rank are zero) ranked and
// padded give the same values bit for bit. Slot and expert ids are clamped
// into range, as the reference's gathers clamp them.

#include <cuda.h>  // CUtensorMap (the encoder is found at run time)

#include <cstdint>
#include <type_traits>

#include "vec.cuh"

namespace {

using repro::to_f32;
using repro::Vec;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // 4 warps
constexpr int kBK = 64;            // d_in rows of a stage (>= 64: swizzle)
constexpr int kGroupElems = 4096;  // rows x rank columns of a row group
constexpr int kMaxRank = 256;
constexpr int kMaxSplits = 16;
constexpr int kZeroBytes = 4096;   // the zeroed buffer bulk stores copy from
constexpr int kRows = 4;           // rows of h an expand pass holds
constexpr int kBLoads = 8;         // B loads of a batch, two batches in flight
constexpr int kMaxDevices = 64;    // devices whose grid sizes are kept
constexpr int kATile = kBK * 128;  // bytes of a 64-column tile of A (bf16)
constexpr int kStages = 3;         // the shrink's ring

// The shared-memory element type: bf16 for the tensor cores when x and the
// factors are both bf16, else f32.
template <typename TX, typename TW>
struct Path {
  static constexpr bool kMma =
      std::is_same<TX, bf16>::value && std::is_same<TW, bf16>::value;
  using TS = typename std::conditional<kMma, bf16, float>::type;
  static constexpr int kES = sizeof(TS);
  static constexpr int kEPC = 16 / kES;  // elements of a 16-byte piece
};

// A launch's row groups: r64 rank columns (r rounded up to 64) by `rows`
// rows (a multiple of 16, rows * r64 <= kGroupElems).
struct Geometry {
  int r64, rows, groups;
};

__host__ __device__ inline Geometry geometry(int cap, int r) {
  Geometry g;
  g.r64 = (r + 63) / 64 * 64;
  const int most = kGroupElems / g.r64 / 16 * 16;
  const int cap16 = (cap + 15) / 16 * 16;
  g.rows = cap16 < most ? cap16 : most;
  g.groups = (cap + g.rows - 1) / g.rows;
  return g;
}

template <typename TX, typename TW>
struct Args {
  const TX* x;
  const TW* A;
  const TW* B;
  const int* slots;
  const int* eids;   // null: E = 1
  const int* ranks;  // read by the ranked forms only
  const int* index;  // null: segment i is the i-th
  float* out;
  float* part;       // n_seg x groups x splits x rows x r64
  int S, n_seg, cap, M, E, d_in, r, r_pool, d_out;
  int splits, split_kt;  // splits of d_in, k tiles of each
  int tma_x, tma_a;      // x's and A's tiles come by tensor map (bf16)
};

// One segment of the list as both kernels see it.
struct Seg {
  int s, slot, e, reff;  // slot < 0: inactive
};

template <bool kRanked, typename A>
__device__ __forceinline__ Seg segment(const A& p, int i) {
  Seg g;
  g.s = p.index ? p.index[i] : i;
  g.slot = p.slots[g.s];
  g.slot = g.slot < 0 ? -1 : min(g.slot, p.M - 1);
  g.e = p.eids ? min(max(p.eids[g.s], 0), p.E - 1) : 0;
  g.reff = kRanked ? min(max(p.ranks[g.s], 0), p.r) : p.r;
  return g;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fills the zero buffer at z (kZeroBytes of shared memory) and makes it
// visible to the bulk copies; every thread of the block calls it.
__device__ __forceinline__ void zero_buffer(unsigned char* z) {
  for (int i = threadIdx.x; i < kZeroBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(z)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// n floats of zeros at dst, by thread t of `lanes` threads that share the
// work. When vec (dst 16-byte aligned, n a multiple of 4) they issue bulk
// copies of kZeroBytes from the zero buffer zbuf on the TMA, so their own
// loads never queue behind these stores (each thread waits for its
// copies' reads of zbuf before it leaves: bulk_wait); else they store one
// value at a time.
__device__ __forceinline__ void zero_floats(float* dst, size_t n, bool vec,
                                            unsigned zbuf, int t, int lanes) {
  if (!vec) {
    for (size_t i = t; i < n; i += lanes) dst[i] = 0.f;
    return;
  }
  constexpr size_t kChunk = kZeroBytes / sizeof(float);
  bool issued = false;
  for (size_t a = t * kChunk; a < n; a += lanes * kChunk) {
    const unsigned bytes =
        (unsigned)(sizeof(float) * (n - a < kChunk ? n - a : kChunk));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst + a),
        "r"(zbuf), "r"(bytes)
        : "memory");
    issued = true;
  }
  if (issued) asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A stage's mbarrier completes its phase on the issuing thread's arrival
// once the tensor copies' bytes have landed.
__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

// The issuing thread's arrival: the phase completes when `bytes` of
// tensor copies have landed.
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A 3-D box of a tensor map into shared memory at dst, counted on bar.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Byte offset of 16-byte piece c of row k in a tile of rb bytes a row; the
// tensor-core path swizzles each 128 bytes (piece c at c ^ (k % 8)), so
// ldmatrix reads 8 rows from 32 distinct banks.
template <bool kSwizzle>
__device__ __forceinline__ int tile_off(int k, int c, int rb) {
  if (kSwizzle) return k * rb + (((c & ~7) | ((c ^ k) & 7)) << 4);
  return k * rb + (c << 4);
}

// 16 bytes of shared memory at dst from the first n values at src: one
// cp.async when all kEPC are wanted and vec (same type, 16-byte aligned),
// zeros when n <= 0, else one value at a time (converted to TS).
template <typename TS, typename TG>
__device__ __forceinline__ void load_piece(unsigned char* dst,
                                           const TG* src, int n, bool vec) {
  constexpr int kEPC = 16 / sizeof(TS);
  if (n >= kEPC && vec) {
    cp_async16(smem_u32(dst), src);
    return;
  }
  uint4 u = make_uint4(0u, 0u, 0u, 0u);  // the bits of +0.0
  TS* v = reinterpret_cast<TS*>(&u);
#pragma unroll
  for (int i = 0; i < kEPC; ++i) {
    if (i < n) {
      if constexpr (std::is_same<TS, TG>::value) v[i] = src[i];
      else v[i] = to_f32(src[i]);
    }
  }
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += L . R over one kBK-deep stage on the tensor cores. L: rows x kBK
// bf16, R: kBK x (64 * groups of columns) bf16, each group of 64 columns a
// tile of its own (kATile bytes). Both are 128-byte rows in the swizzle of
// tile_off, the layout a tensor map with 128-byte swizzle writes. Unit u <
// units of this warp: 16-row tile u % mt of L and columns (u / mt) * 64 +
// 16 * warp of R, its sums in acc[8u .. 8u + 8) (two n8 tiles); columns at
// or past `cols` are skipped.
template <int kU>
__device__ __forceinline__ void mma_stage(unsigned L, unsigned R, int mt,
                                          int units, int cols, float* acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int m = u % mt, g = u / mt;
      if (u >= units || g * 64 + warp * 16 >= cols) continue;
      uint32_t a[4], b[4];
      const int k = ks * 16 + (q & 1) * 8 + (lane & 7);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
          "{%0,%1,%2,%3}, [%4];\n"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(R + g * kATile +
                tile_off<true>(k, warp * 2 + (q >> 1), 128)));
      const int row = m * 16 + (q & 1) * 8 + (lane & 7);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
          : "r"(L + tile_off<true>(row, ks * 2 + (q >> 1), kBK * 2)));
      mma_bf16(acc + u * 8, a, b[0], b[1]);
      mma_bf16(acc + u * 8 + 4, a, b[2], b[3]);
    }
  }
}

// The same on the CUDA cores in f32: output o = tid + kThreads * j < rows *
// n sits at row o / n, column o % n, its sum in acc[j]; L rows have kBK
// floats, R rows n floats.
__device__ __forceinline__ void fma_stage(const float* L, const float* R,
                                          int rows, int n, float* acc) {
  for (int k = 0; k < kBK; ++k) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int o = threadIdx.x + kThreads * j;
      if (o < rows * n)
        acc[j] = fmaf(L[(o / n) * kBK + k], R[k * n + o % n], acc[j]);
    }
  }
}

// fn(j, row, col) for each sum acc[j] this thread holds of a rows x n
// product (the tensor-core unit layout of mma_stage, kU units at most, or
// fma_stage's).
template <bool kMma, int kU, typename Fn>
__device__ __forceinline__ void for_each_sum(int mt, int units, int rows,
                                             int n, Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (kMma) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (u >= units) continue;
      const int row0 = (u % mt) * 16 + (lane >> 2);
      const int col0 = (u / mt) * 64 + warp * 16 + (lane & 3) * 2;
#pragma unroll
      for (int v = 0; v < 8; ++v)  // n8 tile v / 4, row + 8 at v % 4 >= 2
        fn(u * 8 + v, row0 + ((v >> 1) & 1) * 8,
           col0 + (v >> 2) * 8 + (v & 1));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int o = threadIdx.x + kThreads * j;
      if (o < rows * n) fn(j, o / n, o % n);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_n(float* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// The shrink's walk over its items i = blockIdx.x, blockIdx.x + gridDim.x,
// ... < n_seg * groups * splits: (segment i / (groups * splits), row group,
// split). Inactive items are passed over; `zeros` (the loader's walk only)
// stores their share of the output.
template <bool kRanked, typename A>
struct Walk {
  int item = -1, n_items = 0;
  Seg seg;
  int m0 = 0, nrows = 0, kt0 = 0, nkt = 0, kt = 0;

  template <typename Z>
  __device__ __forceinline__ bool next(const A& p, const Geometry& g,
                                       Z zeros) {
    item = item < 0 ? (int)blockIdx.x : item + (int)gridDim.x;
    for (; item < n_items; item += gridDim.x) {
      const int per_seg = g.groups * p.splits;
      const int rg = item % per_seg / p.splits, sp = item % p.splits;
      seg = segment<kRanked>(p, item / per_seg);
      m0 = rg * g.rows;
      nrows = min(g.rows, p.cap - m0);
      if (seg.slot >= 0) {
        const int KT = (p.d_in + kBK - 1) / kBK;
        kt0 = sp * p.split_kt;
        nkt = min(KT, kt0 + p.split_kt) - kt0;
        kt = 0;
        return true;
      }
      zeros(*this, sp);
    }
    return false;
  }
};

// The shared memory: the shrink's ring of kStages stages (one k tile of kBK
// rows each, x's rows then A's columns, 1024-byte aligned; the expand's h
// takes its place), the zero buffer and one mbarrier a stage.
template <typename P>
struct Stage {
  int x_tile, bytes;
  __host__ __device__ explicit Stage(const Geometry& g) {
    x_tile = g.rows * kBK * P::kES;
    bytes = x_tile + kBK * g.r64 * P::kES;
  }
  __host__ __device__ size_t smem() const {
    return 1024 + (size_t)kStages * bytes + kZeroBytes + 8 * kStages;
  }
};

// part: the shrink items' partial h (rows x r64 f32 each), then a 64-bit
// mask of the rows whose partial holds a nonzero for each item, then one
// completion count a (segment, row group).
__host__ __device__ inline size_t part_masks(const Geometry& g, int n_items) {
  return (size_t)n_items * g.rows * g.r64;  // float offset of the masks
}

__host__ __device__ inline size_t part_done(const Geometry& g, int n_items) {
  return part_masks(g, n_items) + 2 * (size_t)n_items;  // of the counts
}

// A shrink item publishes its partial and mask: the block's writes come
// before the count's increment at the scope of the device (a release),
// and an expand item that reads the count (an acquire) sees them.
__device__ __forceinline__ void release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int acquire_load(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// kU: the mma units a warp holds at most (1 when a row group is one
// 16 x 64 unit a warp: 16 rows, r <= 64), so small items fit more blocks.
template <typename TX, typename TW, bool kRanked, int kU>
__global__ void __launch_bounds__(kThreads, kU == 1 ? 4 : 3)
    sgmv_kernel(const Args<TX, TW> p, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap ta) {
  using P = Path<TX, TW>;
  using TS = typename P::TS;
  constexpr bool kMma = P::kMma;
  constexpr int kEPC = P::kEPC, kES = P::kES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ unsigned long long live_s;  // rows of the item's partial != 0
  __shared__ int live_e[16];  // expand: row m of the slice holds a nonzero h
  __shared__ int lrow_s[16];  // those rows, ascending
  __shared__ int n_live_s;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const Geometry g = geometry(p.cap, p.r);
  const Stage<P> sg(g);
  const int mt = g.rows / 16, cgs = g.r64 / 64;
  const int xrb = kBK * kES, arb = g.r64 * kES;
  unsigned char* zb = smem + kStages * sg.bytes;
  const unsigned bar0 = smem_u32(zb + kZeroBytes);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) bar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    live_s = 0;
  }
  zero_buffer(zb);  // and a barrier: the mbarriers are ready too
  const unsigned zbuf = smem_u32(zb);
  const bool x_vec = std::is_same<TX, TS>::value && aligned16(p.x) &&
                     p.d_in % kEPC == 0;
  const bool a_vec = std::is_same<TW, TS>::value && aligned16(p.A) &&
                     p.r_pool % kEPC == 0;
  const bool o_vec = aligned16(p.out) && p.d_out % 4 == 0;

  using W = Walk<kRanked, Args<TX, TW>>;
  W ld, cs;  // the loader's walk (ahead) and the consumer's
  ld.n_items = cs.n_items = p.n_seg * g.groups * p.splits;
  unsigned long long* masks = reinterpret_cast<unsigned long long*>(
      p.part + part_masks(g, cs.n_items));
  int* done = reinterpret_cast<int*>(p.part + part_done(g, cs.n_items));

  // ---- 1. the shrink items ----
  // an inactive item: its share (split sp) of its row group's outputs
  auto zeros = [&](const W& w, int sp) {
    const size_t n = (size_t)w.nrows * p.d_out;
    const size_t per = ((n + p.splits - 1) / p.splits + 3) & ~(size_t)3;
    const size_t lo = sp * per < n ? sp * per : n;
    const size_t hi = lo + per < n ? lo + per : n;
    zero_floats(p.out + ((size_t)w.seg.s * p.cap + w.m0) * p.d_out + lo,
                hi - lo, o_vec, zbuf, tid, kThreads);
  };
  auto none = [](const W&, int) {};
  bool ld_on = ld.next(p, g, zeros), cs_on = cs.next(p, g, none);

  // one stage: its k tiles by tensor map where they can (thread 0 issues,
  // the stage's mbarrier counts the bytes), else 16-byte cp.async pieces
  // (every thread; one cp.async group a stage)
  auto load_stage = [&](int step) {
    unsigned char* st = smem + (step % kStages) * sg.bytes;
    const unsigned bar = bar0 + 8 * (step % kStages);
    const size_t slice = (size_t)ld.seg.slot * p.E + ld.seg.e;
    // A's columns this item wants; a 64-column tile comes by tensor map
    // when all of its columns in the pool are wanted
    const int want = min(ld.seg.reff, p.r);
    auto a_tma = [&](int cg) {
      return kMma && p.tma_a && want >= min(p.r_pool, 64 * cg + 64);
    };
    const int k0 = (ld.kt0 + ld.kt) * kBK;
    unsigned char* at = st + sg.x_tile;
    if (tid == 0) {
      unsigned bytes = kMma && p.tma_x ? g.rows * 128 : 0;
      for (int cg = 0; cg < cgs; ++cg) bytes += a_tma(cg) ? kATile : 0;
      bar_expect(bar, bytes);
      if (kMma && p.tma_x)
        tma_load(smem_u32(st), &tx, k0, ld.m0, ld.seg.s, bar);
      for (int cg = 0; cg < cgs; ++cg)
        if (a_tma(cg))
          tma_load(smem_u32(at + cg * kATile), &ta, 64 * cg, k0, (int)slice,
                   bar);
    }
    if (!(kMma && p.tma_x)) {
      const TX* xb = p.x + ((size_t)ld.seg.s * p.cap + ld.m0) * p.d_in;
      constexpr int kXC = kBK / kEPC;  // pieces of an x row
      for (int idx = tid; idx < g.rows * kXC; idx += kThreads) {
        const int m = idx / kXC, c = idx % kXC, k = k0 + c * kEPC;
        load_piece<TS>(st + tile_off<kMma>(m, c, xrb),
                       xb + (size_t)m * p.d_in + k,
                       m < ld.nrows ? p.d_in - k : 0, x_vec);
      }
    }
    const TW* ab = p.A + slice * p.d_in * p.r_pool;
    const int ac = g.r64 / kEPC;  // pieces of an A row
    for (int idx = tid; idx < kBK * ac; idx += kThreads) {
      const int k = idx / ac, pc = idx % ac, c0 = pc * kEPC;
      if (a_tma(c0 / 64)) continue;
      const int off = kMma ? (pc / 8) * kATile + tile_off<true>(k, pc % 8, 128)
                           : tile_off<false>(k, pc, arb);
      load_piece<TS>(at + off, ab + (size_t)(k0 + k) * p.r_pool + c0,
                     k0 + k < p.d_in && c0 < want ? p.r - c0 : 0, a_vec);
    }
    // this thread's shared-memory writes come before any later tensor copy
    // into the stage
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (++ld.kt == ld.nkt) ld_on = ld.next(p, g, zeros);
  };

  {
    constexpr int kSums = kMma ? 8 * kU : 32;  // this thread's sums
    float acc[kSums], tot[kSums];
    zero_n<kSums>(tot);
    int l_step = 0;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (ld_on) load_stage(l_step++);
      commit();
    }
    for (int step = 0; cs_on; ++step) {
      wait_group<kStages - 2>();
      __syncthreads();  // stage `step`'s pieces landed; step - 1 is free
      if (ld_on) load_stage(l_step++);
      commit();
      bar_wait(bar0 + 8 * (step % kStages), (step / kStages) & 1);
      unsigned char* st = smem + (step % kStages) * sg.bytes;
      zero_n<kSums>(acc);
      if constexpr (kMma)
        mma_stage<kU>(smem_u32(st), smem_u32(st + sg.x_tile), mt, mt * cgs,
                      cs.seg.reff, acc);
      else
        fma_stage(reinterpret_cast<const float*>(st),
                  reinterpret_cast<const float*>(st + sg.x_tile), g.rows,
                  g.r64, acc);
#pragma unroll
      for (int k = 0; k < kSums; ++k) tot[k] = __fadd_rn(tot[k], acc[k]);
      if (++cs.kt == cs.nkt) {  // the item's partial h and its nonzero rows
        float* pt = p.part + (size_t)cs.item * g.rows * g.r64;
        unsigned long long lm = 0;
        for_each_sum<kMma, kU>(mt, mt * cgs, g.rows, g.r64,
                               [&](int j, int m, int c) {
                                 pt[m * g.r64 + c] = tot[j];
                                 if (tot[j] != 0.f) lm |= 1ull << m;
                               });
        if (lm) atomicOr(&live_s, lm);
        __syncthreads();
        if (tid == 0) {
          masks[cs.item] = live_s;
          live_s = 0;
          release_add(done + cs.item / p.splits, 1);
        }
        zero_n<kSums>(tot);
        cs_on = cs.next(p, g, none);
      }
    }
  }
  // ---- 2. the expand items: (segment, 16-row slice, run of kThreads
  // column vectors of B) ----
  wait_group<0>();
  __syncthreads();  // the ring is read: h takes its place
  float* h_s = reinterpret_cast<float*>(smem);  // 16 rows x r64
  constexpr int VEC = Vec<TW>::N;  // B's 16-byte vector
  const bool b_full = aligned16(p.B) && p.d_out % VEC == 0;
  const int nv = (p.d_out + VEC - 1) / VEC;
  const int runs = (nv + kThreads - 1) / kThreads;  // of kThreads vectors
  const int slices = g.rows / 16;                    // of 16 rows a group
  const int n_exp = p.n_seg * g.groups * slices * runs;
  const int warp = tid / 32, lane = tid % 32;
  // an item of an active segment waits until its row group's `splits`
  // shrink items have published (their blocks all run: the grid is what
  // the SMs hold at once, and a shrink item never waits)
  for (int item = blockIdx.x; item < n_exp; item += gridDim.x) {
    const int run = item % runs, sl = item / runs % slices;
    const int rg = item / (runs * slices) % g.groups;
    const int i = item / (runs * slices * g.groups);
    const Seg seg = segment<kRanked>(p, i);
    if (seg.slot < 0) continue;  // its zeros are the shrink's
    const int m0 = rg * g.rows + sl * 16;
    const int nrows = min(16, p.cap - m0);  // this slice's rows
    if (nrows <= 0) continue;
    const int c_lo = run * kThreads * VEC;
    const int c_hi = min(p.d_out, c_lo + kThreads * VEC);
    float* o = p.out + ((size_t)seg.s * p.cap + m0) * p.d_out;
    if (tid == 0) {
      const int* d = done + (size_t)i * g.groups + rg;
      while (acquire_load(d) < p.splits) __nanosleep(32);
    }
    if (tid < 16) live_e[tid] = 0;
    __syncthreads();
    // the slice's rows whose partials are not all exact zeros (read past
    // L1: other blocks wrote them during this launch)
    const size_t it0 = ((size_t)i * g.groups + rg) * p.splits;
    unsigned long long any = 0;
    for (int sp = 0; sp < p.splits; ++sp) any |= __ldcg(masks + it0 + sp);
    const unsigned smask = (unsigned)(any >> (sl * 16)) & 0xffffu;
    const int reff = seg.reff;
    const int v = run * kThreads + tid;
    const int col = v * VEC, n = p.d_out - col;
    const TW* bcol = p.B + ((size_t)seg.slot * p.E + seg.e) * p.r_pool *
                               p.d_out + col;

    // B's first rank rows fly while h is summed (they do not depend on h)
    uint4 bv[2][kBLoads];
    auto load_b = [&](uint4* dst, int c) {
#pragma unroll
      for (int u = 0; u < kBLoads; ++u)
        dst[u] = v < nv && c + u < reff
                     ? repro::raw_at(bcol + (size_t)(c + u) * p.d_out, n,
                                     b_full)
                     : make_uint4(0u, 0u, 0u, 0u);
    };
    if (smask) load_b(bv[0], 0);

    // h = the splits' partials added in split order, masked at c < rank
    // (a row whose partials are all zero has h = 0 and is not read)
    const float* pt = p.part + it0 * g.rows * g.r64 + (size_t)sl * 16 * g.r64;
    for (int i4 = tid; smask && i4 < 16 * g.r64 / 4; i4 += kThreads) {
      const int m = i4 * 4 / g.r64, c0 = i4 * 4 % g.r64;
      float h[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < nrows && c0 < reff && ((smask >> m) & 1)) {
        for (int sp0 = 0; sp0 < p.splits; sp0 += 4) {
          float4 pv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (sp0 + u < p.splits)
              pv[u] = __ldcg(reinterpret_cast<const float4*>(
                                 pt + (size_t)(sp0 + u) * g.rows * g.r64) +
                             i4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (sp0 + u < p.splits) {
              h[0] += pv[u].x;
              h[1] += pv[u].y;
              h[2] += pv[u].z;
              h[3] += pv[u].w;
            }
          }
        }
      }
      bool nz = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float hv = c0 + u < reff ? h[u] : 0.f;
        nz |= hv != 0.f;
        h_s[i4 * 4 + u] = hv;
      }
      if (nz) atomicOr(&live_e[m], 1);
    }
    __syncthreads();
    if (warp == 0) {
      const bool f = lane < nrows && live_e[lane];
      const unsigned mask = __ballot_sync(0xffffffffu, f);
      if (f) lrow_s[__popc(mask & ((1u << lane) - 1u))] = lane;
      if (lane == 0) n_live_s = __popc(mask);
    }
    __syncthreads();
    const int n_live = n_live_s;

    // the rows of h that are all zero: +0 over this item's columns, a
    // thread a row (in bulk where the stores can be vectors)
    if (o_vec) {
      if (tid < nrows && !live_e[tid])
        zero_floats(o + (size_t)tid * p.d_out + c_lo, c_hi - c_lo, true,
                    zbuf, 0, 1);
    } else {
      for (int m = 0; m < nrows; ++m)
        if (!live_e[m])
          zero_floats(o + (size_t)m * p.d_out + c_lo, c_hi - c_lo, false,
                      zbuf, tid, kThreads);
    }
    // the others, kRows at a time: thread t owns column vector v
    for (int r0 = 0; r0 < n_live && v < nv; r0 += kRows) {
      float y[kRows][VEC];
      int hrow[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        hrow[rr] = lrow_s[min(r0 + rr, n_live - 1)];
#pragma unroll
        for (int k = 0; k < VEC; ++k) y[rr][k] = 0.f;
      }
      if (r0 > 0) load_b(bv[0], 0);
      for (int c = 0; c < reff; c += 2 * kBLoads) {
        load_b(bv[1], c + kBLoads);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int cb = c + half * kBLoads;
#pragma unroll
          for (int u = 0; u < kBLoads; ++u) {
            if (cb + u < reff) {
              float w[VEC];
              Vec<TW>::widen(bv[half][u], w);
#pragma unroll
              for (int rr = 0; rr < kRows; ++rr) {
                const float hv = h_s[hrow[rr] * g.r64 + cb + u];
#pragma unroll
                for (int k = 0; k < VEC; ++k)
                  y[rr][k] = fmaf(hv, w[k], y[rr][k]);
              }
            }
          }
          if (half == 0) load_b(bv[0], c + 2 * kBLoads);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (r0 + rr < n_live) {
          float* orow = o + (size_t)hrow[rr] * p.d_out + col;
#pragma unroll
          for (int k = 0; k < VEC; k += 4)
            repro::store4(orow + k,
                          make_float4(y[rr][k], y[rr][k + 1], y[rr][k + 2],
                                      y[rr][k + 3]),
                          n - k, o_vec && n - k >= 4);
        }
      }
    }
    __syncthreads();  // h_s, live_e and lrow_s are the next item's
  }
  bulk_wait();
}

// The persistent grid of kern: every block the SMs hold at `smem` bytes of
// dynamic shared memory, at most `items`. The fit is asked once a device,
// kernel and size; the shared-memory limit is raised at every launch that
// needs it (another size may have set it lower).
template <typename Kern>
cudaError_t grid_for(Kern kern, size_t smem, int items, int* grid) {
  struct Fit {
    const void* kern = nullptr;
    size_t smem = 0;
    int blocks = 0;
  };
  static Fit cache[kMaxDevices][8];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Fit* hit = nullptr;
  for (Fit& f : cache[dev])
    if (f.kern == (const void*)kern && f.smem == smem) hit = &f;
  if (!hit) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, smem);
    if (err != cudaSuccess) return err;
    Fit* slot = &cache[dev][0];  // the first free entry, else the first
    for (Fit& f : cache[dev])
      if (f.kern == nullptr) {
        slot = &f;
        break;
      }
    *slot = Fit{(const void*)kern, smem, n_sm * (per_sm > 0 ? per_sm : 1)};
    hit = slot;
  } else if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  *grid = hit->blocks < items ? hit->blocks : items;
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, found through the runtime (no link to
// libcuda); null where the installed CUDA has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static bool asked = false;
  if (!asked) {
    asked = true;
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess)
      f = nullptr;
#endif
    fn = q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                          : nullptr;
  }
  return fn;
}

// A 3-D bf16 tensor map (dims innermost first, strides of dims 1 and 2 in
// bytes) with a box of 64 x b1 x 1 and the 128-byte swizzle; reads past a
// dim are zeros. False where it cannot be made.
bool tensor_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                uint64_t d2, uint32_t b1) {
  EncodeTiled enc = encoder();
  if (!enc || (reinterpret_cast<uintptr_t>(base) & 15u) || d0 % 8) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TX, typename TW, bool kRanked>
int launch(Args<TX, TW> a, cudaStream_t stream) {
  using P = Path<TX, TW>;
  const Geometry g = geometry(a.cap, a.r);
  CUtensorMap tx{}, ta{};
  if (P::kMma) {  // x (S, cap, d_in) and A (M * E, d_in, r_pool)
    a.tma_x = tensor_map(&tx, a.x, a.d_in, a.cap, a.S, g.rows);
    a.tma_a = tensor_map(&ta, a.A, a.r_pool, a.d_in, (uint64_t)a.M * a.E, 64);
  }
  const size_t smem = Stage<P>(g).smem();
  constexpr int VEC = Vec<TW>::N;
  const int n_shrink = a.n_seg * g.groups * a.splits;
  const int runs = ((a.d_out + VEC - 1) / VEC + kThreads - 1) / kThreads;
  const int n_expand = a.n_seg * g.groups * (g.rows / 16) * runs;
  auto kern = P::kMma && g.rows == 16 && g.r64 == 64
                  ? sgmv_kernel<TX, TW, kRanked, 1>
                  : sgmv_kernel<TX, TW, kRanked, 4>;
  int grid = 0;
  cudaError_t err = grid_for(
      kern, smem, n_shrink > n_expand ? n_shrink : n_expand, &grid);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(a.part + part_done(g, n_shrink), 0,
                        sizeof(int) * a.n_seg * g.groups, stream);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, stream>>>(a, tx, ta);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_ranked(int ranked, const void* x, const void* A, const void* B,
                  const int* slots, const int* eids, const int* ranks,
                  const int* index, float* out, float* part, int S,
                  int n_seg, int cap, int M, int E, int d_in, int r,
                  int r_pool, int d_out, int splits, cudaStream_t st) {
  const int KT = (d_in + kBK - 1) / kBK;
  const int split_kt = (KT + splits - 1) / splits;
  const Args<TX, TW> a{static_cast<const TX*>(x), static_cast<const TW*>(A),
                       static_cast<const TW*>(B), slots, eids, ranks, index,
                       out, part, S, n_seg, cap, M, E, d_in, r, r_pool, d_out,
                       (KT + split_kt - 1) / split_kt, split_kt, 0, 0};
  if (ranked) return launch<TX, TW, true>(a, st);
  return launch<TX, TW, false>(a, st);
}

}  // namespace

// The largest rank column count r the kernels take.
extern "C" int sgmv_max_rank() { return kMaxRank; }
// The largest number of d_in splits the kernels take.
extern "C" int sgmv_max_splits() { return kMaxSplits; }

// Floats of part scratch a segment needs at cap rows, r rank columns and
// `splits` splits of d_in: its items' partials, then 16 bytes an item for
// the 64-bit row masks and the row groups' completion counts (so a run of
// segments' scratch starts 16-byte aligned: the expand reads partials as
// float4).
extern "C" long long sgmv_part_floats(int cap, int r, int splits) {
  const Geometry g = geometry(cap, r);
  return (long long)g.groups * splits * (g.rows * g.r64 + 4);
}

// dtype codes: 0 = float32, 1 = bfloat16. S: segments of x and out; eids
// null means E = 1; ranks is read only when ranked != 0; index null means
// the n_seg segments 0..n_seg in order. part: n_seg *
// sgmv_part_floats(cap, r, splits) floats of scratch; splits:
// 1..sgmv_max_splits() parts of d_in (fewer when d_in has fewer 64-row
// tiles). Any d_in, r <= sgmv_max_rank() and d_out; out (S, cap, d_out)
// f32. A memset of the counts and one kernel on `stream`, which no other
// launch of this kernel may overlap. Returns a cudaError_t (0 = ok).
extern "C" int sgmv_launch(int x_dtype, int w_dtype, int ranked,
                           const void* x, const void* A, const void* B,
                           const int* slots, const int* eids,
                           const int* ranks, const int* index, float* out,
                           float* part, int S, int n_seg, int cap, int M,
                           int E, int d_in, int r, int r_pool, int d_out,
                           int splits, void* stream) {
  if (splits < 1 || splits > kMaxSplits || r < 1 || r > kMaxRank ||
      r > r_pool)
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0 || cap == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SGMV_ARGS                                                      \
  ranked, x, A, B, slots, eids, ranks, index, out, part, S, n_seg, cap, M, \
      E, d_in, r, r_pool, d_out, splits, st
  if (x_dtype == 0 && w_dtype == 0)
    return launch_ranked<float, float>(REPRO_SGMV_ARGS);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_ranked<float, bf16>(REPRO_SGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_ranked<bf16, float>(REPRO_SGMV_ARGS);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_ranked<bf16, bf16>(REPRO_SGMV_ARGS);
#undef REPRO_SGMV_ARGS
  return (int)cudaErrorInvalidValue;
}
