// K6 on dense operands: the whole Jacobi-preconditioned CG solve of every
// instance in one launch, each instance's solve on one thread-block
// cluster, its rows of P and A in the cluster's shared memory, the
// products, the step and the stop test on the device (dense_loop_kernel).
//
// Replaces the while loop of osqp_tpu/linsys/cg.py:141-166 (solve) on
// dense (B, n, n) P and (B, m, n) A, with _matvec_M (:115-119) as its
// product: M p = (P p + sigma p) + A'(rho * A p).  Row-sharded operators
// and any other callable keep the step kernels (csrc/cg.cu): a launch
// cannot wait on another rank's collective.
//
// What bounds it on the H100: the operands.  A step reads P once and A
// twice (A p, then A' of the weighted A p), n^2 + 2 m n values, and does
// one multiply and one add on each, unfused; the vector work is O(n).
// Issued step by step from the host (three batched GEMVs and the three
// step kernels) every step brings the operands in from device memory:
// 1.64 GB a step at B=8192, n=100, m=200 in float32, ~0.49 ms at
// 3.35 TB/s.  Here an instance's operands come in once per CG solve, and
// a step is bound by the shared memory that feeds the products (one
// operand value a multiply-add, 128 bytes a cycle an SM) and by the
// barriers between its phases.
//
// The cut.  CTA c of a cluster of C CTAs (a power of two up to 16, above
// 8 non-portable) owns rows [c n / C, (c + 1) n / C) of P and a slab of
// A's rows: A's m rows fall in S = min(16, m) sub-slabs of RS = ceil(m / S)
// rows, the leaves of a pairwise tree of 16 (those past S empty), and CTA
// c owns leaves [16 c / C, 16 (c + 1) / C), a subtree.  In the resident mode the
// CTA's rows of P and A come into its shared memory once an instance, by
// bulk copies (cp.async.bulk) completing on an mbarrier; in the streamed
// modes they are read from device memory at each step (B=1 at n=1000 in
// float64, 18 MB of operands, more than any cluster holds, stays in L2).
// Every CTA keeps the whole of x, r, z, p, dinv and M p (in shared
// memory, or in device memory of its own where n is beyond that) and runs
// the step's vector work redundantly: all CTAs of a cluster hold the same
// bits, take the same alpha and beta, and stop at the same step, and the
// only exchange of a step is that of the products.
//
// Instances do not depend on each other, so the grid is the clusters
// that the card holds at once (cudaOccupancyMaxActiveClusters), at most
// B, and a cluster takes the next instance from a counter in device
// memory, as cluster_loop_kernel does.  The plan (cluster size, CTA
// width, mode) is chosen on the host by ops/cg.py:dense_loop_plan.
//
// A step, per instance:
//
//   products  P p on the CTA's rows of P and A p on its rows of A, a warp
//             a row against the whole p, four rows at once (lane l adds
//             the products of entries l, l + 32, ... in order, then the
//             warp's xor butterfly, whose halvings at offsets 16 and 8
//             trade rows so that the four take 6 shuffles a lane; p's
//             first 128 entries in registers); w * (A p) on its rows;
//             its leaves' partials of A'(w * A p), a thread a column of a
//             leaf adding its rows in order, then its subtree's pairwise
//             sum; P p and the subtree's root published (C > 1: to device
//             memory, where they stay in L2, double-buffered by step;
//             C = 1: in shared memory); one cluster barrier (release /
//             acquire)
//   Mp        Mp = (P p + sigma p) + V p, V p the top of the tree over
//             the C roots; p'Mp
//   update    alpha = r'z / p'Mp; x += alpha p, r -= alpha Mp, z = dinv r;
//             r'z and r'r
//   p         beta = r'z_new / r'z; p = z + beta p
//
// So every product is summed in an order fixed by n and m alone, whatever
// the plan, and ops/cg.py:DenseOperator.ordered renders it in PyTorch;
// the three inner products are summed in the step kernels' order
// (cg_sums.cuh, ops/cg.py:kernel_dot).  Each product and sum is rounded
// on its own (add / mul, no fused multiply-add), in the order of the JAX
// loop and of the step kernels.  So the loop and
// pcg_solve_plain(op.ordered, ..., dot=kernel_dot, start_dot=kernel_dot)
// take the same steps to the same bits, every plan gives the same bits,
// and two runs give the same bits.
//
// The start from x0 takes one product, with the operands already in
// place: r = b - M x0, z = dinv r, p = z, and r'z and r'r summed in the
// kernel's order (the plain twin sums its start in the same order).  From
// x0 = 0 it takes none: r = b.
//
// Each instance stops on its own, at r'r <= tol^2 or after max_iter
// steps, by the argument of csrc/cg.cu: a frozen instance of the batch
// loop keeps its x, r, z, r'z and r'r bit for bit, and the solve returns
// x and the steps alone.  The start's sums here are the kernel's own, so
// the exception that csrc/cg.cu names for its loop (a start whose
// PyTorch sum of r'r lies within a few ulps of the tolerance) has no
// counterpart: the plain twin's start sums in the same order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cg_sums.cuh"
#include "cluster.cuh"
#include "common.cuh"

namespace {

using namespace osqp_cuda;

constexpr int kDenseMaxCluster = 16;
// three parts' groups of 256 threads at most: at 80 registers a thread
// (the bound lets ptxas keep every value in registers) an SM holds 768
constexpr int kDenseMaxThreads = 3 * kThreads;
constexpr int kSlabs = 16;          // sub-slabs of A's rows at most: the leaves of their sum's tree
constexpr int kRegChunks = 4;       // chunks of 32 entries of p a lane holds in registers
constexpr int kRows = 4;            // rows a warp takes at once in the row products
constexpr int kBatch = 8;           // values a thread loads at once ahead of their additions
constexpr uint32_t kBulkBytes = 32768;  // bytes of one bulk copy at most

// The cut of an instance: the sub-slabs of A's rows (S of RS rows; the
// 16 leaves of the partials' sum tree, those past S empty), the parts
// and rounds of the inner products, the leaves L = 16 / C of a CTA of a
// cluster of C and the most rows of P and of A it owns; `pub` values are
// published a step (P p, then the C subtrees' sums of A'(w A p)).
struct DenseGeom {
  int S, RS, parts, rounds, L, PR, RA;
  size_t pub;
};

inline DenseGeom dense_geom(int n, int m, int C) {
  DenseGeom g;
  g.S = m > 0 ? (m < kSlabs ? m : kSlabs) : 0;
  g.RS = m > 0 ? (m + g.S - 1) / g.S : 0;
  g.parts = parts_of(n);
  g.rounds = (n + g.parts * kThreads - 1) / (g.parts * kThreads);
  g.L = kSlabs / C;
  g.PR = (n + C - 1) / C;
  g.RA = g.L * g.RS;
  g.pub = static_cast<size_t>(n) * (1 + C);
  return g;
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Bytes of a CTA's dynamic shared memory, in the kernel's order: two
// mbarriers; values (8 scalars, the partials of two sums by part, the
// warps' sums of two sums by part; with `vres` x r z p dinv Mp, the
// weights and w * A p of its rows of A and its leaves' partials; with
// C = 1 the published products); with `res` its rows of P and of A, each
// in a 16-byte aligned buffer with room for the bulk copy's aligned
// window.
// ops/cg.py:dense_loop_smem counts the same.
template <typename T>
size_t dense_smem(const DenseGeom& g, int n, int C, bool res, bool vres) {
  size_t vals = 8 + 2 * kMaxParts + 2 * static_cast<size_t>(g.parts) * kWarps;
  if (vres) vals += (6 + static_cast<size_t>(g.L)) * n + 2 * static_cast<size_t>(g.RA);
  if (C == 1) vals += g.pub;
  size_t b = align16(2 * sizeof(uint64_t) + vals * sizeof(T));
  if (res)
    b += align16(sizeof(T) * static_cast<size_t>(g.PR) * n + 32) + align16(sizeof(T) * static_cast<size_t>(g.RA) * n + 32);
  return b;
}

// Values of device scratch: the published products of every cluster in
// flight, two sets each (C > 1), and, where the vectors are not in shared
// memory, each CTA's x r z p Mp, w * A p of its rows and its leaves'
// partials.
inline size_t dense_scratch_values(const DenseGeom& g, int n, int C, bool vres, int clusters) {
  size_t v = C > 1 ? static_cast<size_t>(clusters) * 2 * g.pub : 0;
  if (!vres) v += static_cast<size_t>(clusters) * C * ((5 + static_cast<size_t>(g.L)) * n + g.RA);
  return v;
}

// The operands and state of the solves: P (B, n, n), A (B, m, n) and the
// weights w (B, m) (m may be 0); dinv, b (B, n); x0 (B, n) or null for
// zeros; tol2 (B); x (B, n) the result; steps (B + 1) int32 zeros, the
// steps of each instance and, last, the instance counter; scratch as
// dense_scratch_values counts it.
template <typename T>
struct DenseArgs {
  const T *P, *A, *w, *dinv, *b, *x0, *tol2;
  T *x, *scratch;
  int32_t* steps;
  T sigma;
  int B, n, m, max_iter, C;
  DenseGeom g;
};

// kRows rows of a dense operand against v, by a warp, their chains
// interleaved: for each row lane l adds the products of entries l, l + 32,
// ... in order (+0 past n) into acc (rows_butterfly sums the lanes).  vr
// holds v's first kRegChunks chunks.  Every row is read (the
// caller repeats a row where it has fewer than kRows), and the guards are
// selects, not branches, so that a chunk's loads go out together.
template <typename T>
__device__ __forceinline__ void rows_dot(const T* const (&row)[kRows], const T* v, const T (&vr)[kRegChunks], int n,
                                         int lane, T (&acc)[kRows]) {
  const int K = (n + 31) >> 5;
#pragma unroll
  for (int u = 0; u < kRows; ++u) acc[u] = T(0);
#pragma unroll
  for (int k = 0; k < kRegChunks; ++k)
    if (k < K) {
      const int j = lane + 32 * k;
      const bool in = j < n;
      T x[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) x[u] = in ? row[u][j] : T(0);
#pragma unroll
      for (int u = 0; u < kRows; ++u) acc[u] = add(acc[u], in ? mul(x[u], vr[k]) : T(0));
    }
#pragma unroll 2
  for (int k = kRegChunks; k < K; ++k) {
    const int j = lane + 32 * k;
    const bool in = j < n;
    const T vj = in ? v[j] : T(0);
    T x[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) x[u] = in ? row[u][j] : T(0);
#pragma unroll
    for (int u = 0; u < kRows; ++u) acc[u] = add(acc[u], in ? mul(x[u], vj) : T(0));
  }
}

// The xor butterfly of each of 4 rows' lane sums, the 4 at once: at
// offset 16 a lane keeps 2 rows (lanes below 16 rows 0 and 1) and adds its
// partner's value of each, at offset 8 it keeps 1, then the levels 4, 2, 1
// on that row.  Every node pairs the lanes that the butterfly pairs (in
// either order, which IEEE addition does not see), so lane 8 u returns
// the butterfly's lane-0 sum of row u, bit for bit, in 6 shuffles a lane
// instead of 20.
template <typename T>
__device__ __forceinline__ T rows_butterfly(const T (&acc)[kRows], int lane) {
  static_assert(kRows == 4, "two halvings, then one row a lane");
  const bool h16 = lane & 16, h8 = lane & 8;
  T k0 = h16 ? acc[2] : acc[0], k1 = h16 ? acc[3] : acc[1];
  const T s0 = h16 ? acc[0] : acc[2], s1 = h16 ? acc[1] : acc[3];
  k0 = add(k0, __shfl_xor_sync(0xffffffffu, s0, 16));
  k1 = add(k1, __shfl_xor_sync(0xffffffffu, s1, 16));
  T v = add(h8 ? k1 : k0, __shfl_xor_sync(0xffffffffu, h8 ? k0 : k1, 8));
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Rows [0, bytes) of an instance's operand from device memory at src into
// the 16-byte aligned buffer dst, as the aligned window around them (at
// most 15 bytes more on each side, in the same 16-byte segments of the
// allocation), in bulk copies of at most kBulkBytes completing on *bar;
// returns the window's bytes.  One thread.
__device__ __forceinline__ uint32_t bulk_rows(void* dst, const void* src, size_t bytes, uint64_t* bar) {
  if (bytes == 0) return 0;
  uintptr_t lo;
  uint32_t size;
  window(src, bytes, lo, size);
  for (uint32_t o = 0; o < size; o += kBulkBytes)
    bulk_load(static_cast<unsigned char*>(dst) + o, reinterpret_cast<const void*>(lo + o),
              size - o < kBulkBytes ? size - o : kBulkBytes, bar);
  return size;
}

__device__ __forceinline__ uint32_t window_bytes(const void* src, size_t bytes) {
  if (bytes == 0) return 0;
  uintptr_t lo;
  uint32_t size;
  window(src, bytes, lo, size);
  return size;
}

#ifdef OSQP_STAMPS
// cycles by phase (tools/probe_k6_dense.py): the instance's fetch, loads
// and start; the rows' products, their barrier; A'(w A p); the exchange;
// Mp and p'Mp; the update and its sums; p and its barrier; the result's
// store
__device__ unsigned long long dense_stamps[2][16];
#endif

// The loop's modes (ops/cg.py:LoopPlan, as cluster_loop_kernel's): the
// CTA's rows of P and A and the vectors in shared memory (kResident), the
// vectors alone there, the rows read from device memory at each step
// (kVectors), or everything in device memory (kStreamed: n beyond what a
// CTA's shared memory holds).
enum DenseMode { kResident = 0, kVectors = 1, kStreamed = 2 };

template <typename T, int kMode>
__global__ void __launch_bounds__(kDenseMaxThreads, 1) dense_loop_kernel(const DenseArgs<T> a) {
  namespace cg = cooperative_groups;
  constexpr bool kRes = kMode == kResident, kVres = kMode != kStreamed;
  extern __shared__ __align__(16) unsigned char dense_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const DenseGeom g = a.g;
  const int C = a.C, rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int G = nthreads / kThreads, grp = tid / kThreads, t256 = tid % kThreads;
  const int lane = tid & 31, warp = tid >> 5, wg = t256 >> 5;
  const int n = a.n, m = a.m, S = g.S, RS = g.RS, P = g.parts, rounds = g.rounds;
  const int pr0 = static_cast<int>(static_cast<long long>(rank) * n / C);
  const int pr1 = static_cast<int>(static_cast<long long>(rank + 1) * n / C);
  const int L = g.L, s0 = rank * L;  // the CTA's leaves [s0, s0 + L)
  const int ar0 = min(m, s0 * RS), ar1 = min(m, (s0 + L) * RS);
  const bool local = C == 1;
  const T sigma = a.sigma;

  uint64_t* bars = reinterpret_cast<uint64_t*>(dense_raw);  // the operands' arrival
  T* sv = reinterpret_cast<T*>(bars + 2);
  T* scal = sv;  // p'Mp, r'z, r'r; the next instance (rank 0) and this CTA's copy of it
  sv += 8;
  T* psum = sv;  // the parts' partials of two sums
  sv += 2 * kMaxParts;
  T* wsum = sv;  // the warps' sums of every part, two sums
  sv += 2 * static_cast<size_t>(P) * kWarps;
  T *X, *R, *Z, *Pv, *M, *Wl, *Vl, *Stg;  // Wl, Vl: the CTA's rows of A, row ar0 first; Stg its leaves
  T* Dsm = nullptr;
  const size_t per_cta = (5 + static_cast<size_t>(L)) * n + g.RA;
  const int clusters = gridDim.x / C;
  if constexpr (kVres) {
    X = sv, R = X + n, Z = R + n, Pv = Z + n, Dsm = Pv + n, M = Dsm + n, Wl = M + n, Vl = Wl + g.RA;
    Stg = Vl + g.RA;
    sv = Stg + static_cast<size_t>(L) * n;
  } else {
    T* own = a.scratch + (local ? 0 : static_cast<size_t>(clusters) * 2 * g.pub) + blockIdx.x * per_cta;
    X = own, R = X + n, Z = R + n, Pv = Z + n, M = Pv + n, Vl = M + n, Stg = Vl + g.RA, Wl = nullptr;
  }
  T* const pub_smem = sv;  // C = 1
  if (local) sv += g.pub;
  unsigned char* slabs = reinterpret_cast<unsigned char*>(sv);
  slabs = dense_raw + align16(static_cast<size_t>(slabs - dense_raw));
  unsigned char* const p_slab = slabs;
  unsigned char* const a_slab = slabs + align16(sizeof(T) * static_cast<size_t>(g.PR) * n + 32);
  T* const pub_glob = a.scratch + static_cast<size_t>(blockIdx.x / C) * 2 * g.pub;
  int* next = reinterpret_cast<int*>(scal + 6);
  int* mine = reinterpret_cast<int*>(scal + 7);

  if (tid == 0) {
    mbar_init(bars, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t ld_phase = 0, pub_phase = 0;
  STAMP_DECL(dense_stamps)

  // The sums of NS products an entry over the n entries, in kernel_dot's
  // order: f(i, acc) adds entry i's products to acc[0..NS); the sums go to
  // out[0..NS), which every thread reads after the call.
  auto ksum = [&](auto f, auto ns, T* out) {
    constexpr int NS = decltype(ns)::value;
    for (int q = grp; q < P; q += G) {
      T acc[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) acc[s] = T(0);
      for (int t = 0; t < rounds; ++t) {
        const int i = (t * P + q) * kThreads + t256;
        if (i >= n) break;
        f(i, acc);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const T v = warp_sum(acc[s]);
        if (lane == 0) wsum[(s * P + q) * kWarps + wg] = v;
      }
    }
    __syncthreads();
    if (warp < NS) {
      for (int q = 0; q < P; ++q) {
        const T v = __shfl_sync(0xffffffffu, warps_sum(lane < kWarps ? wsum[(warp * P + q) * kWarps + lane] : T(0)), 0);
        if (lane == 0) psum[warp * kMaxParts + q] = v;
      }
      __syncwarp();
      // one part: parts_total's butterflies add +0 to the partial alone
      const T total = P == 1 ? add(T(0), psum[warp * kMaxParts]) : parts_total(psum + warp * kMaxParts, P, lane);
      if (lane == 0) out[warp] = total;
    }
    __syncthreads();
  };
  // the same entries, for work without sums
  auto each = [&](auto f) {
    for (int q = grp; q < P; q += G)
      for (int t = 0; t < rounds; ++t) {
        const int i = (t * P + q) * kThreads + t256;
        if (i >= n) break;
        f(i);
      }
  };

  for (;;) {
    // the next instance, read by every CTA from rank 0 between two barriers
    if (rank == 0 && tid == 0) *next = atomicAdd(a.steps + a.B, 1);
    cluster_barrier();
    if (tid == 0) *mine = *cluster.map_shared_rank(next, 0);
    cluster_barrier();
    const int b = *mine;
    if (b >= a.B) break;
    const size_t bn = static_cast<size_t>(b) * n, bm = static_cast<size_t>(b) * m;
    const T* const Pg = a.P + bn * n + static_cast<size_t>(pr0) * n;  // the CTA's first row of P
    const T* const Ag = a.A + bm * n + static_cast<size_t>(ar0) * n;  // and of A
    const T *Prows = Pg, *Arows = Ag;
    if constexpr (kRes) {
      const size_t pbytes = sizeof(T) * static_cast<size_t>(pr1 - pr0) * n;
      const size_t abytes = sizeof(T) * static_cast<size_t>(ar1 - ar0) * n;
      if (tid == 0) {
        fence_async_shared();
        mbar_expect_tx(bars, window_bytes(Pg, pbytes) + window_bytes(Ag, abytes));
        bulk_rows(p_slab, Pg, pbytes, bars);
        bulk_rows(a_slab, Ag, abytes, bars);
      }
      Prows = reinterpret_cast<const T*>(p_slab) + misalign(Pg);
      Arows = reinterpret_cast<const T*>(a_slab) + misalign(Ag);
    }
    const T* D = a.dinv + bn;
    const T* W = a.w ? a.w + bm + ar0 : nullptr;
    if constexpr (kVres) {
      for (int i = tid; i < n; i += nthreads) Dsm[i] = a.dinv[bn + i];
      for (int j = tid; j < ar1 - ar0; j += nthreads) Wl[j] = a.w[bm + ar0 + j];
      D = Dsm;
      W = Wl;
    }
    const T* const bb = a.b + bn;
    const T tol2 = a.tol2[b];

    // The products of v (x0 or p) into the published set, then its
    // exchange: returns the set, read by rd.
    auto products = [&](const T* v) -> T* {
      T* pub = local ? pub_smem : pub_glob + static_cast<size_t>(pub_phase) * g.pub;
      T vr[kRegChunks];
#pragma unroll
      for (int k = 0; k < kRegChunks; ++k) {
        const int j = lane + 32 * k;
        vr[k] = j < n ? v[j] : T(0);
      }
      // the CTA's rows of P, then its rows of A, kRows at a time a warp
      const int nP = pr1 - pr0, R = nP + (ar1 - ar0);
      for (int t0 = warp * kRows; t0 < R; t0 += nwarps * kRows) {
        const T* row[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int t = t0 + u < R ? t0 + u : t0;  // past the last row: row t0 again, its sum unused
          row[u] = t < nP ? Prows + static_cast<size_t>(t) * n : Arows + static_cast<size_t>(t - nP) * n;
        }
        T acc[kRows];
        rows_dot(row, v, vr, n, lane, acc);
        const T sum = rows_butterfly(acc, lane);
        const int t = t0 + (lane >> 3);  // lane 8 u holds row t0 + u
        if ((lane & 7) == 0) {
          if (t < nP)
            pub[pr0 + t] = sum;
          else if (t < R)
            Vl[t - nP] = mul(W[t - nP], sum);
        }
      }
      STAMP(1);
      __syncthreads();  // w * A p of the CTA's rows in place
      STAMP(2);
      if (m) {
        // its leaves' partials of A'(w A p): a thread a column of a leaf,
        // kBatch rows' values loaded ahead of their additions; a leaf past
        // S is +0
        const int items = L * n;
        for (int it = tid; it < items; it += nthreads) {
          const int l = it / n, i = it - l * n, s = s0 + l;
          const T* col = Arows + static_cast<size_t>(s * RS - ar0) * n + i;
          const T* vs = Vl + (s * RS - ar0);
          const int rows = s < S ? min(RS, m - s * RS) : 0;  // the leaf's rows in A; the rest add +0
          T acc = T(0);
          for (int j0 = 0; s < S && j0 < RS; j0 += kBatch) {
            T av[kBatch], wv[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const bool in = j0 + u < rows;
              av[u] = in ? col[static_cast<size_t>(j0 + u) * n] : T(0);
              wv[u] = in ? vs[j0 + u] : T(0);
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const T sum = add(acc, mul(av[u], wv[u]));
              acc = j0 + u < RS ? sum : acc;
            }
          }
          Stg[static_cast<size_t>(l) * n + i] = acc;
        }
        __syncthreads();
        // the CTA's subtree of the 16 leaves' pairwise sum, a column a
        // thread, halving in place: its root published
        for (int i = tid; i < n; i += nthreads) {
          for (int w = L >> 1; w > 0; w >>= 1)
            for (int k = 0; k < w; ++k)
              Stg[static_cast<size_t>(k) * n + i] =
                  add(Stg[static_cast<size_t>(2 * k) * n + i], Stg[static_cast<size_t>(2 * k + 1) * n + i]);
          pub[n + static_cast<size_t>(rank) * n + i] = Stg[i];
        }
      }
      STAMP(3);
      if (local) {
        __syncthreads();
      } else {
        cluster_barrier();
        pub_phase ^= 1;
      }
      STAMP(4);
      return pub;
    };
    auto rd = [&](const T* pub, size_t k) -> T { return local ? pub[k] : __ldcg(pub + k); };
    // V v at each of the thread's entries (the top of the tree over the C
    // subtrees' roots, loaded together) into M, where the Mp pass, on the
    // same entries, reads it
    auto tree_top = [&](const T* pub) {
      if (!m) return;
      each([&](int i) {
        T r[kSlabs];
#pragma unroll
        for (int k = 0; k < kSlabs; ++k) r[k] = k < C ? rd(pub, n + static_cast<size_t>(k) * n + i) : T(0);
#pragma unroll
        for (int w = kSlabs / 2; w > 0; w >>= 1)
          if (w < C)
#pragma unroll
            for (int k = 0; k < w; ++k) r[k] = add(r[2 * k], r[2 * k + 1]);
        M[i] = r[0];
      });
    };
    // M v = (P v + sigma v) + V v at entry i, V v in M[i]
    auto assemble = [&](const T* pub, int i, T vi) -> T {
      const T u = add(rd(pub, i), mul(sigma, vi));
      return m ? add(u, M[i]) : u;
    };
    auto start_entry = [&](int i, T ri, T* acc) {
      const T zi = mul(D[i], ri);
      R[i] = ri;
      Z[i] = zi;
      Pv[i] = zi;
      acc[0] = add(acc[0], mul(ri, zi));
      acc[1] = add(acc[1], mul(ri, ri));
    };
    using One = std::integral_constant<int, 1>;
    using Two = std::integral_constant<int, 2>;

    if (a.x0) {
      for (int i = tid; i < n; i += nthreads) X[i] = a.x0[bn + i];
      __syncthreads();
      if constexpr (kRes) mbar_wait(bars, ld_phase);
      const T* pub = products(X);
      tree_top(pub);
      ksum([&](int i, T* acc) { start_entry(i, sub(bb[i], assemble(pub, i, X[i])), acc); }, Two{}, scal + 1);
    } else {
      ksum([&](int i, T* acc) {
        X[i] = T(0);
        start_entry(i, bb[i], acc);
      }, Two{}, scal + 1);
      if constexpr (kRes) mbar_wait(bars, ld_phase);
    }
    ld_phase ^= 1;
    T rz = scal[1], rr = scal[2];
    STAMP(0);

    int k = 0;
    for (; k < a.max_iter && rr > tol2; ++k) {
      const T* pub = products(Pv);
      tree_top(pub);
      // Mp and p'Mp (dot_kernel)
      ksum([&](int i, T* acc) {
        const T pi = Pv[i], u = assemble(pub, i, pi);
        M[i] = u;
        acc[0] = add(acc[0], mul(pi, u));
      }, One{}, scal);
      STAMP(5);
      const T d = scal[0];
      const T alpha = rz / (d > T(0) ? d : T(1));
      // x, r, z, r'z and r'r (update_kernel)
      ksum([&](int i, T* acc) {
        X[i] = add(X[i], mul(alpha, Pv[i]));
        const T ri = sub(R[i], mul(alpha, M[i]));
        const T zi = mul(D[i], ri);
        R[i] = ri;
        Z[i] = zi;
        acc[0] = add(acc[0], mul(ri, zi));
        acc[1] = add(acc[1], mul(ri, ri));
      }, Two{}, scal + 1);
      STAMP(6);
      const T rz_new = scal[1];
      rr = scal[2];
      // beta and p (direction_kernel)
      const T beta = rz_new / (rz > T(0) ? rz : T(1));
      each([&](int i) { Pv[i] = add(Z[i], mul(beta, Pv[i])); });
      __syncthreads();
      STAMP(7);
      rz = rz_new;
    }
    if (rank == 0) {
      for (int i = tid; i < n; i += nthreads) a.x[bn + i] = X[i];
      if (tid == 0) a.steps[b] = k;
    }
    STAMP(8);
  }
}

// The launch of the loop in mode kMode: clusters of C CTAs of `threads`,
// `smem` bytes each; err is set where the plan is not served.
template <typename T, int kMode>
struct DenseLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;

  DenseLaunch(int C, int threads, size_t smem, int clusters, cudaStream_t s) {
    if (C < 1 || C > kDenseMaxCluster || (C & (C - 1)) || threads < kThreads || threads > kDenseMaxThreads ||
        threads % kThreads || smem > static_cast<size_t>(kMaxSmem) || clusters < 1) {
      err = cudaErrorInvalidValue;
      return;
    }
    auto kernel = dense_loop_kernel<T, kMode>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess && C > 8) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg.gridDim = dim3(static_cast<unsigned>(clusters) * C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

inline int dense_mode(int resident, int vectors) {
  return resident ? kResident : (vectors ? kVectors : kStreamed);
}

template <typename T, int kMode>
int launch_dense(DenseArgs<T> a, int threads, int clusters, cudaStream_t s) {
  a.g = dense_geom(a.n, a.m, a.C);
  DenseLaunch<T, kMode> l(a.C, threads, dense_smem<T>(a.g, a.n, a.C, kMode == kResident, kMode != kStreamed),
                          clusters < a.B ? clusters : a.B, s);
  if (l.err != cudaSuccess) return l.err;
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, dense_loop_kernel<T, kMode>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int kMode>
int dense_clusters(int C, int threads, size_t smem) {
  DenseLaunch<T, kMode> l(C, threads, smem, 1, nullptr);
  int clusters = 0;
  if (l.err != cudaSuccess || cudaOccupancyMaxActiveClusters(&clusters, dense_loop_kernel<T, kMode>, &l.cfg) != cudaSuccess)
    return -1;
  return clusters;
}

template <typename T>
int launch_dense_in(int mode, DenseArgs<T> a, int threads, int clusters, cudaStream_t s) {
  return mode == kResident ? launch_dense<T, kResident>(a, threads, clusters, s)
         : mode == kVectors ? launch_dense<T, kVectors>(a, threads, clusters, s)
                            : launch_dense<T, kStreamed>(a, threads, clusters, s);
}

template <typename T>
int dense_clusters_in(int mode, int C, int threads, size_t smem) {
  return mode == kResident ? dense_clusters<T, kResident>(C, threads, smem)
         : mode == kVectors ? dense_clusters<T, kVectors>(C, threads, smem)
                            : dense_clusters<T, kStreamed>(C, threads, smem);
}

}  // namespace

// The whole CG solve of B instances of n variables on dense operands,
// one launch, an instance on a cluster.  dtype: 0 float32, 1 float64.  P
// (B,n,n), A (B,m,n) and w (B,m) (m may be 0: A and w then unread); sigma;
// dinv and b (B,n); x0 (B,n) the start, or null for zeros; tol2 (B) the
// squared tolerances.  Written: x (B,n) the result and steps (B + 1) int32,
// which must hold zeros: the steps of each instance, then the instance
// counter.  scratch: osqp_cg_dense_loop_scratch bytes of device memory.
// The plan (ops/cg.py:dense_loop_plan): clusters of `cluster` CTAs (1 to
// 16, a power of two) of `threads` (256, 512 or 768), the rows of P and A in shared
// memory when `resident`, the vectors when `vectors` (which `resident`
// needs), at most `clusters` clusters at once.  All contiguous, B, n >= 1,
// max_iter >= 0.
extern "C" int osqp_cg_dense_loop(int dtype, const void* P, const void* A, const void* w, double sigma,
                                  const void* dinv, const void* b, const void* x0, const void* tol2, void* x,
                                  void* steps, void* scratch, int B, int n, int m, int max_iter, int cluster,
                                  int threads, int resident, int vectors, int clusters, void* stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  if ((resident && !vectors) || max_iter < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int mode = dense_mode(resident, vectors);
  auto fill = [&](auto a) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(a.P)>>;
    a.P = static_cast<const T*>(P);
    a.A = static_cast<const T*>(A);
    a.w = m > 0 ? static_cast<const T*>(w) : nullptr;
    a.dinv = static_cast<const T*>(dinv);
    a.b = static_cast<const T*>(b);
    a.x0 = static_cast<const T*>(x0);
    a.tol2 = static_cast<const T*>(tol2);
    a.x = static_cast<T*>(x);
    a.scratch = static_cast<T*>(scratch);
    a.steps = static_cast<int32_t*>(steps);
    a.sigma = static_cast<T>(sigma);
    a.B = B;
    a.n = n;
    a.m = m;
    a.max_iter = max_iter;
    a.C = cluster;
    return launch_dense_in<T>(mode, a, threads, clusters, s);
  };
  return dtype == 0 ? fill(DenseArgs<float>{}) : fill(DenseArgs<double>{});
}

// Bytes of shared memory of one CTA of the dense loop's plan (arguments
// as osqp_cg_dense_loop's).
extern "C" int osqp_cg_dense_loop_smem(int dtype, int n, int m, int cluster, int resident, int vectors) {
  const DenseGeom g = dense_geom(n, m, cluster);
  return static_cast<int>(dtype == 0 ? dense_smem<float>(g, n, cluster, resident != 0, vectors != 0)
                                     : dense_smem<double>(g, n, cluster, resident != 0, vectors != 0));
}

// Bytes of device scratch of the dense loop's plan with `clusters`
// clusters at once (at most B).
extern "C" long long osqp_cg_dense_loop_scratch(int dtype, int n, int m, int cluster, int vectors, int clusters) {
  const DenseGeom g = dense_geom(n, m, cluster);
  return static_cast<long long>(dense_scratch_values(g, n, cluster, vectors != 0, clusters) * (dtype == 0 ? 4 : 8));
}

#ifdef OSQP_STAMPS
// The loop's cycles by phase since the last call (2 x 16: CTA 0 and the
// last CTA of the first cluster), then zeroed.
extern "C" int osqp_cg_dense_stamps(unsigned long long* out) {
  static const unsigned long long zero[2][16] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, dense_stamps, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(dense_stamps, zero, sizeof(zero));
  return err;
}
#endif

// Clusters of the dense loop's plan that the card holds at once; negative
// on a CUDA error or a plan the kernel does not serve.
extern "C" int osqp_cg_dense_loop_clusters(int dtype, int cluster, int threads, int smem, int resident, int vectors) {
  if (resident && !vectors) return -1;
  const int mode = dense_mode(resident, vectors);
  const size_t b = static_cast<size_t>(smem);
  return dtype == 0 ? dense_clusters_in<float>(mode, cluster, threads, b)
                    : dense_clusters_in<double>(mode, cluster, threads, b);
}
