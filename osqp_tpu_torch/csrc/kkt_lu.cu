// K8: batched LU of the full KKT matrix with partial pivoting, and the
// solve with its factors.
//
// Replaces osqp_tpu/linsys/kkt_lu.py:_lu_factor (jax.lax.linalg.lu, the
// TPU's LuDecompositionBlock custom call) and _lu_solve (a gather and two
// triangular_solve calls), which the JAX package runs as the kkt_lu
// backend and inside polish (osqp_tpu/polish.py:_make_kkt_solver).
//
//   factor:  P K = L U for each K of a (B, N, N) batch, row pivoting by
//            the FIRST row of largest |value| in the column; lu holds the
//            unit-lower L below the diagonal and U on and above it, perm
//            the row order (row i of P K is row perm[i] of K).  A zero
//            pivot divides by zero: Inf/NaN, as LAPACK-style LU gives.
//   solve:   x = U^-1 L^-1 b[perm] for b of (B, N).
//
// One instance does not fit a block: N = n + m = 300 at the headline is
// 360 KB in float32, N = 2250 (CVXQP2_M) 40 MB in float64.  So the factor
// works in device memory by column panels, a short sequence of launches
// per panel, all enqueued by one C call.  Two entry points: K itself
// (osqp_kkt_lu_factor, not written), or its blocks P, A, the shift s of
// P's diagonal and the (2,2) diagonal d (osqp_kkt_lu_factor_blocks:
// polish, which zeroes A's inactive rows, and the kkt_lu backend), whose
// first pass reads the blocks where it would read K (Source::at: each
// entry one rounding, as form_kkt forms it), so K is never formed.  Two
// paths, by batch:
//
// Batches that fill the card (B >= SMs, the headline), per panel of W =
// 64 columns (32, 16 or 8 where a panel of 64 would keep two blocks off
// an SM: float64 at N = 300; spilled to device memory where no panel
// fits), two launches:
//   1. bpanel_kernel, one block per instance: the panel's rows [k0, N)
//      staged in shared memory by cp.async (no register round trip, so a
//      thread's copies are all in flight at once), rows relabelled, not
//      moved.  The columns go by sub-panels of 16: a thread holds its rows
//      of the sub-panel in registers (up to 1024 rows: 1, 2 or 4 a
//      thread; above that the sweep reads shared memory), and a column
//      costs one block barrier: each warp reduces its candidates (integer
//      reductions on |value|'s bits) and its winner publishes its row of
//      the sub-panel; after the barrier every warp re-reduces the warps'
//      candidates, reads the pivot row and updates its rows, finding the
//      next column's candidates in the same sweep.  At the end of a
//      sub-panel its U12 and the rank-16 update of the rows below run
//      from shared memory.  The epilogue writes the panel in the factored
//      order, composes perm and lists the moved rows.
//   2. bupdate_kernel, a block per strip of 64 columns of an instance:
//      the moved rows on the strip (left of the panel that is all), then
//      right of it U12 = L11^-1 A12 (four lanes a column, rows by
//      shuffle) and A22 -= L21 U12 by chunks of 128 rows, 4 x 8 values a
//      thread, 16-byte shared loads, the next chunk of L21 staged
//      (cp.async, transposed) while this one is used, and the trailing
//      values read and written 16 bytes at a time where rows are aligned.
//      The first pass reads K (or the blocks) through the moves instead
//      of moving it.
// So a factor at N = 300 is 10 launches, the trailing matrix crosses
// device memory 4 times and no row exchange is a pass of its own.  The panel's column steps are latency-bound (a chain of
// warp reductions, a barrier, shared-memory round trips and a division
// per column, with the shared memory of a 64-column panel leaving two
// instances an SM); the update's mul and sub are issued separately.
//
// Batches that cannot fill the card (B < SMs: polish's B = 1), where one
// instance must spread over the card:
//   - cluster_panel_kernel factors a panel 32 columns wide (16 or 8 where
//     the cluster's shared memory cannot hold 32) in a thread-block
//     cluster of up to 16 CTAs per instance, one row of the panel per
//     thread (so N <= 16 x 256 rows on this path).  Per column the pivot
//     search reduces within each CTA; every CTA publishes its candidate
//     and that row's values in its shared memory, and after one cluster
//     barrier every CTA reads all of them through distributed shared
//     memory.  Rows are not moved: a thread keeps its row's place in the
//     factored order, the pivot row and the row it displaces trade
//     places, and the panel goes back to device memory in that order at
//     the end.  A column costs one cluster barrier (a relaxed arrive
//     behind a CTA-scope fence: what crosses it is shared memory alone),
//     one round of remote reads and three block barriers, and writes
//     nothing to device memory.
//   - The same kernel first brings its columns up to date with the
//     previous panel: that panel's exchanges, its U12 block on these
//     columns and the rank-32 update of the rows below.  So the side
//     stream is a chain of panel kernels; on the caller's stream each
//     panel's exchanges and U12 for the other columns (swap_solve_kernel)
//     and its trailing update run beside the next panel, ordered by
//     events.  A panel costs three launches.
//   - A zero multiplier is computed directly (quotient()): the card's
//     division takes a slow path for a zero dividend, and most
//     multipliers of a KKT matrix are zero.
//
// Every value takes its updates in the order of the unblocked
// right-looking algorithm, a_ic <- a_ic - l_ik u_kc for k = 0, 1, ...,
// each product and difference rounded on its own.  Neither path changes
// that: a panel's columns are the unblocked algorithm on its rows (by
// sub-panels, each value still takes its k in order), U12's solves and
// the trailing updates subtract in increasing k, and the updates split
// by strips or in two touch each value once.  So the factors, and with them
// every pivot choice, are bit for bit those of the plain PyTorch version
// (ops/kkt_lu.py:kkt_lu_factor_plain), and two launches agree bit for
// bit: nothing here is atomic on floating values.
//
// The solve, where the batch fills the card, is one block per instance
// with the right-hand side in shared memory: by groups of 32 rows, every
// warp takes dot products of the rows' off-diagonal parts against the
// entries already solved, then one warp solves the 32 x 32 diagonal block
// by shuffles.  Where it cannot (B < SMs), each triangle is one launch of
// strip_solve_kernel: a block takes a strip of 32 rows of one instance,
// reads its rows' off-diagonal parts against the strips already solved as
// each is published (a flag per strip in device memory, release on write,
// acquire on read), and solves its 32 x 32 diagonal block.  Both triangles
// stream through every SM, and only the diagonal solves form a chain of
// N / 32.  Blocks take strips by an integer ticket in order, so a strip
// waits only on strips that running blocks hold: no grid needs to be
// resident at once.  Its sums run in another order than the plain
// version's (dot products by rows), but in a fixed one: two launches
// agree bit for bit.
//
// What bounds them on the H100: the factor does (2/3) N^3 operations an
// instance, issued as separate multiplies and subtractions (no FMA: twice
// the time of chip_smoke.bound's operations figure), and at the headline
// those, not its bytes, set the floor: the update kernel's inner loop is
// 32 multiply-subtracts for three 16-byte shared loads.  At B = 1 the
// chain of N pivot columns sets it: a cluster barrier, a round of remote
// reads and three block barriers per column, some 2.8 us all told,
// against 0.2 ms of operations for the whole factor at N = 2250 in
// float64.  The solve reads lu once and is bound by those bytes; at B = 1
// by its chain of 2 N / 32 diagonal solves, each behind a flag.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <mutex>

#include "common.cuh"

namespace {

using osqp_cuda::allow_smem;
using osqp_cuda::copy_async;
using osqp_cuda::copy_async_wait;
using osqp_cuda::kThreads;
using osqp_cuda::kWarps;
using osqp_cuda::mul;
using osqp_cuda::sub;

constexpr int kMaxNB = 32;     // widest panel of the cluster path
constexpr int kMinNB = 8;      // narrowest panel of the cluster path
constexpr int kMaxBatchedW = 64;  // widest panel of the batched path
constexpr int kTile = 64;      // edge of a tile of the cluster path's trailing update
constexpr int kSolveRows = 32;  // rows of a group of the solve
constexpr int kSolveThreadsWide = 1024;  // launch bound of lu_solve_kernel
constexpr int kClusterMax = 16;         // CTAs of a panel's cluster at most (non-portable above 8)
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory a batched panel may take: what a block may use, less the
// kernel's static shared memory.
constexpr size_t kPanelSmem = osqp_cuda::kMaxSmem - 4096;
// The same for the cluster panel, whose static shared memory is larger.
constexpr size_t kClusterSmem = osqp_cuda::kMaxSmem - 4096;

template <typename T>
__device__ __forceinline__ T absval(T v) {
  return v < T(0) ? -v : v;
}

// a / d, correctly rounded.  A zero a over a finite nonzero d is the zero
// of sign sign(a) sign(d), as IEEE 754 divides, given here directly: the
// card's division takes a slow path (several times the cost) for a zero
// dividend, and most multipliers of a KKT matrix are zero.
template <typename T>
__device__ __forceinline__ T quotient(T a, T d) {
  if (a == T(0) && d != T(0) && isfinite(d))
    return (signbit(a) != signbit(d)) ? -T(0) : T(0);
  return a / d;
}

// The pivot searches compare keys: |value|'s bits plus one
// (bits of non-negative floats order as the values do), 0 for a NaN or
// for no candidate.  Of equal keys the smallest tie wins, where the tie
// carries the logical row: so the winner is the first row of largest
// |value|, and a warp finds it with the integer reductions.
template <typename T>
__device__ __forceinline__ unsigned long long pivot_key(T v, bool candidate) {
  if constexpr (sizeof(T) == 4) {
    const unsigned bits = __float_as_uint(v) & 0x7fffffffu;
    return candidate && bits <= 0x7f800000u ? bits + 1ull : 0ull;
  } else {
    const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(v)) & 0x7fffffffffffffffull;
    return candidate && bits <= 0x7ff0000000000000ull ? bits + 1ull : 0ull;
  }
}

// The warp's largest key and, of the lanes that hold it, the smallest
// tie, in every lane.
template <typename T>
__device__ __forceinline__ void warp_best(unsigned long long key, unsigned tie, unsigned long long& best,
                                          unsigned& best_tie) {
  if constexpr (sizeof(T) == 4) {
    best = __reduce_max_sync(kFull, static_cast<unsigned>(key));
  } else {
    const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
    const unsigned mh = __reduce_max_sync(kFull, hi);
    best = (static_cast<unsigned long long>(mh) << 32) | __reduce_max_sync(kFull, hi == mh ? lo : 0u);
  }
  best_tie = __reduce_min_sync(kFull, key == best ? tie : UINT_MAX);
}

// v[0..V) <- p[0..V), by 16-byte loads (p 16-byte aligned).
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const double2 f = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// p[0..V) <- v[0..V), by 16-byte stores (p 16-byte aligned).
template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], v[2 * i + 1]);
  }
}

// Where a factor's first pass reads K: from lu itself (kLu, every later
// pass too), from a separate K, or from the blocks of
// K = [[P + s I, A'], [A, -diag(d)]] (kBlocks).  Every entry of K is the
// blocks' entry or one rounding of it, as form_kkt computes it: P + s
// (P + 0 off the diagonal), A, -d.
enum SourceKind { kLu = 0, kSeparate = 1, kBlocks = 2 };

template <typename T>
struct Source {
  int kind;
  const T* K;     // kSeparate: (B, N, N)
  const T* P;     // kBlocks: (B, n, n)
  const T* A;     // (B, m, n)
  const T* d;     // (B, m)
  T s;
  int n, m;

  // K[r][c] of instance b, for r, c < N
  __device__ __forceinline__ T at(const T* lu, size_t b, int r, int c, int N) const {
    if (kind == kLu) return lu[(b * N + r) * N + c];
    if (kind == kSeparate) return K[(b * N + r) * N + c];
    if (r < n) {
      if (c < n) return osqp_cuda::add(P[(b * n + r) * n + c], r == c ? s : T(0));
      return A[(b * m + (c - n)) * n + r];
    }
    if (c < n) return A[(b * m + (r - n)) * n + c];
    return r == c ? -d[b * m + (r - n)] : T(0);
  }
  // K of instance b where K is an array (kLu, kSeparate), else null
  __device__ __forceinline__ const T* array(const T* lu, size_t b, int N) const {
    return kind == kLu ? lu + b * N * N : kind == kSeparate ? K + b * N * N : nullptr;
  }
};

// ---------------------------------------------------------------------------
// Batches that fill the card: a panel kernel and an update kernel a panel
// ---------------------------------------------------------------------------

constexpr int kSub = 16;          // columns of a sub-panel of the batched panel
constexpr int kStrip = 64;        // columns of a strip of the batched update
constexpr int kChunk = 128;       // rows of L21 a strip stages at once
constexpr int kChunkLd = kChunk + 4;
constexpr int kMoveInts = 1 + 4 * kMaxBatchedW;  // a panel's moved rows: count, then (to, from) pairs
constexpr size_t kPanelPair = (kPanelSmem - 1024) / 2;  // a panel that lets two blocks share an SM

__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) / 16 * 16; }

// Dynamic shared memory of a batched panel of `rows` rows and `w`
// columns: three int arrays by row (label, row of a label, scratch), then
// the panel's values unless they spill to device memory.
template <typename T>
size_t bpanel_bytes(int rows, int w, bool spill) {
  return align16(3 * sizeof(int) * static_cast<size_t>(rows)) +
         (spill ? 0 : sizeof(T) * static_cast<size_t>(rows) * (w | 1));
}

// Dynamic shared memory of a batched update behind a panel of W columns:
// L21 by chunks (transposed, two buffers), U12 on the strip, L11, the
// gathered rows.
template <typename T, int W>
size_t bupdate_bytes(int rows) {
  return sizeof(T) * (2 * static_cast<size_t>(W) * kChunkLd + W * kStrip + W * (W + 1)) + sizeof(int) * rows;
}

// Factor the panel of columns [k0, k0 + w) of instance blockIdx.x, rows
// [k0, N), in shared memory (in `spill`, one (N - k0) x (w | 1) block an
// instance, where it does not fit).
//
// Rows are not moved: physical row r keeps its place, lab[r] is its
// place in the factored order.  At column j the pivot, the first logical
// row of largest |value| among rows j.., takes label j and the row that
// held label j takes the pivot's, as the plain version swaps the rows.
// Per column: each warp reduces its threads' candidates (integer
// reductions on |value|'s bits, pivot_key), one block barrier, every warp
// re-reduces the warps' candidates, and each thread updates its rows and
// finds its candidate for the next column in the same sweep.  With R > 0
// thread t holds rows t + kThreads i (i < R) of the sub-panel in
// registers, and each warp's winner publishes its row beside its key;
// with R = 0 (more than 4 kThreads rows) the sweep works in place.
//
// The columns go by sub-panels of kSub: a column's update reaches the
// columns of its sub-panel only; at the end of a sub-panel its rows of
// U12 on the panel's later columns are solved (a thread a column) and the
// rows below take the rank-kSub update, two rows by eight columns a
// thread.  Every value so takes its updates in increasing k.
//
// The epilogue writes the panel back in the factored order, perm composed
// with the panel's exchanges, and the moved rows as (to, from) pairs into
// `moves`, for the update kernel to carry to the other columns.
// In float32 a panel of at most kThreads rows keeps its registers to
// three blocks an SM, a taller one to two.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? (R == 1 ? 3 : 2) : 1)
    bpanel_kernel(T* lu, Source<T> src, int* __restrict__ moves, int* __restrict__ perm, T* spill, int N, int k0,
                  int w) {
  extern __shared__ __align__(16) unsigned char bp_smem[];
  __shared__ unsigned long long s_key[2][kWarps];
  __shared__ unsigned s_tie[2][kWarps];
  __shared__ int s_row[2][kWarps];
  __shared__ T s_crow[2][kWarps][kSub];
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const int rows = N - k0, ld = w | 1;  // odd: a thread per row reads a column without bank conflicts
  int* lab = reinterpret_cast<int*>(bp_smem);
  int* where = lab + rows;
  int* tmp = where + rows;
  T* p = spill ? spill + b * rows * ld : reinterpret_cast<T*>(bp_smem + align16(3 * sizeof(int) * rows));
  T* M = lu + b * N * N;
  if (tid == 0) s_count = 0;
  const T* Ks = src.array(lu, b, N);
  for (int r = warp; r < rows; r += kWarps) {
    for (int c = lane; c < w; c += 32) {
      if (Ks && !spill)
        copy_async(p + r * ld + c, Ks + static_cast<size_t>(k0 + r) * N + k0 + c);
      else
        p[r * ld + c] = src.at(lu, b, k0 + r, k0 + c, N);
    }
  }
  copy_async_wait();
  __syncthreads();

  // this thread's candidate for the next column: key, logical row, and
  // its row (R > 0: which of the thread's rows)
  unsigned long long key = 0;
  unsigned tie = UINT_MAX;
  int row = 0;
  auto offer = [&](T v, int lg, int r) {
    const unsigned long long k = pivot_key(v, true);
    if (k > key || (k == key && k != 0 && static_cast<unsigned>(lg) < tie)) {
      key = k;
      tie = lg;
      row = r;
    }
  };
  for (int r = tid; r < rows; r += kThreads) {
    lab[r] = r;
    if constexpr (R == 0) offer(p[r * ld], r, r);
  }
  const T nan = T(0) / T(0);
  for (int q0 = 0; q0 < w; q0 += kSub) {
    const int q1 = min(q0 + kSub, w);
    if constexpr (R > 0) {
      // Rows tid + kThreads i of the sub-panel in registers; each warp's
      // candidate publishes its row with its key, so the pivot row is read
      // after the one barrier of the column.
      T seg[R][kSub];
      int lr[R];
      key = 0;
      tie = UINT_MAX;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = tid + i * kThreads;
        lr[i] = r < rows ? lab[r] : -1;
#pragma unroll
        for (int c = 0; c < kSub; ++c) seg[i][c] = r < rows && q0 + c < q1 ? p[r * ld + q0 + c] : T(0);
        if (lr[i] >= q0) offer(seg[i][0], lr[i], i);
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = q0 + jj;
        if (j >= q1) break;
        const int par = j & 1;
        unsigned long long kb;
        unsigned tb;
        warp_best<T>(key, key ? tie : UINT_MAX, kb, tb);
        const unsigned who = __ballot_sync(kFull, kb != 0 && key == kb && tie == tb);
        if (who && lane == __ffs(who) - 1) {
#pragma unroll
          for (int i = 0; i < R; ++i) {
            if (i == row) {
#pragma unroll
              for (int c = 0; c < kSub; ++c) s_crow[par][warp][c] = seg[i][c];
            }
          }
        }
        if (lane == 0) {
          s_key[par][warp] = kb;
          s_tie[par][warp] = tb;
        }
        __syncthreads();
        const unsigned long long wk = lane < kWarps ? s_key[par][lane] : 0ull;
        warp_best<T>(wk, wk ? s_tie[par][lane] : UINT_MAX, kb, tb);
        const unsigned won = __ballot_sync(kFull, kb != 0 && wk == kb && lane < kWarps && s_tie[par][lane] == tb);
        // No candidate: every live value of the column is NaN; row j stays
        // and the pivot row is taken as NaN.
        const int pr = kb ? static_cast<int>(tb) : j;
        const T* top = kb ? s_crow[par][__ffs(won) - 1] : nullptr;
        T tv[kSub];
#pragma unroll
        for (int c = 0; c < kSub; ++c) tv[c] = top && c >= jj && q0 + c < q1 ? top[c] : nan;
        key = 0;
        tie = UINT_MAX;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = tid + i * kThreads;
          if (r < rows) {
            int lg = lr[i];
            lg = lg == pr ? j : (lg == j ? pr : lg);
            lr[i] = lg;
            if (lg == j) where[j] = r;
            if (lg > j) {
              const T l = quotient(seg[i][jj], tv[jj]);
              seg[i][jj] = l;
#pragma unroll
              for (int c = jj + 1; c < kSub; ++c)
                if (q0 + c < q1) seg[i][c] = sub(seg[i][c], mul(l, tv[c]));
              if (j + 1 < q1) offer(seg[i][jj + 1], lg, i);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = tid + i * kThreads;
        if (r < rows) {
          lab[r] = lr[i];
#pragma unroll
          for (int c = 0; c < kSub; ++c)
            if (q0 + c < q1) p[r * ld + q0 + c] = seg[i][c];
        }
      }
    } else {
      for (int j = q0; j < q1; ++j) {
        const int par = j & 1;
        unsigned long long kb;
        unsigned tb;
        warp_best<T>(key, key ? tie : UINT_MAX, kb, tb);
        unsigned who = __ballot_sync(kFull, kb != 0 && key == kb && tie == tb);
        int at = __shfl_sync(kFull, row, who ? __ffs(who) - 1 : 0);
        if (lane == 0) {
          s_key[par][warp] = kb;
          s_tie[par][warp] = tb;
          s_row[par][warp] = at;
        }
        __syncthreads();
        const unsigned long long wk = lane < kWarps ? s_key[par][lane] : 0ull;
        warp_best<T>(wk, wk ? s_tie[par][lane] : UINT_MAX, kb, tb);
        who = __ballot_sync(kFull, kb != 0 && wk == kb && lane < kWarps && s_tie[par][lane] == tb);
        // No candidate: every live value of the column is NaN; row j stays
        // and the pivot row is taken as NaN.
        const int pr = kb ? static_cast<int>(tb) : j;
        const T* top = kb ? p + s_row[par][__ffs(who) - 1] * ld + q0 : nullptr;
        const T d = top ? top[j - q0] : nan;
        // the pivot row on the sub-panel, once for this thread's rows; the
        // row update unrolled over the sub-panel, so that its loads issue
        // together
        T tv[kSub];
#pragma unroll
        for (int c = 0; c < kSub; ++c) tv[c] = top && q0 + c > j && q0 + c < q1 ? top[c] : nan;
        key = 0;
        tie = UINT_MAX;
        for (int r = tid; r < rows; r += kThreads) {
          int lg = lab[r];
          lg = lg == pr ? j : (lg == j ? pr : lg);
          lab[r] = lg;
          if (lg == j) where[j] = r;
          if (lg > j) {
            T* row_ = p + r * ld + q0;
            const T l = quotient(row_[j - q0], d);
            row_[j - q0] = l;
#pragma unroll
            for (int c = 0; c < kSub; ++c)
              if (q0 + c > j && q0 + c < q1) row_[c] = sub(row_[c], mul(l, tv[c]));
            if (j + 1 < q1) offer(row_[j + 1 - q0], lg, r);
          }
        }
      }
    }
    if (q1 == w) break;
    __syncthreads();
    // U12 of the sub-panel on the columns [q1, w): u <- L11^-1 u
    if (tid < w - q1) {
      const int c = q1 + tid;
      T u[kSub];
      const T* at[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        at[i] = p + where[q0 + i] * ld;
        u[i] = at[i][c];
      }
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
#pragma unroll
        for (int i = k + 1; i < kSub; ++i) u[i] = sub(u[i], mul(at[i][q0 + k], u[k]));
      }
#pragma unroll
      for (int i = 1; i < kSub; ++i) p[where[q0 + i] * ld + c] = u[i];
    }
    __syncthreads();
    // the rows below it (labels >= q1): a -= L21 U12, two rows and eight
    // columns a thread
    {
      const int groups = (w - q1 + 7) / 8, tiles = kThreads / groups;
      const int g = tid % groups, t = tid / groups, c0 = q1 + 8 * g;
      if (t < tiles) {
        for (int r0 = 2 * t; r0 < rows; r0 += 2 * tiles) {
          bool live[2];
          T acc[2][8];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            live[i] = r0 + i < rows && lab[r0 + i] >= q1;
#pragma unroll
            for (int v = 0; v < 8; ++v) acc[i][v] = live[i] && c0 + v < w ? p[(r0 + i) * ld + c0 + v] : T(0);
          }
          if (!live[0] && !live[1]) continue;
#pragma unroll 4
          for (int k = 0; k < kSub; ++k) {
            const T* uk = p + where[q0 + k] * ld + c0;
            T a[2], uv[8];
#pragma unroll
            for (int i = 0; i < 2; ++i) a[i] = live[i] ? p[(r0 + i) * ld + q0 + k] : T(0);
#pragma unroll
            for (int v = 0; v < 8; ++v) uv[v] = c0 + v < w ? uk[v] : T(0);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int v = 0; v < 8; ++v) acc[i][v] = sub(acc[i][v], mul(a[i], uv[v]));
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int v = 0; v < 8; ++v)
              if (live[i] && c0 + v < w) p[(r0 + i) * ld + c0 + v] = acc[i][v];
          }
        }
      }
    }
    __syncthreads();
    if constexpr (R == 0) {
      for (int r = tid; r < rows; r += kThreads) {
        if (lab[r] >= q1) offer(p[r * ld + q1], lab[r], r);
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) where[lab[r]] = r;
  __syncthreads();
  for (int i = warp; i < rows; i += kWarps) {
    const T* from = p + where[i] * ld;
    for (int c = lane; c < w; c += 32) M[static_cast<size_t>(k0 + i) * N + k0 + c] = from[c];
  }
  int* mv = moves + b * kMoveInts;
  int* pm = perm + b * N;
  for (int i = tid; i < rows; i += kThreads) {
    const int from = where[i];
    tmp[i] = k0 == 0 ? from : pm[k0 + from];
    if (from != i) {
      const int slot = atomicAdd(&s_count, 1);
      mv[1 + 2 * slot] = k0 + i;
      mv[2 + 2 * slot] = k0 + from;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows; i += kThreads) pm[k0 + i] = tmp[i];
  if (tid == 0) mv[0] = s_count;
}

// Behind the panel [k0, k0 + w) of instance blockIdx.x / strips: strip
// blockIdx.x % strips of kStrip columns, the first `left` strips over
// the columns [0, k0), the others over [k0 + w, N).
//
// Every strip first carries the panel's moved rows to its columns (read
// all, then write all: the strip's columns belong to this block alone).
// A strip right of the panel then solves its columns of U12 = L11^-1 A12
// (four threads a column, lane g holding the rows g, g + 4, ...: the
// entry of row k comes by shuffle) and takes A22 -= L21 U12 by chunks of
// kChunk rows, L21 staged transposed in shared memory, four rows by
// eight columns a thread, subtracting in increasing k.  In the first
// pass (src not lu) the strip reads K through the moves instead of moving
// it first: the source is not written.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads) bupdate_kernel(T* lu, Source<T> src, const int* __restrict__ moves,
                                                           int N, int k0, int left, int strips) {
  extern __shared__ __align__(16) unsigned char bu_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x / strips;
  const int strip = blockIdx.x - static_cast<int>(b) * strips;
  const int k1 = k0 + W, rows = N - k0;
  const bool right = strip >= left;
  const int c0 = right ? k1 + (strip - left) * kStrip : strip * kStrip;
  const int ce = min(c0 + kStrip, right ? N : k0);
  const int cols = ce - c0;
  T* Lt = reinterpret_cast<T*>(bu_smem);  // [2][W][kChunkLd]; first the moved rows' values
  T* Us = Lt + 2 * W * kChunkLd;          // [W][kStrip]
  T* L11 = Us + W * kStrip;               // [W][W + 1]
  int* from = reinterpret_cast<int*>(L11 + W * (W + 1));  // [rows]: the row whose values logical row i takes
  T* M = lu + b * N * N;
  const int* mv = moves + b * kMoveInts;
  const int count = mv[0];
  const bool gather = src.kind != kLu;
  if (gather) {
    for (int i = tid; i < rows; i += kThreads) from[i] = i;
    __syncthreads();
    for (int e = tid; e < count; e += kThreads) from[mv[1 + 2 * e] - k0] = mv[2 + 2 * e] - k0;
  } else if (count > 0) {
    for (int i = warp; i < count; i += kWarps) {
      const T* from = M + static_cast<size_t>(mv[2 + 2 * i]) * N + c0;
      for (int c = lane; c < cols; c += 32) copy_async(Lt + i * kStrip + c, from + c);
    }
    copy_async_wait();
    __syncthreads();
    for (int i = warp; i < count; i += kWarps) {
      T* to = M + static_cast<size_t>(mv[1 + 2 * i]) * N + c0;
      for (int c = lane; c < cols; c += 32) to[c] = Lt[i * kStrip + c];
    }
  }
  if (!right) return;
  // L21's rows [r0, r0 + kChunk) into chunk buffer `buf`, transposed
  auto stage = [&](int r0, int buf) {
    T* to = Lt + buf * W * kChunkLd;
    const int nr = min(kChunk, N - r0);
    for (int i = warp; i < nr; i += kWarps) {
      const T* from = M + static_cast<size_t>(r0 + i) * N + k0;
      for (int k = lane; k < W; k += 32) copy_async(to + k * kChunkLd + i, from + k);
    }
  };
  __syncthreads();  // the moves' staging area is free
  for (int i = warp; i < W; i += kWarps) {
    const T* from = M + static_cast<size_t>(k0 + i) * N + k0;
    for (int k = lane; k < W; k += 32) copy_async(L11 + i * (W + 1) + k, from + k);
  }
  stage(k1, 0);
  copy_async_wait();
  __syncthreads();
  // the value of logical row r (>= k0) in column c as this pass finds it
  auto value = [&](int r, int c) -> T {
    return gather ? src.at(lu, b, k0 + from[r - k0], c, N) : M[static_cast<size_t>(r) * N + c];
  };

  // U12 on columns c0 + 8 warp + lane % 8
  {
    constexpr int kPer = W / 4;
    const int cl = warp * 8 + (lane & 7), g = lane >> 3;
    const int c = c0 + cl;
    const bool have = cl < cols;
    T u[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) u[t] = have ? value(k0 + g + 4 * t, c) : T(0);
#pragma unroll
    for (int k = 0; k < W - 1; ++k) {
      const T uk = __shfl_sync(kFull, u[k >> 2], ((k & 3) << 3) | (lane & 7));
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        if (4 * t + 3 <= k) continue;  // rows g + 4 t <= k for every g
        const int i = g + 4 * t;
        if (i > k) u[t] = sub(u[t], mul(L11[i * (W + 1) + k], uk));
      }
    }
    if (cl < kStrip) {
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int i = g + 4 * t;
        Us[i * kStrip + cl] = u[t];
        if (have) M[static_cast<size_t>(k0 + i) * N + c] = u[t];
      }
    }
  }

  // A22 -= L21 U12 by chunks of rows
  const bool aligned = N % (16 / sizeof(T)) == 0;  // c0 + cc is a multiple of 8
  const int rt = warp * 4 + (lane >> 3), cg = lane & 7;
  const int rr = 4 * rt, cc = 8 * cg;
  for (int r0 = k1, buf = 0; r0 < N; r0 += kChunk, buf ^= 1) {
    const int nr = min(kChunk, N - r0);
    copy_async_wait();
    __syncthreads();  // this chunk staged, Us written, the other buffer read
    if (r0 + kChunk < N) stage(r0 + kChunk, buf ^ 1);
    const T* Lc = Lt + buf * W * kChunkLd;
    if (rr >= nr || cc >= cols) continue;
    T acc[4][8];
    // whole 16-byte groups of a row where rows start aligned (N a multiple
    // of 16 / sizeof(T)), the strip's columns all present and no gather
    const bool vec = !gather && aligned && cc + 8 <= cols;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (rr + i >= nr) {
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[i][v] = T(0);
      } else if (vec) {
        load_vec<8>(M + static_cast<size_t>(r0 + rr + i) * N + c0 + cc, acc[i]);
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[i][v] = cc + v < cols ? value(r0 + rr + i, c0 + cc + v) : T(0);
      }
    }
#pragma unroll 4
    for (int k = 0; k < W; ++k) {
      T a[4], x[8];
      load_vec<4>(Lc + k * kChunkLd + rr, a);
      load_vec<8>(Us + k * kStrip + cc, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[i][v] = sub(acc[i][v], mul(a[i], x[v]));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (rr + i >= nr) continue;
      T* to = M + static_cast<size_t>(r0 + rr + i) * N + c0 + cc;
      if (aligned && cc + 8 <= cols) {
        store_vec<8>(to, acc[i]);
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v)
          if (cc + v < cols) to[v] = acc[i][v];
      }
    }
  }
}

// K into lu from its source, one pass: the batches that cannot fill the
// card factor in place.
template <typename T>
__global__ void form_kernel(T* lu, Source<T> src, int B, int N) {
  const size_t total = static_cast<size_t>(B) * N * N;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = e / (static_cast<size_t>(N) * N);
    const int rc = static_cast<int>(e - b * N * N), r = rc / N;
    lu[e] = src.at(lu, b, r, rc - r * N, N);
  }
}

// For every column outside the panel [k0, k0 + nb): the panel's row
// exchanges; and right of the panel, u <- L11^-1 u on the column's nb
// values.  Block (b, chunk) takes blockDim.x columns.
//
// The nb exchanges are composed first, once per block: they touch the
// panel's nb rows and at most nb rows below it, and afterwards row
// s_pos[i] holds what row s_src[i] held before.  So a thread loads all
// its values at once and stores them at once, where applying the
// exchanges one after another would be a chain of nb dependent round
// trips to device memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) swap_solve_kernel(T* __restrict__ lu, const int* __restrict__ piv, int N,
                                                              int k0, int nb, int skip, int chunks) {
  __shared__ T L11[kMaxNB][kMaxNB + 1];
  __shared__ int s_pos[2 * kMaxNB];  // [0, nb): the panel's rows; [nb, s_count): rows below it
  __shared__ int s_src[2 * kMaxNB];
  __shared__ int s_piv[kMaxNB];
  __shared__ int s_count;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int b = blockIdx.x / chunks, chunk = blockIdx.x - b * chunks;
  T* M = lu + static_cast<size_t>(b) * N * N;
  for (int e = tid; e < nb * nb; e += threads) {
    const int i = e / nb, j = e - i * nb;
    L11[i][j] = M[static_cast<size_t>(k0 + i) * N + k0 + j];
  }
  if (tid < nb) {
    s_pos[tid] = s_src[tid] = k0 + tid;
    s_piv[tid] = piv[static_cast<size_t>(b) * N + k0 + tid];
  }
  __syncthreads();
  if (tid == 0) {
    int count = nb;
    for (int j = 0; j < nb; ++j) {
      const int pr = s_piv[j];
      if (pr == k0 + j) continue;
      int at = pr - k0;
      if (at >= nb) {
        for (at = nb; at < count && s_pos[at] != pr; ++at) {
        }
        if (at == count) {
          s_pos[at] = s_src[at] = pr;
          ++count;
        }
      }
      const int a = s_src[j];
      s_src[j] = s_src[at];
      s_src[at] = a;
    }
    s_count = count;
  }
  __syncthreads();
  const int t = chunk * threads + tid;
  if (t >= N - nb - skip) return;
  const int c = t < k0 ? t : t + nb + skip;
  T* col = M + c;
  const int below = s_count - nb;
  T u[kMaxNB], w[kMaxNB];
#pragma unroll
  for (int i = 0; i < kMaxNB; ++i) u[i] = i < nb ? col[static_cast<size_t>(s_src[i]) * N] : T(0);
#pragma unroll
  for (int i = 0; i < kMaxNB; ++i) w[i] = i < below ? col[static_cast<size_t>(s_src[nb + i]) * N] : T(0);
  if (c >= k0) {
#pragma unroll
    for (int j = 0; j < kMaxNB; ++j) {
#pragma unroll
      for (int i = j + 1; i < kMaxNB; ++i)
        if (i < nb) u[i] = sub(u[i], mul(L11[i][j], u[j]));
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxNB; ++i)
    if (i < nb && (c >= k0 || s_src[i] != k0 + i)) col[static_cast<size_t>(k0 + i) * N] = u[i];
#pragma unroll
  for (int i = 0; i < kMaxNB; ++i)
    if (i < below) col[static_cast<size_t>(s_pos[nb + i]) * N] = w[i];
}

// A22 <- A22 - L21 U12 behind the panel [k0, k0 + nb), on the trailing
// rows and the columns [c_begin, c_end): block (b, ti, tj) takes a
// kTile x kTile tile, thread (ty, tx) the values at rows ty + 16 u and
// columns tx + 16 v, subtracting the products in the order of k.
template <typename T>
__global__ void __launch_bounds__(kThreads) update_kernel(T* __restrict__ lu, int N, int k0, int nb, int c_begin,
                                                          int c_end, int tiles_r, int tiles_c) {
  __shared__ T Ls[kTile][kMaxNB + 1];
  __shared__ T Us[kMaxNB][kTile];
  const int tid = threadIdx.x;
  const int per = tiles_r * tiles_c;
  const int b = blockIdx.x / per, t = blockIdx.x - b * per;
  const int ti = t / tiles_c, tj = t - ti * tiles_c;
  const int k1 = k0 + nb;
  const int r0 = k1 + ti * kTile, c0 = c_begin + tj * kTile;
  T* M = lu + static_cast<size_t>(b) * N * N;
  for (int e = tid; e < kTile * nb; e += kThreads) {
    const int i = e / nb, k = e - i * nb;
    Ls[i][k] = r0 + i < N ? M[static_cast<size_t>(r0 + i) * N + k0 + k] : T(0);
  }
  for (int e = tid; e < nb * kTile; e += kThreads) {
    const int k = e / kTile, j = e - k * kTile;
    Us[k][j] = c0 + j < c_end ? M[static_cast<size_t>(k0 + k) * N + c0 + j] : T(0);
  }
  __syncthreads();
  const int tx = tid & 15, ty = tid >> 4;
  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + ty + 16 * u, c = c0 + tx + 16 * v;
      acc[u][v] = (r < N && c < c_end) ? M[static_cast<size_t>(r) * N + c] : T(0);
    }
  }
  for (int k = 0; k < nb; ++k) {
    T a[4], w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = Ls[ty + 16 * u][k];
      w[u] = Us[k][tx + 16 * u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = sub(acc[u][v], mul(a[u], w[v]));
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + ty + 16 * u, c = c0 + tx + 16 * v;
      if (r < N && c < c_end) M[static_cast<size_t>(r) * N + c] = acc[u][v];
    }
  }
}

// perm from the pivots: start from the identity and exchange entries k
// and piv[k] for k = 0, 1, ..., one block per instance, in shared memory.
__global__ void perm_kernel(const int* __restrict__ piv, int* __restrict__ perm, int N) {
  extern __shared__ __align__(16) unsigned char perm_smem[];
  int* sp = reinterpret_cast<int*>(perm_smem);
  int* pv = sp + N;
  const size_t off = static_cast<size_t>(blockIdx.x) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sp[i] = i;
    pv[i] = piv[off + i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < N; ++k) {
      const int p = pv[k];
      if (p != k) {
        const int a = sp[k];
        sp[k] = sp[p];
        sp[p] = a;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) perm[off + i] = sp[i];
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// x = U^-1 L^-1 b[perm], one block per instance, the vector in shared
// memory.
template <typename T>
__global__ void __launch_bounds__(kSolveThreadsWide) lu_solve_kernel(const T* __restrict__ lu,
                                                                     const int* __restrict__ perm,
                                                                     const T* __restrict__ rhs, T* __restrict__ x,
                                                                     int N) {
  extern __shared__ __align__(16) unsigned char solve_smem[];
  __shared__ T D[kSolveRows][kSolveRows + 1];
  T* y = reinterpret_cast<T*>(solve_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * N;
  const T* M = lu + off * N;
  for (int i = tid; i < N; i += blockDim.x) y[i] = rhs[off + perm[off + i]];
  __syncthreads();

  // L y' = y, forwards by groups of rows [i0, i0 + nr)
  for (int i0 = 0; i0 < N; i0 += kSolveRows) {
    const int nr = min(kSolveRows, N - i0);
    for (int e = tid; e < nr * nr; e += blockDim.x) {
      const int i = e / nr, j = e - i * nr;
      D[i][j] = M[static_cast<size_t>(i0 + i) * N + i0 + j];
    }
    for (int r = warp; r < nr; r += warps) {
      const T* row = M + static_cast<size_t>(i0 + r) * N;
      T acc = T(0);
      for (int j = lane; j < i0; j += 32) acc += row[j] * y[j];
      acc = warp_sum(acc);
      if (lane == 0) y[i0 + r] -= acc;
    }
    __syncthreads();
    if (warp == 0) {
      T yl = lane < nr ? y[i0 + lane] : T(0);
      for (int j = 0; j < nr; ++j) {
        const T yj = __shfl_sync(kFull, yl, j);
        if (lane > j && lane < nr) yl -= D[lane][j] * yj;
      }
      if (lane < nr) y[i0 + lane] = yl;
    }
    __syncthreads();
  }

  // U x = y', backwards
  for (int i0 = ((N - 1) / kSolveRows) * kSolveRows; i0 >= 0; i0 -= kSolveRows) {
    const int nr = min(kSolveRows, N - i0);
    const int j0 = i0 + nr;
    for (int e = tid; e < nr * nr; e += blockDim.x) {
      const int i = e / nr, j = e - i * nr;
      D[i][j] = M[static_cast<size_t>(i0 + i) * N + i0 + j];
    }
    for (int r = warp; r < nr; r += warps) {
      const T* row = M + static_cast<size_t>(i0 + r) * N;
      T acc = T(0);
      for (int j = j0 + lane; j < N; j += 32) acc += row[j] * y[j];
      acc = warp_sum(acc);
      if (lane == 0) y[i0 + r] -= acc;
    }
    __syncthreads();
    if (warp == 0) {
      T yl = lane < nr ? y[i0 + lane] : T(0);
      for (int j = nr - 1; j >= 0; --j) {
        const T xj = __shfl_sync(kFull, lane == j ? yl / D[j][j] : T(0), j);
        if (lane == j) yl = xj;
        if (lane < j) yl -= D[lane][j] * xj;
      }
      if (lane < nr) y[i0 + lane] = yl;
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += blockDim.x) x[off + i] = y[i];
}


// ---------------------------------------------------------------------------
// Batches that cannot fill the card
// ---------------------------------------------------------------------------

// Shared memory of one CTA of a cluster panel: the rows of the previous
// panel's L21 of its slab (prev + 1 values each), that panel's U12 block
// on these columns (prev x nb) and its L11 (prev x prev), then `src` (the
// previous panel's exchanges over rows [k0 - prev, N), composed).  The
// panel's own rows live in registers, one per thread.
template <typename T>
size_t cluster_panel_bytes(int rows, int slab, int nb, int prev) {
  return sizeof(T) * (static_cast<size_t>(slab) * (nb + 1) + static_cast<size_t>(prev > 0 ? slab : 0) * (prev + 1) +
                      static_cast<size_t>(prev) * (nb + prev)) +
         sizeof(int) * (static_cast<size_t>(rows) + prev);
}

// row[c] -= l top[c] for c in (j, nb), each product and difference
// rounded on its own.
template <typename T>
__device__ __forceinline__ void row_update(T* __restrict__ row, const T* __restrict__ top, T l, int j, int nb) {
#pragma unroll 4
  for (int c = j + 1; c < nb; ++c) row[c] = sub(row[c], mul(l, top[c]));
}

template <typename T>
__device__ __forceinline__ void row_copy(T* __restrict__ to, const T* __restrict__ from, int nb) {
#pragma unroll 4
  for (int c = 0; c < nb; ++c) to[c] = from[c];
}


// Bring the columns [k0, k0 + nb) of instance blockIdx.x / C up to date
// with the previous panel [k0 - prev, k0) and factor them, rows [k0, N),
// in a cluster of C CTAs (kCluster; a single block otherwise, whose
// barriers are block barriers).
//
// Up to date: the previous panel's row exchanges (composed once into
// `src`), its U12 block on these columns (u <- L11^-1 u by columns, in
// every CTA; CTA 0 writes it back) and the rank-prev update of the rows
// below, a_ic -= l_ik u_kc in increasing k.  So on the caller's stream
// the previous panel's exchanges, U12 and update skip these columns.
//
// Factor: thread t of CTA q holds row q slab + t of the panel in
// registers (slab <= kThreads), and `lg`, its place in the factored order
// (its logical row).  At column j the pivot, the first logical row of
// largest |value| among rows j.., trades places with logical row j, as
// the plain version swaps the rows; the rows and the pivots are written
// back at the end.  Each CTA publishes its candidate for the next column
// and that row's values in one of two slots (by the parity of the
// column); every CTA reads all of them after one cluster barrier.  So a
// column costs one cluster barrier, one round of reads of other CTAs'
// shared memory and three block barriers, and the loop writes nothing to
// device memory, so the barrier's release waits on shared memory alone.
template <typename T, bool kCluster>
__global__ void __launch_bounds__(kThreads) cluster_panel_kernel(T* __restrict__ lu, int* __restrict__ piv, int N,
                                                                 int k0, int nb, int prev, int slab) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char cpanel_smem[];
  __shared__ unsigned long long s_wkey[kWarps], s_cand[2];
  __shared__ unsigned s_wtie[kWarps];
  __shared__ int s_cand_idx[2];
  __shared__ T s_crow[2][kMaxNB];
  __shared__ T s_top[kMaxNB];
  __shared__ int s_piv[kMaxNB];
  int C = 1, rank = 0;
  if constexpr (kCluster) {
    C = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  // The cluster barrier of the loop.  What other CTAs read after it is
  // shared memory alone, so a CTA-scope fence makes this CTA's writes
  // visible (performed at its shared memory, where remote reads are
  // served) before a relaxed arrive: cluster.sync()'s release fences at
  // device scope and costs three times as much per column.
  auto sync_all = [&]() {
    if constexpr (kCluster) {
      asm volatile("fence.acq_rel.cta;\n" ::: "memory");
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    } else {
      __syncthreads();
    }
  };
  auto in_rank = [&](auto* ptr, int q) {
    if constexpr (kCluster)
      return cg::this_cluster().map_shared_rank(ptr, q);
    else
      return ptr;
  };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / C;
  const int rows = N - k0, kp = k0 - prev, lld = prev + 1;
  const int r0 = rank * slab;
  const bool have = tid < slab && r0 + tid < rows;  // this thread holds a row
  const int ld = nb + 1;  // odd: a thread per row reads a column without bank conflicts
  T* rowp = reinterpret_cast<T*>(cpanel_smem);
  T* L21 = rowp + static_cast<size_t>(slab) * ld;
  T* U = L21 + static_cast<size_t>(prev > 0 ? slab : 0) * lld;
  T* L = U + static_cast<size_t>(prev) * nb;
  int* src = reinterpret_cast<int*>(L + static_cast<size_t>(prev) * prev);
  T* M = lu + static_cast<size_t>(b) * N * N;

  if (prev > 0) {
    for (int i = tid; i < rows + prev; i += kThreads) src[i] = i;
    for (int e = tid; e < prev * prev; e += kThreads) {
      const int i = e / prev, j = e - i * prev;
      L[e] = M[static_cast<size_t>(kp + i) * N + kp + j];
    }
    const int mine = max(0, min(slab, rows - r0));
    for (int e = tid; e < mine * prev; e += kThreads) {
      const int r = e / prev, k = e - r * prev;
      L21[r * lld + k] = M[static_cast<size_t>(k0 + r0 + r) * N + kp + k];
    }
    if (tid < prev) s_piv[tid] = piv[static_cast<size_t>(b) * N + kp + tid] - kp;
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < prev; ++j) {
        const int pr = s_piv[j];
        const int a = src[j];
        src[j] = src[pr];
        src[pr] = a;
      }
    }
    __syncthreads();
    if (tid < nb) {
      T u[kMaxNB];
#pragma unroll
      for (int i = 0; i < kMaxNB; ++i) u[i] = i < prev ? M[static_cast<size_t>(kp + src[i]) * N + k0 + tid] : T(0);
#pragma unroll
      for (int j = 0; j < kMaxNB; ++j) {
#pragma unroll
        for (int i = j + 1; i < kMaxNB; ++i)
          if (i < prev) u[i] = sub(u[i], mul(L[i * prev + j], u[j]));
      }
#pragma unroll
      for (int i = 0; i < kMaxNB; ++i)
        if (i < prev) U[i * nb + tid] = u[i];
    }
    __syncthreads();
  }

  // this thread's row: staged (through the previous panel's exchanges)
  // and brought up to date by the previous panel's update
  T* row = rowp + tid * ld;
  int lg = have ? r0 + tid : INT_MAX;
  if (have) {
    const T* from = M + static_cast<size_t>(prev > 0 ? kp + src[prev + lg] : k0 + lg) * N + k0;
    T a[kMaxNB];
#pragma unroll
    for (int c = 0; c < kMaxNB; ++c) a[c] = c < nb ? from[c] : T(0);
    if (prev > 0) {
      const T* l21 = L21 + tid * lld;
#pragma unroll 4
      for (int k = 0; k < prev; ++k) {
        const T l = l21[k];
        const T* uk = U + k * nb;
#pragma unroll
        for (int c = 0; c < kMaxNB; ++c)
          if (c < nb) a[c] = sub(a[c], mul(l, uk[c]));
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxNB; ++c)
      if (c < nb) row[c] = a[c];
  }

  // This CTA's candidate (its key and logical row) and that row's values
  // into slot `slot`.  The tie is the logical row times kThreads plus the
  // thread, which holds the row (logical rows < 2^20 on this path).
  auto publish = [&](unsigned long long key, int slot) {
    unsigned long long kb;
    unsigned tb;
    warp_best<T>(key, key ? static_cast<unsigned>(lg) * kThreads + tid : UINT_MAX, kb, tb);
    if (lane == 0) {
      s_wkey[warp] = kb;
      s_wtie[warp] = tb;
    }
    __syncthreads();
    if (warp == 0) {
      warp_best<T>(lane < kWarps ? s_wkey[lane] : 0ull, lane < kWarps ? s_wtie[lane] : UINT_MAX, kb, tb);
      if (kb && lane < nb) s_crow[slot][lane] = rowp[(tb % kThreads) * ld + lane];
      if (lane == 0) {
        s_cand[slot] = kb;
        s_cand_idx[slot] = kb ? static_cast<int>(tb / kThreads) : INT_MAX;
      }
    }
  };
  publish(have ? pivot_key(row[0], true) : 0ull, 0);
  sync_all();

  for (int j = 0; j < nb; ++j) {
    const int slot = j & 1;
    if (warp == 0) {
      // the cluster's pivot: every lane reduces the C candidates alike;
      // lane c holds column c of every CTA's candidate row
      unsigned long long key = 0;
      int cidx = INT_MAX;
      T cr[kClusterMax];
      if (lane < C) {
        key = *in_rank(&s_cand[slot], lane);
        cidx = *in_rank(&s_cand_idx[slot], lane);
      }
#pragma unroll
      for (int q = 0; q < kClusterMax; ++q) cr[q] = q < C && lane < nb ? in_rank(&s_crow[slot][0], q)[lane] : T(0);
      unsigned long long kb;
      unsigned tb;
      warp_best<T>(key, key ? static_cast<unsigned>(cidx) : UINT_MAX, kb, tb);
      const int idx = kb ? static_cast<int>(tb) : INT_MAX;
      const int own = key ? cidx : INT_MAX;
      // No candidate: every live value of the column is NaN.  Then every
      // multiplier is NaN whatever the pivot row, so row j stays and the
      // pivot row is taken as NaN.
      T t = T(0) / T(0);
      if (idx != INT_MAX) {
        const int won = __ffs(__ballot_sync(kFull, lane < C && own == idx)) - 1;
#pragma unroll
        for (int q = 0; q < kClusterMax; ++q)
          if (q == won) t = cr[q];
      }
      if (lane < nb) s_top[lane] = t;
      if (lane == 0) s_piv[j] = idx == INT_MAX ? j : idx;
    }
    __syncthreads();
    const int pr = s_piv[j];
    unsigned long long key = 0;
    if (have) {
      lg = lg == pr ? j : (lg == j ? pr : lg);
      if (lg > j) {
        const T l = quotient(row[j], s_top[j]);
        row[j] = l;
        row_update(row, s_top, l, j, nb);
        key = pivot_key(row[j + 1], j + 1 < nb);
      }
    }
    if (j + 1 < nb) publish(key, slot ^ 1);
    sync_all();  // also: no CTA reads another's shared memory after the last
  }
  if (have) row_copy(M + static_cast<size_t>(k0 + lg) * N + k0, row, nb);
  if (rank == 0) {
    if (tid < nb) piv[static_cast<size_t>(b) * N + k0 + tid] = k0 + s_piv[tid];
    // the previous panel's U12 block on these columns: written after the
    // first cluster barrier, when no CTA stages from those rows any more
    for (int e = tid; e < prev * nb; e += kThreads) {
      const int i = e / nb, c = e - i * nb;
      M[static_cast<size_t>(kp + i) * N + k0 + c] = U[e];
    }
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// One triangle of x = U^-1 L^-1 b[perm] (kForward: L y = b[perm] into x;
// else U x = y in place) by strips of kSolveRows rows.  Item t * B + b is
// instance b's t-th strip in the order of the substitution; blocks take
// items by the ticket, in order.  The block's warps read its rows against
// the strips solved before the last one, each as its flag is set; warp 0
// then waits for the last one with that strip's block of the matrix
// already in registers (lane i holds row i), takes its product by
// shuffles, solves the diagonal block and publishes the strip.  So a link
// of the chain is one flag, one read of 32 values at L2, 64 shuffle steps
// and a release.  Values other blocks publish are read at L2 (__ldcg),
// never from a stale L1 line.
template <typename T, bool kForward>
__global__ void __launch_bounds__(kThreads) strip_solve_kernel(const T* __restrict__ lu, const int* __restrict__ perm,
                                                               const T* __restrict__ rhs, T* x, int* flags,
                                                               int* ticket, int B, int N, int G) {
  constexpr int kRowsPerWarp = kSolveRows / kWarps;
  __shared__ T D[kSolveRows][kSolveRows + 1];
  __shared__ T s_acc[kSolveRows];
  __shared__ int s_item, s_ready;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (;;) {
    if (tid == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= B * G) return;
    const int t = item / B, b = item - t * B;
    const int g = kForward ? t : G - 1 - t;
    const int i0 = g * kSolveRows, nr = min(kSolveRows, N - i0);
    const T* M = lu + static_cast<size_t>(b) * N * N;
    T* xb = x + static_cast<size_t>(b) * N;
    int* fl = flags + static_cast<size_t>(b) * G;
    for (int e = tid; e < nr * nr; e += kThreads) {
      const int i = e / nr, j = e - i * nr;
      D[i][j] = M[static_cast<size_t>(i0 + i) * N + i0 + j];
    }
    // every strip but the last before this one, by all warps
    T acc[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = T(0);
    for (int done = 0; done < t - 1;) {
      if (tid == 0) {
        while (load_acquire(fl + (kForward ? done : G - 1 - done)) == 0) {
        }
        int ready = done + 1;
        while (ready < t - 1 && load_acquire(fl + (kForward ? ready : G - 1 - ready)) != 0) ++ready;
        s_ready = ready;
      }
      __syncthreads();
      const int ready = s_ready;
#pragma unroll 4
      for (int u = done; u < ready; ++u) {
        const int c = (kForward ? u : G - 1 - u) * kSolveRows + lane;
        if (c < N) {
          const T v = __ldcg(xb + c);
#pragma unroll
          for (int q = 0; q < kRowsPerWarp; ++q) {
            const int r = warp * kRowsPerWarp + q;
            if (r < nr) acc[q] += M[static_cast<size_t>(i0 + r) * N + c] * v;
          }
        }
      }
      done = ready;
      __syncthreads();  // s_ready is read
    }
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const T s = warp_sum(acc[q]);
      if (lane == 0) s_acc[warp * kRowsPerWarp + q] = s;
    }
    __syncthreads();
    if (warp == 0) {
      T yl = T(0), rd = T(1);
      if (lane < nr) {
        const size_t o = static_cast<size_t>(b) * N + i0 + lane;
        yl = (kForward ? rhs[static_cast<size_t>(b) * N + perm[o]] : __ldcg(x + o)) - s_acc[lane];
        if (!kForward) rd = T(1) / D[lane][lane];  // off the chain: x_j = y_j * (1 / u_jj)
      }
      if (t > 0) {
        // the last strip before this one: its block of the matrix first
        const int h = kForward ? g - 1 : g + 1;
        const int c0 = h * kSolveRows, nc = min(kSolveRows, N - c0);
        T row[kSolveRows];
        const T* Mr = M + static_cast<size_t>(i0 + (lane < nr ? lane : 0)) * N + c0;
#pragma unroll
        for (int j = 0; j < kSolveRows; ++j) row[j] = j < nc ? Mr[j] : T(0);
        if (lane == 0) {
          while (load_acquire(fl + h) == 0) {
          }
        }
        __syncwarp();
        const T yh = lane < nc ? __ldcg(xb + c0 + lane) : T(0);
        T s = T(0);
#pragma unroll
        for (int j = 0; j < kSolveRows; ++j) s += row[j] * __shfl_sync(kFull, yh, j);
        if (lane < nr) yl -= s;
      }
      if (kForward) {
        for (int j = 0; j < nr; ++j) {
          const T yj = __shfl_sync(kFull, yl, j);
          if (lane > j && lane < nr) yl -= D[lane][j] * yj;
        }
      } else {
        for (int j = nr - 1; j >= 0; --j) {
          const T xj = __shfl_sync(kFull, lane == j ? yl * rd : T(0), j);
          if (lane == j) yl = xj;
          if (lane < j) yl -= D[lane][j] * xj;
        }
      }
      if (lane < nr) xb[i0 + lane] = yl;
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(fl + g, 1);
    }
    __syncthreads();  // D, s_acc and s_item are free
  }
}

bool fits_grid(long long blocks) { return blocks > 0 && blocks <= INT_MAX; }

// The panel's exchanges and U12 for every column outside [k0, k0 + nb)
// but the `skip` columns right after it.
template <typename T>
cudaError_t launch_swap_solve(T* lu, const int* piv, int B, int N, int k0, int nb, int skip, cudaStream_t s) {
  const int outside = N - nb - skip;
  if (outside <= 0) return cudaSuccess;
  // the columns in chunks of equal size, whole warps, at most kThreads
  const int chunks = (outside + kThreads - 1) / kThreads;
  const int threads = ((outside + chunks - 1) / chunks + 31) / 32 * 32;
  if (!fits_grid(static_cast<long long>(B) * chunks)) return cudaErrorInvalidValue;
  swap_solve_kernel<T><<<B * chunks, threads, 0, s>>>(lu, piv, N, k0, nb, skip, chunks);
  return cudaGetLastError();
}

// The trailing update behind the panel [k0, k0 + nb) on columns [cb, ce).
template <typename T>
cudaError_t launch_update(T* lu, int B, int N, int k0, int nb, int cb, int ce, cudaStream_t s) {
  const int tiles_r = (N - k0 - nb + kTile - 1) / kTile, tiles_c = (ce - cb + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(B) * tiles_r * tiles_c;
  if (!fits_grid(blocks)) return cudaErrorInvalidValue;
  update_kernel<T><<<static_cast<int>(blocks), kThreads, 0, s>>>(lu, N, k0, nb, cb, ce, tiles_r, tiles_c);
  return cudaGetLastError();
}

// The cluster of a panel of `rows` rows and `nb` columns behind a panel
// of `prev`: the fewest CTAs (a power of two, at most cmax) that give
// every row a thread and whose shared memory fits.  False where none does.
template <typename T>
bool cluster_plan(int rows, int nb, int prev, int cmax, int& C, int& slab) {
  for (C = 1; C < cmax && C * kThreads < rows; C <<= 1) {
  }
  for (;; C <<= 1) {
    slab = (rows + C - 1) / C;
    if (slab <= kThreads && cluster_panel_bytes<T>(rows, slab, nb, prev) <= kClusterSmem) return true;
    if (C >= cmax) return false;
  }
}

template <typename T>
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int B, int rows, int nb, int prev,
                           int C, int slab, cudaStream_t s) {
  // a cluster of one is a plain launch of the single-block form
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_panel_bytes<T>(rows, slab, nb, prev);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return fits_grid(static_cast<long long>(B) * C) ? cudaSuccess : cudaErrorInvalidValue;
}

// The cluster path's panel width and largest cluster at N rows: clusters
// of 16 CTAs where the card schedules them, else 8; the widest of 32, 16,
// 8 columns whose largest panel (the second: N - nb rows behind a full
// panel) and first panel fit.  ok = false where none fits, and the factor
// takes the batched path.
template <typename T>
cudaError_t cluster_path(int N, int& nb, int& cmax, bool& ok) {
  ok = false;
  cudaError_t err =
      cudaFuncSetAttribute(cluster_panel_kernel<T, true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = allow_smem(cluster_panel_kernel<T, true>, kClusterSmem);
  if (err == cudaSuccess) err = allow_smem(cluster_panel_kernel<T, false>, kClusterSmem);
  if (err != cudaSuccess) return err;
  for (cmax = kClusterMax; cmax >= 8; cmax >>= 1) {
    for (nb = kMaxNB; nb >= kMinNB; nb >>= 1) {
      int C, slab, C2, slab2;
      const int w = nb < N ? nb : N;
      if (!cluster_plan<T>(N, w, 0, cmax, C, slab) || !cluster_plan<T>(N, w, w, cmax, C2, slab2)) continue;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr[1];
      err = cluster_config<T>(cfg, attr, 1, N, w, w, C2, slab2, nullptr);
      int clusters = 0;
      if (err == cudaSuccess && C2 > 1)
        err = cudaOccupancyMaxActiveClusters(&clusters, cluster_panel_kernel<T, true>, &cfg);
      else if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&clusters, cluster_panel_kernel<T, false>, kThreads,
                                                            cfg.dynamicSmemBytes);
      if (err != cudaSuccess) return err;
      ok = clusters > 0;
      if (ok) return cudaSuccess;
      break;  // narrower panels need no fewer CTAs: try a smaller cluster
    }
  }
  return cudaSuccess;
}

// The side stream of the look-ahead and its events, one set per device,
// made at first use; the lock keeps two factors from sharing them at once.
struct LookAhead {
  cudaStream_t side = nullptr;
  cudaEvent_t start = nullptr, panel = nullptr, updated[2] = {nullptr, nullptr};
};

std::mutex look_ahead_lock;
LookAhead look_ahead_of[kMaxDevices];

cudaError_t look_ahead(LookAhead*& la) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  la = &look_ahead_of[device];
  if (la->side) return cudaSuccess;
  int least = 0, greatest = 0;
  err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
  if (err == cudaSuccess) err = cudaStreamCreateWithPriority(&la->side, cudaStreamNonBlocking, greatest);
  for (cudaEvent_t* e : {&la->start, &la->panel, &la->updated[0], &la->updated[1]})
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(e, cudaEventDisableTiming);
  return err;
}

#define OSQP_TRY(expr)                  \
  do {                                  \
    const cudaError_t e_ = (expr);      \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

// The factor of a batch that cannot fill the card.  Panel p (columns
// [k0, k1)) runs on the side stream as one cluster kernel, which also
// brings its columns up to date with panel p - 1; on the caller's stream
// panel p's exchanges and U12 (swap_solve_kernel) and its trailing update
// skip panel p + 1's columns, which panel p + 1 takes itself.  Panel p + 2
// waits for panel p's update (two events in turn), so the side stream is
// a chain of panels with the updates beside it.  Counts its launches in
// `kernels`.
template <typename T>
cudaError_t factor_clustered(T* lu, int* piv, int B, int N, int nb, int cmax, cudaStream_t main, int& kernels,
                             int& first_cluster) {
  std::lock_guard<std::mutex> guard(look_ahead_lock);
  LookAhead* la = nullptr;
  OSQP_TRY(look_ahead(la));
  OSQP_TRY(cudaEventRecord(la->start, main));
  OSQP_TRY(cudaStreamWaitEvent(la->side, la->start, 0));
  int prev = 0;
  for (int k0 = 0, p = 0; k0 < N; ++p) {
    const int rows = N - k0, w = nb < rows ? nb : rows;
    int C, slab;
    if (!cluster_plan<T>(rows, w, prev, cmax, C, slab)) return cudaErrorInvalidValue;
    if (k0 == 0) first_cluster = C;
    if (p >= 2) OSQP_TRY(cudaStreamWaitEvent(la->side, la->updated[p & 1], 0));  // panel p - 2's update
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    OSQP_TRY(cluster_config<T>(cfg, attr, B, rows, w, prev, C, slab, la->side));
    if (C > 1)
      OSQP_TRY(cudaLaunchKernelEx(&cfg, cluster_panel_kernel<T, true>, lu, piv, N, k0, w, prev, slab));
    else
      OSQP_TRY(cudaLaunchKernelEx(&cfg, cluster_panel_kernel<T, false>, lu, piv, N, k0, w, prev, slab));
    ++kernels;
    OSQP_TRY(cudaEventRecord(la->panel, la->side));
    OSQP_TRY(cudaStreamWaitEvent(main, la->panel, 0));
    const int k1 = k0 + w, trailing = N - k1;
    const int next = nb < trailing ? nb : trailing;  // panel p + 1's columns
    if (N - w - next > 0) {
      OSQP_TRY(launch_swap_solve<T>(lu, piv, B, N, k0, w, next, main));
      ++kernels;
    }
    if (trailing > next) {
      OSQP_TRY(launch_update<T>(lu, B, N, k0, w, k1 + next, N, main));
      ++kernels;
    }
    OSQP_TRY(cudaEventRecord(la->updated[p & 1], main));
    prev = w;
    k0 = k1;
  }
  return cudaSuccess;
}

// The batched panel's template width at `rows` rows, and whether its
// values spill to device memory: the widest of 64, 32, 16 and 8 columns
// whose staged panel lets two blocks share an SM, else the widest that
// fits one block, else 32 columns spilled.
template <typename T>
int batched_width(int rows, bool& spill) {
  spill = false;
  for (size_t limit : {kPanelPair, kPanelSmem})
    for (int W = kMaxBatchedW; W >= 8; W >>= 1)
      if (bpanel_bytes<T>(rows, W < rows ? W : rows, false) <= limit) return W;
  spill = true;
  return 32;
}

// Bytes of the factor's scratch at (B, N): the cluster path's pivots,
// the batched path's moved rows and, where its first panel spills, the
// spilled panel of every instance.
template <typename T>
size_t factor_scratch(int B, int N) {
  bool spill;
  const int W = batched_width<T>(N, spill);
  const size_t ints = align16(sizeof(int) * (static_cast<size_t>(B) * N + static_cast<size_t>(B) * kMoveInts));
  return ints + (spill ? sizeof(T) * B * static_cast<size_t>(N) * (W | 1) : 0);
}

// The update behind the batched panel [k0, k0 + w) of template width W.
template <typename T, int W>
cudaError_t launch_bupdate(T* lu, const Source<T>& src, const int* moves, int B, int N, int k0, int w,
                           cudaStream_t s, int& kernels) {
  const int rows = N - k0;
  const int left = (k0 + kStrip - 1) / kStrip;
  const int right = rows > w ? (rows - w + kStrip - 1) / kStrip : 0;
  if (left + right == 0) return cudaSuccess;
  if (!fits_grid(static_cast<long long>(B) * (left + right))) return cudaErrorInvalidValue;
  const size_t smem = bupdate_bytes<T, W>(rows);
  OSQP_TRY(allow_smem(bupdate_kernel<T, W>, smem));
  bupdate_kernel<T, W><<<B * (left + right), kThreads, smem, s>>>(lu, src, moves, N, k0, left, left + right);
  ++kernels;
  return cudaGetLastError();
}

// The factor of a batch that fills the card: per panel a bpanel_kernel
// and a bupdate_kernel, the first pair reading K from `first`.
template <typename T>
cudaError_t factor_batched(T* lu, const Source<T>& first, int* moves, int* perm, T* spill, int B, int N,
                           cudaStream_t s, int& kernels, int& first_nb) {
  // a later, shorter panel may be wider and take more than the first
  OSQP_TRY(allow_smem(bpanel_kernel<T, 0>, kPanelSmem));
  OSQP_TRY(allow_smem(bpanel_kernel<T, 1>, kPanelSmem));
  OSQP_TRY(allow_smem(bpanel_kernel<T, 2>, kPanelSmem));
  OSQP_TRY(allow_smem(bpanel_kernel<T, 4>, kPanelSmem));
  Source<T> later = first;
  later.kind = kLu;
  for (int k0 = 0; k0 < N;) {
    const int rows = N - k0;
    bool spilled;
    const int W = batched_width<T>(rows, spilled), w = W < rows ? W : rows;
    if (spilled && (!spill || bpanel_bytes<T>(rows, w, true) > kPanelSmem)) return cudaErrorInvalidValue;
    if (k0 == 0) first_nb = w;
    const Source<T>& src = k0 == 0 ? first : later;
    const size_t smem = bpanel_bytes<T>(rows, w, spilled);
    T* sp = spilled ? spill : nullptr;
    if (rows <= kThreads)
      bpanel_kernel<T, 1><<<B, kThreads, smem, s>>>(lu, src, moves, perm, sp, N, k0, w);
    else if (rows <= 2 * kThreads)
      bpanel_kernel<T, 2><<<B, kThreads, smem, s>>>(lu, src, moves, perm, sp, N, k0, w);
    else if (rows <= 4 * kThreads)
      bpanel_kernel<T, 4><<<B, kThreads, smem, s>>>(lu, src, moves, perm, sp, N, k0, w);
    else
      bpanel_kernel<T, 0><<<B, kThreads, smem, s>>>(lu, src, moves, perm, sp, N, k0, w);
    ++kernels;
    OSQP_TRY(cudaGetLastError());
    switch (W) {
      case 64: OSQP_TRY((launch_bupdate<T, 64>(lu, src, moves, B, N, k0, w, s, kernels))); break;
      case 32: OSQP_TRY((launch_bupdate<T, 32>(lu, src, moves, B, N, k0, w, s, kernels))); break;
      case 16: OSQP_TRY((launch_bupdate<T, 16>(lu, src, moves, B, N, k0, w, s, kernels))); break;
      default: OSQP_TRY((launch_bupdate<T, 8>(lu, src, moves, B, N, k0, w, s, kernels))); break;
    }
    k0 += w;
  }
  return cudaSuccess;
}

template <typename T>
Source<T> separate(const T* K) {
  Source<T> src{};
  src.kind = kSeparate;
  src.K = K;
  return src;
}

// P K = L U of K as `src` gives it, into lu and perm.  scratch holds
// factor_scratch<T>(B, N) bytes.  info (3 ints): the kernels launched,
// the first panel's width, and its cluster's CTAs (0 on the batched
// path).
template <typename T>
int factor(const Source<T>& src, T* lu, int* perm, unsigned char* scratch, int B, int N, int sm_count, int* info,
           cudaStream_t stream) {
  int* piv = reinterpret_cast<int*>(scratch);
  int* moves = piv + static_cast<size_t>(B) * N;
  T* spill = reinterpret_cast<T*>(
      scratch + align16(sizeof(int) * (static_cast<size_t>(B) * N + static_cast<size_t>(B) * kMoveInts)));
  int kernels = 0, first_nb = 0, first_cluster = 0;
  int nb = 0, cmax = 0;
  bool clustered = false;
  if (B < sm_count) OSQP_TRY(cluster_path<T>(N, nb, cmax, clustered));
  if (clustered) {
    // the cluster path factors in place: K into lu first
    const size_t total = static_cast<size_t>(B) * N * N;
    if (src.kind == kSeparate) {
      OSQP_TRY(cudaMemcpyAsync(lu, src.K, total * sizeof(T), cudaMemcpyDeviceToDevice, stream));
    } else if (src.kind == kBlocks) {
      const size_t blocks = (total + kThreads - 1) / kThreads;
      form_kernel<T><<<static_cast<int>(blocks < 65536 ? blocks : 65536), kThreads, 0, stream>>>(lu, src, B, N);
      ++kernels;
    }
    OSQP_TRY(factor_clustered<T>(lu, piv, B, N, nb, cmax, stream, kernels, first_cluster));
    first_nb = nb < N ? nb : N;
    const size_t smem = 2 * static_cast<size_t>(N) * sizeof(int);
    OSQP_TRY(allow_smem(perm_kernel, smem));
    perm_kernel<<<B, kThreads, smem, stream>>>(piv, perm, N);
    ++kernels;
  } else {
    OSQP_TRY(factor_batched<T>(lu, src, moves, perm, spill, B, N, stream, kernels, first_nb));
  }
  if (info) {
    info[0] = kernels;
    info[1] = first_nb;
    info[2] = first_cluster;
  }
  return cudaGetLastError();
}

// Ints of scratch the solve takes: the strips' flags of both triangles
// and two tickets where the batch cannot fill the card, else none.
int solve_scratch(int B, int N, int sm_count) {
  if (B >= sm_count) return 0;
  const long long groups = (N + kSolveRows - 1) / kSolveRows;
  return static_cast<int>(2 * static_cast<long long>(B) * groups + 2);
}

template <typename T>
int solve(const void* lu_, const int* perm, const void* rhs_, void* x_, int* scratch, int B, int N, int sm_count,
          cudaStream_t stream) {
  auto lu = static_cast<const T*>(lu_);
  auto rhs = static_cast<const T*>(rhs_);
  auto x = static_cast<T*>(x_);
  if (B >= sm_count) {
    const size_t smem = static_cast<size_t>(N) * sizeof(T);
    OSQP_TRY(allow_smem(lu_solve_kernel<T>, smem));
    lu_solve_kernel<T><<<B, kThreads, smem, stream>>>(lu, perm, rhs, x, N);
    return cudaGetLastError();
  }
  if (!scratch) return cudaErrorInvalidValue;
  const int G = (N + kSolveRows - 1) / kSolveRows;
  const long long items = static_cast<long long>(B) * G;
  int per_sm = 0;
  OSQP_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, strip_solve_kernel<T, true>, kThreads, 0));
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count;
  const int blocks = static_cast<int>(items < resident ? items : resident);
  int* flags = scratch;
  int* tickets = scratch + 2 * items;
  strip_solve_kernel<T, true><<<blocks, kThreads, 0, stream>>>(lu, perm, rhs, x, flags, tickets, B, N, G);
  strip_solve_kernel<T, false><<<blocks, kThreads, 0, stream>>>(lu, perm, rhs, x, flags + items, tickets + 1, B,
                                                                 N, G);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  Bytes of scratch osqp_kkt_lu_factor and
// osqp_kkt_lu_factor_blocks take at (B, N).
extern "C" long long osqp_kkt_lu_factor_scratch(int dtype, int B, int N) {
  return static_cast<long long>(dtype == 0 ? factor_scratch<float>(B, N) : factor_scratch<double>(B, N));
}

// P K = L U of the contiguous (B, N, N) batch K into lu (B, N, N) and perm
// (B, N) int32; K is not written.  info, where not null, gets 3 ints: the
// kernels launched, the first panel's width, its cluster's CTAs (0 on the
// batched path, B >= sm_count).
extern "C" int osqp_kkt_lu_factor(int dtype, const void* K, void* lu, void* perm, void* scratch, int B, int N,
                                  int sm_count, void* info, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<int*>(perm);
  auto sc = static_cast<unsigned char*>(scratch);
  auto in = static_cast<int*>(info);
  if (dtype == 0) return factor<float>(separate(static_cast<const float*>(K)), static_cast<float*>(lu), pm, sc, B, N,
                                       sm_count, in, s);
  return factor<double>(separate(static_cast<const double*>(K)), static_cast<double*>(lu), pm, sc, B, N, sm_count,
                        in, s);
}

// The same for K = [[P + s I, A'], [A, -diag(d)]] from its blocks: P
// (B, n, n), A (B, m, n), d (B, m), all contiguous; N = n + m.  The
// first pass reads the blocks where it would read K.
extern "C" int osqp_kkt_lu_factor_blocks(int dtype, const void* P, const void* A, const void* d,
                                         double shift, int n, int m, void* lu, void* perm, void* scratch, int B,
                                         int sm_count, void* info, void* stream) {
  const int N = n + m;
  if (B == 0 || N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<int*>(perm);
  auto sc = static_cast<unsigned char*>(scratch);
  auto in = static_cast<int*>(info);
  if (dtype == 0) {
    const Source<float> src{kBlocks, nullptr, static_cast<const float*>(P), static_cast<const float*>(A),
                            static_cast<const float*>(d), static_cast<float>(shift), n, m};
    return factor<float>(src, static_cast<float*>(lu), pm, sc, B, N, sm_count, in, s);
  }
  const Source<double> src{kBlocks, nullptr, static_cast<const double*>(P), static_cast<const double*>(A),
                           static_cast<const double*>(d), shift, n, m};
  return factor<double>(src, static_cast<double*>(lu), pm, sc, B, N, sm_count, in, s);
}

// Ints of zeroed scratch osqp_kkt_lu_solve takes at (B, N).
extern "C" int osqp_kkt_lu_solve_scratch(int B, int N, int sm_count) { return solve_scratch(B, N, sm_count); }

// x = U^-1 L^-1 b[perm] with the factors above; b and x are (B, N);
// scratch holds osqp_kkt_lu_solve_scratch ints, zeroed (null where that
// is 0).
extern "C" int osqp_kkt_lu_solve(int dtype, const void* lu, const void* perm, const void* b, void* x, void* scratch,
                                 int B, int N, int sm_count, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<const int*>(perm);
  auto sc = static_cast<int*>(scratch);
  return dtype == 0 ? solve<float>(lu, pm, b, x, sc, B, N, sm_count, s)
                    : solve<double>(lu, pm, b, x, sc, B, N, sm_count, s);
}
