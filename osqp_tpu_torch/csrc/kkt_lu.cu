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
// works in place in device memory by column panels, a short sequence of
// launches per panel, all enqueued by one C call.  Two paths, by batch:
//
// Batches that fill the card (B >= SMs, the headline), per panel:
//   1. panel_kernel, one block per instance: the panel's rows below the
//      diagonal, nb <= 32 columns wide, are staged in shared memory (the
//      widest of 32, 16, 8 columns that fits; above that the panel stays
//      in device memory), and factored column by column: pivot search by
//      a block reduction, row exchange, scale, rank-1 update, a thread
//      per row.
//   2. swap_solve_kernel, a thread per column outside the panel: the
//      panel's row exchanges, composed into one gather, and for the
//      columns to its right the triangular solve U12 = L11^-1 A12, the
//      column held in registers.
//   3. update_kernel, a block per 64 x 64 tile of the trailing matrix:
//      A22 -= L21 U12 in 4 x 4 register tiles.
//   4. perm_kernel turns the pivots into perm.
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
// that: a panel's columns are the unblocked algorithm on its rows, U12's
// solve and the trailing update subtract in increasing k, and the update
// split in two touches each value once.  So the factors, and with them
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
// instance and, blocked by 32 columns, moves the trailing matrix through
// device memory N / 32 times (about N^3 / 48 values read and written an
// instance), so at the headline its bytes, not its operations, set the
// time.  At B = 1 the chain of N pivot columns sets it: a cluster barrier,
// a round of remote reads and three block barriers per column, some 2.8
// us all told, against 0.2 ms of operations for the whole factor at
// N = 2250 in float64.  The
// solve reads lu once and is bound by those bytes; at B = 1 by its chain
// of 2 N / 32 diagonal solves, each behind a flag.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <mutex>

#include "common.cuh"

namespace {

using osqp_cuda::allow_smem;
using osqp_cuda::kThreads;
using osqp_cuda::kWarps;
using osqp_cuda::mul;
using osqp_cuda::sub;

constexpr int kMaxNB = 32;     // widest panel
constexpr int kMinNB = 8;      // narrowest staged panel
constexpr int kGlobalNB = 16;  // panel width where no staged panel fits
constexpr int kTile = 64;      // edge of a tile of the trailing update
constexpr int kSolveRows = 32;  // rows of a group of the solve
constexpr int kSolveThreadsWide = 1024;  // launch bound of lu_solve_kernel
constexpr int kClusterMax = 16;         // CTAs of a panel's cluster at most (non-portable above 8)
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory a staged panel may take: what a block may use, less the
// kernel's static shared memory.
constexpr size_t kPanelSmem = osqp_cuda::kMaxSmem - 1024;
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

// Of two (|value|, row) candidates keep the larger value, and of equal
// values the smaller row.
template <typename T>
__device__ __forceinline__ void keep_better(T& best, int& idx, T ob, int oi) {
  if (ob > best || (ob == best && oi < idx)) {
    best = ob;
    idx = oi;
  }
}

template <typename T>
size_t panel_bytes(int rows, int nb) {
  return static_cast<size_t>(rows) * (nb + 1) * sizeof(T);
}

// Factor the panel of columns [k0, k0 + nb) of every instance: rows
// [k0, N), in place.  piv[b][k0 + j] is the row exchanged with row k0 + j.
template <typename T>
__global__ void __launch_bounds__(kThreads) panel_kernel(T* __restrict__ lu, int* __restrict__ piv, int N, int k0,
                                                         int nb, int staged) {
  extern __shared__ __align__(16) unsigned char panel_smem[];
  __shared__ T s_best[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_piv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = N - k0;
  T* base = lu + static_cast<size_t>(blockIdx.x) * N * N + static_cast<size_t>(k0) * N + k0;
  T* p = base;
  size_t ld = N;
  if (staged) {
    p = reinterpret_cast<T*>(panel_smem);
    ld = nb + 1;  // odd: a thread per row reads a column without bank conflicts
    for (int e = tid; e < rows * nb; e += kThreads) {
      const int r = e / nb, c = e - r * nb;
      p[r * ld + c] = base[static_cast<size_t>(r) * N + c];
    }
    __syncthreads();
  }
  for (int j = 0; j < nb; ++j) {
    // the first row of largest |value| in column j, rows [j, rows)
    T best = T(-1);
    int idx = INT_MAX;
    for (int r = j + tid; r < rows; r += kThreads) {
      const T v = absval(p[r * ld + j]);
      if (v > best) {
        best = v;
        idx = r;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      keep_better(best, idx, __shfl_down_sync(kFull, best, off), __shfl_down_sync(kFull, idx, off));
    if (lane == 0) {
      s_best[warp] = best;
      s_idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? s_best[lane] : T(-1);
      idx = lane < kWarps ? s_idx[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1)
        keep_better(best, idx, __shfl_down_sync(kFull, best, off), __shfl_down_sync(kFull, idx, off));
      if (lane == 0) {
        const int pr = idx == INT_MAX ? j : idx;  // a column of NaN keeps its row
        s_piv = pr;
        piv[static_cast<size_t>(blockIdx.x) * N + k0 + j] = k0 + pr;
      }
    }
    __syncthreads();
    const int pr = s_piv;
    if (pr != j && tid < nb) {
      const T a = p[j * ld + tid];
      p[j * ld + tid] = p[pr * ld + tid];
      p[pr * ld + tid] = a;
    }
    __syncthreads();
    const T d = p[j * ld + j];
    const T* top = p + j * ld;
    for (int r = j + 1 + tid; r < rows; r += kThreads) {
      T* row = p + r * ld;
      const T l = row[j] / d;
      row[j] = l;
      for (int c = j + 1; c < nb; ++c) row[c] = sub(row[c], mul(l, top[c]));
    }
    __syncthreads();
  }
  if (staged) {
    for (int e = tid; e < rows * nb; e += kThreads) {
      const int r = e / nb, c = e - r * nb;
      base[static_cast<size_t>(r) * N + c] = p[r * ld + c];
    }
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

// The cluster panel's pivot search compares keys: |value|'s bits plus one
// (bits of non-negative floats order as the values do), 0 for a NaN or
// for no candidate.  Of equal keys the smallest tie wins, where the tie
// carries the logical row: so the winner is keep_better's, the first row
// of largest |value|, and a warp finds it with the integer reductions.
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

// The width of the panel at `rows` rows, and whether it is staged.
template <typename T>
int panel_width(int rows, bool& staged) {
  int nb = kMaxNB;
  while (nb > kMinNB && panel_bytes<T>(rows, nb) > kPanelSmem) nb >>= 1;
  staged = panel_bytes<T>(rows, nb) <= kPanelSmem;
  if (!staged) nb = kGlobalNB;
  return nb < rows ? nb : rows;
}

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

// info (3 ints): the kernels launched, the first panel's width, and its
// cluster's CTAs (0 on the batched path).
template <typename T>
int factor(void* lu_, int* piv, int* perm, int B, int N, int sm_count, int* info, cudaStream_t stream) {
  T* lu = static_cast<T*>(lu_);
  int kernels = 0, first_nb = 0, first_cluster = 0;
  int nb = 0, cmax = 0;
  bool clustered = false;
  if (B < sm_count) OSQP_TRY(cluster_path<T>(N, nb, cmax, clustered));
  if (clustered) {
    OSQP_TRY(factor_clustered<T>(lu, piv, B, N, nb, cmax, stream, kernels, first_cluster));
    first_nb = nb < N ? nb : N;
  } else {
    bool staged;
    // a later, shorter panel may be wider and take more than the first
    OSQP_TRY(allow_smem(panel_kernel<T>, kPanelSmem));
    for (int k0 = 0; k0 < N;) {
      const int rows = N - k0;
      const int w = panel_width<T>(rows, staged);
      if (k0 == 0) first_nb = w;
      panel_kernel<T><<<B, kThreads, staged ? panel_bytes<T>(rows, w) : 0, stream>>>(lu, piv, N, k0, w, staged);
      ++kernels;
      if (N > w) {
        OSQP_TRY(launch_swap_solve<T>(lu, piv, B, N, k0, w, 0, stream));
        ++kernels;
      }
      if (rows > w) {
        OSQP_TRY(launch_update<T>(lu, B, N, k0, w, k0 + w, N, stream));
        ++kernels;
      }
      OSQP_TRY(cudaGetLastError());
      k0 += w;
    }
  }
  const size_t smem = 2 * static_cast<size_t>(N) * sizeof(int);
  OSQP_TRY(allow_smem(perm_kernel, smem));
  perm_kernel<<<B, kThreads, smem, stream>>>(piv, perm, N);
  ++kernels;
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

// dtype: 0 float32, 1 float64.  lu is a contiguous (B, N, N) batch holding
// K, factored in place; piv (scratch) and perm are (B, N) int32.  info,
// where not null, gets 3 ints: the kernels launched, the first panel's
// width, its cluster's CTAs (0 on the batched path, B >= sm_count).
extern "C" int osqp_kkt_lu_factor(int dtype, void* lu, void* piv, void* perm, int B, int N, int sm_count, void* info,
                                  void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto pv = static_cast<int*>(piv), pm = static_cast<int*>(perm);
  auto in = static_cast<int*>(info);
  return dtype == 0 ? factor<float>(lu, pv, pm, B, N, sm_count, in, s)
                    : factor<double>(lu, pv, pm, B, N, sm_count, in, s);
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
