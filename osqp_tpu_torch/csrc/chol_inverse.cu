// K2: batched SPD inverse, one thread block per instance.
//
// Replaces osqp_tpu/ops/spd_inverse.py:spd_inverse (its Jacobi scaling,
// the recursive _chol_inv with its leaves _chol_inv_base2,
// _chol_inv_leaf and _chol_inv_leaf_batchminor, and T'T), called from
// osqp_tpu/linsys/dense_inv.py:init.  The JAX package recurses into
// batched GEMMs because a Cholesky factorization serialises on the TPU.
// On Hopper one block per instance runs the classic algorithm, blocked,
// on a copy of the matrix held entirely in shared memory:
//
//   d_i = 1/sqrt(M_ii)          (NaN where M_ii <= 0)
//   S   = d M d                 symmetric Jacobi equilibration
//   L   = chol(S), lower        blocked right-looking, panels of kNB
//   T   = L^-1                  blocked forward substitution
//   X   = d (T'T) d             lower triangle, mirrored on the store
//
// A non-PD matrix (a pivot that is not positive, or M_ii <= 0) gives
// NaN in the whole instance, which callers read as the non-convexity
// signal, as in the JAX package.
//
// What bounds it on the H100: device memory sees one read of M and one
// write of X (80 KB per instance at n=100 in f32), far below what the
// time is.  The ~n^3 operations per instance run out of shared memory;
// what sets the time is the chain of dependent steps inside a block and
// how many threads share each step, with four blocks (f32, registers
// capped at 64) or two (f64) per SM to overlap their chains.  The design
// shortens the chain:
//
//   * Cholesky by panels of kNB = 16 columns, three block barriers per
//     panel instead of two per column: one warp factors the panel's
//     diagonal block in registers, rows spread over lanes and columns
//     passed by shuffles, and leaves the diagonal's reciprocals; each row
//     below it is solved by its own thread; the trailing update is a SYRK
//     over the lower triangle in 4 x 4 register tiles, whose coordinates
//     come from the tile index once per tile, not per element.
//   * T = L^-1 without a row-serial walk: every warp inverts diagonal
//     blocks of L on its own; then one step per block row k scales the
//     block row by T_kk (a half-warp per column) and subtracts L_ik X_k
//     from every row below in 4 x 4 register tiles: two barriers per
//     block.  T lives transposed in the upper triangle of S, which the
//     load leaves zero, with its diagonal in a separate n-value buffer, so
//     L stays readable while T is formed; each inverted diagonal block
//     holds T_kk whole (diagonal in, zeros below), so that every read of
//     X in the updates is a plain load.
//   * T'T on the lower triangle only, 4 x 4 register tiles, each value
//     written to X and its mirror.
//   * The leading dimension of S is odd where the matrix leaves room, so
//     that a warp reading a column (rows at stride ld) hits 32 banks.
//
// The block holds n*ld + 2n values, so n <= 240 in float32 and n <= 169
// in float64 fit the 227 KB a block may use.  Above that the wrapper
// (ops/spd_inverse.py:spd_inverse) runs the JAX package's blocked
// recursion: M split at about n/2, T11 = chol(M11)^-1, L21 = M21 T11',
// T22 = chol(M22 - L21 L21')^-1, T21 = -T22 L21 T11, down to diagonal
// blocks that fit, each a launch of the leaf entry below
// (osqp_chol_inverse_leaf: the same factor and triangular inverse on S as
// it comes, writing T instead of T'T); the products between the leaves
// are batched GEMMs, as the JAX package leaves them to XLA.  Where B is at
// most half the SM count (B = 1 among them) a leaf would run on B of the
// card's SMs, one after another: there the leaf's cluster form
// (cluster_leaf_kernel below) spreads each instance over up to 16 CTAs.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "cluster.cuh"
#include "common.cuh"

namespace {

using osqp_cuda::allow_smem;
using osqp_cuda::prefer_shared;
using osqp_cuda::kThreads;
using osqp_cuda::kWarps;

constexpr int kNB = 16;  // panel width, and the edge of a diagonal block of T
constexpr int kTile = 4;  // edge of a register tile
constexpr unsigned kFull = 0xffffffffu;

// (ti, tj), ti >= tj, of tile t in the row-major order of a lower
// triangle of tiles: t = ti (ti + 1) / 2 + tj.
__device__ __forceinline__ void lower_tile(int t, int& ti, int& tj) {
  ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  tj = t - ti * (ti + 1) / 2;
}

// Cholesky of the kb x kb diagonal block at (k0, k0), in place, by one
// warp: lane r holds row r (identity beyond kb).  Flags a pivot that is
// not positive, and leaves the reciprocals of the new diagonal in td.
template <typename T>
__device__ void factor_diagonal(T* S, T* td, int ld, int k0, int kb, int* bad) {
  const int r = threadIdx.x & 31;
  T a[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    a[c] = (r < kb && c <= r) ? S[(k0 + r) * ld + k0 + c] : (c == r ? T(1) : T(0));
#pragma unroll
  for (int p = 0; p < kNB; ++p) {
    const T piv = __shfl_sync(kFull, a[p], p);
    if (r == 0 && p < kb && !(piv > T(0))) *bad = 1;
    const T lpp = sqrt(piv);
    const T inv = T(1) / lpp;
    a[p] = r == p ? lpp : (r > p ? a[p] * inv : a[p]);
#pragma unroll
    for (int q = p + 1; q < kNB; ++q) {
      const T lqp = __shfl_sync(kFull, a[p], q);
      if (r >= q) a[q] -= a[p] * lqp;
    }
  }
  if (r < kb) {
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      if (c <= r) S[(k0 + r) * ld + k0 + c] = a[c];
    td[k0 + r] = T(1) / S[(k0 + r) * ld + k0 + r];  // for the panel solve; T's diagonal replaces it
  }
}

// Row i below the panel: x L_dd' = S[i, k0:k0+kb], solved in registers,
// with the diagonal's reciprocals from td; two partial sums halve each
// step's chain of dependent multiply-adds.
template <typename T>
__device__ void solve_panel_row(T* S, const T* td, int ld, int k0, int kb, int i) {
  T x[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c) x[c] = c < kb ? S[i * ld + k0 + c] : T(0);
#pragma unroll
  for (int c = 0; c < kNB; ++c) {
    if (c < kb) {
      const T* lc = S + (k0 + c) * ld + k0;
      T v0 = x[c], v1 = T(0);
#pragma unroll
      for (int t = 0; t < c; ++t) {
        if (t & 1) v1 -= x[t] * lc[t];
        else v0 -= x[t] * lc[t];
      }
      x[c] = (v0 + v1) * td[k0 + c];
    }
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    if (c < kb) S[i * ld + k0 + c] = x[c];
}

// S[i, j] -= sum_t L[i, k0+t] L[j, k0+t] over the lower triangle of the
// trailing rows and columns [k0 + kb, n), in 4 x 4 tiles.
template <typename T>
__device__ void trailing_update(T* S, int ld, int k0, int kb, int n) {
  const int base = k0 + kb;
  const int nt = (n - base + kTile - 1) / kTile;
  for (int t = threadIdx.x; t < nt * (nt + 1) / 2; t += kThreads) {
    int ti, tj;
    lower_tile(t, ti, tj);
    const int i0 = base + kTile * ti, j0 = base + kTile * tj;
    T acc[kTile][kTile] = {};
#pragma unroll
    for (int p = 0; p < kNB; ++p) {
      if (p < kb) {
        T a[kTile], b[kTile];
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
          a[u] = S[min(i0 + u, n - 1) * ld + k0 + p];  // rows past n are read but never stored
          b[u] = S[min(j0 + u, n - 1) * ld + k0 + p];
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int v = 0; v < kTile; ++v) acc[u][v] += a[u] * b[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int v = 0; v < kTile; ++v)
        if (i0 + u < n && j0 + v <= i0 + u) S[(i0 + u) * ld + j0 + v] -= acc[u][v];
  }
}

// T(r, c) = (L^-1)_rc, r >= c: transposed in the upper triangle of S,
// the diagonal in td, zero above the diagonal.
template <typename T>
__device__ __forceinline__ T tval(const T* S, const T* td, int ld, int r, int c) {
  return c < r ? S[c * ld + r] : (c == r ? td[r] : T(0));
}

// The diagonal block T_kk = L_kk^-1 at (k0, k0), by one warp: lane c
// takes column c by forward substitution.  Once the warp has read L_kk,
// which nothing reads later, the block holds T_kk whole: its strict upper
// triangle T' as everywhere, its diagonal (also kept in td), and zeros
// below, so that every X[r][c] with c < k0 + kb reads S[c][r] directly.
template <typename T>
__device__ void invert_diagonal(T* S, T* td, int ld, int k0, int kb) {
  const int c = threadIdx.x & 31;
  T t[kNB];
#pragma unroll
  for (int r = 0; r < kNB; ++r) {
    t[r] = T(0);
    if (c < kb && r < kb && r >= c) {
      const T* lr = S + (k0 + r) * ld + k0;
      T v = r == c ? T(1) : T(0);
#pragma unroll
      for (int q = 0; q < r; ++q) v -= lr[q] * t[q];
      t[r] = v / lr[r];
    }
  }
  const T diag = c < kb ? T(1) / S[(k0 + c) * ld + k0 + c] : T(0);  // t[c], without indexing t by a lane
  __syncwarp();
  if (c >= kb) return;
  td[k0 + c] = diag;
  S[(k0 + c) * ld + k0 + c] = diag;
#pragma unroll
  for (int r = 0; r < kNB; ++r) {
    if (r < kb && r > c) {
      S[(k0 + c) * ld + k0 + r] = t[r];
      S[(k0 + r) * ld + k0 + c] = T(0);
    }
  }
}

// X[k][c] <- T_kk X[k][c] for the columns c < k0 of block row k: a
// half-warp per column, lane r computing row r from rows q <= r.  Each
// half-warp reads its whole column before it writes it back.
template <typename T>
__device__ void scale_block_row(T* S, const T* td, int ld, int k0, int kb) {
  const int r = threadIdx.x & 15;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
  for (int c = threadIdx.x >> 4; c < k0; c += kThreads / 16) {
    T* x = S + c * ld + k0;
    T v = T(0);
    if (r < kb) {
      v = td[k0 + r] * x[r];
      for (int q = 0; q < r; ++q) v += S[(k0 + q) * ld + k0 + r] * x[q];
    }
    __syncwarp(mask);
    if (r < kb) x[r] = v;
    __syncwarp(mask);
  }
}

// X[i][c] -= sum_t L[i, k0+t] X[k0+t][c] for rows i in [k0+kb, n) and
// columns c in [0, k0+kb), in 4 x 4 tiles; X[k0+t][c] is S[c][k0+t] for
// every such c (invert_diagonal).  A tile takes every ntr-th row, so that
// the threads of a warp, which take consecutive tiles of one column
// group, read and write consecutive rows (no bank conflicts) and share
// the values of X they read.  Rows and columns past the ends are read
// clamped and not stored.
template <typename T>
__device__ void forward_update(T* S, int ld, int k0, int kb, int n) {
  const int base = k0 + kb;
  const int ntr = (n - base + kTile - 1) / kTile, ntc = (base + kTile - 1) / kTile;
  for (int t = threadIdx.x; t < ntr * ntc; t += kThreads) {
    const int tc = t / ntr;
    const int i0 = base + (t - tc * ntr), c0 = kTile * tc;
    T acc[kTile][kTile] = {};
    const T* ra[kTile];
    const T* rb[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      ra[u] = S + min(i0 + ntr * u, n - 1) * ld + k0;
      rb[u] = S + min(c0 + u, base - 1) * ld + k0;
    }
#pragma unroll
    for (int p = 0; p < kNB; ++p) {
      if (p < kb) {
        T a[kTile], b[kTile];
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
          a[u] = ra[u][p];
          b[u] = rb[u][p];
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int v = 0; v < kTile; ++v) acc[u][v] += a[u] * b[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int v = 0; v < kTile; ++v)
        if (i0 + ntr * u < n && c0 + v < base) S[(c0 + v) * ld + i0 + ntr * u] -= acc[u][v];
  }
}

// Registers capped so that 4 blocks (f32) or 2 (f64, whose matrix at
// n=100 leaves room for 2) share an SM.  kLeaf: the recursion's leaf
// (osqp_chol_inverse_leaf), which takes S as it is (no Jacobi scaling)
// and writes T = chol(S)^-1, lower with zeros above, instead of T'T.
template <typename T, bool kLeaf>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
chol_inverse_kernel(const T* __restrict__ M, T* __restrict__ X, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bad;
  T* S = reinterpret_cast<T*>(smem_raw);  // n x ld: L below the diagonal, T' above
  T* d = S + n * ld;                      // Jacobi scaling
  T* td = d + n;                          // diagonal of T
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const T* Mb = M + off;
  T* Xb = X + off;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  if (tid == 0) bad = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const T g = Mb[i * n + i];
    if (kLeaf) {
      d[i] = T(1);  // a diagonal entry that is not positive fails as a pivot
    } else {
      if (!(g > T(0))) bad = 1;
      d[i] = g > T(0) ? T(1) / sqrt(g) : T(NAN);
    }
  }
  __syncthreads();
  // S = d M d below and on the diagonal, zero above, walking M in order
  // with four loads in flight per thread; (i, j) follow without division.
  {
    const int nn = n * n;
    const int di = kThreads / n, dj = kThreads % n;
    int i = tid / n, j = tid % n;
    for (int e0 = tid; e0 < nn; e0 += 4 * kThreads) {
      T v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = e0 + q * kThreads < nn ? Mb[e0 + q * kThreads] : T(0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e0 + q * kThreads < nn) S[i * ld + j] = j <= i ? (kLeaf ? v[q] : v[q] * d[i] * d[j]) : T(0);
        i += di;
        j += dj;
        if (j >= n) {
          j -= n;
          ++i;
        }
      }
    }
  }
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += kNB) {
    const int kb = min(kNB, n - k0);
    if (warp == 0) factor_diagonal(S, td, ld, k0, kb, &bad);
    __syncthreads();
    for (int i = k0 + kb + tid; i < n; i += kThreads) solve_panel_row(S, td, ld, k0, kb, i);
    __syncthreads();
    trailing_update(S, ld, k0, kb, n);
    __syncthreads();
  }

  for (int k0 = warp * kNB; k0 < n; k0 += kWarps * kNB) invert_diagonal(S, td, ld, k0, min(kNB, n - k0));
  __syncthreads();
  for (int k0 = 0; k0 < n; k0 += kNB) {
    const int kb = min(kNB, n - k0);
    scale_block_row(S, td, ld, k0, kb);
    __syncthreads();
    forward_update(S, ld, k0, kb, n);
    __syncthreads();
  }

  const bool nan_out = bad != 0;
  if (kLeaf) {
    // T itself, row by row: T_rc is S[c][r] below the diagonal.
    for (int e = tid; e < n * n; e += kThreads) {
      const int r = e / n, c = e - r * n;
      Xb[e] = nan_out ? T(NAN) : tval(S, td, ld, r, c);
    }
    return;
  }

  // X = d (T'T) d: X_ij = sum_{k >= max(i, j)} T_ki T_kj, lower tiles.
  const int nt = (n + kTile - 1) / kTile;
  for (int t = tid; t < nt * (nt + 1) / 2; t += kThreads) {
    int ti, tj;
    lower_tile(t, ti, tj);
    const int i0 = kTile * ti, j0 = kTile * tj;
    T acc[kTile][kTile] = {};
    // k < i0 + 4 meets the diagonal of T; beyond it every T_ki sits in the
    // upper triangle of S, read along rows i (clamped to n - 1: rows past
    // n are read but never stored).
    const int head = min(i0 + kTile, n);
    for (int k = i0; k < head; ++k) {
      T a[kTile], b[kTile];
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        a[u] = tval(S, td, ld, k, min(i0 + u, n - 1));
        b[u] = tval(S, td, ld, k, min(j0 + u, n - 1));
      }
#pragma unroll
      for (int u = 0; u < kTile; ++u)
#pragma unroll
        for (int v = 0; v < kTile; ++v) acc[u][v] += a[u] * b[v];
    }
    const T* ra[kTile];
    const T* rb[kTile];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      ra[u] = S + min(i0 + u, n - 1) * ld;
      rb[u] = S + min(j0 + u, n - 1) * ld;
    }
#pragma unroll 4
    for (int k = head; k < n; ++k) {
      T a[kTile], b[kTile];
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        a[u] = ra[u][k];
        b[u] = rb[u][k];
      }
#pragma unroll
      for (int u = 0; u < kTile; ++u)
#pragma unroll
        for (int v = 0; v < kTile; ++v) acc[u][v] += a[u] * b[v];
    }
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        const int i = i0 + u, j = j0 + v;
        if (i < n && j <= i) {
          const T x = nan_out ? T(NAN) : acc[u][v] * d[i] * d[j];
          Xb[i * n + j] = x;
          Xb[j * n + i] = x;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The leaf's cluster form: one instance over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kPitch = kNB + 1;  // odd: rows of a 16-column panel at this pitch meet 32 banks
constexpr int kLeafClusterMax = 16;
constexpr int kBlockValues = kNB * kPitch;
// Dynamic shared memory a CTA of the cluster form may take: the 227 KB a
// block may use less 64 bytes for the static flag (ops/spd_inverse.py
// sizes by the same figure).
constexpr int kLeafClusterSmem = osqp_cuda::kMaxSmem - 64;

// Shared memory of one CTA of the cluster form, in values: its strip of s
// rows (pitch n), its rows of the current panel, the panel buffer (X's
// block row and L's panel column below it, 17 n at most) and the current
// diagonal block twice.  ops/spd_inverse.py:_leaf_cluster_values repeats
// this sum.
inline size_t leaf_cluster_values(int n, int s) {
  return static_cast<size_t>(s) * n + static_cast<size_t>(s) * kPitch + static_cast<size_t>(kPitch) * n +
         2 * kBlockValues;
}

#ifdef OSQP_STAMPS
// cycles by phase of the cluster leaf (tools/probe_k2_leaf.py): load, the
// diagonal block, the panel solve, X's block row and the publication,
// the barrier, the loads, the next diagonal block, the updates, the end
__device__ unsigned long long leaf_stamps[2][16];
#endif

// Device memory a cluster leaf needs beside S and T, in values per
// instance: L's panel columns by the panel's parity (n x 16 each) and the
// next diagonal block, published, by parity (16 x 16 each).
__host__ __device__ inline size_t leaf_cluster_scratch(int n) {
  return 2 * static_cast<size_t>(n) * kNB + 2 * kNB * kNB;
}

// Lane r of the calling warp factors row r of the kb x kb block D (pitch
// kPitch, lower) in place, right-looking by columns, its row in registers
// shifted one column a step so that every register index is static;
// column kNB of row j (the pitch's spare) takes 1 / L_jj.  Each column costs a reciprocal square root and
// products, no division and no square root: the card's correctly rounded
// division and square root cost several hundred cycles a step on this
// chain (PERF.md).  Flags a pivot that is not positive.
__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }

template <typename T>
__device__ void factor_block(T* D, int kb, int* bad) {
  const int r = threadIdx.x & 31;
  T a[kNB];
#pragma unroll
  for (int u = 0; u < kNB; ++u) a[u] = r < kb && u <= r ? D[r * kPitch + u] : T(0);
#pragma unroll
  for (int jj = 0; jj < kNB; ++jj) {
    if (jj >= kb) break;
    const T piv = __shfl_sync(kFull, a[0], jj);
    if (r == 0 && !(piv > T(0))) *bad = 1;
    const T inv = rsq(piv);
    if (r > jj) a[0] *= inv;
    if (r == jj) {
      a[0] = piv * inv;
      D[jj * kPitch + kNB] = inv;
    }
    if (r >= jj && r < kb) D[r * kPitch + jj] = a[0];
#pragma unroll
    for (int u = 1; u < kNB; ++u) {
      const T l = __shfl_sync(kFull, a[0], min(jj + u, 31));
      if (jj + u < kb && r >= jj + u) a[u] -= a[0] * l;
    }
#pragma unroll
    for (int u = 0; u + 1 < kNB; ++u) a[u] = a[u + 1];
    a[kNB - 1] = T(0);
  }
}

// y <- L^-1 y for the kb x kb lower L of factor_block (pitch kPitch, its
// reciprocal diagonal in column kNB) and y the 16 values y[u] = in(u), by
// one thread, forward by columns with the values shifted as in
// factor_block; out(jj, value) takes each result as it comes.
template <typename T, typename In, typename Out>
__device__ __forceinline__ void forward16(const T* L, int kb, In in, Out out) {
  T a[kNB];
#pragma unroll
  for (int u = 0; u < kNB; ++u) a[u] = u < kb ? in(u) : T(0);
#pragma unroll
  for (int jj = 0; jj < kNB; ++jj) {
    if (jj >= kb) break;
    const T v = a[0] * L[jj * kPitch + kNB];
    out(jj, v);
#pragma unroll
    for (int u = 1; u < kNB; ++u)
      if (jj + u < kb) a[u] -= L[(jj + u) * kPitch + jj] * v;
#pragma unroll
    for (int u = 0; u + 1 < kNB; ++u) a[u] = a[u + 1];
    a[kNB - 1] = T(0);
  }
}

// T = chol(S)^-1 of one instance over a cluster of k CTAs, for B below
// the SM count, where one CTA an instance would leave most of the card
// idle (the recursion's leaves at B = 1).  CTA q holds rows [q s, q s + s)
// of S in its shared memory, s a multiple of 16, so that every diagonal
// block has one owner.  Row i of the strip holds S's row, then L's, and
// from the left X = L^-1 takes its place: after panel p the columns left
// of the panel's end are X's, the rest S's trailing part.  Panel p
// (columns [j0, j0 + 16)):
//
//   a. warp 0 of every CTA factors the diagonal block L_pp from its own
//      copy of it: every CTA knows a failed pivot;
//   b. the strip's rows below the block solve their panel columns,
//      L_ip = S_ip L_pp^-T (a thread a row), and publish them; the
//      block's owner finishes X's block row, L_pp X_p = [X_p, I] (a
//      thread a column), and writes it to T; the owner of the next
//      diagonal block publishes it as the panels before this one left it;
//   c. one cluster barrier;
//   d. every CTA loads X's block row p, L's panel column below the block
//      and the next diagonal block, which it brings up to date with the
//      panel itself;
//   e. the strip's rows below the block: the trailing update of S,
//      S_ic -= L_ip L_cp' (the next diagonal block excepted: it was
//      published before), and X's rows, X_i -= L_ip X_p, in one pass by
//      columns, each thread holding its column's 16 values of the panel
//      and taking four rows at a time.
//
// So a panel costs one cluster barrier.  What is published goes through
// device memory (T itself, and the scratch for L's panel columns and the
// next diagonal block, alternating by the panel's parity, so that no
// CTA overwrites what a slower one still loads) and L2: every CTA loads
// the same X row and panel, which one owner's shared memory, serving
// about a request a cycle, took 75% of the leaf's time to hand out
// (PERF.md).  Products are fused (the leaf is held to its plain version
// within a tolerance, not bit for bit); a failed pivot gives NaN over the
// whole instance.
template <typename T>
__global__ void __launch_bounds__(kThreads) cluster_leaf_kernel(const T* __restrict__ S, T* __restrict__ X,
                                                                T* __restrict__ scratch, int n, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bad;
  const int k = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int q = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const int r0 = q * s, rows = max(0, min(s, n - r0));
  T* R = reinterpret_cast<T*>(smem_raw);            // the strip, pitch n
  T* Lown = R + static_cast<size_t>(s) * n;         // [s][kPitch]: L's panel columns of the strip
  T* PX = Lown + static_cast<size_t>(s) * kPitch;   // X's block row, then L's panel column
  T* Dc = PX + static_cast<size_t>(kPitch) * n;     // [2]: the current diagonal block
  const size_t inst = blockIdx.x / k;
  const T* Si = S + inst * n * n;
  T* Xi = X + inst * n * n;
  T* Lg = scratch + inst * leaf_cluster_scratch(n);  // [2][n][16]
  T* Dg = Lg + 2 * static_cast<size_t>(n) * kNB;     // [2][16][16]
  STAMP_DECL(leaf_stamps)

  for (int e = tid; e < rows * n; e += nt) R[e] = Si[static_cast<size_t>(r0) * n + e];
  {
    const int kb = min(kNB, n);
    for (int e = tid; e < kNB * kNB; e += nt) {
      const int rr = e / kNB, cc = e % kNB;
      if (rr < kb && cc <= rr) Dc[rr * kPitch + cc] = Si[static_cast<size_t>(rr) * n + cc];
    }
  }
  if (tid == 0) bad = 0;
  __syncthreads();
  STAMP(0);

  const int np = (n + kNB - 1) / kNB;
  for (int p = 0; p < np; ++p) {
    const int j0 = p * kNB, kb = min(kNB, n - j0), base = j0 + kb;
    const int kb1 = min(kNB, n - base);
    T* D = Dc + (p & 1) * kBlockValues;
    T* Lp = Lg + (p & 1) * static_cast<size_t>(n) * kNB;
    T* Dp = Dg + (p & 1) * kNB * kNB;
    if (warp == 0) factor_block(D, kb, &bad);
    __syncthreads();
    STAMP(1);
    // b. the strip's rows below the block: L_ip = S_ip L_pp^-T, kept and
    // published
    for (int lr = tid; lr < rows; lr += nt) {
      const int r = r0 + lr;
      if (r >= base) {
        const T* a = R + static_cast<size_t>(lr) * n + j0;
        forward16(D, kb, [&](int u) { return a[u]; }, [&](int jj, T v) {
          Lown[lr * kPitch + jj] = v;
          Lp[static_cast<size_t>(r) * kNB + jj] = v;
        });
      }
    }
    STAMP(2);
    // X's block row p, by its owner: L_pp X_p = [X_p, I], a thread a
    // column, into the strip and into T
    if (j0 >= r0 && j0 < r0 + rows) {
      T* xp = R + static_cast<size_t>(j0 - r0) * n;
      for (int c = tid; c < base; c += nt) {
        forward16(
            D, kb, [&](int u) { return c < j0 ? xp[static_cast<size_t>(u) * n + c] : (c - j0 == u ? T(1) : T(0)); },
            [&](int jj, T v) {
              xp[static_cast<size_t>(jj) * n + c] = v;
              Xi[static_cast<size_t>(j0 + jj) * n + c] = v;
            });
      }
    }
    if (base == n) break;
    // the next diagonal block, by its owner, as the panels before this one
    // left it
    if (base >= r0 && base < r0 + rows) {
      for (int e = tid; e < kNB * kNB; e += nt) {
        const int rr = e / kNB, cc = e % kNB;
        if (rr < kb1 && cc <= rr) Dp[rr * kNB + cc] = R[static_cast<size_t>(base - r0 + rr) * n + base + cc];
      }
    }
    STAMP(3);
    osqp_cuda::cluster_barrier();
    STAMP(4);
    // d. X's block row p (columns [0, base)), L's panel column below the
    // block, the next diagonal block, through L2
    T* Xb = PX;                                    // [kb][base]
    T* Pb = PX + static_cast<size_t>(kNB) * base;  // [n - base][kPitch]
    T* Dn = Dc + ((p + 1) & 1) * kBlockValues;
    osqp_cuda::load_rows_l2(Xb, base, Xi + static_cast<size_t>(j0) * n, n, kb, base);
    osqp_cuda::load_rows_l2(Pb, kPitch, Lp + static_cast<size_t>(base) * kNB, kNB, n - base, kb);
    osqp_cuda::load_rows_l2(Dn, kPitch, Dp, kNB, kb1, kb1);
    __syncthreads();
    STAMP(5);
    for (int e = tid; e < kNB * kNB; e += nt) {
      const int rr = e / kNB, cc = e % kNB;
      if (rr < kb1 && cc <= rr) {
        T v = Dn[rr * kPitch + cc];
#pragma unroll
        for (int jj = 0; jj < kNB; ++jj)
          if (jj < kb) v -= Pb[rr * kPitch + jj] * Pb[cc * kPitch + jj];
        Dn[rr * kPitch + cc] = v;
      }
    }
    STAMP(6);
    // e. the strip's rows below the block, by columns: X's columns [0,
    // base) (those of the panel start from zero), S's trailing columns
    // [base, r] without the next diagonal block
    for (int c = tid; c < n; c += nt) {
      const bool xcol = c < base;
      T pc[kNB];
#pragma unroll
      for (int jj = 0; jj < kNB; ++jj)
        pc[jj] = jj < kb ? (xcol ? Xb[jj * base + c] : Pb[(c - base) * kPitch + jj]) : T(0);
      const int first = xcol ? base : (c < base + kNB ? base + kNB : c);
      const bool fresh = xcol && c >= j0;
      int lr = max(first - r0, 0);
      // four rows at a time: four independent chains
      for (; lr + 4 <= rows; lr += 4) {
        T acc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fresh ? T(0) : R[static_cast<size_t>(lr + u) * n + c];
#pragma unroll
        for (int jj = 0; jj < kNB; ++jj)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u] -= Lown[(lr + u) * kPitch + jj] * pc[jj];
#pragma unroll
        for (int u = 0; u < 4; ++u) R[static_cast<size_t>(lr + u) * n + c] = acc[u];
      }
      for (; lr < rows; ++lr) {
        T acc = fresh ? T(0) : R[static_cast<size_t>(lr) * n + c];
#pragma unroll
        for (int jj = 0; jj < kNB; ++jj) acc -= Lown[lr * kPitch + jj] * pc[jj];
        R[static_cast<size_t>(lr) * n + c] = acc;
      }
    }
    __syncthreads();
    STAMP(7);
  }
  __syncthreads();
  const bool nan_out = bad != 0;
  for (int e = tid; e < rows * n; e += nt) {
    const int lr = e / n, c = e - lr * n;
    Xi[static_cast<size_t>(r0) * n + e] = nan_out ? T(NAN) : (c <= r0 + lr ? R[e] : T(0));
  }
  STAMP(8);
}

template <typename T>
size_t smem_bytes(int n, int ld) {
  return (static_cast<size_t>(n) * ld + 2 * n) * sizeof(T);
}

// The leading dimension of S: odd where the matrix leaves room for it.
template <typename T>
int leading_dim(int n) {
  const int ld = n | 1;
  return smem_bytes<T>(n, ld) + sizeof(int) > static_cast<size_t>(osqp_cuda::kMaxSmem) ? n : ld;
}

template <typename T, bool kLeaf>
int launch(const void* M, void* X, int B, int n, cudaStream_t stream) {
  const int ld = leading_dim<T>(n);
  const size_t smem = smem_bytes<T>(n, ld);
  if (smem + sizeof(int) > static_cast<size_t>(osqp_cuda::kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(chol_inverse_kernel<T, kLeaf>, smem, sizeof(int));
  if (err == cudaSuccess) err = prefer_shared(chol_inverse_kernel<T, kLeaf>);
  if (err != cudaSuccess) return err;
  chol_inverse_kernel<T, kLeaf><<<B, kThreads, smem, stream>>>(static_cast<const T*>(M), static_cast<T*>(X), n, ld);
  return cudaGetLastError();
}

// The cluster form: B clusters of k CTAs, strips of s = 16 ceil(n / 16 k)
// rows.  What the card cannot take is refused, never replaced by the
// one-CTA form.
template <typename T>
int launch_cluster(const void* S, void* X, void* scratch, int B, int n, int k, cudaStream_t stream) {
  if (k < 1 || k > kLeafClusterMax || static_cast<long long>(B) * k > INT_MAX) return cudaErrorInvalidValue;
  const int s = kNB * ((n + kNB * k - 1) / (kNB * k));
  const size_t smem = leaf_cluster_values(n, s) * sizeof(T);
  if (smem > static_cast<size_t>(kLeafClusterSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cluster_leaf_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = allow_smem(cluster_leaf_kernel<T>, smem, sizeof(int));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_leaf_kernel<T>, static_cast<const T*>(S), static_cast<T*>(X),
                           static_cast<T*>(scratch), n, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Blocks of the kernel that one SM holds at once; negative on error.
template <typename T>
int blocks_per_sm(int n) {
  const size_t smem = smem_bytes<T>(n, leading_dim<T>(n));
  int blocks = 0;
  if (allow_smem(chol_inverse_kernel<T, false>, smem, sizeof(int)) != cudaSuccess ||
      prefer_shared(chol_inverse_kernel<T, false>) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chol_inverse_kernel<T, false>, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// dtype: 0 float32, 1 float64.  M and X are contiguous (B, n, n).
extern "C" int osqp_chol_inverse(int dtype, const void* M, void* X, int B, int n, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float, false>(M, X, B, n, s) : launch<double, false>(M, X, B, n, s);
}

// The recursion's leaf: T = chol(S)^-1 of each (n, n) S, lower with zeros
// above (NaN over the whole instance where S is not PD), no scaling.  S
// and T contiguous (B, n, n); n as osqp_chol_inverse's.
extern "C" int osqp_chol_inverse_leaf(int dtype, const void* S, void* T, int B, int n, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float, true>(S, T, B, n, s) : launch<double, true>(S, T, B, n, s);
}

// The leaf's cluster form (B below the SM count): each instance over a
// cluster of k CTAs (k <= 16), n up to what a cluster of k holds
// (ops/spd_inverse.py:cluster_fits); the same outputs as
// osqp_chol_inverse_leaf.  scratch: B x osqp_chol_inverse_leaf_scratch(n)
// values of the dtype, contents ignored.
extern "C" int osqp_chol_inverse_leaf_cluster(int dtype, const void* S, void* T, void* scratch, int B, int n, int k,
                                              void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_cluster<float>(S, T, scratch, B, n, k, s)
                    : launch_cluster<double>(S, T, scratch, B, n, k, s);
}

// Values of scratch one instance of the cluster form takes at n.
extern "C" long long osqp_chol_inverse_leaf_scratch(int n) { return static_cast<long long>(leaf_cluster_scratch(n)); }

#ifdef OSQP_STAMPS
// The cluster leaf's cycles by phase since the last call, [CTA 0, CTA k -
// 1 of the first instance][16 phases], and zero them.
extern "C" int osqp_leaf_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, leaf_stamps, sizeof(leaf_stamps));
  static const unsigned long long zero[2][16] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(leaf_stamps, zero, sizeof(leaf_stamps));
  return err;
}
#endif

// Blocks per SM at n (dtype as above); negative on a CUDA error.
extern "C" int osqp_chol_inverse_blocks_per_sm(int dtype, int n) {
  return dtype == 0 ? blocks_per_sm<float>(n) : blocks_per_sm<double>(n);
}
