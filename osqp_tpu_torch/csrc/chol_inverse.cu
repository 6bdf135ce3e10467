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
// are batched GEMMs, as the JAX package leaves them to XLA.  At B = 1 the
// leaves run one after another, each on one block: one SM of the card.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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
  cudaError_t err = allow_smem(chol_inverse_kernel<T, kLeaf>, smem);
  if (err == cudaSuccess) err = prefer_shared(chol_inverse_kernel<T, kLeaf>);
  if (err != cudaSuccess) return err;
  chol_inverse_kernel<T, kLeaf><<<B, kThreads, smem, stream>>>(static_cast<const T*>(M), static_cast<T*>(X), n, ld);
  return cudaGetLastError();
}

// Blocks of the kernel that one SM holds at once; negative on error.
template <typename T>
int blocks_per_sm(int n) {
  const size_t smem = smem_bytes<T>(n, leading_dim<T>(n));
  int blocks = 0;
  if (allow_smem(chol_inverse_kernel<T, false>, smem) != cudaSuccess ||
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

// Blocks per SM at n (dtype as above); negative on a CUDA error.
extern "C" int osqp_chol_inverse_blocks_per_sm(int dtype, int n) {
  return dtype == 0 ? blocks_per_sm<float>(n) : blocks_per_sm<double>(n);
}
