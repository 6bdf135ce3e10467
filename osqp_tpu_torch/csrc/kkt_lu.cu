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
// works in place in device memory by column panels, as a short sequence
// of launches per panel, all enqueued by one C call:
//
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
//      A22 -= L21 U12 in 4 x 4 register tiles.  At B = 1 this is where one
//      instance spreads over the card (1225 blocks at N = 2250).
//   4. perm_kernel turns the pivots into perm.
//
// Every value takes its updates in the order of the unblocked
// right-looking algorithm, a_ic <- a_ic - l_ik u_kc for k = 0, 1, ...,
// each product and difference rounded on its own.  So the factors, and
// with them every pivot choice, are bit for bit those of the plain
// PyTorch version (ops/kkt_lu.py:kkt_lu_factor_plain), and two launches
// agree bit for bit: nothing here is atomic.
//
// The solve is one block per instance (1024 threads where the batch
// cannot fill the card, 256 otherwise) with the right-hand side in
// shared memory: by groups of 32 rows, every warp takes dot products of
// the rows' off-diagonal parts against the entries already solved, then
// one warp solves the 32 x 32 diagonal block by shuffles.
//
// What bounds them on the H100: the factor does (2/3) N^3 operations an
// instance and, blocked by 32 columns, moves the trailing matrix through
// device memory N / 32 times (about N^3 / 48 values read and written an
// instance), so at the headline its bytes, not its operations, set the
// time; the panel step adds a chain of four block barriers per column.
// The solve reads lu once and is bound by those bytes; at B = 1 one SM
// pulls them alone.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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
constexpr int kSolveThreadsWide = 1024;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory a staged panel may take: what a block may use, less the
// kernel's static shared memory.
constexpr size_t kPanelSmem = osqp_cuda::kMaxSmem - 1024;

template <typename T>
__device__ __forceinline__ T absval(T v) {
  return v < T(0) ? -v : v;
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
                                                              int k0, int nb, int chunks) {
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
  if (t >= N - nb) return;
  const int c = t < k0 ? t : t + nb;
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

// A22 <- A22 - L21 U12 behind the panel [k0, k0 + nb): block (b, ti, tj)
// takes a kTile x kTile tile, thread (ty, tx) the values at rows
// ty + 16 u and columns tx + 16 v, subtracting the products in the order
// of k.
template <typename T>
__global__ void __launch_bounds__(kThreads) update_kernel(T* __restrict__ lu, int N, int k0, int nb, int tiles) {
  __shared__ T Ls[kTile][kMaxNB + 1];
  __shared__ T Us[kMaxNB][kTile];
  const int tid = threadIdx.x;
  const int per = tiles * tiles;
  const int b = blockIdx.x / per, t = blockIdx.x - b * per;
  const int ti = t / tiles, tj = t - ti * tiles;
  const int k1 = k0 + nb;
  const int r0 = k1 + ti * kTile, c0 = k1 + tj * kTile;
  T* M = lu + static_cast<size_t>(b) * N * N;
  for (int e = tid; e < kTile * nb; e += kThreads) {
    const int i = e / nb, k = e - i * nb;
    Ls[i][k] = r0 + i < N ? M[static_cast<size_t>(r0 + i) * N + k0 + k] : T(0);
  }
  for (int e = tid; e < nb * kTile; e += kThreads) {
    const int k = e / kTile, j = e - k * kTile;
    Us[k][j] = c0 + j < N ? M[static_cast<size_t>(k0 + k) * N + c0 + j] : T(0);
  }
  __syncthreads();
  const int tx = tid & 15, ty = tid >> 4;
  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = r0 + ty + 16 * u, c = c0 + tx + 16 * v;
      acc[u][v] = (r < N && c < N) ? M[static_cast<size_t>(r) * N + c] : T(0);
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
      if (r < N && c < N) M[static_cast<size_t>(r) * N + c] = acc[u][v];
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

template <typename T>
int factor(void* lu_, int* piv, int* perm, int B, int N, cudaStream_t stream) {
  T* lu = static_cast<T*>(lu_);
  bool staged;
  // a later, shorter panel may be wider and take more than the first
  cudaError_t err = allow_smem(panel_kernel<T>, kPanelSmem);
  if (err != cudaSuccess) return err;
  for (int k0 = 0; k0 < N;) {
    const int rows = N - k0;
    const int nb = panel_width<T>(rows, staged);
    panel_kernel<T><<<B, kThreads, staged ? panel_bytes<T>(rows, nb) : 0, stream>>>(lu, piv, N, k0, nb, staged);
    const int outside = N - nb;
    if (outside > 0) {
      // the columns in chunks of equal size, whole warps, at most kThreads
      const int chunks = (outside + kThreads - 1) / kThreads;
      const int threads = ((outside + chunks - 1) / chunks + 31) / 32 * 32;
      if (!fits_grid(static_cast<long long>(B) * chunks)) return cudaErrorInvalidValue;
      swap_solve_kernel<T><<<B * chunks, threads, 0, stream>>>(lu, piv, N, k0, nb, chunks);
    }
    const int trailing = rows - nb;
    if (trailing > 0) {
      const int tiles = (trailing + kTile - 1) / kTile;
      if (!fits_grid(static_cast<long long>(B) * tiles * tiles)) return cudaErrorInvalidValue;
      update_kernel<T><<<B * tiles * tiles, kThreads, 0, stream>>>(lu, N, k0, nb, tiles);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    k0 += nb;
  }
  const size_t smem = 2 * static_cast<size_t>(N) * sizeof(int);
  err = allow_smem(perm_kernel, smem);
  if (err != cudaSuccess) return err;
  perm_kernel<<<B, kThreads, smem, stream>>>(piv, perm, N);
  return cudaGetLastError();
}

template <typename T>
int solve(const void* lu, const int* perm, const void* rhs, void* x, int B, int N, int sm_count, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N) * sizeof(T);
  const cudaError_t err = allow_smem(lu_solve_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  // a batch that cannot give every SM a block takes wide blocks
  const int threads = B < sm_count ? kSolveThreadsWide : kThreads;
  lu_solve_kernel<T><<<B, threads, smem, stream>>>(static_cast<const T*>(lu), perm, static_cast<const T*>(rhs),
                                                   static_cast<T*>(x), N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  lu is a contiguous (B, N, N) batch holding
// K, factored in place; piv (scratch) and perm are (B, N) int32.
extern "C" int osqp_kkt_lu_factor(int dtype, void* lu, void* piv, void* perm, int B, int N, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto pv = static_cast<int*>(piv), pm = static_cast<int*>(perm);
  return dtype == 0 ? factor<float>(lu, pv, pm, B, N, s) : factor<double>(lu, pv, pm, B, N, s);
}

// x = U^-1 L^-1 b[perm] with the factors above; b and x are (B, N).
extern "C" int osqp_kkt_lu_solve(int dtype, const void* lu, const void* perm, const void* b, void* x, int B, int N,
                                 int sm_count, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<const int*>(perm);
  return dtype == 0 ? solve<float>(lu, pm, b, x, B, N, sm_count, s) : solve<double>(lu, pm, b, x, B, N, sm_count, s);
}
