// K3: the matrix products of the termination checks, the infeasibility
// certificates and the rho estimate, for a batch of dense QPs.
//
// Replaces the products of osqp_tpu/termination.py:compute_products
// (A x, P x, A'y), primal_infeasibility (A'dy), dual_infeasibility
// (P dx, A dx) and compute_rho_estimate, and of
// osqp_tpu/admm.py:segment_row_info.  The JAX package makes each a
// separate product, and so does the plain version (six bmm GEMVs on the
// card).  Here one pass over A gives A x, A dx (row dots) and A'y, A'dy
// (column sums), and one pass over P gives P x and P dx:
//
//   row_out[v][b][i] = sum_j M_ij vec_v[b][j]          v: x, dx
//   col_out[v][b][j] = sum_i M_ij wgt_v[b][i]          v: y, dy   (A only)
//
// What bounds it on the H100: device-memory bandwidth, since every
// matrix value is used for two to four multiply-adds.  The design reads
// each matrix once with coalesced loads and splits the rows of one
// instance over blocks, so that B=1 at n=1000 fills the card as B=8192
// at n=100 does.  A block takes a tile of rows by 256 columns; a warp
// takes one row at a time, each lane eight columns of it, so that a row
// dot is a warp reduction and a column sum stays in the lane's
// registers until the warps of the block add theirs.  Partial sums of
// several column chunks or row tiles go to scratch and a second kernel
// adds them in a fixed order: the result does not depend on scheduling.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace osqp_cuda;

// One (rows x 256 columns) tile of an R x C matrix of instance
// blockIdx.x.  Row dots with v0 (and v1 when nv == 2) go to
//   rowdst[v * rv + b * rb + chunk * R + r],
// column sums weighted by w0 (and w1) to
//   coldst[v * cv + b * cb + tile * C + c];
// with w0 null no column sums are taken.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rowcol_kernel(const T* __restrict__ M, int R, int C, int rows, int nv, const T* __restrict__ v0,
              const T* __restrict__ v1, const T* __restrict__ w0, const T* __restrict__ w1,
              T* __restrict__ rowdst, size_t rv, size_t rb, T* __restrict__ coldst, size_t cv, size_t cb) {
  __shared__ T red[2][kWarps][kChunk];
  const size_t b = blockIdx.x;
  const int tile = blockIdx.y;
  const int chunk = blockIdx.z;
  const int r0 = tile * rows;
  const int r1 = min(R, r0 + rows);
  const int c0 = chunk * kChunk;
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const bool two = nv > 1;
  const T* Mb = M + b * R * C;

  T x0[kPerLane], x1[kPerLane], col0[kPerLane], col1[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = c0 + lane + 32 * k;
    x0[k] = c < C ? v0[b * C + c] : T(0);
    x1[k] = two && c < C ? v1[b * C + c] : T(0);
    col0[k] = T(0);
    col1[k] = T(0);
  }

  for (int r = r0 + w; r < r1; r += kWarps) {
    T a[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + lane + 32 * k;
      a[k] = c < C ? Mb[static_cast<size_t>(r) * C + c] : T(0);
    }
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      s0 += a[k] * x0[k];
      s1 += a[k] * x1[k];
    }
    if (w0) {
      const T y0 = w0[b * R + r];
      const T y1 = two ? w1[b * R + r] : T(0);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        col0[k] += a[k] * y0;
        col1[k] += a[k] * y1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (lane == 0) {
      const size_t at = b * rb + static_cast<size_t>(chunk) * R + r;
      rowdst[at] = s0;
      if (two) rowdst[rv + at] = s1;
    }
  }

  if (!w0) return;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    red[0][w][lane + 32 * k] = col0[k];
    red[1][w][lane + 32 * k] = col1[k];
  }
  __syncthreads();
  const int tid = w * 32 + lane;
  const int c = c0 + tid;
  if (c < C) {
    T s0 = red[0][0][tid], s1 = red[1][0][tid];
    for (int k = 1; k < kWarps; ++k) {
      s0 += red[0][k][tid];
      s1 += red[1][k][tid];
    }
    const size_t at = b * cb + static_cast<size_t>(tile) * C + c;
    coldst[at] = s0;
    if (two) coldst[cv + at] = s1;
  }
}

// out[v][b][i] = sum_p ws[v][b][p][i] for i < L, p < parts, in order of p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const T* __restrict__ ws, T* __restrict__ out, int nv, int B, int parts, int L) {
  const size_t total = static_cast<size_t>(nv) * B * L;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total; e += stride) {
    const size_t vb = e / L;
    const size_t i = e - vb * L;
    const T* src = ws + vb * parts * L + i;
    T s = T(0);
    for (int p = 0; p < parts; ++p) s += src[static_cast<size_t>(p) * L];
    out[e] = s;
  }
}

template <typename T>
int launch(void* const* p, int B, int n, int m, int rows_a, int rows_p, cudaStream_t s) {
  auto in = [&](int k) { return static_cast<const T*>(p[k]); };
  auto out = [&](int k) { return static_cast<T*>(p[k]); };
  const T *P = in(0), *A = in(1), *x = in(2), *y = in(3), *dx = in(4), *dy = in(5);
  T *row_out = out(6), *p_out = out(7), *col_out = out(8), *row_ws = out(9), *col_ws = out(10);
  const int nv = dx ? 2 : 1;
  const int chunks = chunks_of(n);
  const dim3 block(32, kWarps);

  if (m > 0) {
    const int tiles = (m + rows_a - 1) / rows_a;
    T* rdst = chunks > 1 ? row_ws : row_out;
    const size_t rv = static_cast<size_t>(B) * chunks * m;
    T* cdst = tiles > 1 ? col_ws : col_out;
    const size_t cv = static_cast<size_t>(B) * tiles * n;
    rowcol_kernel<T><<<dim3(B, tiles, chunks), block, 0, s>>>(
        A, m, n, rows_a, nv, x, dx, y, dy, rdst, rv, static_cast<size_t>(chunks) * m, cdst, cv,
        static_cast<size_t>(tiles) * n);
    if (chunks > 1)
      finish_kernel<T><<<grid_size(rv * nv / chunks), kThreads, 0, s>>>(row_ws, row_out, nv, B, chunks, m);
    if (tiles > 1)
      finish_kernel<T><<<grid_size(cv * nv / tiles), kThreads, 0, s>>>(col_ws, col_out, nv, B, tiles, n);
  } else {
    const cudaError_t err = cudaMemsetAsync(col_out, 0, sizeof(T) * nv * static_cast<size_t>(B) * n, s);
    if (err != cudaSuccess) return err;
  }

  const int tiles = (n + rows_p - 1) / rows_p;
  T* rdst = chunks > 1 ? row_ws : p_out;
  const size_t rv = static_cast<size_t>(B) * chunks * n;
  rowcol_kernel<T><<<dim3(B, tiles, chunks), block, 0, s>>>(
      P, n, n, rows_p, nv, x, dx, nullptr, nullptr, rdst, rv, static_cast<size_t>(chunks) * n, nullptr, 0, 0);
  if (chunks > 1)
    finish_kernel<T><<<grid_size(rv * nv / chunks), kThreads, 0, s>>>(row_ws, p_out, nv, B, chunks, n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  P (B,n,n), A (B,m,n), x (B,n), y (B,m);
// dx (B,n) and dy (B,m) both given or both null.  Outputs, nv = 2 with
// dx and dy else 1: row_out (nv,B,m) = [A x, A dx], p_out (nv,B,n) =
// [P x, P dx], col_out (nv,B,n) = [A'y, A'dy].  Scratch: row_ws holds
// nv*B*chunks*max(m,n) values when n > 256 (else null), col_ws
// nv*B*ceil(m/rows_a)*n when that tile count exceeds 1 (else null).
// All contiguous, n >= 1.
extern "C" int osqp_term_products(int dtype, const void* P, const void* A, const void* x,
                                  const void* y, const void* dx, const void* dy, void* row_out,
                                  void* p_out, void* col_out, void* row_ws, void* col_ws, int B,
                                  int n, int m, int rows_a, int rows_p, void* stream) {
  if (B == 0) return cudaSuccess;
  void* const p[11] = {const_cast<void*>(P), const_cast<void*>(A), const_cast<void*>(x),
                       const_cast<void*>(y), const_cast<void*>(dx), const_cast<void*>(dy),
                       row_out, p_out, col_out, row_ws, col_ws};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, B, n, m, rows_a, rows_p, s)
                    : launch<double>(p, B, n, m, rows_a, rows_p, s);
}
