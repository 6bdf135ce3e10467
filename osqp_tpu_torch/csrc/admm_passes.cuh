// The passes from which K1 (admm_iter.cu) and K1r (admm_iter_refined.cu)
// build one ADMM iteration, each instance split over blocks.
//
// A pass streams one row-major matrix per instance.  Block (b, tile,
// chunk) takes a tile of rows by a chunk of kChunk = 256 columns, as K3
// and K4 cut theirs (common.cuh, tile_rows), and streams it through the
// bulk-copy ring (common.cuh, stream_rows).  A warp takes a row at a
// time, each lane eight of its columns:
//
//   colsum_kernel: out[b][tile][c] = sum_{r in tile} M[r, c] wt(b, r)
//   rowdot_kernel: out[b][chunk][r] = sum_{c in chunk} M[r, c] v[b][c]
//
// A column sum stays in the lanes' registers until the block adds its
// warps' in order; a row dot is a warp reduction.  The partial sums of
// the tiles or chunks go to scratch, and the next pass adds them in the
// order of the tiles or chunks: no float atomics, so the result does not
// depend on scheduling and two calls on the same inputs agree bit for
// bit.  Blocks of an inactive instance return before reading anything.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace osqp_cuda {

// Up to two matrices side by side, [M0 | M1] of R rows and C0 + C1
// columns; chunk k < chunks0 is a chunk of M0, the rest of M1.  Batch-
// major and contiguous: instance b of M0 starts at M0 + b R C0.
template <typename T>
struct Mats {
  const T* M0;
  const T* M1;
  int C0, C1, chunks0;
};

// out[(b * tiles + tile) * (C0 + C1) + col] = sum over the tile's rows r
// of M[r, col] * wt(b, r), summed in Acc.  wt(b, r) runs once per row of
// the tile, before the matrix is streamed.
template <typename T, typename Acc, typename Weight>
__global__ void __launch_bounds__(kThreads)
colsum_kernel(Mats<T> mats, int R, int rows, Weight wt, const uint8_t* __restrict__ active, Acc* __restrict__ out) {
  const size_t b = blockIdx.x;
  if (!active[b]) return;
  extern __shared__ __align__(128) unsigned char smem[];
  Acc* wts = reinterpret_cast<Acc*>(smem + Ring<T>::kBytes);
  const int tile = blockIdx.y;
  const int r0 = tile * rows;
  const int r1 = min(R, r0 + rows);
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int r = r0 + tid; r < r1; r += kThreads) wts[r - r0] = wt(b, r);

  const bool first = static_cast<int>(blockIdx.z) < mats.chunks0;
  const int C = first ? mats.C0 : mats.C1;
  const int c0 = (first ? blockIdx.z : blockIdx.z - mats.chunks0) * kChunk;
  const int cw = min(kChunk, C - c0);
  const T* M = (first ? mats.M0 : mats.M1) + b * R * static_cast<size_t>(C);
  const int lane = threadIdx.x;

  Acc col[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) col[k] = Acc(0);
  // stream_rows begins with a block barrier: the weights are in place
  stream_rows(M, C, r0, r1, c0, cw, smem, [&](int r, const T* row) {
    const Acc v = wts[r - r0];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      const Acc a = j < cw ? Acc(row[j]) : Acc(0);
      col[k] += a * v;
    }
  });

  // the ring is free: the warps' sums go through it, added in warp order
  Acc* red = reinterpret_cast<Acc*>(smem + Ring<T>::kBarBytes);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) red[threadIdx.y * kChunk + lane + 32 * k] = col[k];
  __syncthreads();
  if (tid < cw) {
    Acc s = red[tid];
    for (int w = 1; w < kWarps; ++w) s += red[w * kChunk + tid];
    const int ld = mats.C0 + mats.C1;
    out[(b * gridDim.y + tile) * ld + (first ? 0 : mats.C0) + c0 + tid] = s;
  }
}

// out[(b * chunks + chunk) * R + r] = sum over the chunk's columns c of
// M[r, c] * v[b][c], summed in Acc.
template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const T* __restrict__ M, int R, int C, int rows, const T* __restrict__ v,
              const uint8_t* __restrict__ active, Acc* __restrict__ out) {
  const size_t b = blockIdx.x;
  if (!active[b]) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const int r0 = blockIdx.y * rows;
  const int r1 = min(R, r0 + rows);
  const int c0 = blockIdx.z * kChunk;
  const int cw = min(kChunk, C - c0);
  const int lane = threadIdx.x;
  Acc x[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    x[k] = j < cw ? Acc(v[b * C + c0 + j]) : Acc(0);
  }
  stream_rows(M + b * R * static_cast<size_t>(C), C, r0, r1, c0, cw, smem, [&](int r, const T* row) {
    Acc s = Acc(0);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      s += (j < cw ? Acc(row[j]) : Acc(0)) * x[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[(b * gridDim.z + blockIdx.z) * R + r] = s;
  });
}

// Bytes of dynamic shared memory of a pass: the ring, and for a column
// sum the tile's weights.
template <typename T, typename Acc>
size_t pass_smem(int rows, bool weights) {
  static_assert(sizeof(Acc) * kWarps * kChunk <= Ring<T>::kBytes - Ring<T>::kBarBytes,
                "the warps' column sums must fit in the ring");
  return Ring<T>::kBytes + (weights ? sizeof(Acc) * rows : 0);
}

template <typename T, typename Acc, typename Weight>
cudaError_t launch_colsum(Mats<T> mats, int B, int R, int rows, Weight wt, const uint8_t* active, Acc* out,
                          cudaStream_t s) {
  const int tiles = tiles_of(R, rows);
  const int chunks = mats.chunks0 + chunks_of(mats.C1);
  if (B == 0 || tiles == 0 || chunks == 0) return cudaSuccess;
  const size_t smem = pass_smem<T, Acc>(rows, true);
  const cudaError_t err = allow_smem(colsum_kernel<T, Acc, Weight>, smem);
  if (err != cudaSuccess) return err;
  colsum_kernel<T, Acc, Weight><<<dim3(B, tiles, chunks), dim3(32, kWarps), smem, s>>>(mats, R, rows, wt, active, out);
  return cudaGetLastError();
}

template <typename T, typename Acc>
cudaError_t launch_rowdot(const T* M, int B, int R, int C, int rows, const T* v, const uint8_t* active, Acc* out,
                          cudaStream_t s) {
  const int tiles = tiles_of(R, rows);
  const int chunks = chunks_of(C);
  if (B == 0 || tiles == 0 || chunks == 0) return cudaSuccess;
  const size_t smem = pass_smem<T, Acc>(rows, false);
  const cudaError_t err = allow_smem(rowdot_kernel<T, Acc>, smem);
  if (err != cudaSuccess) return err;
  rowdot_kernel<T, Acc><<<dim3(B, tiles, chunks), dim3(32, kWarps), smem, s>>>(M, R, C, rows, v, active, out);
  return cudaGetLastError();
}

// Sum of parts p < nparts of ws[(b * nparts + p) * ld + off + i], in order.
template <typename Acc>
__device__ __forceinline__ Acc sum_parts(const Acc* ws, size_t b, int nparts, int ld, int off, int i) {
  if (nparts == 0) return Acc(0);
  const Acc* src = ws + b * nparts * static_cast<size_t>(ld) + off + i;
  Acc s = src[0];
  for (int p = 1; p < nparts; ++p) s += src[static_cast<size_t>(p) * ld];
  return s;
}

// The weights of the first two passes of both bodies.
// w(b, i) = rho o (z - rho^-1 o y) for a row i of A.
template <typename T>
struct DualWeight {
  const T *rho, *rho_inv, *z, *y;
  int m;
  __device__ T operator()(size_t b, int i) const {
    const size_t k = b * m + i;
    return mul(rho[k], sub(z[k], mul(rho_inv[k], y[k])));
  }
};

// t(b, j) = (sigma x - q) + (A'w)_j, the A'w partials added in tile
// order; chunk 0 of each tile writes t to t_out when that is not null.
template <typename T>
struct RhsWeight {
  const T *x, *q, *parts;
  T* t_out;
  T sigma;
  int n, nparts;
  __device__ T operator()(size_t b, int j) const {
    const size_t k = b * n + j;
    const T t = add(sub(mul(sigma, x[k]), q[k]), sum_parts(parts, b, nparts, n, 0, j));
    if (t_out && blockIdx.z == 0) t_out[k] = t;
    return t;
  }
};

// The relaxed x/z/y updates of admm_step and the active-mask selects,
// with x~ and z~ given as partial sums (Parts), rounded one operation at
// a time as PyTorch rounds them:
//   x' = alpha x~ + (1 - alpha) x,               dx = x' - x
//   zr = alpha z~ + (1 - alpha) z
//   z' = clip(zr + rho^-1 o y, l, u),            dy = rho o (zr - z')
//   y' = y + dy, or with a carry y_lo the TwoSum of (y, dy + y_lo)
// Inactive instances copy their inputs.
template <typename T>
struct Parts {
  const T* ws;
  int nparts, ld, off;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(Parts<T> xt, Parts<T> zt, const T* __restrict__ l, const T* __restrict__ u,
                const T* __restrict__ rho, const T* __restrict__ rho_inv, const uint8_t* __restrict__ active,
                const T* __restrict__ x, const T* __restrict__ z, const T* __restrict__ y,
                const T* __restrict__ dx, const T* __restrict__ dy, const T* __restrict__ y_lo,
                T* __restrict__ x_out, T* __restrict__ z_out, T* __restrict__ y_out, T* __restrict__ dx_out,
                T* __restrict__ dy_out, T* __restrict__ y_lo_out, T alpha, int B, int n, int m) {
  const size_t nx = static_cast<size_t>(B) * n;
  const size_t total = nx + static_cast<size_t>(B) * m;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const T one_m_alpha = sub(T(1), alpha);
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total; e += stride) {
    if (e < nx) {
      const size_t b = e / n;
      const int j = static_cast<int>(e - b * n);
      if (!active[b]) {
        x_out[e] = x[e];
        dx_out[e] = dx[e];
        continue;
      }
      const T xp = x[e];
      const T xn = add(mul(alpha, sum_parts(xt.ws, b, xt.nparts, xt.ld, xt.off, j)), mul(one_m_alpha, xp));
      x_out[e] = xn;
      dx_out[e] = sub(xn, xp);
    } else {
      const size_t k = e - nx;
      const size_t b = k / m;
      const int i = static_cast<int>(k - b * m);
      if (!active[b]) {
        z_out[k] = z[k];
        y_out[k] = y[k];
        dy_out[k] = dy[k];
        if (y_lo) y_lo_out[k] = y_lo[k];
        continue;
      }
      const T zp = z[k];
      const T yp = y[k];
      const T zr = add(mul(alpha, sum_parts(zt.ws, b, zt.nparts, zt.ld, zt.off, i)), mul(one_m_alpha, zp));
      // clip as max-then-min with NaN passing through, like torch.clamp
      T zn = add(zr, mul(rho_inv[k], yp));
      zn = zn < l[k] ? l[k] : zn;
      zn = zn > u[k] ? u[k] : zn;
      const T dyn = mul(rho[k], sub(zr, zn));
      z_out[k] = zn;
      dy_out[k] = dyn;
      if (y_lo) {
        // TwoSum(y, dy + y_lo): the exact sum split into (hi, lo)
        const T bsum = add(dyn, y_lo[k]);
        const T s = add(yp, bsum);
        const T bb = sub(s, yp);
        y_lo_out[k] = add(sub(yp, sub(s, bb)), sub(bsum, bb));
        y_out[k] = s;
      } else {
        y_out[k] = add(yp, dyn);
      }
    }
  }
}

// Carves scratch buffers, each 256-byte aligned, out of one allocation;
// with a null base it only counts the bytes.
struct Carve {
  unsigned char* base;
  size_t used = 0;
  template <typename U>
  U* take(size_t count) {
    U* p = base ? reinterpret_cast<U*>(base + used) : nullptr;
    used += (count * sizeof(U) + 255) & ~size_t(255);
    return p;
  }
};

}  // namespace osqp_cuda
