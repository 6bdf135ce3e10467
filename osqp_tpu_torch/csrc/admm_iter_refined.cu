// K1r: one masked ADMM iteration of the dense_inv backend, refined body,
// one thread block per instance.
//
// Replaces osqp_tpu/linsys/dense_inv.py:solve(refine=True) together with
// osqp_tpu/admm.py:admm_step (its TwoSum dual carry, :152-160) and the
// active-mask selects of the refined loop body (admm.py:318-348), the
// body that ill-conditioned batches run.  For each active instance b:
//
//   w  = rho o (z - rho^-1 o y)
//   t  = sigma x - q + A' w
//   x~ = Minv t
//   repeat ncorr times (2 in float32, 1 in float64):
//     r  = t - (P x~ + sigma x~ + A'(rho o (A x~)))     accumulated in f64
//     x~ = x~ + Minv r
//   z~ = A x~                                           (not AMinvT t)
//   x' = alpha x~ + (1 - alpha) x,                      dx = x' - x
//   zr = alpha z~ + (1 - alpha) z
//   z' = clip(zr + rho^-1 o y, l, u),                  dy = rho o (zr - z')
//   y' = y + dy, in float32 as TwoSum(y, dy + y_lo) with the low part
//   carried in y_lo
//
// and copies x, z, y, dx, dy (and y_lo) unchanged where active[b] is
// false.  The residual of a float32 solve is summed in double from the
// float32 operands, converted in registers: no f64 copy of P or A is
// made.  Elementwise steps round each operation on its own (__fmul_rn
// and friends), as PyTorch does, so that TwoSum stays exact and only the
// order of the sums differs from the plain version.
//
// What bounds it on the H100: device-memory bandwidth.  An iteration
// reads A five times in float32 (A'w, twice A x~ and A'(rho A x~), and
// A x~ at the end), Minv three times and P twice, against K1's one pass
// over Minv, AMinvT and A.  Matrix products keep four rows in flight per
// thread with coalesced loads: column sums (A'v, Minv v; Minv is read as
// Minv' v, as the plain version applies it) let the 32 lanes of a warp
// take neighbouring columns and the warps split the rows; row dots
// (A x, P x) give a row to a warp and reduce across its lanes.  One
// block per instance leaves a B=1 solve on one SM; splitting an instance
// over blocks is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace osqp_cuda;

// out[c] = sum_r Acc(Mat[r * C + c]) * Acc(v[r]) for c < C; red holds
// kWarps * C values of Acc.  Ends with a block barrier.
template <typename Acc, typename TM, typename TV>
__device__ void colsum(const TM* __restrict__ Mat, int R, int C, const TV* v, Acc* out, Acc* red) {
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    if (c < C) {
      Acc acc = Acc(0);
      int r = w;
      for (; r + 3 * kWarps < R; r += 4 * kWarps) {
        const Acc a0 = Mat[static_cast<size_t>(r) * C + c];
        const Acc a1 = Mat[static_cast<size_t>(r + kWarps) * C + c];
        const Acc a2 = Mat[static_cast<size_t>(r + 2 * kWarps) * C + c];
        const Acc a3 = Mat[static_cast<size_t>(r + 3 * kWarps) * C + c];
        acc += a0 * Acc(v[r]) + a1 * Acc(v[r + kWarps]) + a2 * Acc(v[r + 2 * kWarps]) +
               a3 * Acc(v[r + 3 * kWarps]);
      }
      for (; r < R; r += kWarps) acc += Acc(Mat[static_cast<size_t>(r) * C + c]) * Acc(v[r]);
      red[w * C + c] = acc;
    }
  }
  __syncthreads();
  for (int c = threadIdx.y * 32 + lane; c < C; c += kThreads) {
    Acc s = Acc(0);
    for (int k = 0; k < kWarps; ++k) s += red[k * C + c];
    out[c] = s;
  }
  __syncthreads();
}

// out[r] = sum_c Acc(Mat[r * C + c]) * Acc(v[c]) for r < R, a warp per
// row.  Ends with a block barrier.
template <typename Acc, typename TM, typename TV>
__device__ void rowdot(const TM* __restrict__ Mat, int R, int C, const TV* v, Acc* out) {
  const int lane = threadIdx.x;
  for (int r = threadIdx.y; r < R; r += kWarps) {
    const TM* row = Mat + static_cast<size_t>(r) * C;
    Acc acc = Acc(0);
    int c = lane;
    for (; c + 96 < C; c += 128) {
      const Acc a0 = row[c], a1 = row[c + 32], a2 = row[c + 64], a3 = row[c + 96];
      acc += a0 * Acc(v[c]) + a1 * Acc(v[c + 32]) + a2 * Acc(v[c + 64]) + a3 * Acc(v[c + 96]);
    }
    for (; c < C; c += 32) acc += Acc(row[c]) * Acc(v[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[r] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
admm_iter_refined_kernel(const T* __restrict__ Minv, const T* __restrict__ A, const T* __restrict__ P,
                         const T* __restrict__ q, const T* __restrict__ l, const T* __restrict__ u,
                         const T* __restrict__ rho, const T* __restrict__ rho_inv,
                         const uint8_t* __restrict__ active, const T* __restrict__ x,
                         const T* __restrict__ z, const T* __restrict__ y, const T* __restrict__ dx,
                         const T* __restrict__ dy, const T* __restrict__ y_lo, T* __restrict__ x_out,
                         T* __restrict__ z_out, T* __restrict__ y_out, T* __restrict__ dx_out,
                         T* __restrict__ dy_out, T* __restrict__ y_lo_out, T sigma, double sigma64,
                         T alpha, int n, int m, int ncorr) {
  const size_t b = blockIdx.x;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const size_t bn = b * n;
  const size_t bm = b * m;
  const bool carry = y_lo != nullptr;

  if (!active[b]) {
    for (int j = tid; j < n; j += kThreads) {
      x_out[bn + j] = x[bn + j];
      dx_out[bn + j] = dx[bn + j];
    }
    for (int i = tid; i < m; i += kThreads) {
      z_out[bm + i] = z[bm + i];
      y_out[bm + i] = y[bm + i];
      dy_out[bm + i] = dy[bm + i];
      if (carry) y_lo_out[bm + i] = y_lo[bm + i];
    }
    return;
  }

  extern __shared__ double smem[];
  const int nm = n > m ? n : m;
  double* red = smem;             // kWarps * max(n, m), also as T
  double* s64 = red + kWarps * nm;  // m: rho o (A x~), f64
  double* mx64 = s64 + m;         // n: M x~ pieces, f64
  T* t = reinterpret_cast<T*>(mx64 + n);  // n
  T* xt = t + n;                  // n
  T* w = xt + n;                  // m, also the residual r (n <= nm)
  T* zt = w + nm;                 // m
  T* redT = reinterpret_cast<T*>(red);
  const T* Ab = A + b * m * n;
  const T* Pb = P + b * n * n;
  const T* Mb = Minv + b * n * n;

  // t = sigma x - q + A'(rho o (z - rho^-1 o y))
  for (int i = tid; i < m; i += kThreads)
    w[i] = mul(rho[bm + i], sub(z[bm + i], mul(rho_inv[bm + i], y[bm + i])));
  __syncthreads();
  colsum<T>(Ab, m, n, w, t, redT);
  for (int j = tid; j < n; j += kThreads) t[j] = add(sub(mul(sigma, x[bn + j]), q[bn + j]), t[j]);
  __syncthreads();
  colsum<T>(Mb, n, n, t, xt, redT);

  for (int k = 0; k < ncorr; ++k) {
    // r = t - (P x~ + sigma x~ + A'(rho o A x~)), in double
    rowdot<double>(Ab, m, n, xt, s64);
    for (int i = tid; i < m; i += kThreads) s64[i] = static_cast<double>(rho[bm + i]) * s64[i];
    __syncthreads();
    colsum<double>(Ab, m, n, s64, mx64, red);
    // the P x~ row dots of one warp per row: add onto mx64 in place
    const int lane = threadIdx.x;
    for (int r = threadIdx.y; r < n; r += kWarps) {
      const T* row = Pb + static_cast<size_t>(r) * n;
      double acc = 0.0;
      int c = lane;
      for (; c + 96 < n; c += 128) {
        const double a0 = row[c], a1 = row[c + 32], a2 = row[c + 64], a3 = row[c + 96];
        acc += a0 * double(xt[c]) + a1 * double(xt[c + 32]) + a2 * double(xt[c + 64]) + a3 * double(xt[c + 96]);
      }
      for (; c < n; c += 32) acc += double(row[c]) * double(xt[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        // (P x + sigma x) + A'(rho A x), in the plain version's order
        const double xv = xt[r];
        const double px = __dadd_rn(acc, __dmul_rn(sigma64, xv));
        w[r] = static_cast<T>(__dsub_rn(static_cast<double>(t[r]), __dadd_rn(px, mx64[r])));
      }
    }
    __syncthreads();
    colsum<T>(Mb, n, n, w, zt, redT);  // zt holds Minv r for now
    for (int j = tid; j < n; j += kThreads) xt[j] = add(xt[j], zt[j]);
    __syncthreads();
  }

  rowdot<T>(Ab, m, n, xt, zt);  // z~ = A x~

  const T one_m_alpha = sub(T(1), alpha);
  for (int j = tid; j < n; j += kThreads) {
    const T xp = x[bn + j];
    const T xn = add(mul(alpha, xt[j]), mul(one_m_alpha, xp));
    x_out[bn + j] = xn;
    dx_out[bn + j] = sub(xn, xp);
  }
  for (int i = tid; i < m; i += kThreads) {
    const T zp = z[bm + i];
    const T yp = y[bm + i];
    const T zr = add(mul(alpha, zt[i]), mul(one_m_alpha, zp));
    // clip as max-then-min with NaN passing through, like torch.clamp
    T zn = add(zr, mul(rho_inv[bm + i], yp));
    zn = zn < l[bm + i] ? l[bm + i] : zn;
    zn = zn > u[bm + i] ? u[bm + i] : zn;
    const T dyn = mul(rho[bm + i], sub(zr, zn));
    z_out[bm + i] = zn;
    dy_out[bm + i] = dyn;
    if (carry) {
      // TwoSum(y, dy + y_lo): the exact sum split into (hi, lo)
      const T bsum = add(dyn, y_lo[bm + i]);
      const T s = add(yp, bsum);
      const T bb = sub(s, yp);
      y_lo_out[bm + i] = add(sub(yp, sub(s, bb)), sub(bsum, bb));
      y_out[bm + i] = s;
    } else {
      y_out[bm + i] = add(yp, dyn);
    }
  }
}

template <typename T>
size_t smem_bytes(int n, int m) {
  const size_t nm = n > m ? n : m;
  return (kWarps * nm + m + n) * sizeof(double) + (2 * static_cast<size_t>(n) + 2 * nm) * sizeof(T);
}

template <typename T>
int launch(void* const* p, double sigma, double alpha, int B, int n, int m, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n, m);
  const cudaError_t err = allow_smem(admm_iter_refined_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  auto c = [&](int k) { return static_cast<const T*>(p[k]); };
  auto o = [&](int k) { return static_cast<T*>(p[k]); };
  const int ncorr = sizeof(T) == 4 ? 2 : 1;
  // sigma64: the solve-dtype sigma, widened exactly, as the plain version's sigma.double()
  admm_iter_refined_kernel<T><<<B, dim3(32, kWarps), smem, stream>>>(
      c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), static_cast<const uint8_t*>(p[8]), c(9), c(10),
      c(11), c(12), c(13), c(14), o(15), o(16), o(17), o(18), o(19), o(20), static_cast<T>(sigma),
      static_cast<double>(static_cast<T>(sigma)), static_cast<T>(alpha), n, m, ncorr);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  Operands are contiguous and batch-major:
// Minv (B,n,n), A (B,m,n), P (B,n,n); q, x, dx (B,n); l, u, rho,
// rho_inv, z, y, dy (B,m); active (B,) bytes; y_lo (B,m) in float32 and
// null in float64.  Outputs have the shapes of x, z, y, dx, dy, y_lo
// (y_lo_out null with y_lo) and must not alias the inputs.
extern "C" int osqp_admm_iter_refined(int dtype, const void* Minv, const void* A, const void* P,
                                      const void* q, const void* l, const void* u, const void* rho,
                                      const void* rho_inv, const void* active, const void* x,
                                      const void* z, const void* y, const void* dx, const void* dy,
                                      const void* y_lo, void* x_out, void* z_out, void* y_out,
                                      void* dx_out, void* dy_out, void* y_lo_out, double sigma,
                                      double alpha, int B, int n, int m, void* stream) {
  if (B == 0) return cudaSuccess;
  void* const p[21] = {const_cast<void*>(Minv), const_cast<void*>(A),  const_cast<void*>(P),
                       const_cast<void*>(q),    const_cast<void*>(l),  const_cast<void*>(u),
                       const_cast<void*>(rho),  const_cast<void*>(rho_inv), const_cast<void*>(active),
                       const_cast<void*>(x),    const_cast<void*>(z),  const_cast<void*>(y),
                       const_cast<void*>(dx),   const_cast<void*>(dy), const_cast<void*>(y_lo),
                       x_out,                   z_out,                 y_out,
                       dx_out,                  dy_out,                y_lo_out};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, sigma, alpha, B, n, m, s) : launch<double>(p, sigma, alpha, B, n, m, s);
}

// Bytes of shared memory one block of osqp_admm_iter_refined takes at (n, m).
extern "C" size_t osqp_admm_iter_refined_smem(int dtype, int n, int m) {
  return dtype == 0 ? smem_bytes<float>(n, m) : smem_bytes<double>(n, m);
}
