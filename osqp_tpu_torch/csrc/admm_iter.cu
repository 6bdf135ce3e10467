// K1: one masked ADMM iteration of the dense_inv backend, plain body,
// one thread block per instance.
//
// Replaces osqp_tpu/linsys/dense_inv.py:solve (plain body, the explicit
// inverse products) together with osqp_tpu/admm.py:admm_step and the
// active-mask selects of the loop body (admm.py:338-348).  XLA fused
// those into one loop body on the TPU; here one kernel computes, for
// each active instance b,
//
//   w  = rho o (z - rho^-1 o y)
//   t  = sigma x - q + A' w                  (t kept in shared memory)
//   x~ = Minv t,   z~ = (A Minv) t           (Minv symmetric; AMinvT = Minv A')
//   x' = alpha x~ + (1 - alpha) x,            dx = x' - x
//   zr = alpha z~ + (1 - alpha) z
//   z' = clip(zr + rho^-1 o y, l, u),        dy = rho o (zr - z'),  y' = y + dy
//
// and copies x, z, y, dx, dy unchanged where active[b] is false.
//
// What bounds it on the H100: device-memory bandwidth.  Each iteration
// reads A (m x n), Minv (n x n) and AMinvT (n x m) once: 200 KB per
// instance at n=100, m=200 in f32, 1.64 GB per iteration at B=8192,
// against ~10 KB of vectors.  The design streams each matrix exactly
// once with coalesced loads: all three products have the form
// out_c = sum_r Mat[r, c] v[r] on a row-major matrix, so the 32 lanes
// of a warp take 32 neighbouring columns of one row, the warps of the
// block split the rows, and a small shared buffer sums the warps'
// partials.  Four rows are in flight per thread to keep enough loads
// outstanding.  Inactive instances read no matrix at all.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using osqp_cuda::allow_smem;
using osqp_cuda::kWarps;

// out[c] = sum_r Mat[r * C + c] * v[r] for c < C; red holds kWarps * C.
// Ends with a block barrier, so out is visible to every thread.
template <typename T>
__device__ void tmatvec(const T* __restrict__ Mat, int R, int C, const T* v, T* out, T* red) {
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    if (c < C) {
      T acc = T(0);
      int r = w;
      for (; r + 3 * kWarps < R; r += 4 * kWarps) {
        const T a0 = Mat[static_cast<size_t>(r) * C + c];
        const T a1 = Mat[static_cast<size_t>(r + kWarps) * C + c];
        const T a2 = Mat[static_cast<size_t>(r + 2 * kWarps) * C + c];
        const T a3 = Mat[static_cast<size_t>(r + 3 * kWarps) * C + c];
        acc += a0 * v[r] + a1 * v[r + kWarps] + a2 * v[r + 2 * kWarps] + a3 * v[r + 3 * kWarps];
      }
      for (; r < R; r += kWarps) acc += Mat[static_cast<size_t>(r) * C + c] * v[r];
      red[w * C + c] = acc;
    }
  }
  __syncthreads();
  for (int c = threadIdx.y * 32 + lane; c < C; c += 32 * kWarps) {
    T s = T(0);
    for (int k = 0; k < kWarps; ++k) s += red[k * C + c];
    out[c] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
admm_iter_kernel(const T* __restrict__ Minv, const T* __restrict__ AMinvT, const T* __restrict__ A,
                 const T* __restrict__ q, const T* __restrict__ l, const T* __restrict__ u,
                 const T* __restrict__ rho, const T* __restrict__ rho_inv,
                 const uint8_t* __restrict__ active, const T* __restrict__ x,
                 const T* __restrict__ z, const T* __restrict__ y, const T* __restrict__ dx,
                 const T* __restrict__ dy, T* __restrict__ x_out, T* __restrict__ z_out,
                 T* __restrict__ y_out, T* __restrict__ dx_out, T* __restrict__ dy_out, T sigma,
                 T alpha, int n, int m) {
  const size_t b = blockIdx.x;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int nt = 32 * kWarps;
  const size_t bn = b * n;
  const size_t bm = b * m;

  if (!active[b]) {
    for (int j = tid; j < n; j += nt) {
      x_out[bn + j] = x[bn + j];
      dx_out[bn + j] = dx[bn + j];
    }
    for (int i = tid; i < m; i += nt) {
      z_out[bm + i] = z[bm + i];
      y_out[bm + i] = y[bm + i];
      dy_out[bm + i] = dy[bm + i];
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);  // n
  T* xt = t + n;                          // n
  T* w = xt + n;                          // m
  T* zt = w + m;                          // m
  T* red = zt + m;                        // kWarps * max(n, m)

  for (int i = tid; i < m; i += nt) w[i] = rho[bm + i] * (z[bm + i] - rho_inv[bm + i] * y[bm + i]);
  __syncthreads();
  tmatvec(A + b * m * n, m, n, w, t, red);
  for (int j = tid; j < n; j += nt) t[j] = (sigma * x[bn + j] - q[bn + j]) + t[j];
  __syncthreads();
  tmatvec(Minv + b * n * n, n, n, t, xt, red);
  tmatvec(AMinvT + b * n * m, n, m, t, zt, red);

  const T one_m_alpha = T(1) - alpha;
  for (int j = tid; j < n; j += nt) {
    const T xp = x[bn + j];
    const T xn = alpha * xt[j] + one_m_alpha * xp;
    x_out[bn + j] = xn;
    dx_out[bn + j] = xn - xp;
  }
  for (int i = tid; i < m; i += nt) {
    const T zp = z[bm + i];
    const T yp = y[bm + i];
    const T zr = alpha * zt[i] + one_m_alpha * zp;
    // clip as max-then-min with NaN passing through, like jnp.clip
    T zn = zr + rho_inv[bm + i] * yp;
    zn = zn < l[bm + i] ? l[bm + i] : zn;
    zn = zn > u[bm + i] ? u[bm + i] : zn;
    const T dyn = rho[bm + i] * (zr - zn);
    z_out[bm + i] = zn;
    dy_out[bm + i] = dyn;
    y_out[bm + i] = yp + dyn;
  }
}

// t, x~, w, z~ and the warps' partial sums
template <typename T>
size_t smem_bytes(int n, int m) {
  return (2 * static_cast<size_t>(n) + 2 * m + kWarps * static_cast<size_t>(n > m ? n : m)) * sizeof(T);
}

template <typename T>
int launch(void* const* p, double sigma, double alpha, int B, int n, int m, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(n, m);
  const cudaError_t err = allow_smem(admm_iter_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  auto c = [&](int k) { return static_cast<const T*>(p[k]); };
  auto o = [&](int k) { return static_cast<T*>(p[k]); };
  admm_iter_kernel<T><<<B, dim3(32, kWarps), smem, stream>>>(
      c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), static_cast<const uint8_t*>(p[8]), c(9),
      c(10), c(11), c(12), c(13), o(14), o(15), o(16), o(17), o(18), static_cast<T>(sigma),
      static_cast<T>(alpha), n, m);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  Operands are contiguous and batch-major:
// Minv (B,n,n), AMinvT (B,n,m), A (B,m,n); q, x, dx (B,n); l, u, rho,
// rho_inv, z, y, dy (B,m); active (B,) bytes.  Outputs have the shapes
// of x, z, y, dx, dy and must not alias the inputs.
extern "C" int osqp_admm_iter(int dtype, const void* Minv, const void* AMinvT, const void* A,
                              const void* q, const void* l, const void* u, const void* rho,
                              const void* rho_inv, const void* active, const void* x,
                              const void* z, const void* y, const void* dx, const void* dy,
                              void* x_out, void* z_out, void* y_out, void* dx_out, void* dy_out,
                              double sigma, double alpha, int B, int n, int m, void* stream) {
  if (B == 0) return cudaSuccess;
  void* const p[19] = {const_cast<void*>(Minv), const_cast<void*>(AMinvT), const_cast<void*>(A),
                       const_cast<void*>(q),    const_cast<void*>(l),      const_cast<void*>(u),
                       const_cast<void*>(rho),  const_cast<void*>(rho_inv), const_cast<void*>(active),
                       const_cast<void*>(x),    const_cast<void*>(z),      const_cast<void*>(y),
                       const_cast<void*>(dx),   const_cast<void*>(dy),     x_out,
                       z_out,                   y_out,                     dx_out,
                       dy_out};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, sigma, alpha, B, n, m, s)
                    : launch<double>(p, sigma, alpha, B, n, m, s);
}

// Bytes of shared memory one block of osqp_admm_iter takes at (n, m).
extern "C" size_t osqp_admm_iter_smem(int dtype, int n, int m) {
  return dtype == 0 ? smem_bytes<float>(n, m) : smem_bytes<double>(n, m);
}
