// K1r: one masked ADMM iteration of the dense_inv backend, refined body,
// each instance split over blocks.
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
// What bounds it on the H100: device-memory bandwidth, at one or two
// multiply-adds per matrix value (tensor cores would not help).  An
// iteration reads A 2 + 2 ncorr times (A'w, then A x~ and A'(rho A x~)
// per correction, and A x~ at the end): 6 times in float32, 4 in
// float64; Minv 1 + ncorr times and P ncorr times.  The least time
// counts each matrix once: 13 MB, 3.9 us at 3.35 TB/s, at the Solver's
// CVXQP2_M (B=1, n=1000, m=1250) in float32, whose matrices fit the
// 50 MB L2 and are read again every iteration, so a warm call may beat
// it; 1.31 GB, 0.391 ms, at B=8192, n=100, m=200.
//
// The design (admm_passes.cuh): a short sequence of split passes from
// one C call, each instance's rows spread over blocks, each block
// keeping its tile in flight with bulk copies through a ring in shared
// memory (common.cuh).  Column sums (A'v, Minv'v: Minv is read as
// Minv' v, as the plain version applies it) and row dots (A x, P x)
// leave partial sums in scratch, which the next pass adds in order:
//   colsum A (w)             -> A'w partials
//   colsum Minv (t)          -> x~ partials; t itself to scratch
//   finish                   -> x~
//   per correction:
//     rowdot A x~ (f64)      -> partials of A x~ by column chunk
//     colsum A (rho o A x~)  -> A'(rho A x~) partials, f64
//     rowdot P x~ (f64)      -> P x~ partials, f64
//     colsum Minv (r)        -> Minv r partials, r made in the block
//     finish                 -> x~ += Minv r
//   rowdot A x~              -> z~ partials
//   epilogue                 -> x, z, y, dx, dy, y_lo
#include <cuda_runtime.h>

#include <cstdint>

#include "admm_passes.cuh"
#include "common.cuh"

namespace {

using namespace osqp_cuda;

// rho_i (A x~)_i in double, the row-dot partials added in chunk order.
template <typename T>
struct RhoAxWeight {
  const T* rho;
  const double* parts;
  int m, nparts;
  __device__ double operator()(size_t b, int i) const {
    return static_cast<double>(rho[b * m + i]) * sum_parts(parts, b, nparts, m, 0, i);
  }
};

// r_j = t_j - ((P x~)_j + sigma x~_j + (A'(rho A x~))_j), in double, in
// the plain version's order, rounded to T.
template <typename T>
struct ResidualWeight {
  const T *t, *xt;
  const double *p_parts, *a_parts;
  double sigma64;
  int n, p_nparts, a_nparts;
  __device__ T operator()(size_t b, int j) const {
    const size_t k = b * n + j;
    const double px = __dadd_rn(sum_parts(p_parts, b, p_nparts, n, 0, j), __dmul_rn(sigma64, double(xt[k])));
    const double mx = __dadd_rn(px, sum_parts(a_parts, b, a_nparts, n, 0, j));
    return static_cast<T>(__dsub_rn(static_cast<double>(t[k]), mx));
  }
};

// xt = parts summed in order (accumulate false), or xt + that sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_finish_kernel(const T* __restrict__ parts, int nparts, const uint8_t* __restrict__ active,
                    T* __restrict__ xt, bool accumulate, int B, int n) {
  const size_t total = static_cast<size_t>(B) * n;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total; e += stride) {
    const size_t b = e / n;
    if (!active[b]) continue;
    const T s = sum_parts(parts, b, nparts, n, 0, static_cast<int>(e - b * n));
    xt[e] = accumulate ? add(xt[e], s) : s;
  }
}

template <typename T>
struct Plan {
  int chunks_n, rows_a, tiles_a, rows_n, tiles_n;
  T *t_parts, *t, *x_parts, *xt, *z_parts;
  double *ax_parts, *as_parts, *px_parts;
  size_t bytes;
  Plan(int B, int n, int m, int sm_count, unsigned char* scratch) {
    chunks_n = chunks_of(n);
    rows_a = tile_rows(B, chunks_n, m, sm_count);
    tiles_a = tiles_of(m, rows_a);
    rows_n = tile_rows(B, chunks_n, n, sm_count);
    tiles_n = tiles_of(n, rows_n);
    const size_t Bn = static_cast<size_t>(B) * n, Bm = static_cast<size_t>(B) * m;
    Carve c{scratch};
    t_parts = c.take<T>(Bn * tiles_a);
    t = c.take<T>(Bn);
    x_parts = c.take<T>(Bn * tiles_n);
    xt = c.take<T>(Bn);
    z_parts = c.take<T>(Bm * chunks_n);
    ax_parts = c.take<double>(Bm * chunks_n);
    as_parts = c.take<double>(Bn * tiles_a);
    px_parts = c.take<double>(Bn * chunks_n);
    bytes = c.used;
  }
};

template <typename T>
int launch(void* const* p, unsigned char* scratch, double sigma, double alpha, int B, int n, int m, int sm_count,
           cudaStream_t s) {
  auto c = [&](int k) { return static_cast<const T*>(p[k]); };
  auto o = [&](int k) { return static_cast<T*>(p[k]); };
  const T *Minv = c(0), *A = c(1), *P = c(2), *q = c(3), *l = c(4), *u = c(5), *rho = c(6), *rho_inv = c(7);
  const auto* active = static_cast<const uint8_t*>(p[8]);
  const T *x = c(9), *z = c(10), *y = c(11), *dx = c(12), *dy = c(13), *y_lo = c(14);
  const Plan<T> pl(B, n, m, sm_count, scratch);
  const int ncorr = sizeof(T) == 4 ? 2 : 1;
  const T sig = static_cast<T>(sigma);
  // the solve-dtype sigma, widened exactly, as the plain version's sigma.double()
  const double sigma64 = static_cast<double>(sig);
  const Mats<T> matA{A, nullptr, n, 0, pl.chunks_n}, matMinv{Minv, nullptr, n, 0, pl.chunks_n};
  const int fin_grid = grid_size(static_cast<size_t>(B) * n);

#define OSQP_TRY(call)                              \
  do {                                              \
    const cudaError_t e_ = (call);                  \
    if (e_ != cudaSuccess) return e_;               \
  } while (0)

  OSQP_TRY((launch_colsum<T, T>(matA, B, m, pl.rows_a, DualWeight<T>{rho, rho_inv, z, y, m}, active, pl.t_parts, s)));
  OSQP_TRY((launch_colsum<T, T>(matMinv, B, n, pl.rows_n,
                                RhsWeight<T>{x, q, pl.t_parts, pl.t, sig, n, pl.tiles_a}, active, pl.x_parts, s)));
  solve_finish_kernel<T><<<fin_grid, kThreads, 0, s>>>(pl.x_parts, pl.tiles_n, active, pl.xt, false, B, n);
  for (int k = 0; k < ncorr; ++k) {
    OSQP_TRY((launch_rowdot<T, double>(A, B, m, n, pl.rows_a, pl.xt, active, pl.ax_parts, s)));
    OSQP_TRY((launch_colsum<T, double>(matA, B, m, pl.rows_a, RhoAxWeight<T>{rho, pl.ax_parts, m, pl.chunks_n},
                                       active, pl.as_parts, s)));
    OSQP_TRY((launch_rowdot<T, double>(P, B, n, n, pl.rows_n, pl.xt, active, pl.px_parts, s)));
    const ResidualWeight<T> resid{pl.t, pl.xt, pl.px_parts, pl.as_parts, sigma64, n, pl.chunks_n, pl.tiles_a};
    OSQP_TRY((launch_colsum<T, T>(matMinv, B, n, pl.rows_n, resid, active, pl.x_parts, s)));
    solve_finish_kernel<T><<<fin_grid, kThreads, 0, s>>>(pl.x_parts, pl.tiles_n, active, pl.xt, true, B, n);
  }
  OSQP_TRY((launch_rowdot<T, T>(A, B, m, n, pl.rows_a, pl.xt, active, pl.z_parts, s)));
#undef OSQP_TRY

  const Parts<T> xt{pl.xt, 1, n, 0}, zt{pl.z_parts, pl.chunks_n, m, 0};
  epilogue_kernel<T><<<grid_size(static_cast<size_t>(B) * (n + m)), kThreads, 0, s>>>(
      xt, zt, l, u, rho, rho_inv, active, x, z, y, dx, dy, y_lo, o(15), o(16), o(17), o(18), o(19), o(20),
      static_cast<T>(alpha), B, n, m);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  Operands are contiguous and batch-major:
// Minv (B,n,n), A (B,m,n), P (B,n,n); q, x, dx (B,n); l, u, rho,
// rho_inv, z, y, dy (B,m); active (B,) bytes; y_lo (B,m) in float32 and
// null in float64.  Outputs have the shapes of x, z, y, dx, dy, y_lo
// (y_lo_out null with y_lo) and must not alias the inputs.  scratch holds
// osqp_admm_iter_refined_scratch(dtype, B, n, m, sm_count) bytes,
// 256-byte aligned; sm_count is the card's number of SMs.
extern "C" int osqp_admm_iter_refined(int dtype, const void* Minv, const void* A, const void* P,
                                      const void* q, const void* l, const void* u, const void* rho,
                                      const void* rho_inv, const void* active, const void* x,
                                      const void* z, const void* y, const void* dx, const void* dy,
                                      const void* y_lo, void* x_out, void* z_out, void* y_out,
                                      void* dx_out, void* dy_out, void* y_lo_out, void* scratch,
                                      double sigma, double alpha, int B, int n, int m, int sm_count,
                                      void* stream) {
  if (B == 0) return cudaSuccess;
  void* const p[21] = {const_cast<void*>(Minv), const_cast<void*>(A),  const_cast<void*>(P),
                       const_cast<void*>(q),    const_cast<void*>(l),  const_cast<void*>(u),
                       const_cast<void*>(rho),  const_cast<void*>(rho_inv), const_cast<void*>(active),
                       const_cast<void*>(x),    const_cast<void*>(z),  const_cast<void*>(y),
                       const_cast<void*>(dx),   const_cast<void*>(dy), const_cast<void*>(y_lo),
                       x_out,                   z_out,                 y_out,
                       dx_out,                  dy_out,                y_lo_out};
  auto s = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<unsigned char*>(scratch);
  return dtype == 0 ? launch<float>(p, ws, sigma, alpha, B, n, m, sm_count, s)
                    : launch<double>(p, ws, sigma, alpha, B, n, m, sm_count, s);
}

// Bytes of scratch that osqp_admm_iter_refined takes at (B, n, m) on a
// card of sm_count SMs.
extern "C" size_t osqp_admm_iter_refined_scratch(int dtype, int B, int n, int m, int sm_count) {
  return dtype == 0 ? Plan<float>(B, n, m, sm_count, nullptr).bytes
                    : Plan<double>(B, n, m, sm_count, nullptr).bytes;
}
