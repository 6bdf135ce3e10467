// K1: one masked ADMM iteration of the dense_inv backend, plain body,
// each instance split over blocks.
//
// Replaces osqp_tpu/linsys/dense_inv.py:solve (plain body, the explicit
// inverse products) together with osqp_tpu/admm.py:admm_step and the
// active-mask selects of the loop body (admm.py:338-348).  XLA fused
// those into one loop body on the TPU; here one C call computes, for
// each active instance b,
//
//   w  = rho o (z - rho^-1 o y)
//   t  = sigma x - q + A' w
//   x~ = Minv t,   z~ = (A Minv) t           (Minv symmetric; AMinvT = Minv A')
//   x' = alpha x~ + (1 - alpha) x,            dx = x' - x
//   zr = alpha z~ + (1 - alpha) z
//   z' = clip(zr + rho^-1 o y, l, u),        dy = rho o (zr - z'),  y' = y + dy
//
// and copies x, z, y, dx, dy unchanged where active[b] is false.
//
// What bounds it on the H100: device-memory bandwidth.  Each iteration
// reads A (m x n), Minv (n x n) and AMinvT (n x m) once and does one
// multiply-add per value, far below the card's ridge point, so tensor
// cores would not help.  Least times at 3.35 TB/s: 1.64 GB, 0.489 ms, at
// B=8192, n=100, m=200 in float32; 28 MB, 8.4 us, at the Solver's
// CVXQP2_M (B=1, n=1000, m=1250) in float64, whose matrices fit the 50 MB
// L2 and are read again every iteration, so a warm call may beat it.
//
// The design (admm_passes.cuh): three launches from one C call.
//   1. colsum over A: per row tile, the partial sums of A'w, with w made
//      in the block for its own rows;
//   2. colsum over the n rows of [Minv | AMinvT]: each block first adds
//      the A'w partials of its rows in order and sigma x - q, then takes
//      the column sums of x~ and z~ for its tile;
//   3. the epilogue: adds those partials in order and writes x, z, y,
//      dx, dy under the active mask.
// At B=1 the tiles spread one instance over the card's SMs; at B=8192 a
// tile spans the matrix and the split costs one round trip of (B, n+m)
// partials through scratch.  Each block keeps its tile's rows in flight
// with bulk copies through a ring in shared memory (common.cuh), which
// also makes shared memory independent of n and m.
#include <cuda_runtime.h>

#include <cstdint>

#include "admm_passes.cuh"
#include "common.cuh"

namespace {

using namespace osqp_cuda;

// How a call cuts the work, and its scratch.
template <typename T>
struct Plan {
  int chunks_n, rows_a, tiles_a, rows_x, tiles_x;
  T *t_parts, *xz_parts;
  Plan(int B, int n, int m, int sm_count, unsigned char* scratch) {
    chunks_n = chunks_of(n);
    rows_a = tile_rows(B, chunks_n, m, sm_count);
    tiles_a = tiles_of(m, rows_a);
    rows_x = tile_rows(B, chunks_n + chunks_of(m), n, sm_count);
    tiles_x = tiles_of(n, rows_x);
    Carve c{scratch};
    t_parts = c.take<T>(static_cast<size_t>(B) * tiles_a * n);
    xz_parts = c.take<T>(static_cast<size_t>(B) * tiles_x * (n + m));
    bytes = c.used;
  }
  size_t bytes;
};

template <typename T>
int launch(void* const* p, unsigned char* scratch, double sigma, double alpha, int B, int n, int m, int sm_count,
           cudaStream_t s) {
  auto c = [&](int k) { return static_cast<const T*>(p[k]); };
  auto o = [&](int k) { return static_cast<T*>(p[k]); };
  const T *Minv = c(0), *AMinvT = c(1), *A = c(2), *q = c(3), *l = c(4), *u = c(5), *rho = c(6), *rho_inv = c(7);
  const auto* active = static_cast<const uint8_t*>(p[8]);
  const T *x = c(9), *z = c(10), *y = c(11), *dx = c(12), *dy = c(13);
  const Plan<T> plan(B, n, m, sm_count, scratch);

  cudaError_t err = launch_colsum<T, T>(Mats<T>{A, nullptr, n, 0, plan.chunks_n}, B, m, plan.rows_a,
                                        DualWeight<T>{rho, rho_inv, z, y, m}, active, plan.t_parts, s);
  if (err != cudaSuccess) return err;
  const RhsWeight<T> rhs{x, q, plan.t_parts, nullptr, static_cast<T>(sigma), n, plan.tiles_a};
  err = launch_colsum<T, T>(Mats<T>{Minv, AMinvT, n, m, plan.chunks_n}, B, n, plan.rows_x, rhs, active,
                            plan.xz_parts, s);
  if (err != cudaSuccess) return err;
  const Parts<T> xt{plan.xz_parts, plan.tiles_x, n + m, 0}, zt{plan.xz_parts, plan.tiles_x, n + m, n};
  epilogue_kernel<T><<<grid_size(static_cast<size_t>(B) * (n + m)), kThreads, 0, s>>>(
      xt, zt, l, u, rho, rho_inv, active, x, z, y, dx, dy, nullptr, o(14), o(15), o(16), o(17), o(18), nullptr,
      static_cast<T>(alpha), B, n, m);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  Operands are contiguous and batch-major:
// Minv (B,n,n), AMinvT (B,n,m), A (B,m,n); q, x, dx (B,n); l, u, rho,
// rho_inv, z, y, dy (B,m); active (B,) bytes.  Outputs have the shapes
// of x, z, y, dx, dy and must not alias the inputs.  scratch holds
// osqp_admm_iter_scratch(dtype, B, n, m, sm_count) bytes, 256-byte
// aligned; sm_count is the card's number of SMs.
extern "C" int osqp_admm_iter(int dtype, const void* Minv, const void* AMinvT, const void* A,
                              const void* q, const void* l, const void* u, const void* rho,
                              const void* rho_inv, const void* active, const void* x,
                              const void* z, const void* y, const void* dx, const void* dy,
                              void* x_out, void* z_out, void* y_out, void* dx_out, void* dy_out,
                              void* scratch, double sigma, double alpha, int B, int n, int m,
                              int sm_count, void* stream) {
  if (B == 0) return cudaSuccess;
  void* const p[19] = {const_cast<void*>(Minv), const_cast<void*>(AMinvT), const_cast<void*>(A),
                       const_cast<void*>(q),    const_cast<void*>(l),      const_cast<void*>(u),
                       const_cast<void*>(rho),  const_cast<void*>(rho_inv), const_cast<void*>(active),
                       const_cast<void*>(x),    const_cast<void*>(z),      const_cast<void*>(y),
                       const_cast<void*>(dx),   const_cast<void*>(dy),     x_out,
                       z_out,                   y_out,                     dx_out,
                       dy_out};
  auto s = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<unsigned char*>(scratch);
  return dtype == 0 ? launch<float>(p, ws, sigma, alpha, B, n, m, sm_count, s)
                    : launch<double>(p, ws, sigma, alpha, B, n, m, sm_count, s);
}

// Bytes of scratch that osqp_admm_iter takes at (B, n, m) on a card of
// sm_count SMs.
extern "C" size_t osqp_admm_iter_scratch(int dtype, int B, int n, int m, int sm_count) {
  return dtype == 0 ? Plan<float>(B, n, m, sm_count, nullptr).bytes : Plan<double>(B, n, m, sm_count, nullptr).bytes;
}
