// K1r: one masked ADMM iteration of the dense_inv backend, refined body:
// each instance resident in a thread-block cluster, or split over blocks.
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
// Two paths, chosen in osqp_tpu_torch/ops/admm_iter.py:refined_plan from
// the shapes before the launch.
//
// Resident path (refined_resident_kernel), for batches whose instances
// fit the shared memory of a thread-block cluster of k = 1, 2, 4, 8 or
// 16 CTAs: CTA `rank` of a cluster holds a row slab of Minv, of A and,
// where it fits, of P, brought by one bulk copy (cp.async.bulk) each on
// an mbarrier, and runs the whole refined iteration of an instance out
// of shared memory, so each matrix value is read from device memory once
// per call where the split path reads A 6 times, Minv 3 and P 2 (float32).
// Where P does not fit, its rows are read from device memory at each
// P x~.  A CTA has 16 warps where n <= 256, 8 above; a warp takes rows,
// each lane kCols of their columns: row dots (A x~, P x~) are local to
// the CTA that holds the rows, several rows reduced at once across the
// warp; a correction's A x~ and A'(rho o A x~) take one pass over A.
// Column sums (A'w, Minv't, A'(rho A x~), Minv'r) leave per-CTA partials
// that the CTAs of a cluster add through distributed shared memory, in
// rank order and without atomics, so two launches agree bit for bit.
// One cluster barrier per column sum (6 in float32, 4 in float64),
// partials in two sets used in turn; the P row dot runs between the
// arrive and the wait of the A'(rho A x~) barrier.  The grid is
// persistent: cluster c takes instances c, c + G, ...; an instance's
// Minv and P slabs are refilled with the next active instance's as soon
// as its last Minv pass is done, its A slab after z~ = A x~, so the
// copies overlap the tail of the iteration.  Inactive instances read no
// matrix and are copied through.  Measured on the H100 (PERF.md), the
// copies are not what bounds this path: one CTA, which holds most of an
// SM's shared memory, runs an instance's ~13 dependent steps alone, and
// the correction's pass over A (float64 conversions, products and the
// row dots' shuffles) takes the largest share of its cycles.
//
// Split path, for the rest (CVXQP2_M at B=1 and other instances larger
// than a cluster, or batches too small to fill the card): the design in
// the next paragraph.
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
#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// Resident path
// ---------------------------------------------------------------------------
namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;

// Shared memory of one CTA of the resident path, in bytes from the start
// of the dynamic allocation: two mbarriers, then regions each rounded up
// to 16 bytes: the slabs of Minv, A and (p_res) P, each with 16 bytes of
// slack on each side for the aligned window of its bulk copy; x~ (n); t,
// r and x of the CTA's rows of Minv (rows_n); w, z~, rho, z, y, rho^-1,
// l, u and y_lo of its rows of A (rows_m); in double P x~ and
// A'(rho A x~) (rows_n), the warps' column sums (a row of n a warp) and,
// in a
// cluster, two sets of partials (2 n).  ops/admm_iter.py:refined_bytes
// repeats this sum.  A CTA has resident_warps(n) warps: 16 where a lane
// holds at most 8 columns (n <= 256), 8 above, where a thread's columns
// take most of its registers.
__host__ __device__ constexpr int resident_warps(int n) { return n <= 256 ? 16 : 8; }

template <typename T>
struct RLayout {
  int rows_n, rows_m;
  size_t minv, a, p, xt, tv, rv, xs, wt, zt, rho, zs, ys, ris, ls, us, ylo, px, as, red, part, bytes;

  __host__ __device__ static size_t take(size_t& at, size_t count) {
    const size_t o = at;
    at += (count + 15) & ~size_t(15);
    return o;
  }
  __host__ __device__ RLayout(int n, int m, int k, bool p_res) {
    constexpr size_t pad = 16 / sizeof(T);
    rows_n = (n + k - 1) / k;
    rows_m = (m + k - 1) / k;
    size_t at = 16;
    minv = take(at, sizeof(T) * (static_cast<size_t>(rows_n) * n + 2 * pad));
    a = take(at, sizeof(T) * (static_cast<size_t>(rows_m) * n + 2 * pad));
    p = take(at, p_res ? sizeof(T) * (static_cast<size_t>(rows_n) * n + 2 * pad) : 0);
    xt = take(at, sizeof(T) * n);
    tv = take(at, sizeof(T) * rows_n);
    rv = take(at, sizeof(T) * rows_n);
    xs = take(at, sizeof(T) * rows_n);
    wt = take(at, sizeof(T) * rows_m);
    zt = take(at, sizeof(T) * rows_m);
    rho = take(at, sizeof(T) * rows_m);
    zs = take(at, sizeof(T) * rows_m);
    ys = take(at, sizeof(T) * rows_m);
    ris = take(at, sizeof(T) * rows_m);
    ls = take(at, sizeof(T) * rows_m);
    us = take(at, sizeof(T) * rows_m);
    ylo = take(at, sizeof(T) * rows_m);
    px = take(at, sizeof(double) * rows_n);
    as = take(at, sizeof(double) * rows_n);
    red = take(at, sizeof(double) * resident_warps(n) * n);
    part = take(at, k > 1 ? sizeof(double) * 2 * n : 0);
    bytes = at;
  }
};

template <typename T>
struct RArgs {
  const T *Minv, *A, *P, *q, *l, *u, *rho, *rho_inv;
  const uint8_t* active;
  const T *x, *z, *y, *dx, *dy, *y_lo;
  T *x_out, *z_out, *y_out, *dx_out, *dy_out, *y_lo_out;
  T sigma, alpha;
  int B, n, m;
};

// red[w n + j] = sum over the warp's rows i of S[i, j] w_i (warp w of kW
// takes rows w, w + kW, ...; lane l columns l + 32 c), summed in Acc.
template <typename Acc, int kCols, int kW, typename T, typename W>
__device__ __forceinline__ void slab_colsum(const T* S, int rows, int n, const W* w, Acc* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Acc col[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) col[c] = Acc(0);
#pragma unroll 2
  for (int i = warp; i < rows; i += kW) {
    const Acc wi = static_cast<Acc>(w[i]);
    const T* row = S + static_cast<size_t>(i) * n;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = lane + 32 * c;
      if (j < n) col[c] += static_cast<Acc>(row[j]) * wi;
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = lane + 32 * c;
    if (j < n) red[warp * n + j] = col[c];
  }
}

// The CTA's column sum at j: the kW warps' sums added in warp order.
template <int kW, typename Acc>
__device__ __forceinline__ Acc warp_total(const Acc* red, int n, int j) {
  Acc s = red[j];
#pragma unroll
  for (int w = 1; w < kW; ++w) s += red[w * n + j];
  return s;
}

// The warp sums of kRows values a lane (kRows a power of two, at most
// 32): v[h] is the lane's part of row h's sum.  Transposing levels first
// (at xor distance 16, 8, ...: each lane keeps half of its rows and adds
// its partner's half of them) leave each lane one row, row
// lane >> (5 - log2 kRows); butterfly levels then add that row over the
// 32 / kRows lanes that hold it.  kRows - 1 + 5 - log2 kRows shuffles for
// kRows rows, where a butterfly per row takes 5 each; the order of the
// additions is fixed.  Returns the lane's row's total.
template <int kRows>
__host__ __device__ constexpr int log2_of() {
  return kRows <= 1 ? 0 : 1 + log2_of<kRows / 2>();
}

template <int kRows, typename Acc>
__device__ __forceinline__ Acc warp_rows_total(Acc (&v)[kRows]) {
  constexpr int kLog = log2_of<kRows>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int lvl = 0; lvl < kLog; ++lvl) {  // constant trip counts: v stays in registers
    const int off = 16 >> lvl;
    const bool hi = lane & off;
#pragma unroll
    for (int q = 0; q < (kRows >> (lvl + 1)); ++q) {
      const Acc send = hi ? v[q] : v[q + (kRows >> (lvl + 1))];
      const Acc keep = hi ? v[q + (kRows >> (lvl + 1))] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  Acc s = v[0];
#pragma unroll
  for (int lvl = kLog; lvl < 5; ++lvl) s += __shfl_xor_sync(0xffffffffu, s, 16 >> lvl);
  return s;
}

// f(i, sum_j S[i, j] v_j) for each row i < rows, summed in Acc; v (n
// values) in shared memory.  S may lie in shared or in device memory.  A
// warp of kW takes kRowDot rows at a time (rows i0 + h kW), summed by
// warp_rows_total; the first lane of each row's group calls f.
constexpr int kRowDot = 8;
template <typename Acc, int kCols, int kW, typename T, typename F>
__device__ __forceinline__ void slab_rowdot(const T* S, int rows, int n, const T* v, F&& f) {
  constexpr int kShift = 5 - log2_of<kRowDot>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Acc xr[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = lane + 32 * c;
    xr[c] = j < n ? static_cast<Acc>(v[j]) : Acc(0);
  }
  for (int i0 = warp; i0 < rows; i0 += kRowDot * kW) {
    Acc s[kRowDot];
#pragma unroll
    for (int h = 0; h < kRowDot; ++h) {
      s[h] = Acc(0);
      const int i = i0 + h * kW;
      if (i < rows) {
        const T* row = S + static_cast<size_t>(i) * n;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = lane + 32 * c;
          if (j < n) s[h] += static_cast<Acc>(row[j]) * xr[c];
        }
      }
    }
    const Acc t = warp_rows_total<kRowDot>(s);
    const int i = i0 + (lane >> kShift) * kW;
    if ((lane & ((1 << kShift) - 1)) == 0 && i < rows) f(i, t);
  }
}

// The correction's pass over A, in double: for each row i < rows the dot
// d_i = sum_j A[i, j] x_j, then red[w n + j] = sum over the warp's rows
// of A[i, j] rho_i d_i (as slab_colsum sums it): one read and one
// conversion of each value.  A warp of kW takes kRows rows at a time,
// their values held in registers; their dots come back to every lane by
// shuffle.
template <int kCols, int kRows, int kW, typename T>
__device__ __forceinline__ void slab_fused(const T* S, int rows, int n, const T* v, const T* rho, double* red) {
  constexpr int kShift = 5 - log2_of<kRows>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double xr[kCols], col[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = lane + 32 * c;
    xr[c] = j < n ? static_cast<double>(v[j]) : 0.0;
    col[c] = 0.0;
  }
  for (int i0 = warp; i0 < rows; i0 += kRows * kW) {
    double e[kRows][kCols], s[kRows];
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      s[h] = 0.0;
      const int i = i0 + h * kW;
      const T* row = S + static_cast<size_t>(i < rows ? i : i0) * n;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = lane + 32 * c;
        e[h][c] = i < rows && j < n ? static_cast<double>(row[j]) : 0.0;
        if (j < n) s[h] += e[h][c] * xr[c];
      }
    }
    const double t = warp_rows_total<kRows>(s);
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int i = i0 + h * kW;
      const double d = __shfl_sync(0xffffffffu, t, h << kShift);
      if (i < rows) {
        const double w = static_cast<double>(rho[i]) * d;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (lane + 32 * c < n) col[c] += e[h][c] * w;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = lane + 32 * c;
    if (j < n) red[warp * n + j] = col[c];
  }
}

// The cluster barrier, split: the arrive releases this CTA's partials to
// the cluster (and orders its reads of the others' partials of the round
// before), the wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// sum over ranks r < k, in rank order, of rank r's part[j].
template <typename Acc>
__device__ __forceinline__ Acc cluster_total(cg::cluster_group& cluster, int k, Acc* part, int j) {
  Acc v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < k ? *cluster.map_shared_rank(part + j, r) : Acc(0);
  Acc s = v[0];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r)
    if (r < k) s += v[r];
  return s;
}

// One refined iteration (as the split path's, in the header's order) of
// every instance of the batch; cluster c of G takes instances c, c + G,
// ...  kCols columns a lane: n <= 32 kCols.  kPRes: P's slab in shared
// memory, else its rows are read from device memory at each P x~.
template <typename T, int kCols, bool kPRes>
__global__ void __launch_bounds__(32 * resident_warps(32 * kCols), 1) refined_resident_kernel(RArgs<T> a) {
  constexpr int kW = resident_warps(32 * kCols);
  constexpr int kT = 32 * kW;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t G = gridDim.x / k;
  const int n = a.n, m = a.m;
  const size_t B = a.B;
  const RLayout<T> L(n, m, k, kPRes);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar_a = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_m = bar_a + 1;  // Minv and, resident, P
  T* r_minv = reinterpret_cast<T*>(smem + L.minv);
  T* r_a = reinterpret_cast<T*>(smem + L.a);
  T* r_p = reinterpret_cast<T*>(smem + L.p);
  T* xt = reinterpret_cast<T*>(smem + L.xt);
  T* tv = reinterpret_cast<T*>(smem + L.tv);
  T* rv = reinterpret_cast<T*>(smem + L.rv);
  T* wt = reinterpret_cast<T*>(smem + L.wt);
  T* zt = reinterpret_cast<T*>(smem + L.zt);
  T* rho_s = reinterpret_cast<T*>(smem + L.rho);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* zs = reinterpret_cast<T*>(smem + L.zs);
  T* ys = reinterpret_cast<T*>(smem + L.ys);
  T* ris = reinterpret_cast<T*>(smem + L.ris);
  T* ls = reinterpret_cast<T*>(smem + L.ls);
  T* us = reinterpret_cast<T*>(smem + L.us);
  T* ylo = reinterpret_cast<T*>(smem + L.ylo);
  double* px = reinterpret_cast<double*>(smem + L.px);
  double* as = reinterpret_cast<double*>(smem + L.as);
  unsigned char* red = smem + L.red;
  unsigned char* part = smem + L.part;
  const int tid = threadIdx.x;
  const int n0 = min(n, rank * L.rows_n), nn = min(n, n0 + L.rows_n) - n0;
  const int m0 = min(m, rank * L.rows_m), mm = min(m, m0 + L.rows_m) - m0;
  const int ncorr = sizeof(T) == 4 ? 2 : 1;
  const T sig = a.sigma, alpha = a.alpha;
  const double sigma64 = static_cast<double>(sig);  // as the plain version's sigma.double()
  const T one_m_alpha = sub(T(1), alpha);
  auto g_a = [&](size_t b) { return a.A + (b * m + m0) * static_cast<size_t>(n); };
  auto g_minv = [&](size_t b) { return a.Minv + (b * n + n0) * static_cast<size_t>(n); };
  auto g_p = [&](size_t b) { return a.P + (b * n + n0) * static_cast<size_t>(n); };

  // one thread: the copies of instance b's slab of A, or of Minv (and P)
  auto load = [&](uint64_t* bar, T* dst0, const T* src0, T* dst1, const T* src1, int rows) {
    uintptr_t lo0 = 0, lo1 = 0;
    uint32_t size0 = 0, size1 = 0;
    if (rows > 0) {
      window(src0, sizeof(T) * static_cast<size_t>(rows) * n, lo0, size0);
      if (src1) window(src1, sizeof(T) * static_cast<size_t>(rows) * n, lo1, size1);
    }
    mbar_expect_tx(bar, size0 + size1);
    if (size0) bulk_load(dst0, reinterpret_cast<const void*>(lo0), size0, bar);
    if (size1) bulk_load(dst1, reinterpret_cast<const void*>(lo1), size1, bar);
  };
  auto load_a = [&](size_t b) { load(bar_a, r_a, g_a(b), nullptr, nullptr, mm); };
  auto load_m = [&](size_t b) { load(bar_m, r_minv, g_minv(b), r_p, kPRes ? g_p(b) : nullptr, nn); };

  // The first active instance among b, b + G, ... (B where there is
  // none): each warp reads 32 flags at once and takes the first set one.
  const int lane = tid & 31;
  auto next_active = [&](size_t b) {
    for (; b < B; b += 32 * G) {
      const size_t c = b + lane * G;
      const unsigned set = __ballot_sync(0xffffffffu, c < B && a.active[c]);
      if (set) return b + (__ffs(set) - 1) * G;
    }
    return B;
  };

  // A column sum's end: warp sums in red (kW n values of Acc) ->
  // f(j, total) for j in [j0, j1), the totals of the cluster's CTAs added
  // in rank order.  In a cluster every CTA publishes all n of its totals
  // in a set of partials used in turn; with `between` the caller's work
  // runs between the arrive and the wait.  Ends with a block barrier.
  int round = 0;
  auto combine = [&](auto zero, int j0, int j1, auto&& f, auto&& between) {
    using Acc = decltype(zero);
    const Acc* r = reinterpret_cast<const Acc*>(red);
    __syncthreads();
    if (k == 1) {
      between();
      for (int j = j0 + tid; j < j1; j += kT) f(j, warp_total<kW>(r, n, j));
    } else {
      // the two sets at fixed places (n doubles each), whatever Acc is: a
      // float set must not overlap the next double set, which other CTAs
      // may still be reading
      Acc* pb = reinterpret_cast<Acc*>(part + (round & 1) * sizeof(double) * n);
      for (int j = tid; j < n; j += kT) pb[j] = warp_total<kW>(r, n, j);
      cluster_arrive();
      between();
      cluster_wait();
      for (int j = j0 + tid; j < j1; j += kT) f(j, cluster_total(cluster, k, pb, j));
      ++round;
    }
    __syncthreads();
  };
  auto nothing = [] {};

  if (tid == 0) {
    mbar_init(bar_a, 1);
    mbar_init(bar_m, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t cid = blockIdx.x / k;
  size_t b = next_active(cid);
  if (tid == 0 && b < B) {
    load_a(b);
    load_m(b);
  }
  // The CTA's rows of the inactive instances of this cluster's turn,
  // copied through, all at once, so that their loads overlap.
  const size_t turns = cid < B ? (B - cid + G - 1) / G : 0;
  for (size_t e = tid; e < turns * nn; e += kT) {
    const size_t t = e / nn;
    const size_t g = (cid + t * G) * n + n0 + (e - t * nn);
    if (!a.active[cid + t * G]) {
      a.x_out[g] = a.x[g];
      a.dx_out[g] = a.dx[g];
    }
  }
  for (size_t e = tid; e < turns * mm; e += kT) {
    const size_t t = e / mm;
    const size_t g = (cid + t * G) * m + m0 + (e - t * mm);
    if (!a.active[cid + t * G]) {
      a.z_out[g] = a.z[g];
      a.y_out[g] = a.y[g];
      a.dy_out[g] = a.dy[g];
      if (a.y_lo) a.y_lo_out[g] = a.y_lo[g];
    }
  }
  uint32_t phase = 0;
  while (b < B) {
    // the next instance's flags, read with this one's vectors (one round trip)
    const size_t c = b + G + lane * G;
    const bool c_set = c < B && a.active[c];
    const T* sA = r_a + misalign(g_a(b));
    const T* sMinv = r_minv + misalign(g_minv(b));
    const T* sP = kPRes ? r_p + misalign(g_p(b)) : g_p(b);
    for (int i = tid; i < mm; i += kT) {
      const size_t g = b * m + m0 + i;
      const T rho = a.rho[g], z = a.z[g], y = a.y[g], ri = a.rho_inv[g];
      rho_s[i] = rho;
      zs[i] = z;
      ys[i] = y;
      ris[i] = ri;
      ls[i] = a.l[g];
      us[i] = a.u[g];
      if (a.y_lo) ylo[i] = a.y_lo[g];
      wt[i] = mul(rho, sub(z, mul(ri, y)));  // w = rho o (z - rho^-1 o y)
    }
    for (int j = tid; j < nn; j += kT) {
      const size_t g = b * n + n0 + j;
      const T x = a.x[g];
      xs[j] = x;
      tv[j] = sub(mul(sig, x), a.q[g]);  // sigma x - q
    }
    const unsigned set = __ballot_sync(0xffffffffu, c_set);
    const size_t nb = set ? b + G + (__ffs(set) - 1) * G : next_active(b + 33 * G);
    __syncthreads();

    // t = (sigma x - q) + A'w, on the CTA's rows of Minv
    mbar_wait(bar_a, phase);
    slab_colsum<T, kCols, kW>(sA, mm, n, wt, reinterpret_cast<T*>(red));
    combine(T(0), n0, n0 + nn, [&](int j, T s) { tv[j - n0] = add(tv[j - n0], s); }, nothing);
    // x~ = Minv't, all n on every CTA
    mbar_wait(bar_m, phase);
    slab_colsum<T, kCols, kW>(sMinv, nn, n, tv, reinterpret_cast<T*>(red));
    combine(T(0), 0, n, [&](int j, T s) { xt[j] = s; }, nothing);
    for (int c = 0; c < ncorr; ++c) {
      // A'(rho o (A x~)) in double, one pass over the CTA's rows of A; P x~
      // on the CTA's rows while the cluster meets
      slab_fused<kCols, kCols <= 4 ? 8 : 32 / kCols, kW>(sA, mm, n, xt, rho_s, reinterpret_cast<double*>(red));
      combine(double(0), n0, n0 + nn, [&](int j, double s) { as[j - n0] = s; },
              [&] { slab_rowdot<double, kCols, kW>(sP, nn, n, xt, [&](int i, double v) { px[i] = v; }); });
      // r = t - (P x~ + sigma x~ + A'(rho A x~)), in double, rounded to T
      for (int j = tid; j < nn; j += kT) {
        const double pxs = __dadd_rn(px[j], __dmul_rn(sigma64, static_cast<double>(xt[n0 + j])));
        rv[j] = static_cast<T>(__dsub_rn(static_cast<double>(tv[j]), __dadd_rn(pxs, as[j])));
      }
      __syncthreads();
      // x~ += Minv'r
      slab_colsum<T, kCols, kW>(sMinv, nn, n, rv, reinterpret_cast<T*>(red));
      combine(T(0), 0, n, [&](int j, T s) { xt[j] = add(xt[j], s); }, nothing);
    }
    // Minv and P are read: the next instance's may come in
    if (tid == 0 && nb < B) {
      fence_async_shared();
      load_m(nb);
    }
    // z~ = A x~
    slab_rowdot<T, kCols, kW>(sA, mm, n, xt, [&](int i, T v) { zt[i] = v; });
    __syncthreads();
    if (tid == 0 && nb < B) {
      fence_async_shared();
      load_a(nb);
    }
    // the relaxed updates and the TwoSum carry, on the CTA's rows
    for (int j = tid; j < nn; j += kT) {
      const size_t g = b * n + n0 + j;
      const T xp = xs[j];
      const T xn = add(mul(alpha, xt[n0 + j]), mul(one_m_alpha, xp));
      a.x_out[g] = xn;
      a.dx_out[g] = sub(xn, xp);
    }
    for (int i = tid; i < mm; i += kT) {
      const size_t g = b * m + m0 + i;
      const T zp = zs[i], yp = ys[i];
      const T zr = add(mul(alpha, zt[i]), mul(one_m_alpha, zp));
      T zn = add(zr, mul(ris[i], yp));
      zn = zn < ls[i] ? ls[i] : zn;
      zn = zn > us[i] ? us[i] : zn;
      const T dyn = mul(rho_s[i], sub(zr, zn));
      a.z_out[g] = zn;
      a.dy_out[g] = dyn;
      if (a.y_lo) {
        const T bsum = add(dyn, ylo[i]);
        const T s = add(yp, bsum);
        const T bb = sub(s, yp);
        a.y_lo_out[g] = add(sub(yp, sub(s, bb)), sub(bsum, bb));
        a.y_out[g] = s;
      } else {
        a.y_out[g] = add(yp, dyn);
      }
    }
    phase ^= 1;
    b = nb;
    __syncthreads();
  }
  if (k > 1) {  // no CTA leaves while another may still read its partials
    cluster_arrive();
    cluster_wait();
  }
}

// The resident launch for clusters of k CTAs (P resident or not): the
// kernel for n's column count, its shared memory and the cluster
// attribute; err is set where the shape or k is not served.
template <typename T>
struct ResidentLaunch {
  using Kernel = void (*)(RArgs<T>);
  Kernel kernel = nullptr;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;

  ResidentLaunch(int n, int m, int k, bool p_res, int clusters, cudaStream_t s) {
    if (n < 1 || n > 512 || m < 0 || !(k == 1 || k == 2 || k == 4 || k == 8 || k == 16) || clusters < 1) {
      err = cudaErrorInvalidValue;
      return;
    }
    if (p_res)
      kernel = n <= 128 ? refined_resident_kernel<T, 4, true>
               : n <= 256 ? refined_resident_kernel<T, 8, true>
                          : refined_resident_kernel<T, 16, true>;
    else
      kernel = n <= 128 ? refined_resident_kernel<T, 4, false>
               : n <= 256 ? refined_resident_kernel<T, 8, false>
                          : refined_resident_kernel<T, 16, false>;
    const size_t smem = RLayout<T>(n, m, k, p_res).bytes;
    if (smem > static_cast<size_t>(kMaxSmem)) {
      err = cudaErrorInvalidValue;
      return;
    }
    err = allow_smem(kernel, smem);
    if (err == cudaSuccess && k > 8) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg.gridDim = dim3(static_cast<unsigned>(clusters) * k);
    cfg.blockDim = dim3(32 * resident_warps(n));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T>
int launch_resident(void* const* p, double sigma, double alpha, int B, int n, int m, int k, bool p_res,
                    int clusters, cudaStream_t s) {
  ResidentLaunch<T> l(n, m, k, p_res, clusters < B ? clusters : B, s);
  if (l.err != cudaSuccess) return l.err;
  auto c = [&](int i) { return static_cast<const T*>(p[i]); };
  auto o = [&](int i) { return static_cast<T*>(p[i]); };
  const RArgs<T> args{c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), static_cast<const uint8_t*>(p[8]),
                      c(9), c(10), c(11), c(12), c(13), c(14), o(15), o(16), o(17), o(18), o(19), o(20),
                      static_cast<T>(sigma), static_cast<T>(alpha), B, n, m};
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, l.kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Clusters of k CTAs of the resident kernel that the card holds at once;
// negative on a CUDA error or a shape the path does not serve.
template <typename T>
int resident_clusters(int n, int m, int k, bool p_res) {
  ResidentLaunch<T> l(n, m, k, p_res, 1024, nullptr);
  int clusters = 0;
  if (l.err != cudaSuccess || cudaOccupancyMaxActiveClusters(&clusters, l.kernel, &l.cfg) != cudaSuccess)
    return -1;
  return clusters;
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

// The resident path: the operands as osqp_admm_iter_refined's, clusters
// of k CTAs (1, 2, 4, 8 or 16; n <= 512), P's slab resident when p_res,
// at most `clusters` clusters at once (osqp_admm_iter_refined_resident_
// clusters), no scratch.
extern "C" int osqp_admm_iter_refined_resident(int dtype, const void* Minv, const void* A, const void* P,
                                               const void* q, const void* l, const void* u, const void* rho,
                                               const void* rho_inv, const void* active, const void* x,
                                               const void* z, const void* y, const void* dx, const void* dy,
                                               const void* y_lo, void* x_out, void* z_out, void* y_out,
                                               void* dx_out, void* dy_out, void* y_lo_out, double sigma,
                                               double alpha, int B, int n, int m, int k, int p_res, int clusters,
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
  return dtype == 0 ? launch_resident<float>(p, sigma, alpha, B, n, m, k, p_res != 0, clusters, s)
                    : launch_resident<double>(p, sigma, alpha, B, n, m, k, p_res != 0, clusters, s);
}

// Clusters of k CTAs of the resident path that the card holds at once at
// (n, m) (dtype and p_res as above); negative on error.
extern "C" int osqp_admm_iter_refined_resident_clusters(int dtype, int n, int m, int k, int p_res) {
  return dtype == 0 ? resident_clusters<float>(n, m, k, p_res != 0) : resident_clusters<double>(n, m, k, p_res != 0);
}

// Bytes of shared memory of one CTA of the resident path.
extern "C" int osqp_admm_iter_refined_resident_smem(int dtype, int n, int m, int k, int p_res) {
  return static_cast<int>(dtype == 0 ? RLayout<float>(n, m, k, p_res != 0).bytes
                                     : RLayout<double>(n, m, k, p_res != 0).bytes);
}
