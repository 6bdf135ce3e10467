// K6: the batched Jacobi-preconditioned conjugate gradient, warm-started,
// with converged instances frozen: one step's vector work per launch
// (cg_step), and the whole loop in one launch on ELL operands (cg_loop).
//
// Replaces the while loop of osqp_tpu/linsys/cg.py:129-169 (solve), which
// solves (P + sigma I + A' diag(rho) A) x = b for every instance of the
// batch, and polish's _pcg (osqp_tpu/polish.py:65-102), the same loop on
// S = P + d I + (MA)'(MA) / d.
//
// The step, three launches over the (B, n) vectors, from the caller's
// operator products (K5 launches on ELL operands, batched GEMVs on dense
// ones):
//
//   dot_kernel        Mp = (P p + sigma p) + V p;  partials of p'Mp
//   update_kernel     alpha = rz / p'Mp, 0 where r'r <= tol^2 (the freeze);
//                     x += alpha p,  r -= alpha Mp,  z = dinv r;
//                     partials of r'z and r'r;  steps[b] += 1 where live
//   direction_kernel  beta = rz_new / rz;  p = z + beta p;  rz, r'r stored
//
// An instance's vectors are cut into `parts` parts of 256 entries' stride
// (blockIdx.x), so that B=1 at n=1e4 spreads over 40 SMs.  Each part's
// block writes its partial sums, and every block of the next phase adds
// all of its instance's partials itself, in the same fixed order: the dot
// products do not depend on scheduling, there is no floating atomic, and
// two runs are bit-identical.  rz and r'r go to the `next` slots of a
// ping-pong pair, since blocks of the direction pass still read the
// current rz.
//
// The loop (loop_kernel) runs every step of one CG solve on ELL operands
// in one cooperative launch: per step the stop test (is any instance
// live?), A p, then the three phases above with the operator's products
// computed inside the dot phase by K5's row gathers (ell_gather.cuh), a
// grid barrier between phases, until no instance is live or max_iter
// steps are taken.  The host reads nothing until it ends.  The grid is
// what the card holds at once (occupancy x SMs), at most one block per
// (instance, part); the (instance, part) items stride over it, and each
// is computed by one block with the step kernels' thread mapping, so its
// sums are the step kernels' whatever the grid.  Two operator forms, each
// rounded as its plain version: the cg backend's V p = A'(rho * A p)
// (K5's weighted transpose) and polish's V p = A'(A p) / d, divided after
// the transposed product.
//
// Each product and sum is rounded on its own (no fused multiply-add), in
// the order the JAX loop writes them; the plain loop in ops/cg.py can sum
// its dot products in this order (kernel_dot), and from the same products
// the two then agree bit for bit.  So the step and the loop take the
// same steps to the same bits of x.
//
// What bounds it on the H100: latency.  One step reads and writes some ten
// (B, n) vectors, 0.8 MB at B=1, n=1e4 in float64: 0.25 us at the HBM rate.
// Issued step by step from the host, a step costs three K5 and three K6
// launches and some 0.2 ms of host time; the loop replaces them with four
// grid barriers of a few microseconds each.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ell_gather.cuh"

namespace {

using namespace osqp_cuda;

constexpr int kMaxParts = 64;  // blocks per instance at most

inline int parts_of(int n) {
  const int p = (n + kThreads - 1) / kThreads;
  return p < 1 ? 1 : (p > kMaxParts ? kMaxParts : p);
}

// Sum of v over the block in a fixed order: a butterfly within each warp,
// then warp 0 adds the warps' sums.  Every thread gets the result.
template <typename T>
__device__ T block_sum(T v, T* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();  // sh may still be read from an earlier call
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    T s = lane < kWarps ? sh[lane] : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) sh[kWarps] = s;
  }
  __syncthreads();
  return sh[kWarps];
}

// Sum of the `parts` partials of one instance, in a fixed order.  Not
// __restrict__: in the loop other blocks write the partials between
// barriers.
template <typename T>
__device__ T parts_sum(const T* part, int parts, T* sh) {
  T s = T(0);
  for (int i = threadIdx.x; i < parts; i += kThreads) s = add(s, part[i]);
  return block_sum(s, sh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ p, const T* __restrict__ u, const T* __restrict__ v, T sigma, T* __restrict__ Mp,
           T* __restrict__ part, int n, int parts) {
  __shared__ T sh[kWarps + 1];
  const size_t b = blockIdx.y;
  const size_t o = b * n;
  T acc = T(0);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += parts * kThreads) {
    T t = add(u[o + i], mul(sigma, p[o + i]));
    if (v) t = add(t, v[o + i]);
    Mp[o + i] = t;
    acc = add(acc, mul(p[o + i], t));
  }
  const T s = block_sum(acc, sh);
  if (threadIdx.x == 0) part[b * parts + blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_kernel(const T* __restrict__ part_pm, const T* __restrict__ rz, const T* __restrict__ rr,
              const T* __restrict__ tol2, const T* __restrict__ p, const T* __restrict__ Mp,
              const T* __restrict__ dinv, T* __restrict__ x, T* __restrict__ r, T* __restrict__ z,
              T* __restrict__ part_rz, T* __restrict__ part_rr, int32_t* __restrict__ steps, int n, int parts) {
  __shared__ T sh[kWarps + 1];
  const size_t b = blockIdx.y;
  const size_t o = b * n;
  const T denom = parts_sum(part_pm + b * parts, parts, sh);
  const bool live = rr[b] > tol2[b];
  const T alpha = live ? rz[b] / (denom > T(0) ? denom : T(1)) : T(0);
  if (live && blockIdx.x == 0 && threadIdx.x == 0) steps[b] += 1;
  T acc_rz = T(0), acc_rr = T(0);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += parts * kThreads) {
    x[o + i] = add(x[o + i], mul(alpha, p[o + i]));
    const T ri = sub(r[o + i], mul(alpha, Mp[o + i]));
    const T zi = mul(dinv[o + i], ri);
    r[o + i] = ri;
    z[o + i] = zi;
    acc_rz = add(acc_rz, mul(ri, zi));
    acc_rr = add(acc_rr, mul(ri, ri));
  }
  const T s_rz = block_sum(acc_rz, sh);
  const T s_rr = block_sum(acc_rr, sh);
  if (threadIdx.x == 0) {
    part_rz[b * parts + blockIdx.x] = s_rz;
    part_rr[b * parts + blockIdx.x] = s_rr;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
direction_kernel(const T* __restrict__ part_rz, const T* __restrict__ part_rr, const T* __restrict__ rz,
                 T* __restrict__ rz_next, T* __restrict__ rr_next, const T* __restrict__ z, T* __restrict__ p,
                 int n, int parts) {
  __shared__ T sh[kWarps + 1];
  const size_t b = blockIdx.y;
  const size_t o = b * n;
  const T rz_new = parts_sum(part_rz + b * parts, parts, sh);
  const T rr_new = parts_sum(part_rr + b * parts, parts, sh);
  const T rz_old = rz[b];
  const T beta = rz_new / (rz_old > T(0) ? rz_old : T(1));
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += parts * kThreads)
    p[o + i] = add(z[o + i], mul(beta, p[o + i]));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    rz_next[b] = rz_new;
    rr_next[b] = rr_new;
  }
}

template <typename T>
int launch(void* const* a, double sigma, int B, int n, cudaStream_t s) {
  auto in = [&](int k) { return static_cast<const T*>(a[k]); };
  auto out = [&](int k) { return static_cast<T*>(a[k]); };
  const T *p_in = in(0), *u = in(1), *v = in(2), *dinv = in(3), *tol2 = in(4), *rz = in(5), *rr = in(6);
  T *Mp = out(7), *x = out(8), *r = out(9), *z = out(10), *p = out(11), *rz_next = out(12), *rr_next = out(13),
    *part = out(14);
  auto* steps = static_cast<int32_t*>(a[15]);
  const int parts = parts_of(n);
  const size_t np = static_cast<size_t>(B) * parts;
  T *part_pm = part, *part_rz = part + np, *part_rr = part + 2 * np;
  const dim3 grid(parts, B);
  dot_kernel<T><<<grid, kThreads, 0, s>>>(p_in, u, v, static_cast<T>(sigma), Mp, part_pm, n, parts);
  update_kernel<T><<<grid, kThreads, 0, s>>>(part_pm, rz, rr, tol2, p_in, Mp, dinv, x, r, z, part_rz, part_rr,
                                             steps, n, parts);
  direction_kernel<T><<<grid, kThreads, 0, s>>>(part_rz, part_rr, rz, rz_next, rr_next, z, p, n, parts);
  return cudaGetLastError();
}


// The operands and state of one CG solve in the loop.  The ELL operands:
// P's rows (B, n, kp) with pattern (n, kp), A's rows (B, m, ka) with
// (m, ka) and A's transpose (B, n, kt) with (n, kt).  w (B, m) the cg
// form's weights, or null for polish's form, which divides by `div`.
// The vectors are (B, n) unless named: Ap (B, m), rz and rr (2, B) with
// slot 0 holding the start, part (3, B, parts).
template <typename T>
struct LoopArgs {
  const T *pv, *av, *tv, *w, *dinv, *tol2;
  const int32_t *pi, *ai, *ti;
  T *x, *r, *z, *p, *Ap, *Mp, *rz, *rr, *part;
  int32_t* steps;
  T sigma, div;
  int kp, ka, kt, B, n, m, parts, max_iter;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) loop_kernel(const LoopArgs<T> a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ T sh[kWarps + 1];
  const int tid = threadIdx.x;
  const int parts = a.parts, n = a.n, m = a.m, B = a.B;
  const int items = B * parts;
  const size_t np = static_cast<size_t>(items);
  T *part_pm = a.part, *part_rz = a.part + np, *part_rr = a.part + 2 * np;
  const size_t threads = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t gtid = static_cast<size_t>(blockIdx.x) * kThreads + tid;
  int cur = 0;
  for (int k = 0; k < a.max_iter; ++k) {
    const T *rz = a.rz + cur * B, *rr = a.rr + cur * B;
    T *rz_next = a.rz + (1 - cur) * B, *rr_next = a.rr + (1 - cur) * B;
    // the stop test, which every block reads alike
    int live_any = 0;
    for (int b = tid; b < B; b += kThreads) live_any |= rr[b] > a.tol2[b];
    if (!__syncthreads_or(live_any)) break;

    // A p
    for (size_t e = gtid; e < static_cast<size_t>(B) * m; e += threads) {
      const size_t b = e / m;
      const int row = static_cast<int>(e - b * m);
      a.Ap[e] = ell_row<T, kSum>(a.av + e * a.ka, a.ai + static_cast<size_t>(row) * a.ka, a.p + b * n, nullptr,
                                  a.ka, row);
    }
    grid.sync();

    // Mp = (P p + sigma p) + V p and the partials of p'Mp (dot_kernel)
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / parts, q = it - b * parts;
      const size_t o = static_cast<size_t>(b) * n;
      T acc = T(0);
      for (int i = q * kThreads + tid; i < n; i += parts * kThreads) {
        const T p_i = a.p[o + i];
        T t = add(ell_row<T, kSum>(a.pv + (o + i) * a.kp, a.pi + static_cast<size_t>(i) * a.kp, a.p + o, nullptr,
                                   a.kp, i),
                  mul(a.sigma, p_i));
        if (m) {
          const T* tv = a.tv + (o + i) * a.kt;
          const int32_t* ti = a.ti + static_cast<size_t>(i) * a.kt;
          const T* Ap = a.Ap + static_cast<size_t>(b) * m;
          const T v = a.w ? ell_row<T, kWSum>(tv, ti, Ap, a.w + static_cast<size_t>(b) * m, a.kt, i)
                          : ell_row<T, kSum>(tv, ti, Ap, nullptr, a.kt, i) / a.div;
          t = add(t, v);
        }
        a.Mp[o + i] = t;
        acc = add(acc, mul(p_i, t));
      }
      const T s = block_sum(acc, sh);
      if (tid == 0) part_pm[it] = s;
    }
    grid.sync();

    // alpha, x, r, z and the partials of r'z and r'r (update_kernel)
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / parts, q = it - b * parts;
      const size_t o = static_cast<size_t>(b) * n;
      const T denom = parts_sum(part_pm + static_cast<size_t>(b) * parts, parts, sh);
      const bool live = rr[b] > a.tol2[b];
      const T alpha = live ? rz[b] / (denom > T(0) ? denom : T(1)) : T(0);
      if (live && q == 0 && tid == 0) a.steps[b] += 1;
      T acc_rz = T(0), acc_rr = T(0);
      for (int i = q * kThreads + tid; i < n; i += parts * kThreads) {
        a.x[o + i] = add(a.x[o + i], mul(alpha, a.p[o + i]));
        const T ri = sub(a.r[o + i], mul(alpha, a.Mp[o + i]));
        const T zi = mul(a.dinv[o + i], ri);
        a.r[o + i] = ri;
        a.z[o + i] = zi;
        acc_rz = add(acc_rz, mul(ri, zi));
        acc_rr = add(acc_rr, mul(ri, ri));
      }
      const T s_rz = block_sum(acc_rz, sh);
      const T s_rr = block_sum(acc_rr, sh);
      if (tid == 0) {
        part_rz[it] = s_rz;
        part_rr[it] = s_rr;
      }
    }
    grid.sync();

    // beta, p, and the next rz and r'r (direction_kernel)
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / parts, q = it - b * parts;
      const size_t o = static_cast<size_t>(b) * n;
      const T rz_new = parts_sum(part_rz + static_cast<size_t>(b) * parts, parts, sh);
      const T rr_new = parts_sum(part_rr + static_cast<size_t>(b) * parts, parts, sh);
      const T rz_old = rz[b];
      const T beta = rz_new / (rz_old > T(0) ? rz_old : T(1));
      for (int i = q * kThreads + tid; i < n; i += parts * kThreads) a.p[o + i] = add(a.z[o + i], mul(beta, a.p[o + i]));
      if (q == 0 && tid == 0) {
        rz_next[b] = rz_new;
        rr_next[b] = rr_new;
      }
    }
    grid.sync();
    cur = 1 - cur;
  }
}

// Blocks of the loop's grid for B instances of n variables: what the card
// holds at once, at most one per (instance, part).  0 on a CUDA error.
template <typename T>
int loop_blocks(int B, int n) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, loop_kernel<T>, kThreads, 0) != cudaSuccess)
    return 0;
  const long long items = static_cast<long long>(B) * parts_of(n);
  const long long resident = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(items < resident ? items : resident);
}

template <typename T>
int launch_loop(LoopArgs<T> a, cudaStream_t s) {
  a.parts = parts_of(a.n);
  const int blocks = loop_blocks<T>(a.B, a.n);
  if (blocks <= 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(loop_kernel<T>), dim3(blocks),
                                                      dim3(kThreads), args, 0, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Blocks per instance of a step at n variables: the partials buffer holds
// 3 * B * osqp_cg_parts(n) values.
extern "C" int osqp_cg_parts(int n) { return parts_of(n); }

// One CG step for B instances of n variables.  dtype: 0 float32, 1 float64.
// p (B,n) the direction, read and then overwritten with the next one;
// u = P p and v = A'(rho A p) (B,n), v null when A has no rows; dinv,
// tol2 (B), rz and rr (B) of the current step.  Written: Mp (B,n), x, r,
// z (B,n) updated in place, rz_next and rr_next (B), steps (B) int32
// incremented where the instance is live, and the partials (3,B,parts).
// All contiguous, B, n >= 1.
extern "C" int osqp_cg_step(int dtype, void* p, const void* u, const void* v, const void* dinv, const void* tol2,
                            const void* rz, const void* rr, void* Mp, void* x, void* r, void* z, void* rz_next,
                            void* rr_next, void* part, void* steps, double sigma, int B, int n, void* stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  void* const a[16] = {p, const_cast<void*>(u), const_cast<void*>(v), const_cast<void*>(dinv),
                       const_cast<void*>(tol2), const_cast<void*>(rz), const_cast<void*>(rr), Mp, x, r, z, p,
                       rz_next, rr_next, part, steps};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, sigma, B, n, s) : launch<double>(a, sigma, B, n, s);
}

// The whole CG solve of B instances of n variables on ELL operands, one
// cooperative launch.  dtype: 0 float32, 1 float64.  P: pv (B,n,kp), pi
// (n,kp); A (m rows; m may be 0): av (B,m,ka), ai (m,ka), tv (B,n,kt), ti
// (n,kt) int32; w (B,m) for the cg form, null for polish's form, whose
// V p is divided by `div`.  dinv (B,n), tol2 (B).  x, r, z, p (B,n) the
// start, updated in place; Ap (B,m) and Mp (B,n) scratch; rz and rr (2,B)
// with the start in slot 0; part (3,B,osqp_cg_parts(n)) scratch; steps
// (B) int32, incremented where live.  All contiguous, B, n >= 1.
extern "C" int osqp_cg_loop(int dtype, const void* pv, const void* pi, int kp, const void* av, const void* ai, int ka,
                            const void* tv, const void* ti, int kt, const void* w, double sigma, double div,
                            const void* dinv, const void* tol2, void* x, void* r, void* z, void* p, void* Ap, void* Mp,
                            void* rz, void* rr, void* part, void* steps, int B, int n, int m, int max_iter,
                            void* stream) {
  if (B == 0 || n == 0 || max_iter <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto a) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(a.pv)>>;
    a.pv = static_cast<const T*>(pv);
    a.av = static_cast<const T*>(av);
    a.tv = static_cast<const T*>(tv);
    a.w = static_cast<const T*>(w);
    a.dinv = static_cast<const T*>(dinv);
    a.tol2 = static_cast<const T*>(tol2);
    a.pi = static_cast<const int32_t*>(pi);
    a.ai = static_cast<const int32_t*>(ai);
    a.ti = static_cast<const int32_t*>(ti);
    a.x = static_cast<T*>(x);
    a.r = static_cast<T*>(r);
    a.z = static_cast<T*>(z);
    a.p = static_cast<T*>(p);
    a.Ap = static_cast<T*>(Ap);
    a.Mp = static_cast<T*>(Mp);
    a.rz = static_cast<T*>(rz);
    a.rr = static_cast<T*>(rr);
    a.part = static_cast<T*>(part);
    a.steps = static_cast<int32_t*>(steps);
    a.sigma = static_cast<T>(sigma);
    a.div = static_cast<T>(div);
    a.kp = kp;
    a.ka = ka;
    a.kt = kt;
    a.B = B;
    a.n = n;
    a.m = m;
    a.max_iter = max_iter;
    return launch_loop<T>(a, s);
  };
  return dtype == 0 ? fill(LoopArgs<float>{}) : fill(LoopArgs<double>{});
}

// The loop's grid at B instances of n variables (its blocks), 0 on a
// CUDA error.
extern "C" int osqp_cg_loop_blocks(int dtype, int B, int n) {
  return dtype == 0 ? loop_blocks<float>(B, n) : loop_blocks<double>(B, n);
}
