// K6: the vector work of one step of the batched Jacobi-preconditioned
// conjugate gradient, warm-started, with converged instances frozen.
//
// Replaces the body of the while loop of osqp_tpu/linsys/cg.py:129-169
// (solve), which solves (P + sigma I + A' diag(rho) A) x = b for every
// instance of the batch.  The operator's products (P p and A'(rho * A p))
// are the caller's: K5 launches on ELL operands, batched GEMVs on dense
// ones.  One step is then three launches over the (B, n) vectors:
//
//   dot_kernel        Mp = (P p + sigma p) + A'(rho A p);  partials of p'Mp
//   update_kernel     alpha = rz / p'Mp, 0 where r'r <= tol^2 (the freeze);
//                     x += alpha p,  r -= alpha Mp,  z = dinv r;
//                     partials of r'z and r'r;  steps[b] += 1 where live
//   direction_kernel  beta = rz_new / rz;  p = z + beta p;  rz, r'r stored
//
// An instance's vectors are cut over `parts` blocks (blockIdx.x), so that
// B=1 at n=1e4 spreads over 40 SMs.  Each block writes its partial sums,
// and every block of the next launch adds all of its instance's partials
// itself, in the same fixed order: the dot products do not depend on
// scheduling, there is no floating atomic, and two runs are bit-identical.
// rz and r'r go to the `next` slots of a ping-pong pair the wrapper swaps,
// since blocks of the direction pass still read the current rz.
//
// Each product and sum is rounded on its own (no fused multiply-add), in
// the order the JAX loop writes them; the plain version in ops/cg.py can
// sum its dot products in this kernel's order (kernel_dot), and from the
// same products the two then agree bit for bit.
//
// What bounds it on the H100: latency.  One step reads and writes some ten
// (B, n) vectors, 0.8 MB at B=1, n=1e4 in float64: 0.25 us at the HBM rate
// against three launches of a few microseconds each.  The loop that keeps
// every step on the device is a later redesign (a persistent kernel).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

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

// Sum of the `parts` partials of one instance, in a fixed order.
template <typename T>
__device__ T parts_sum(const T* __restrict__ part, int parts, T* sh) {
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
