// K5's row-gather reductions over one ELL row, shared by K5's kernels
// (ell_ops.cu) and by K6's device loop (cg.cu), which computes the CG
// operator's products with ell_row_sum so that its products are K5's bit
// for bit.
//
// With v the k values of row r of one instance, j the row's pattern and
// g (w) the instance's gathered vector (weight):
//
//   kSum   sum_s v[s] * g[j[s]]                 A x, and A'y on the transpose
//   kWSum  sum_s v[s] * (w[j[s]] * g[j[s]])     A'(w * y), w gathered per slot
//   kSq    sum_s (v[s] * v[s]) * g[j[s]]         sum_i w_i A_ij^2 on the transpose
//   kMax   max_s |v[s]| * g[j[s]]               row / column inf-norms under a weight
//   kDiag  sum_s v[s] where j[s] == r            diag(P)
//
// Sums run in slot order from 0, each product and sum rounded on its own
// (no fused multiply-add), as the plain versions in ops/ell.py sum them.
// Padded slots hold v = 0, j = 0, so they add 0 to each sum and to each
// non-negative maximum.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace osqp_cuda {

enum EllMode { kSum = 0, kWSum = 1, kSq = 2, kMax = 3, kDiag = 4 };

// |x| with the sign bit cleared, as torch.abs gives it (-0 becomes +0).
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

template <typename T, int M>
__device__ __forceinline__ T ell_row(const T* v, const int32_t* j, const T* g, const T* w, int k, int r) {
  T acc = T(0);
  for (int s = 0; s < k; ++s) {
    if (M == kSum) {
      acc = add(acc, mul(v[s], g[j[s]]));
    } else if (M == kWSum) {
      acc = add(acc, mul(v[s], mul(w[j[s]], g[j[s]])));
    } else if (M == kSq) {
      acc = add(acc, mul(mul(v[s], v[s]), g[j[s]]));
    } else if (M == kMax) {
      const T a = mul(abs_of(v[s]), g[j[s]]);
      acc = s == 0 || a > acc ? a : acc;
    } else {
      if (j[s] == r) acc = add(acc, v[s]);
    }
  }
  return acc;
}

// ell_row<T, kSum> with the gathered vector read through get(j): the same
// slot order and rounding (K6's device loop, whose p and A p lie where
// other CTAs stored them).
template <typename T, typename Get>
__device__ __forceinline__ T ell_row_sum(const T* v, const int32_t* j, int k, Get&& get) {
  T acc = T(0);
  for (int s = 0; s < k; ++s) acc = add(acc, mul(v[s], get(j[s])));
  return acc;
}

}  // namespace osqp_cuda
