// The order of K6's inner products, which its step kernels and both of its
// loops share (csrc/cg.cu, csrc/cg_dense.cu) and ops/cg.py:kernel_dot
// renders in PyTorch: an instance's n entries cut into `parts` parts of 256
// threads' grid-stride loops (entry i to thread i % 256 of part (i / 256) %
// parts), each thread adding its products in order, each part's warps
// summed by a butterfly and the warps' sums by another (block_sum), and
// the parts' partials summed in a fixed order (parts_sum).
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace osqp_cuda {

constexpr int kMaxParts = 64;  // parts of an instance at most

inline int parts_of(int n) {
  const int p = (n + kThreads - 1) / kThreads;
  return p < 1 ? 1 : (p > kMaxParts ? kMaxParts : p);
}

// The xor butterfly of sums over a warp; lane 0's value is the order that
// ops/cg.py:_lane0_of_butterfly renders (the other lanes hold the same sum
// in other orders).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// block_sum's last stage, the butterfly of warp 0 over the kWarps warps'
// sums with +0 in the other lanes: the levels at offsets 16 and 8 add +0
// to lanes below 8, which turns a -0 into +0 and changes no other value,
// so one addition of +0 stands for them.  Every lane below 8 gets the sum.
template <typename T>
__device__ __forceinline__ T warps_sum(T v) {
  static_assert(kWarps == 8, "the butterfly below is block_sum's over 8 warps");
  v = add(v, T(0));
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// parts_sum of parts <= 64 partials by one warp, every lane getting it:
// block_sum's warps 0 and 1 over partials [0, 32) and [32, 64), its warps
// 2-7 over zeros (+0), then its warp 0 over the eight warps' sums, whose
// butterfly adds +0 to the first two sums four times and then adds them.
template <typename T>
__device__ __forceinline__ T parts_total(const T* part, int parts, int lane) {
  const T a = warp_sum(lane < parts ? add(T(0), part[lane]) : T(0));
  const T b = parts > 32 ? warp_sum(lane + 32 < parts ? add(T(0), part[lane + 32]) : T(0)) : T(0);
  return add(add(a, T(0)), add(b, T(0)));
}

}  // namespace osqp_cuda
