// What the kernels of osqp_tpu_torch share: the block and tile geometry,
// correctly rounded arithmetic, and the sizes of a split launch.
//
// The geometry lives here only.  The Python wrappers ask the library for
// what they must size (osqp_split_geometry, osqp_*_smem in the .cu
// files) instead of repeating these constants.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace osqp_cuda {

constexpr int kWarps = 8;                // warps of every block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 8;              // columns a lane takes in the split kernels (K3, K4)
constexpr int kChunk = 32 * kPerLane;    // columns one block of a split kernel takes
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory above this needs an opt-in

// Each operation rounded on its own, as PyTorch rounds it: nvcc may not
// contract these into fused multiply-adds.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// Blocks of a grid-stride loop over `total` elements.
inline int grid_size(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65536 ? (blocks > 0 ? blocks : 1) : 65536);
}

// Column chunks of an n-column matrix in a split kernel.
inline int chunks_of(int n) { return (n + kChunk - 1) / kChunk; }

// Rows of an R-row matrix that one block of a split kernel takes: enough
// tiles that B x chunks x tiles blocks give every SM four, and at least
// one row per warp.  At B=8192 one tile spans the matrix; at B=1 the
// rows of one instance spread over the card.
inline int rows_per_tile(int B, int chunks, int R, int sm_count) {
  const long long want = 4LL * sm_count;
  const long long blocks = static_cast<long long>(B) * chunks;
  long long tiles = (want + blocks - 1) / (blocks > 0 ? blocks : 1);
  const long long most = (R + kWarps - 1) / kWarps;
  tiles = tiles < most ? tiles : most;
  tiles = tiles > 1 ? tiles : 1;
  const long long rows = (R + tiles - 1) / tiles;
  return static_cast<int>(rows > 1 ? rows : 1);
}

// Opt a kernel in to `smem` bytes of dynamic shared memory when that is
// above the default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

}  // namespace osqp_cuda
