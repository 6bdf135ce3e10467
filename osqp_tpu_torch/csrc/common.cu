// Library-wide entry points: CUDA error names and the sizes of a split
// launch, which the Python wrappers need to size scratch buffers.
#include "common.cuh"

// The message of a cudaError_t that a launcher returned.
extern "C" const char* osqp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// How the split kernels (K3 term_products, K4 ruiz) cut a batch of B
// instances with an (m x n) A and an (n x n) P on a card of sm_count
// SMs: out[0] column chunks, out[1] rows of A and out[2] rows of P that
// one block takes.
extern "C" void osqp_split_geometry(int B, int n, int m, int sm_count, int* out) {
  using namespace osqp_cuda;
  const int chunks = chunks_of(n);
  out[0] = chunks;
  out[1] = rows_per_tile(B, chunks, m, sm_count);
  out[2] = rows_per_tile(B, chunks, n, sm_count);
}
