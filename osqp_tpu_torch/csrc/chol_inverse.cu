// K2: batched SPD inverse, one thread block per instance.
//
// Replaces osqp_tpu/ops/spd_inverse.py:spd_inverse (its Jacobi scaling,
// the recursive _chol_inv with its leaves _chol_inv_base2,
// _chol_inv_leaf and _chol_inv_leaf_batchminor, and T'T), called from
// osqp_tpu/linsys/dense_inv.py:init.  The JAX package recurses into
// batched GEMMs because a Cholesky factorization serialises on the TPU.
// On Hopper one block per instance runs the classic algorithm on a copy
// of the matrix held entirely in shared memory:
//
//   d_i = 1/sqrt(M_ii)          (NaN where M_ii <= 0)
//   S   = d M d                 symmetric Jacobi equilibration
//   S   = L, lower, in place    right-looking Cholesky
//   S   = T = L^-1 in place     row by row
//   X   = d (T'T) d             written to device memory
//
// A non-PD matrix gives NaN (sqrt of a negative pivot), which spreads
// through the rest of the factor and the inverse: callers read that NaN
// as the non-convexity signal, as in the JAX package.
//
// What bounds it on the H100: the n x n block in shared memory.  The
// block holds n*n + 2n values, so n <= 240 in float32 and n <= 169 in
// float64 fit the 227 KB a block may use; the Python wrapper raises
// above that and dense_inv.init takes torch's Cholesky there.  Device
// memory traffic is one read of M and one write of X (80 KB per
// instance at n=100 in f32); the work is ~4n^3/3 flops per instance
// (n^3/3 factor, n^3/3 triangular inverse, 2n^3/3 for T'T), all out of
// shared memory, with 4n block barriers in the two sequential phases.
// The design keeps every intermediate on chip: device memory sees only
// M and X, and the sequential depth, not bandwidth, sets the time.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_inverse_kernel(const T* __restrict__ M, T* __restrict__ X, int n) {
  extern __shared__ unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // n*n working matrix
  T* d = S + n * n;                       // Jacobi scaling
  T* row = d + n;                         // one row of L
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const T* Mb = M + off;
  T* Xb = X + off;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nn = n * n;

  for (int i = tid; i < n; i += nt) {
    const T g = Mb[i * n + i];
    d[i] = g > T(0) ? T(1) / sqrt(g) : T(NAN);
  }
  __syncthreads();
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n;
    const int j = e - i * n;
    S[e] = Mb[e] * d[i] * d[j];
  }
  __syncthreads();

  // Right-looking Cholesky of the lower triangle, in place.
  for (int k = 0; k < n; ++k) {
    const T lkk = sqrt(S[k * n + k]);
    for (int i = k + 1 + tid; i < n; i += nt) S[i * n + k] /= lkk;
    __syncthreads();
    if (tid == 0) S[k * n + k] = lkk;
    const int r = n - k - 1;
    for (int e = tid; e < r * r; e += nt) {
      const int ii = e / r;
      const int jj = e - ii * r;
      if (jj <= ii) {
        const int i = k + 1 + ii;
        const int j = k + 1 + jj;
        S[i * n + j] -= S[i * n + k] * S[j * n + k];
      }
    }
    __syncthreads();
  }

  // T = L^-1 in place, one row at a time: row i of L is copied out
  // first, because row i of T overwrites it while being computed.
  //   T_ij = (delta_ij - sum_{k=j}^{i-1} L_ik T_kj) / L_ii,   j <= i
  for (int i = 0; i < n; ++i) {
    for (int j = tid; j <= i; j += nt) row[j] = S[i * n + j];
    __syncthreads();
    const T lii = row[i];
    for (int j = tid; j <= i; j += nt) {
      T acc = j == i ? T(1) : T(0);
      for (int k = j; k < i; ++k) acc -= row[k] * S[k * n + j];
      S[i * n + j] = acc / lii;
    }
    __syncthreads();
  }

  // X = d (T'T) d; T is lower, so the sum starts at max(i, j).  The
  // upper triangle of S still holds scaled M and is never read.
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n;
    const int j = e - i * n;
    T acc = T(0);
    for (int k = i > j ? i : j; k < n; ++k) acc += S[k * n + i] * S[k * n + j];
    Xb[e] = acc * d[i] * d[j];
  }
}

template <typename T>
int launch(const void* M, void* X, int B, int n, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(n) * n + 2 * n) * sizeof(T);
  if (smem > 48 * 1024) {  // above the default, dynamic shared memory needs an opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        chol_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chol_inverse_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(M), static_cast<T*>(X), n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  M and X are contiguous (B, n, n).
extern "C" int osqp_chol_inverse(int dtype, const void* M, void* X, int B, int n, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(M, X, B, n, s) : launch<double>(M, X, B, n, s);
}

extern "C" const char* osqp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
