// K7: the block-tridiagonal Cholesky factorization of the reduced KKT
// matrix M = P + sigma I + A' diag(rho) A, and the solve with its factors,
// one thread block per instance.
//
// Replaces osqp_tpu/linsys/block_tridiag.py:init (:133-170), _tsolve
// (:173) and solve (:180-228), two lax.scan recursions over the Nb stages
// of b = nx + nu variables of a stage-ordered problem (MPC), each step a
// batched b x b Cholesky or triangular solve:
//
//   factor  C_0 = chol(D_0);  G_i = O_i C_{i-1}^-T;  C_i = chol(D_i - G_i G_i')
//   solve   y_i = C_i^-1 (r_i - G_i y_{i-1})         forward over the stages
//           x_i = C_i^-T (y_i - G_{i+1}' x_{i+1})    backward over the stages
//
// where D_i = M[block i, block i] and O_i = M[block i, block i-1].  The
// factor kernel reads those two blocks of each stage straight from M
// (strided; the rest of M is never read), keeps C_{i-1}, D_i and O_i in
// shared memory (3 b^2 values), and writes C (B, Nb, b, b), lower with
// zeros above, and G (B, Nb-1, b, b).  A stage whose pivot is not
// positive gives NaN in the whole lower triangle of C_i, as
// jnp.linalg.cholesky does, and the NaN runs on through every later
// stage: it is not raised.  The solve kernel walks both passes in one
// launch, keeping y in x's memory.
//
// Every product, sum, quotient and square root is rounded on its own (no
// fused multiply-add), in the order of the plain versions in
// ops/block_tridiag.py: the triangular solves by columns, the Cholesky
// right-looking, column by column.  So kernel and plain version agree bit
// for bit.
//
// What bounds it on the H100: latency.  At the MPC cell (B = 1000, b = 12,
// Nb = 31, float32) the factor reads the band blocks of M and writes C
// and G, about 70 MB (0.02 ms at the HBM rate), and the solve reads C and
// G once, about 35 MB; the work is ~Nb b^3 operations per instance.  What
// sets the time is the chain of dependent steps inside a block: b column
// steps of the Cholesky and of each triangular solve per stage, each
// behind a block barrier.  This first version is the simple one; packing
// several instances into a block and fusing the A products into the solve
// are for later.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using osqp_cuda::allow_smem;
using osqp_cuda::mul;
using osqp_cuda::sub;

constexpr int kFactorThreads = 128;
constexpr int kSolveThreads = 32;

__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

template <typename T>
__device__ __forceinline__ T not_a_number() {
  return static_cast<T>(NAN);
}

template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
factor_kernel(const T* __restrict__ M, T* __restrict__ C, T* __restrict__ G, int b, int Nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int bad;
  const int bb = b * b;
  T* Cp = reinterpret_cast<T*>(smem);  // C_{i-1}
  T* S = Cp + bb;                      // D_i, then D_i - G_i G_i', then C_i
  T* W = S + bb;                       // O_i, then G_i
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t n = static_cast<size_t>(Nb) * b;
  const T* Mi = M + blockIdx.x * n * n;
  T* Ci = C + blockIdx.x * static_cast<size_t>(Nb) * bb;
  T* Gi = G + blockIdx.x * static_cast<size_t>(Nb - 1) * bb;

  for (int i = 0; i < Nb; ++i) {
    const size_t r0 = static_cast<size_t>(i) * b;
    for (int e = tid; e < bb; e += nt) {
      const int r = e / b, c = e - r * b;
      const T* row = Mi + (r0 + r) * n + r0;
      S[e] = row[c];
      if (i > 0) W[e] = row[c - b];
    }
    if (tid == 0) bad = 0;
    __syncthreads();

    if (i > 0) {
      // G_i = O_i C_{i-1}^-T, one row per thread:
      // G[r, j] = (O[r, j] - sum_{t<j} G[r, t] C[j, t]) / C[j, j]
      for (int r = tid; r < b; r += nt) {
        T* g = W + r * b;
        for (int j = 0; j < b; ++j) {
          T acc = g[j];
          for (int t = 0; t < j; ++t) acc = sub(acc, mul(g[t], Cp[j * b + t]));
          g[j] = quot(acc, Cp[j * b + j]);
        }
      }
      __syncthreads();
      // D_i - G_i G_i' on the lower triangle; G_i to device memory
      for (int e = tid; e < bb; e += nt) {
        Gi[static_cast<size_t>(i - 1) * bb + e] = W[e];
        const int r = e / b, c = e - r * b;
        if (c <= r) {
          T acc = S[e];
          for (int t = 0; t < b; ++t) acc = sub(acc, mul(W[r * b + t], W[c * b + t]));
          S[e] = acc;
        }
      }
      __syncthreads();
    }

    // C_i = chol(S), right-looking, column by column.  The diagonal is
    // written in the update phase, which does not read it.
    for (int j = 0; j < b; ++j) {
      const T piv = S[j * b + j];
      const T d = root(piv);
      for (int r = j + 1 + tid; r < b; r += nt) S[r * b + j] = quot(S[r * b + j], d);
      __syncthreads();
      if (tid == 0) {
        S[j * b + j] = d;
        if (!(piv > T(0))) bad = 1;
      }
      for (int e = tid; e < bb; e += nt) {
        const int r = e / b, c = e - r * b;
        if (c > j && c <= r) S[e] = sub(S[e], mul(S[r * b + j], S[c * b + j]));
      }
      __syncthreads();
    }
    const bool failed = bad != 0;
    for (int e = tid; e < bb; e += nt) {
      const int r = e / b, c = e - r * b;
      const T v = c <= r ? (failed ? not_a_number<T>() : S[e]) : T(0);
      Ci[static_cast<size_t>(i) * bb + e] = v;
      Cp[e] = v;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
solve_kernel(const T* __restrict__ C, const T* __restrict__ G, const T* __restrict__ rhs, T* __restrict__ x, int b,
             int Nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* v = reinterpret_cast<T*>(smem);
  const int bb = b * b;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t n = static_cast<size_t>(Nb) * b;
  const T* Ci = C + blockIdx.x * static_cast<size_t>(Nb) * bb;
  const T* Gi = G + blockIdx.x * static_cast<size_t>(Nb - 1) * bb;
  const T* ri = rhs + blockIdx.x * n;
  T* xi = x + blockIdx.x * n;

  // Forward: y_i = C_i^-1 (r_i - G_i y_{i-1}), y kept in x.
  for (int i = 0; i < Nb; ++i) {
    const T* c = Ci + static_cast<size_t>(i) * bb;
    for (int j = tid; j < b; j += nt) {
      T acc = ri[static_cast<size_t>(i) * b + j];
      if (i > 0) {
        const T* g = Gi + static_cast<size_t>(i - 1) * bb + j * b;
        const T* yp = xi + static_cast<size_t>(i - 1) * b;
        for (int t = 0; t < b; ++t) acc = sub(acc, mul(g[t], yp[t]));
      }
      v[j] = acc;
    }
    __syncthreads();
    for (int j = 0; j < b; ++j) {
      const T yj = quot(v[j], c[j * b + j]);
      for (int k = j + 1 + tid; k < b; k += nt) v[k] = sub(v[k], mul(c[k * b + j], yj));
      if (tid == 0) xi[static_cast<size_t>(i) * b + j] = yj;
      __syncthreads();
    }
  }
  // Backward: x_i = C_i^-T (y_i - G_{i+1}' x_{i+1}).
  for (int i = Nb - 1; i >= 0; --i) {
    const T* c = Ci + static_cast<size_t>(i) * bb;
    for (int j = tid; j < b; j += nt) {
      T acc = xi[static_cast<size_t>(i) * b + j];
      if (i < Nb - 1) {
        const T* g = Gi + static_cast<size_t>(i) * bb + j;
        const T* xn = xi + static_cast<size_t>(i + 1) * b;
        for (int t = 0; t < b; ++t) acc = sub(acc, mul(g[t * b], xn[t]));
      }
      v[j] = acc;
    }
    __syncthreads();
    for (int j = b - 1; j >= 0; --j) {
      const T xj = quot(v[j], c[j * b + j]);
      for (int k = tid; k < j; k += nt) v[k] = sub(v[k], mul(c[j * b + k], xj));
      if (tid == 0) xi[static_cast<size_t>(i) * b + j] = xj;
      __syncthreads();
    }
  }
}

template <typename T>
int factor(const void* M, void* C, void* G, int B, int b, int Nb, cudaStream_t s) {
  const size_t smem = 3 * static_cast<size_t>(b) * b * sizeof(T);
  const cudaError_t err = allow_smem(factor_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  factor_kernel<T><<<B, kFactorThreads, smem, s>>>(static_cast<const T*>(M), static_cast<T*>(C), static_cast<T*>(G),
                                                    b, Nb);
  return cudaGetLastError();
}

template <typename T>
int solve(const void* C, const void* G, const void* rhs, void* x, int B, int b, int Nb, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(b) * sizeof(T);
  const cudaError_t err = allow_smem(solve_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  solve_kernel<T><<<B, kSolveThreads, smem, s>>>(static_cast<const T*>(C), static_cast<const T*>(G),
                                                  static_cast<const T*>(rhs), static_cast<T*>(x), b, Nb);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  M (B, Nb b, Nb b) contiguous; writes C
// (B, Nb, b, b) and G (B, Nb-1, b, b), contiguous.  3 b^2 values of the
// dtype must fit one block's shared memory (the wrapper checks).
extern "C" int osqp_bt_factor(int dtype, const void* M, void* C, void* G, int B, int b, int Nb, void* stream) {
  if (B == 0 || b == 0 || Nb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? factor<float>(M, C, G, B, b, Nb, s) : factor<double>(M, C, G, B, b, Nb, s);
}

// x = M^-1 rhs with the factors above; rhs and x (B, Nb b), contiguous.
extern "C" int osqp_bt_solve(int dtype, const void* C, const void* G, const void* rhs, void* x, int B, int b, int Nb,
                             void* stream) {
  if (B == 0 || b == 0 || Nb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? solve<float>(C, G, rhs, x, B, b, Nb, s) : solve<double>(C, G, rhs, x, B, b, Nb, s);
}
