// K4: modified Ruiz equilibration of dense batched QP data.
//
// Replaces osqp_tpu/scaling.py:scale_data (dense branch, its sweep and
// the final apply), called from batch._prepare and the Solver's setup.
// For sweeps k = 1..n_iters, per instance b (scaling.c:44-156):
//
//   colA_j = max_i E_i |A_ij|       rowA_i = max_j |A_ij| D_j
//   D_j   *= 1 / sqrt(limit(max(Pcol_j c, colA_j D_j)))
//   E_i   *= 1 / sqrt(limit(rowA_i E_i))
//   Pcol_j = (max_i D_i |P_ij|) D_j                     (with the new D)
//   c     /= limit(max(mean_j(Pcol_j c), limit(max_j |q_j| D_j c)))
//
// then one pass writes c DPD, EAD, c Dq, El and Eu.
//
// What bounds it on the H100: device-memory bandwidth.  The plain
// version writes a scaled (B,n,n) or (B,m,n) temporary for every
// reduction; here each sweep reads A once (both of its maxima) and P
// once, and writes only vectors.  The reads split over blocks within an
// instance (a tile of rows by 256 columns each), so that B=1 at n=1000
// fills the card as B=8192 at n=100 does.  Blocks combine their partial
// maxima with atomicMax on the bit patterns of non-negative values,
// which order as unsigned integers: a maximum does not depend on its
// order, so D and E equal the plain version's bit for bit.  The mean is
// the pairwise sum of osqp_tpu_torch.ops.ruiz.tree_sum, in the same
// order, so c does too.  Every product is rounded on its own
// (__fmul_rn), as PyTorch rounds it, and nothing is contracted.
//
// Launch sequence per sweep: amax over A, update D and E, amax over P,
// update c.  The scratch maxima are zeroed by the kernel that reads
// them, ready for the next sweep.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace osqp_cuda;
constexpr double kMinScaling = 1e-4;
constexpr double kMaxScaling = 1e4;

template <typename T> struct Bits;
template <> struct Bits<float> { using U = unsigned int; };
template <> struct Bits<double> { using U = unsigned long long; };

__device__ __forceinline__ unsigned int to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned long long to_bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v));
}
__device__ __forceinline__ float from_bits(unsigned int v) { return __uint_as_float(v); }
__device__ __forceinline__ double from_bits(unsigned long long v) {
  return __longlong_as_double(static_cast<long long>(v));
}

// max that passes NaN on, as torch.maximum and amax do
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// scaling.c:7-14
template <typename T>
__device__ __forceinline__ T limit_scaling(T v) {
  v = v < T(kMinScaling) ? T(1) : v;
  return v > T(kMaxScaling) ? T(kMaxScaling) : v;
}

// 1 / sqrt(limit(v)), each step correctly rounded
template <typename T>
__device__ __forceinline__ T inv_sqrt_limited(T v) {
  return T(1) / sqrt(limit_scaling(v));
}

// Partial maxima of one (rows x 256 columns) tile of an R x C matrix of
// instance blockIdx.x:
//   colout_c = max_r rowscale_r |M_rc|     (atomicMax)
//   rowout_r = max_c |M_rc| colscale_c     (atomicMax; skipped when null)
// A warp takes one row at a time, each lane eight columns of it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ M, int R, int C, int rows, const T* __restrict__ rowscale,
            const T* __restrict__ colscale, typename Bits<T>::U* __restrict__ colout,
            typename Bits<T>::U* __restrict__ rowout) {
  __shared__ T red[kWarps][kChunk];
  const size_t b = blockIdx.x;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(R, r0 + rows);
  const int c0 = blockIdx.z * kChunk;
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const T* Mb = M + b * R * C;
  T colacc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) colacc[k] = T(0);

  for (int r = r0 + w; r < r1; r += kWarps) {
    const T rs = rowscale[b * R + r];
    T a[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + lane + 32 * k;
      a[k] = c < C ? fabs(Mb[static_cast<size_t>(r) * C + c]) : T(0);
    }
    T rowacc = T(0);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < C) {
        colacc[k] = vmax(colacc[k], mul(a[k], rs));
        if (rowout) rowacc = vmax(rowacc, mul(a[k], colscale[b * C + c]));
      }
    }
    if (rowout) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rowacc = vmax(rowacc, __shfl_xor_sync(0xffffffffu, rowacc, off));
      if (lane == 0) atomicMax(rowout + b * R + r, to_bits(rowacc));
    }
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) red[w][lane + 32 * k] = colacc[k];
  __syncthreads();
  const int tid = w * 32 + lane;
  const int c = c0 + tid;
  if (c < C && r0 < r1) {
    T v = red[0][tid];
    for (int k = 1; k < kWarps; ++k) v = vmax(v, red[k][tid]);
    atomicMax(colout + b * C + c, to_bits(v));
  }
}

// D and E of one sweep from the maxima over A; zeroes those maxima.
template <typename T>
__global__ void __launch_bounds__(kThreads)
update_de_kernel(const T* __restrict__ c, const T* __restrict__ p_col, typename Bits<T>::U* __restrict__ col_a,
                 typename Bits<T>::U* __restrict__ row_a, T* __restrict__ D, T* __restrict__ E, int n, int m) {
  const size_t b = blockIdx.x;
  const int j = blockIdx.y * kThreads + threadIdx.y * 32 + threadIdx.x;
  if (j < n) {
    const size_t k = b * n + j;
    const T pn = mul(p_col[k], c[b]);
    T dn = pn;
    if (m > 0) {
      dn = vmax(pn, mul(from_bits(col_a[k]), D[k]));
      col_a[k] = 0;
    }
    D[k] = mul(D[k], inv_sqrt_limited(dn));
  }
  if (j < m) {
    const size_t k = b * m + j;
    const T en = mul(from_bits(row_a[k]), E[k]);
    row_a[k] = 0;
    E[k] = mul(E[k], inv_sqrt_limited(en));
  }
}

// Pcol_j = (max_i D_i |P_ij|) D_j from the maxima over P, which it
// zeroes; with update_cost, the cost normalisation of c.  One block per
// instance; sum holds `width` values, n rounded up to a power of two.
template <typename T>
__global__ void __launch_bounds__(kThreads)
update_c_kernel(const T* __restrict__ q, const T* __restrict__ D, typename Bits<T>::U* __restrict__ col_p,
                T* __restrict__ p_col, T* __restrict__ c, int n, int width, bool update_cost) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sum = reinterpret_cast<T*>(smem_raw);
  __shared__ T qred[kWarps];
  const size_t b = blockIdx.x;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const T cb = c[b];
  T qmax = T(0);
  for (int j = tid; j < width; j += kThreads) {
    T s = T(0);
    if (j < n) {
      const size_t k = b * n + j;
      const T pc = mul(from_bits(col_p[k]), D[k]);
      col_p[k] = 0;
      p_col[k] = pc;
      s = mul(pc, cb);
      qmax = vmax(qmax, mul(fabs(q[k]), D[k]));
    }
    sum[j] = s;
  }
  if (!update_cost) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qmax = vmax(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  if (threadIdx.x == 0) qred[threadIdx.y] = qmax;
  __syncthreads();
  for (int h = width / 2; h >= 1; h /= 2) {
    for (int j = tid; j < h; j += kThreads) sum[j] = add(sum[j], sum[j + h]);
    __syncthreads();
  }
  if (tid == 0) {
    T qm = qred[0];
    for (int k = 1; k < kWarps; ++k) qm = vmax(qm, qred[k]);
    const T mean = sum[0] / T(n);
    const T inf_norm_q = limit_scaling(mul(qm, cb));
    c[b] = cb / limit_scaling(vmax(mean, inf_norm_q));
  }
}

// out = scale_b ((left_i M_ij) right_j) over a (B, R, C) batch, in the
// plain version's order; scale may be null (1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ M, const T* __restrict__ left, const T* __restrict__ right,
             const T* __restrict__ scale, T* __restrict__ out, int B, int R, int C) {
  const size_t total = static_cast<size_t>(B) * R * C;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.y * 32 + threadIdx.x; e < total;
       e += stride) {
    const size_t b = e / (static_cast<size_t>(R) * C);
    const size_t rc = e - b * R * C;
    const int i = static_cast<int>(rc / C);
    const int j = static_cast<int>(rc - static_cast<size_t>(i) * C);
    const T v = mul(mul(left[b * R + i], M[e]), right[b * C + j]);
    out[e] = scale ? mul(scale[b], v) : v;
  }
}

// q_s = c (D q), l_s = E l, u_s = E u
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_vectors_kernel(const T* __restrict__ q, const T* __restrict__ l, const T* __restrict__ u,
                     const T* __restrict__ c, const T* __restrict__ D, const T* __restrict__ E,
                     T* __restrict__ qs, T* __restrict__ ls, T* __restrict__ us, int n, int m) {
  const size_t b = blockIdx.x;
  for (int j = threadIdx.y * 32 + threadIdx.x; j < n || j < m; j += kThreads) {
    if (j < n) qs[b * n + j] = mul(c[b], mul(D[b * n + j], q[b * n + j]));
    if (j < m) {
      ls[b * m + j] = mul(E[b * m + j], l[b * m + j]);
      us[b * m + j] = mul(E[b * m + j], u[b * m + j]);
    }
  }
}

template <typename T>
int launch(void* const* p, int n_iters, int B, int n, int m, int rows_a, int rows_p, cudaStream_t s) {
  using U = typename Bits<T>::U;
  auto in = [&](int k) { return static_cast<const T*>(p[k]); };
  auto out = [&](int k) { return static_cast<T*>(p[k]); };
  const T *P = in(0), *q = in(1), *A = in(2), *l = in(3), *u = in(4);
  T *c = out(5), *D = out(6), *E = out(7);
  T *Ps = out(8), *qs = out(9), *As = out(10), *ls = out(11), *us = out(12);
  U* col_a = static_cast<U*>(p[13]);
  U* row_a = static_cast<U*>(p[14]);
  U* col_p = static_cast<U*>(p[15]);
  T* p_col = out(16);

  int width = 1;
  while (width < n) width *= 2;
  const size_t smem_c = static_cast<size_t>(width) * sizeof(T);
  const cudaError_t err = allow_smem(update_c_kernel<T>, smem_c);
  if (err != cudaSuccess) return err;
  const dim3 block(32, kWarps);
  const int chunks = chunks_of(n);
  const dim3 grid_a(B, m > 0 ? (m + rows_a - 1) / rows_a : 1, chunks);
  const dim3 grid_p(B, (n + rows_p - 1) / rows_p, chunks);
  const int nm = n > m ? n : m;
  const dim3 grid_de(B, (nm + kThreads - 1) / kThreads);

  // Pcol of the unscaled P (D = 1).
  amax_kernel<T><<<grid_p, block, 0, s>>>(P, n, n, rows_p, D, nullptr, col_p, nullptr);
  update_c_kernel<T><<<B, block, smem_c, s>>>(q, D, col_p, p_col, c, n, width, false);
  for (int it = 0; it < n_iters; ++it) {
    if (m > 0) amax_kernel<T><<<grid_a, block, 0, s>>>(A, m, n, rows_a, E, D, col_a, row_a);
    update_de_kernel<T><<<grid_de, block, 0, s>>>(c, p_col, col_a, row_a, D, E, n, m);
    amax_kernel<T><<<grid_p, block, 0, s>>>(P, n, n, rows_p, D, nullptr, col_p, nullptr);
    update_c_kernel<T><<<B, block, smem_c, s>>>(q, D, col_p, p_col, c, n, width, true);
  }
  apply_kernel<T><<<grid_size(static_cast<size_t>(B) * n * n), block, 0, s>>>(P, D, D, c, Ps, B, n, n);
  if (m > 0) apply_kernel<T><<<grid_size(static_cast<size_t>(B) * m * n), block, 0, s>>>(A, E, D, nullptr, As, B, m, n);
  apply_vectors_kernel<T><<<B, block, 0, s>>>(q, l, u, c, D, E, qs, ls, us, n, m);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  Inputs P (B,n,n), q (B,n), A (B,m,n),
// l, u (B,m); c (B,), D (B,n), E (B,m) come in as ones and leave as the
// scaling; outputs have the inputs' shapes.  Scratch: col_a, col_p,
// p_col (B,n) and row_a (B,m), the first three and row_a zeroed.  All
// contiguous, n >= 1; rows_a and rows_p are the rows of A and P that one
// block takes.
extern "C" int osqp_ruiz(int dtype, const void* P, const void* q, const void* A, const void* l,
                         const void* u, void* c, void* D, void* E, void* Ps, void* qs, void* As,
                         void* ls, void* us, void* col_a, void* row_a, void* col_p, void* p_col,
                         int n_iters, int B, int n, int m, int rows_a, int rows_p, void* stream) {
  if (B == 0) return cudaSuccess;
  void* const p[17] = {const_cast<void*>(P), const_cast<void*>(q), const_cast<void*>(A),
                       const_cast<void*>(l), const_cast<void*>(u), c, D, E, Ps, qs, As, ls, us,
                       col_a, row_a, col_p, p_col};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, n_iters, B, n, m, rows_a, rows_p, s)
                    : launch<double>(p, n_iters, B, n, m, rows_a, rows_p, s);
}
