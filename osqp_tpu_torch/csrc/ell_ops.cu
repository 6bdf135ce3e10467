// K5: the row-gather products of ELL operands, for a batch of sparse QPs
// that share one sparsity pattern.
//
// Replaces osqp_tpu/sparse_ops.py:120-177 (ell_matvec, ell_tmatvec,
// ell_diagonal, ell_sq_colsums, ell_row_norms, ell_col_norms, ell_scale),
// which XLA lowers to a gather and a reduction over the slot axis.  One
// templated kernel serves every reduction.  With val (B, R, k) row-padded
// values, idx (R, k) the pattern shared by the batch and g (B, G) the
// gathered vector, thread (b, r) reduces over the k slots of row r:
//
//   kSum   out[b][r] = sum_s val * g[idx]            A x, and A'y on the transpose
//   kWSum  out[b][r] = sum_s val * (w[idx] * g[idx]) A'(rho * y), rho gathered per slot
//   kSq    out[b][r] = sum_s (val * val) * g[idx]    sum_i w_i A_ij^2 on the transpose
//   kMax   out[b][r] = max_s |val| * g[idx]          row / column inf-norms under a weight
//   kDiag  out[b][r] = sum_s val where idx == r      diag(P)
//
// scale_kernel is the same walk written elementwise: val * r[row] * s[idx]
// (* c) on A's copy and on the transpose's, in one launch.
//
// Padded slots hold val = 0, idx = 0, so they add 0 to each sum and to each
// non-negative maximum, as the JAX reductions have them: nothing masks by
// count.  Sums run in slot order from 0, each product and sum rounded on
// its own (no fused multiply-add), as the plain versions in ops/ell.py sum
// them, so kernel and plain version agree bit for bit.  The reduction over
// one row lives in ell_gather.cuh, which K6's device loop shares.
//
// What bounds it on the H100: latency and launch overhead.  k is the
// largest row count (1-9 on the Maros-Meszaros problems of the sparse
// path), so one call at B=1, n=1e4 moves about 1 MB: 0.3 us at the HBM
// rate, well under one launch.  One thread per output row, looping over
// its k slots, is enough for that; a warp per row would only pay for wide
// rows (k >= 32), which the path does not have.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "ell_gather.cuh"

namespace {

using namespace osqp_cuda;

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ val, const int32_t* __restrict__ idx, const T* __restrict__ g,
              const T* __restrict__ w, T* __restrict__ out, int B, int R, int k, int G) {
  const size_t total = static_cast<size_t>(B) * R;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total; e += stride) {
    const size_t b = e / R;
    const int r = static_cast<int>(e - b * R);
    out[e] = ell_row<T, M>(val + e * k, idx + static_cast<size_t>(r) * k, g + b * G, w ? w + b * G : nullptr, k, r);
  }
}

// Elements [0, B*m*ka) are A's: val_out = ((val * row_s[b][i]) * col_s[b][idx]) * c[b];
// the next B*n*kt are the transpose's: t_val_out = ((t_val * col_s[b][j]) * row_s[b][t_idx]) * c[b].
// c null: no cost factor.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const T* __restrict__ val, const int32_t* __restrict__ idx, const T* __restrict__ t_val,
             const int32_t* __restrict__ t_idx, const T* __restrict__ row_s, const T* __restrict__ col_s,
             const T* __restrict__ c, T* __restrict__ val_out, T* __restrict__ t_val_out, int B, int m, int ka,
             int n, int kt) {
  const size_t na = static_cast<size_t>(B) * m * ka;
  const size_t total = na + static_cast<size_t>(B) * n * kt;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total; e += stride) {
    const bool mine = e < na;
    const size_t f = mine ? e : e - na;
    const int rows = mine ? m : n, k = mine ? ka : kt, len_in = mine ? n : m;
    const size_t b = f / (static_cast<size_t>(rows) * k);
    const size_t rs = f - b * rows * k;  // row * k + slot
    const int row = static_cast<int>(rs / k);
    const T* rsc = mine ? row_s : col_s;  // scale of the stored row
    const T* csc = mine ? col_s : row_s;  // scale of the gathered index
    const int32_t j = (mine ? idx : t_idx)[rs];
    T v = mul(mul((mine ? val : t_val)[f], rsc[b * rows + row]), csc[b * len_in + j]);
    if (c) v = mul(v, c[b]);
    (mine ? val_out : t_val_out)[f] = v;
  }
}

template <typename T>
int launch_reduce(int mode, const void* val, const void* idx, const void* g, const void* w, void* out, int B,
                  int R, int k, int G, cudaStream_t s) {
  const auto* v = static_cast<const T*>(val);
  const auto* j = static_cast<const int32_t*>(idx);
  const auto* gg = static_cast<const T*>(g);
  const auto* ww = static_cast<const T*>(w);
  auto* o = static_cast<T*>(out);
  const int grid = grid_size(static_cast<size_t>(B) * R);
  switch (mode) {
    case kSum: reduce_kernel<T, kSum><<<grid, kThreads, 0, s>>>(v, j, gg, ww, o, B, R, k, G); break;
    case kWSum: reduce_kernel<T, kWSum><<<grid, kThreads, 0, s>>>(v, j, gg, ww, o, B, R, k, G); break;
    case kSq: reduce_kernel<T, kSq><<<grid, kThreads, 0, s>>>(v, j, gg, ww, o, B, R, k, G); break;
    case kMax: reduce_kernel<T, kMax><<<grid, kThreads, 0, s>>>(v, j, gg, ww, o, B, R, k, G); break;
    case kDiag: reduce_kernel<T, kDiag><<<grid, kThreads, 0, s>>>(v, j, gg, ww, o, B, R, k, G); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64; mode: 0 sum, 1 weighted sum, 2 squared sum,
// 3 max, 4 diagonal (see above).  val (B,R,k) and idx (R,k) int32, g (B,G)
// (unused by mode 4), w (B,G) for mode 1 else null, out (B,R).  All
// contiguous; idx in [0, G).  R, k >= 1.
extern "C" int osqp_ell_reduce(int dtype, int mode, const void* val, const void* idx, const void* g, const void* w,
                               void* out, int B, int R, int k, int G, void* stream) {
  if (B == 0 || R == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_reduce<float>(mode, val, idx, g, w, out, B, R, k, G, s)
                    : launch_reduce<double>(mode, val, idx, g, w, out, B, R, k, G, s);
}

// dtype as above.  A's copy val (B,m,ka), idx (m,ka); the transpose's
// t_val (B,n,kt), t_idx (n,kt); row_s (B,m), col_s (B,n), c (B) or null;
// outputs val_out and t_val_out of the inputs' shapes.  All contiguous,
// m, n >= 1.
extern "C" int osqp_ell_scale(int dtype, const void* val, const void* idx, const void* t_val, const void* t_idx,
                              const void* row_s, const void* col_s, const void* c, void* val_out, void* t_val_out,
                              int B, int m, int ka, int n, int kt, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = grid_size(static_cast<size_t>(B) * (static_cast<size_t>(m) * ka + static_cast<size_t>(n) * kt));
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* ti = static_cast<const int32_t*>(t_idx);
  if (dtype == 0) {
    using T = float;
    scale_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(val), i, static_cast<const T*>(t_val), ti, static_cast<const T*>(row_s),
        static_cast<const T*>(col_s), static_cast<const T*>(c), static_cast<T*>(val_out),
        static_cast<T*>(t_val_out), B, m, ka, n, kt);
  } else {
    using T = double;
    scale_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(val), i, static_cast<const T*>(t_val), ti, static_cast<const T*>(row_s),
        static_cast<const T*>(col_s), static_cast<const T*>(c), static_cast<T*>(val_out),
        static_cast<T*>(t_val_out), B, m, ka, n, kt);
  }
  return cudaGetLastError();
}
