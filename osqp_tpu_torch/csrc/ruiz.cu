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
// What bounds it on the H100: device-memory bandwidth, P and A read
// once and their scaled copies written once.  Every product is rounded
// on its own (mul), as PyTorch rounds it, maxima do not depend on their
// order, and the mean is the pairwise sum of
// osqp_tpu_torch.ops.ruiz.tree_sum in the same order: D, E and c equal
// the plain version's bit for bit on either path.
//
// Resident path (ruiz_resident_kernel), where one instance fits a
// thread-block cluster (osqp_tpu_torch.ops.ruiz.cluster_size): the k
// CTAs of a cluster each hold a share of the rows of P and of A in
// shared memory, brought by one bulk copy each on an mbarrier, so each
// value is read from device memory once.  All sweeps then run out of
// shared memory, 16 bytes per load where the rows are aligned.  Row
// maxima and E are local to a CTA's rows; column maxima are taken per
// CTA (shared-memory atomicMax on the bit patterns of non-negative
// values, which order as unsigned integers, NaN above inf) and combined
// after cluster.sync() by reading every CTA's partials through
// distributed shared memory.  Every CTA then holds the same D and c and
// computes them redundantly.  The P pass of one sweep and the A pass of
// the next need the same D and E, so they run together: one cluster
// barrier per sweep takes the place of four launches, with the partials
// double-buffered so that no CTA overwrites a set another may still
// read.  The final pass scales in place and writes with bulk stores.  k
// is the smallest of 1, 2, 4, 8 whose share leaves room for two CTAs per
// SM, so that one cluster's copies overlap another's sweeps.  What bounds
// it then is not the bytes but the sweeps' dependent steps: each waits
// for the whole cluster, and only a few CTAs share an SM to overlap them.
//
// Split path (amax_kernel and the update kernels), for instances that
// fit no cluster, such as CVXQP2_M (n=1000, m=1250): an instance splits
// over blocks (a tile of rows by 256 columns each), partial maxima meet
// through atomicMax in device memory, and each sweep re-reads P and A,
// which at these sizes sit in the 50 MB L2.  Launch sequence per sweep:
// amax over A, update D and E, amax over P, update c.  The scratch
// maxima are zeroed by the kernel that reads them, ready for the next
// sweep.
#include <cooperative_groups.h>
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
// plain version's order; scale may be null (1).  Block (b, y) takes rows
// y, y + gridDim.y, ... of instance b: no division per element, and at
// B=1 a block per row keeps enough loads in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ M, const T* __restrict__ left, const T* __restrict__ right,
             const T* __restrict__ scale, T* __restrict__ out, int R, int C) {
  const size_t b = blockIdx.x;
  const T s = scale ? scale[b] : T(1);
  for (int i = blockIdx.y; i < R; i += gridDim.y) {
    const size_t row = (b * R + i) * static_cast<size_t>(C);
    const T li = left[b * R + i];
    for (int j = threadIdx.y * 32 + threadIdx.x; j < C; j += kThreads) {
      const T v = mul(mul(li, M[row + j]), right[b * C + j]);
      out[row + j] = scale ? mul(s, v) : v;
    }
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

// ---------------------------------------------------------------------------
// Resident path
// ---------------------------------------------------------------------------
namespace cg = cooperative_groups;

constexpr int kLaneCols = 16;  // columns a lane keeps in registers at most: n <= 32 * kLaneCols

// Shared-memory layout of one CTA of the resident path with a cluster of
// k CTAs: a 16-byte mbarrier slot, then regions of values of T, each
// starting 16-byte aligned.  The shares of P and A leave room for the
// aligned window of their bulk copies.  ops/ruiz.py:_resident_bytes
// repeats this sum to choose k.
template <typename T>
struct Resident {
  static constexpr int kPad = 16 / sizeof(T);
  int rows_p, rows_a, width;
  size_t p, a, d, pcol, qa, col_a, col_p, sum, e, rmax, red, total;

  __host__ __device__ static size_t take(size_t& at, size_t count) {
    const size_t o = at;
    at += (count + kPad - 1) / kPad * kPad;
    return o;
  }
  __host__ __device__ Resident(int n, int m, int k) {
    rows_p = (n + k - 1) / k;
    rows_a = (m + k - 1) / k;
    width = 1;
    while (width < n) width *= 2;
    size_t at = 0;
    p = take(at, static_cast<size_t>(rows_p) * n + 2 * kPad);
    a = take(at, static_cast<size_t>(rows_a) * n + 2 * kPad);
    d = take(at, n);
    pcol = take(at, n);
    qa = take(at, n);
    col_a = take(at, 2 * n);  // two sets of partial maxima, used in turn
    col_p = take(at, 2 * n);
    sum = take(at, width);
    e = take(at, rows_a);
    rmax = take(at, rows_a);
    red = take(at, kWarps);
    total = at;
  }
  __host__ __device__ size_t bytes() const { return 16 + sizeof(T) * total; }
};

// The larger of two bit patterns.  Every value a sweep takes a maximum
// of is a product of non-negative factors, so it is +0, positive, +inf
// or a NaN with its sign bit clear (fabs clears it; a product that is
// NaN is the canonical positive NaN): as unsigned integers these order as
// the values do, NaN above inf, and the larger bits are vmax's result.
template <typename U>
__device__ __forceinline__ U umax(U a, U b) {
  return a > b ? a : b;
}

constexpr int kRowsAtOnce = 4;  // rows a warp takes at a time in share_maxima

// kVec values of T that one load brings (16 bytes, or a single value).
template <typename T, int kVec>
struct alignas(kVec * sizeof(T)) Pack {
  T v[kVec];
};

// Column maxima of the rows [0, rows) of a share M (rows x n, shared
// memory): col_j = max_i rs_i |M_ij|, added by atomicMax on bits into
// this CTA's col.  With kRows, also each row's maximum max_j |M_ij| cs_j,
// as bits into rowmax[i].  A warp takes kRowsAtOnce rows at a time, so that
// their chains of maxima and shuffles overlap, and each lane the groups
// of kVec columns starting at kVec (lane + 32 t): with kVec > 1 (16-byte
// aligned rows, n a multiple of kVec) one load brings a group.
template <bool kRows, int kCols, int kVec, typename T, typename U>
__device__ void share_maxima(const T* M, int rows, int n, const T* rs, const T* cs, U* col, U* rowmax) {
  using V = Pack<T, kVec>;
  constexpr int kGroups = kCols / kVec;
  const int lane = threadIdx.x;
  U acc[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) acc[t] = 0;
  for (int i0 = threadIdx.y; i0 < rows; i0 += kRowsAtOnce * kWarps) {
    const V* row[kRowsAtOnce];
    T r[kRowsAtOnce];
    U racc[kRowsAtOnce];
#pragma unroll
    for (int h = 0; h < kRowsAtOnce; ++h) {
      const int i = i0 + h * kWarps;
      row[h] = reinterpret_cast<const V*>(M + static_cast<size_t>(i < rows ? i : i0) * n) + lane;
      r[h] = i < rows ? rs[i] : T(0);
      racc[h] = 0;
    }
#pragma unroll
    for (int t = 0; t < kGroups; ++t) {
      if (32 * kVec * t >= n) break;
      if (kVec * (lane + 32 * t) < n) {
        V csj = {};
        if (kRows) csj = reinterpret_cast<const V*>(cs)[lane + 32 * t];
#pragma unroll
        for (int h = 0; h < kRowsAtOnce; ++h) {
          if (i0 + h * kWarps < rows) {
            const V a = row[h][32 * t];
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              const T x = fabs(a.v[e]);
              acc[kVec * t + e] = umax(acc[kVec * t + e], to_bits(mul(x, r[h])));
              if (kRows) racc[h] = umax(racc[h], to_bits(mul(x, csj.v[e])));
            }
          }
        }
      }
    }
    if (kRows) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int h = 0; h < kRowsAtOnce; ++h) racc[h] = umax(racc[h], __shfl_xor_sync(0xffffffffu, racc[h], off));
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < kRowsAtOnce; ++h)
          if (i0 + h * kWarps < rows) rowmax[i0 + h * kWarps] = racc[h];
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kGroups; ++t) {
    if (32 * kVec * t >= n) break;
    const int j = kVec * (lane + 32 * t);
    if (j < n) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) atomicMax(col + j + e, acc[kVec * t + e]);
    }
  }
}

// The maximum over the cluster's k CTAs of their partial maxima at j,
// read through distributed shared memory, all loads in flight at once.
template <typename U>
__device__ __forceinline__ U cluster_max(cg::cluster_group& cluster, int k, U* part, int j) {
  U x[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] = r < k ? cluster.map_shared_rank(part, r)[j] : U(0);
  U v = x[0];
#pragma unroll
  for (int r = 1; r < 8; ++r) v = umax(v, x[r]);
  return v;
}

// c / limit(max(mean, limit(qmax c))), with mean the pairwise sum of
// sum[0, width) over n in tree_sum's order (zero-padded to a power of
// two, the upper half added onto the lower half) and qmax the block's
// maximum of the threads' qm.  After one barrier every warp computes it
// on its own, the same bits in each: lane l holds sum[l + 32 q], the
// levels down to 32 add registers, the last five are shuffles.  red
// holds a value per warp; the caller synchronises the block before red
// or sum is written again.
template <int kCols, typename T>
__device__ T cost_scale(T c, const T* sum, int width, int n, T qm, T* red) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qm = vmax(qm, __shfl_xor_sync(0xffffffffu, qm, off));
  if (lane == 0) red[threadIdx.y] = qm;
  __syncthreads();
  T v[kCols];  // width <= 32 * kCols
#pragma unroll
  for (int q = 0; q < kCols; ++q) v[q] = lane + 32 * q < width ? sum[lane + 32 * q] : T(0);
#pragma unroll
  for (int hq = kCols / 2; hq >= 1; hq /= 2) {
    if (64 * hq <= width) {  // the level that adds element e + 32 hq onto e
#pragma unroll
      for (int q = 0; q < hq; ++q) v[q] = add(v[q], v[q + hq]);
    }
  }
  for (int h = (width < 32 ? width : 32) / 2; h >= 1; h /= 2) {
    const T o = __shfl_down_sync(0xffffffffu, v[0], h);
    if (lane < h) v[0] = add(v[0], o);
  }
  T qmax = red[0];
  for (int w = 1; w < kWarps; ++w) qmax = vmax(qmax, red[w]);
  const T mean = __shfl_sync(0xffffffffu, v[0], 0) / T(n);
  return c / limit_scaling(vmax(mean, limit_scaling(mul(qmax, c))));
}

// M_ij <- scale ((left_i M_ij) right_j) over a rows x n share in shared
// memory, in place, kVec values at a time (a row holds whole groups when
// kVec > 1); the row and column of each group follow from the previous
// ones without a division.
template <int kVec, typename T>
__device__ void scale_share(T* M, int rows, int n, const T* left, const T* right, T scale, bool with_scale) {
  using V = Pack<T, kVec>;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const size_t count = static_cast<size_t>(rows) * n / kVec;
  const int step = kThreads * kVec;
  const int di = step / n, dj = step % n;
  int i = tid * kVec / n, j = tid * kVec % n;
  for (size_t e = tid; e < count; e += kThreads) {
    V x = reinterpret_cast<V*>(M)[e];
    const V r = *reinterpret_cast<const V*>(right + j);
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const T v = mul(mul(left[i], x.v[q]), r.v[q]);
      x.v[q] = with_scale ? mul(scale, v) : v;
    }
    reinterpret_cast<V*>(M)[e] = x;
    i += di;
    j += dj;
    if (j >= n) {
      j -= n;
      ++i;
    }
  }
}

// Write `count` values from shared memory to dst: where both sides sit
// alike against 16 bytes (always, for the contiguous tensors the wrapper
// passes, unless an input is a view at an odd offset), the aligned middle
// as one bulk store issued by thread 0 and the ragged ends by the
// threads; otherwise every value by the threads.  The caller fences and
// synchronises the block first.
template <typename T>
__device__ void store_share(T* dst, const T* src, size_t count) {
  constexpr size_t kV = 16 / sizeof(T);
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  size_t head = count, body = 0;
  if (((d ^ smem_addr(src)) & 15) == 0) {
    head = ((16 - (d & 15)) & 15) / sizeof(T);
    head = head < count ? head : count;
    body = (count - head) / kV * kV;
  }
  if (tid == 0 && body > 0) bulk_store(dst + head, src + head, static_cast<uint32_t>(body * sizeof(T)));
  for (size_t e = tid; e < count; e += kThreads)
    if (e < head || e >= head + body) dst[e] = src[e];
}

// All sweeps and the final scaling of one instance in one cluster of k
// CTAs (grid B * k); CTA `rank` holds rows [rank * rows_p, ...) of P and
// [rank * rows_a, ...) of A.  Output as the split path's.
// Registers capped so that three CTAs share an SM, as the shares of the
// headline's clusters of two allow.  A lane keeps kCols columns: n <= 32
// kCols; kVec > 1 where P's and A's rows are 16-byte aligned.
template <typename T, int kCols, int kVec>
__global__ void __launch_bounds__(kThreads, 3)
ruiz_resident_kernel(const T* __restrict__ P, const T* __restrict__ q, const T* __restrict__ A,
                     const T* __restrict__ l, const T* __restrict__ u, T* __restrict__ c_out, T* __restrict__ D_out,
                     T* __restrict__ E_out, T* __restrict__ Ps, T* __restrict__ qs, T* __restrict__ As,
                     T* __restrict__ ls, T* __restrict__ us, int n_iters, int n, int m) {
  using U = typename Bits<T>::U;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / k;
  const Resident<T> lay(n, m, k);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  T* vals = reinterpret_cast<T*>(smem_raw + 16);
  T* D = vals + lay.d;
  T* pcol = vals + lay.pcol;
  T* qa = vals + lay.qa;
  U* col_a = reinterpret_cast<U*>(vals + lay.col_a);
  U* col_p = reinterpret_cast<U*>(vals + lay.col_p);
  T* sum = vals + lay.sum;
  T* E = vals + lay.e;
  U* rmax = reinterpret_cast<U*>(vals + lay.rmax);
  T* red = vals + lay.red;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int p0 = min(n, rank * lay.rows_p), np = min(n, p0 + lay.rows_p) - p0;
  const int a0 = min(m, rank * lay.rows_a), na = min(m, a0 + lay.rows_a) - a0;
  const T* gP = P + (b * n + p0) * n;
  const T* gA = A + (b * m + a0) * n;
  // each share lands at its window's start; its first value sits past the slack
  T* sP = vals + lay.p + misalign(gP);
  T* sA = vals + lay.a + misalign(gA);

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    uintptr_t lo_p = 0, lo_a = 0;
    uint32_t size_p = 0, size_a = 0;
    if (np > 0) window(gP, sizeof(T) * static_cast<size_t>(np) * n, lo_p, size_p);
    if (na > 0) window(gA, sizeof(T) * static_cast<size_t>(na) * n, lo_a, size_a);
    mbar_expect_tx(bar, size_p + size_a);
    if (size_p) bulk_load(vals + lay.p, reinterpret_cast<const void*>(lo_p), size_p, bar);
    if (size_a) bulk_load(vals + lay.a, reinterpret_cast<const void*>(lo_a), size_a, bar);
  }
  for (int j = tid; j < n; j += kThreads) {
    D[j] = T(1);
    qa[j] = fabs(q[b * n + j]);
    col_a[j] = col_a[n + j] = 0;
    col_p[j] = col_p[n + j] = 0;
  }
  for (int i = tid; i < na; i += kThreads) E[i] = T(1);
  T c = T(1);
  __syncthreads();
  mbar_wait(bar, 0);

  // Stage s: one pass over P (its column maxima with D_s) and over A (its
  // column and row maxima with D_s, E_s), into partial set s % 2; a
  // cluster barrier; then Pcol_s, c_s (from stage 1 on) and D_{s+1},
  // E_{s+1}.  The P pass of a sweep and the A pass of the next need the
  // same D and E, so one cluster barrier per sweep serves both.  The last
  // stage takes only P, for the final c.  The first cluster barrier also
  // ensures that every CTA of the cluster runs before its memory is read;
  // a CTA zeroes a set of partials one stage after it was read, when every
  // CTA has passed the barrier that follows the read.
  for (int st = 0;; ++st) {
    const bool last = st == n_iters;
    U* cp = col_p + (st & 1) * n;
    U* ca = col_a + (st & 1) * n;
    share_maxima<false, kCols, kVec>(sP, np, n, D + p0, static_cast<const T*>(nullptr), cp, static_cast<U*>(nullptr));
    if (!last && m > 0) share_maxima<true, kCols, kVec>(sA, na, n, E, D, ca, rmax);
    cluster.sync();
    T qm = T(0);
    for (int j = tid; j < lay.width; j += kThreads) {
      T s = T(0);
      if (j < n) {
        col_p[((st + 1) & 1) * n + j] = 0;
        col_a[((st + 1) & 1) * n + j] = 0;
        const T pc = mul(from_bits(cluster_max(cluster, k, cp, j)), D[j]);
        pcol[j] = pc;
        s = mul(pc, c);
        qm = vmax(qm, mul(qa[j], D[j]));
      }
      sum[j] = s;
    }
    if (st > 0) c = cost_scale<kCols>(c, sum, lay.width, n, qm, red);
    if (last) break;
    for (int i = tid; i < na; i += kThreads) E[i] = mul(E[i], inv_sqrt_limited(mul(from_bits(rmax[i]), E[i])));
    for (int j = tid; j < n; j += kThreads) {
      const T pn = mul(pcol[j], c);
      const T dn = m > 0 ? vmax(pn, mul(from_bits(cluster_max(cluster, k, ca, j)), D[j])) : pn;
      D[j] = mul(D[j], inv_sqrt_limited(dn));
    }
    __syncthreads();
  }
  cluster.sync();  // no CTA reads another's shared memory after this

  scale_share<kVec>(sP, np, n, D + p0, D, c, true);
  scale_share<kVec>(sA, na, n, E, D, T(1), false);
  fence_async_shared();
  __syncthreads();
  store_share(Ps + (b * n + p0) * n, sP, static_cast<size_t>(np) * n);
  store_share(As + (b * m + a0) * n, sA, static_cast<size_t>(na) * n);
  if (rank == 0) {
    if (tid == 0) c_out[b] = c;
    for (int j = tid; j < n; j += kThreads) {
      D_out[b * n + j] = D[j];
      qs[b * n + j] = mul(c, mul(D[j], q[b * n + j]));
    }
  }
  for (int i = tid; i < na; i += kThreads) {
    const size_t g = b * m + a0 + i;
    E_out[g] = E[i];
    ls[g] = mul(E[i], l[g]);
    us[g] = mul(E[i], u[g]);
  }
  if (tid == 0) bulk_store_wait_read();
}

// The launch of the resident kernel for B instances: clusters of k CTAs,
// lanes holding as few columns as n allows.
template <typename T>
struct ResidentLaunch {
  using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, T*, T*, T*, T*, T*, T*, T*, int,
                          int, int);
  Kernel kernel;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;

  ResidentLaunch(int B, int n, int m, int k, bool aligned, cudaStream_t s) {
    constexpr int kVec = 16 / sizeof(T);
    if (aligned && n % kVec == 0)
      kernel = n <= 128   ? ruiz_resident_kernel<T, 4, kVec>
               : n <= 256 ? ruiz_resident_kernel<T, 8, kVec>
                          : ruiz_resident_kernel<T, 16, kVec>;
    else
      kernel = n <= 128   ? ruiz_resident_kernel<T, 4, 1>
               : n <= 256 ? ruiz_resident_kernel<T, 8, 1>
                          : ruiz_resident_kernel<T, 16, 1>;
    const size_t smem = Resident<T>(n, m, k).bytes();
    if (n > 32 * kLaneCols || !(k == 1 || k == 2 || k == 4 || k == 8)) err = cudaErrorInvalidValue;
    if (err == cudaSuccess) err = allow_smem(kernel, smem);
    if (err == cudaSuccess) err = prefer_shared(kernel);
    cfg.gridDim = dim3(static_cast<unsigned>(B) * k);
    cfg.blockDim = dim3(32, kWarps);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T>
int launch_resident(void* const* p, int n_iters, int B, int n, int m, int k, cudaStream_t s) {
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  // 16-byte aligned rows: every instance's and share's offset is a
  // multiple of n values, so the base addresses decide.
  const bool aligned = reinterpret_cast<uintptr_t>(p[0]) % 16 == 0 && reinterpret_cast<uintptr_t>(p[2]) % 16 == 0;
  ResidentLaunch<T> l(B, n, m, k, aligned, s);
  if (l.err != cudaSuccess) return l.err;
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, l.kernel, in(0), in(1), in(2), in(3), in(4),
                                             out(5), out(6), out(7), out(8), out(9), out(10), out(11), out(12),
                                             n_iters, n, m);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of k CTAs of the resident kernel the card holds at
// once; negative on a CUDA error.
template <typename T>
int resident_clusters(int n, int m, int k) {
  ResidentLaunch<T> l(1024, n, m, k, true, nullptr);
  int clusters = 0;
  if (l.err != cudaSuccess || cudaOccupancyMaxActiveClusters(&clusters, l.kernel, &l.cfg) != cudaSuccess)
    return -1;
  return clusters;
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
  apply_kernel<T><<<dim3(B, n < 65535 ? n : 65535), block, 0, s>>>(P, D, D, c, Ps, n, n);
  if (m > 0) apply_kernel<T><<<dim3(B, m < 65535 ? m : 65535), block, 0, s>>>(A, E, D, nullptr, As, m, n);
  apply_vectors_kernel<T><<<B, block, 0, s>>>(q, l, u, c, D, E, qs, ls, us, n, m);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  Inputs P (B,n,n), q (B,n), A (B,m,n),
// l, u (B,m); c (B,), D (B,n), E (B,m) come in as ones and leave as the
// scaling; outputs have the inputs' shapes.  All contiguous, n >= 1.
// cluster > 0 takes the resident path with clusters of that many CTAs
// (1, 2, 4 or 8; n <= 512), which uses no scratch.  cluster = 0 takes the
// split path, with scratch col_a, col_p, p_col (B,n) and row_a (B,m),
// zeroed; rows_a and rows_p are the rows of A and P that one block takes.
extern "C" int osqp_ruiz(int dtype, const void* P, const void* q, const void* A, const void* l,
                         const void* u, void* c, void* D, void* E, void* Ps, void* qs, void* As,
                         void* ls, void* us, void* col_a, void* row_a, void* col_p, void* p_col,
                         int n_iters, int B, int n, int m, int rows_a, int rows_p, int cluster, void* stream) {
  if (B == 0) return cudaSuccess;
  void* const p[17] = {const_cast<void*>(P), const_cast<void*>(q), const_cast<void*>(A),
                       const_cast<void*>(l), const_cast<void*>(u), c, D, E, Ps, qs, As, ls, us,
                       col_a, row_a, col_p, p_col};
  auto s = static_cast<cudaStream_t>(stream);
  if (cluster > 0)
    return dtype == 0 ? launch_resident<float>(p, n_iters, B, n, m, cluster, s)
                      : launch_resident<double>(p, n_iters, B, n, m, cluster, s);
  return dtype == 0 ? launch<float>(p, n_iters, B, n, m, rows_a, rows_p, s)
                    : launch<double>(p, n_iters, B, n, m, rows_a, rows_p, s);
}

// Clusters of k CTAs of the resident path that the card holds at once,
// at n variables and m constraints (dtype as above); negative on error.
extern "C" int osqp_ruiz_resident_clusters(int dtype, int n, int m, int k) {
  return dtype == 0 ? resident_clusters<float>(n, m, k) : resident_clusters<double>(n, m, k);
}

// ---------------------------------------------------------------------------
// The split path one step at a time
// ---------------------------------------------------------------------------
// The kernels of the split path behind entries of their own, for a caller
// that runs the sweeps from the host and combines the maxima of row
// blocks between the steps (osqp_tpu_torch.parallel: A's rows spread over
// processes, the column maxima merged by an all-reduce of their bits and
// the row maxima gathered).  The sequence per sweep is the split path's:
// osqp_ruiz_sweep_a on each row block, osqp_ruiz_update, osqp_ruiz_sweep_p;
// osqp_ruiz_sweep_p with update_cost = 0 first (P's column norm at D = 1),
// and osqp_ruiz_apply / osqp_ruiz_apply_vectors at the end.  The maxima do
// not depend on how the rows are cut, so c, D and E are the split path's
// bit for bit.  Maxima buffers hold bit patterns (zero = +0.0) and come in
// zeroed; osqp_ruiz_update and osqp_ruiz_sweep_p zero what they read.
namespace {

template <typename T>
int sweep_a(const void* A, const void* E, const void* D, void* col_a, void* row_a, int B, int R, int n, int rows,
            cudaStream_t s) {
  using U = typename Bits<T>::U;
  if (R == 0) return cudaSuccess;
  const dim3 grid(B, (R + rows - 1) / rows, chunks_of(n));
  amax_kernel<T><<<grid, dim3(32, kWarps), 0, s>>>(static_cast<const T*>(A), R, n, rows, static_cast<const T*>(E),
                                                    static_cast<const T*>(D), static_cast<U*>(col_a),
                                                    static_cast<U*>(row_a));
  return cudaGetLastError();
}

template <typename T>
int update(const void* c, const void* p_col, void* col_a, void* row_a, void* D, void* E, int B, int n, int m,
           cudaStream_t s) {
  using U = typename Bits<T>::U;
  const int nm = n > m ? n : m;
  update_de_kernel<T><<<dim3(B, (nm + kThreads - 1) / kThreads), dim3(32, kWarps), 0, s>>>(
      static_cast<const T*>(c), static_cast<const T*>(p_col), static_cast<U*>(col_a), static_cast<U*>(row_a),
      static_cast<T*>(D), static_cast<T*>(E), n, m);
  return cudaGetLastError();
}

template <typename T>
int sweep_p(const void* P, const void* q, const void* D, void* col_p, void* p_col, void* c, int B, int n,
            int rows_p, bool update_cost, cudaStream_t s) {
  using U = typename Bits<T>::U;
  int width = 1;
  while (width < n) width *= 2;
  const size_t smem_c = static_cast<size_t>(width) * sizeof(T);
  const cudaError_t err = allow_smem(update_c_kernel<T>, smem_c);
  if (err != cudaSuccess) return err;
  const dim3 block(32, kWarps);
  amax_kernel<T><<<dim3(B, (n + rows_p - 1) / rows_p, chunks_of(n)), block, 0, s>>>(
      static_cast<const T*>(P), n, n, rows_p, static_cast<const T*>(D), nullptr, static_cast<U*>(col_p), nullptr);
  update_c_kernel<T><<<B, block, smem_c, s>>>(static_cast<const T*>(q), static_cast<const T*>(D),
                                              static_cast<U*>(col_p), static_cast<T*>(p_col), static_cast<T*>(c), n,
                                              width, update_cost);
  return cudaGetLastError();
}

template <typename T>
int apply(const void* M, const void* left, const void* right, const void* scale, void* out, int B, int R, int C,
          cudaStream_t s) {
  if (R == 0) return cudaSuccess;
  apply_kernel<T><<<dim3(B, R < 65535 ? R : 65535), dim3(32, kWarps), 0, s>>>(
      static_cast<const T*>(M), static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const T*>(scale), static_cast<T*>(out), R, C);
  return cudaGetLastError();
}

template <typename T>
int apply_vectors(const void* q, const void* l, const void* u, const void* c, const void* D, const void* E, void* qs,
                  void* ls, void* us, int B, int n, int m, cudaStream_t s) {
  apply_vectors_kernel<T><<<B, dim3(32, kWarps), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(l), static_cast<const T*>(u), static_cast<const T*>(c),
      static_cast<const T*>(D), static_cast<const T*>(E), static_cast<T*>(qs), static_cast<T*>(ls),
      static_cast<T*>(us), n, m);
  return cudaGetLastError();
}

}  // namespace

// dtype as for osqp_ruiz.  The maxima over a block of R rows of A (B,R,n)
// with E's rows of the block (B,R) and D (B,n): col_a (B,n) takes
// max_i E_i |A_ij| over the block's rows (atomicMax, so blocks may share
// one buffer), row_a (B,R) max_j |A_ij| D_j.  rows: A's rows a CTA takes
// (osqp_split_geometry for B, n, R).
extern "C" int osqp_ruiz_sweep_a(int dtype, const void* A, const void* E, const void* D, void* col_a, void* row_a,
                                 int B, int R, int n, int rows, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? sweep_a<float>(A, E, D, col_a, row_a, B, R, n, rows, s)
                    : sweep_a<double>(A, E, D, col_a, row_a, B, R, n, rows, s);
}

// One sweep's D (B,n) and E (B,m), in place, from c (B,), P's column norm
// p_col (B,n) and the maxima over all of A's rows, col_a (B,n) and row_a
// (B,m), which it zeroes.
extern "C" int osqp_ruiz_update(int dtype, const void* c, const void* p_col, void* col_a, void* row_a, void* D,
                                void* E, int B, int n, int m, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? update<float>(c, p_col, col_a, row_a, D, E, B, n, m, s)
                    : update<double>(c, p_col, col_a, row_a, D, E, B, n, m, s);
}

// P's column norm p_col (B,n) under D from P (B,n,n) and, with
// update_cost, the cost normalisation of c (B,) in place; col_p (B,n) is
// the zeroed scratch of the maxima.  rows_p as osqp_split_geometry gives.
extern "C" int osqp_ruiz_sweep_p(int dtype, const void* P, const void* q, const void* D, void* col_p, void* p_col,
                                 void* c, int B, int n, int rows_p, int update_cost, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? sweep_p<float>(P, q, D, col_p, p_col, c, B, n, rows_p, update_cost != 0, s)
                    : sweep_p<double>(P, q, D, col_p, p_col, c, B, n, rows_p, update_cost != 0, s);
}

// out (B,R,C) = scale_b ((left_i M_ij) right_j); scale may be null.
extern "C" int osqp_ruiz_apply(int dtype, const void* M, const void* left, const void* right, const void* scale,
                               void* out, int B, int R, int C, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? apply<float>(M, left, right, scale, out, B, R, C, s)
                    : apply<double>(M, left, right, scale, out, B, R, C, s);
}

// qs = c (D q), ls = E l, us = E u.
extern "C" int osqp_ruiz_apply_vectors(int dtype, const void* q, const void* l, const void* u, const void* c,
                                       const void* D, const void* E, void* qs, void* ls, void* us, int B, int n,
                                       int m, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? apply_vectors<float>(q, l, u, c, D, E, qs, ls, us, B, n, m, s)
                    : apply_vectors<double>(q, l, u, c, D, E, qs, ls, us, B, n, m, s);
}
