// K5: the row-gather products of ELL operands, for a batch of sparse QPs
// that share one sparsity pattern.
//
// Replaces osqp_tpu/sparse_ops.py:120-177 (ell_matvec, ell_tmatvec,
// ell_diagonal, ell_sq_colsums, ell_row_norms, ell_col_norms, ell_scale),
// which XLA lowers to a gather and a reduction over the slot axis, and
// the start of the cg backend's CG (osqp_tpu/linsys/cg.py:129-137: the
// right-hand side, r = b - M x0 and z = dinv r).  Three kernels:
//
// group_kernel: up to kMaxJobs independent reductions in one launch.  A
// job is an operand (values val (B, R, k), pattern idx (R, k) shared by
// the batch), a mode, a gathered vector g (B, G), a weight w (B, G) and
// an output (B, R); row r of instance b reduces over its k slots:
//
//   kSum   out[b][r] = sum_s val * g[idx]            A x, and A'y on the transpose
//   kWSum  out[b][r] = sum_s val * (w[idx] * g[idx]) A'(rho * y), rho gathered per slot
//   kSq    out[b][r] = sum_s (val * val) * g[idx]    sum_i w_i A_ij^2 on the transpose
//   kMax   out[b][r] = max_s |val| * g[idx]          row / column inf-norms under a weight
//   kDiag  out[b][r] = sum_s val where idx == r      diag(P)
//
// The wrapper's plan (ops/ell.py:plan) deals the CTAs to the jobs by row
// tiles of `rows` rows (32 to 256) and runs of `run` instances, `ipar` of
// them side by side, so that a launch has a CTA per SM wherever its rows
// allow.  Each thread loads its row's pattern once into registers and
// keeps it for every instance of its CTA's run.  A CTA of one group of
// ipar instances loads its values with the pattern, straight from device
// memory, so that one load latency precedes the gathers; a CTA of several
// groups (large batches) brings each group's values (each instance's tile
// contiguous: val[b, r0:r1, :]) by 1-D bulk copies (cp.async.bulk on an
// mbarrier) into a two-stage ring, so that the next group's values land
// while this one's gathers run.  k is a template parameter from 1 to kMaxK
// (the Maros-Meszaros operands of the sparse path have k from 1 to 9): a
// row's loop unrolls, and all its gathers issue before the first add.
// Above kMaxK a run-time loop over the slots, in the same order, reads
// values and pattern from device memory.  The pattern, the values and the
// gathered vectors come through the read-only path.
//
// cg_start_kernel: the CG's start from x0 on the cg backend's operator
// M = P + sigma I + A' diag(w) A, one thread per column j of the
// transpose, given P x0 and A x0 (a group_kernel launch before it):
//
//   t_j  = sum_s At_val * (rho * rhs_z)[idx]     b_j = rhs_x_j + t_j
//   v_j  = sum_s At_val * (w * A x0)[idx]        Mx_j = (P x0_j + sigma x0_j) + v_j
//   r_j  = b_j - Mx_j                            z_j = dinv_j r_j
//
// (without rhs_z, b is rhs_x as given).  scale_kernel is the final
// scaling written elementwise: val * r[row] * s[idx] (* c) on A's copy
// and on the transpose's, in one launch.
//
// Padded slots hold val = 0, idx = 0, so they add 0 to each sum and to
// each non-negative maximum, as the JAX reductions have them: nothing
// masks by count.  Sums run in slot order from 0, each product and sum
// rounded on its own (no fused multiply-add), as the plain versions in
// ops/ell.py sum them, so kernel and plain version agree bit for bit.
// The run-time reduction over one row lives in ell_gather.cuh, which
// K6's device loop shares.
//
// What bounds it on the H100: launches and latency.  One product at B=1,
// n=1e4 moves about 0.6 MB, 0.2 us at the HBM rate, against some 2 us of
// launch and a chain of two dependent loads (values and pattern, then the
// gather).  So the path's independent products share one launch, and the
// CG's start runs in one kernel after one grouped launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "ell_gather.cuh"

namespace {

using namespace osqp_cuda;

constexpr int kMaxJobs = 8;
constexpr int kMaxK = 16;            // slots of the unrolled rows
constexpr int kJobWords = 11;        // int64 words of one job from the host
constexpr size_t kBarBytes = 128;    // the ring's two mbarriers, ahead of its stages

template <typename T>
struct Job {
  const T* val;
  const int32_t* idx;
  const T* g;
  const T* w;
  T* out;
  int R, k, G, mode, tiles, cta0;  // cta0: the job's first CTA
};

template <typename T>
struct Jobs {
  Job<T> job[kMaxJobs];
  int n, B, rows, ipar, run;  // ipar instances side by side, rows x ipar threads
};

__host__ __device__ constexpr size_t round_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

// Bytes of one instance's slot in the ring: its tile of values and the
// 16-byte aligned window's slack on each side.
template <typename T>
__host__ __device__ constexpr size_t slot_bytes(int rows, int k) {
  return round_up(sizeof(T) * rows * k, 16) + 32;
}

// Dynamic shared memory of a CTA that streams tiles of k slots a row
// through the ring: the mbarriers and two stages of ipar instances.
template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int rows, int ipar, int k) {
  return kBarBytes + 2 * ipar * slot_bytes<T>(rows, k);
}

template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  return __ldg(p);
}

// The reduction of one row with K slots: a the row's values and j its
// pattern (registers), g and w the instance's vectors.
template <typename T, int M, int K>
__device__ __forceinline__ T row_fixed(const T (&a)[K], const int32_t (&j)[K], const T* __restrict__ g,
                                       const T* __restrict__ w, int r) {
  T c[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (M != kDiag) c[s] = ldg(g + j[s]);
    if (M == kWSum) c[s] = mul(ldg(w + j[s]), c[s]);
  }
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (M == kSum || M == kWSum) {
      acc = add(acc, mul(a[s], c[s]));
    } else if (M == kSq) {
      acc = add(acc, mul(mul(a[s], a[s]), c[s]));
    } else if (M == kMax) {
      const T m = mul(abs_of(a[s]), c[s]);
      acc = s == 0 || m > acc ? m : acc;
    } else {
      if (j[s] == r) acc = add(acc, a[s]);
    }
  }
  return acc;
}

// One CTA's tile, rows [r0, r1) x instances [b0, b1), K slots a row, ipar
// instances side by side.  Each thread loads its row's pattern once into
// registers and keeps it for every instance of the run.  A CTA of one
// group of instances loads its values with the pattern, straight from
// device memory (one load latency before the gathers); a CTA of several
// streams each group's values through the ring of bulk copies, the next
// group's landing while this one's gathers run.
template <typename T, int M, int K>
__device__ void tile_fixed(const Job<T>& job, int rows, int ipar, int r0, int r1, int b0, int b1,
                           unsigned char* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  const size_t pitch = slot_bytes<T>(rows, K);
  const int tid = threadIdx.x, nr = r1 - r0;
  const int groups = (b1 - b0 + ipar - 1) / ipar;
  const size_t tile = sizeof(T) * nr * K;
  auto issue = [&](int gi) {  // one thread: the copies of group gi into stage gi & 1
    const int s = gi & 1, bb = b0 + gi * ipar, be = min(bb + ipar, b1);
    uintptr_t lo;
    uint32_t size, total = 0;
    for (int b = bb; b < be; ++b) {
      window(job.val + (static_cast<size_t>(b) * job.R + r0) * K, tile, lo, size);
      total += size;
    }
    mbar_expect_tx(bars + s, total);
    for (int b = bb; b < be; ++b) {
      window(job.val + (static_cast<size_t>(b) * job.R + r0) * K, tile, lo, size);
      bulk_load(ring + (s * ipar + (b - bb)) * pitch, reinterpret_cast<const void*>(lo), size, bars + s);
    }
  };
  if (tid == 0 && groups > 1) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue(0);
    issue(1);
  }
  const int slot = tid / rows, rr = tid - slot * rows, r = r0 + rr;
  const bool live = rr < nr;
  int32_t j[K];
  const int32_t* jr = job.idx + static_cast<size_t>(live ? r : r0) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) j[s] = ldg(jr + s);
  auto reduce = [&](int b, const T (&a)[K]) {
    const size_t base = static_cast<size_t>(b) * job.R;
    const T* g = M == kDiag ? nullptr : job.g + static_cast<size_t>(b) * job.G;
    const T* w = M == kWSum ? job.w + static_cast<size_t>(b) * job.G : nullptr;
    job.out[base + r] = row_fixed<T, M, K>(a, j, g, w, r);
  };
  T a[K];
  if (groups == 1) {
    const int b = b0 + slot;
    if (!live || b >= b1) return;
    const T* v = job.val + (static_cast<size_t>(b) * job.R + r) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) a[s] = ldg(v + s);
    reduce(b, a);
    return;
  }
  __syncthreads();  // the barriers are initialised
  for (int gi = 0; gi < groups; ++gi) {
    const int s = gi & 1;
    mbar_wait(bars + s, (gi >> 1) & 1);
    const int b = b0 + gi * ipar + slot;
    if (live && b < b1) {
      const T* v = reinterpret_cast<const T*>(ring + (s * ipar + slot) * pitch) +
                   misalign(job.val + (static_cast<size_t>(b) * job.R + r0) * K) + rr * K;
#pragma unroll
      for (int q = 0; q < K; ++q) a[q] = v[q];
      reduce(b, a);
    }
    __syncthreads();  // stage s is read; the copies may refill it
    if (tid == 0 && gi + 2 < groups) {
      fence_async_shared();
      issue(gi + 2);
    }
  }
}

// A tile whose rows have more than kMaxK slots: each thread a (row,
// instance) pair, the run-time loop of ell_gather.cuh over device memory.
template <typename T, int M>
__device__ void tile_loose(const Job<T>& job, int r0, int r1, int b0, int b1) {
  const int nr = r1 - r0;
  for (int e = threadIdx.x; e < nr * (b1 - b0); e += blockDim.x) {
    const int bo = e / nr, r = r0 + (e - bo * nr);
    const size_t b = b0 + bo, o = b * job.R + r;
    job.out[o] = ell_row<T, M>(job.val + o * job.k, job.idx + static_cast<size_t>(r) * job.k,
                               M == kDiag ? nullptr : job.g + b * job.G, M == kWSum ? job.w + b * job.G : nullptr,
                               job.k, r);
  }
}

template <typename T, int M, int K = 1>
__device__ void tile_by_k(const Job<T>& job, int rows, int ipar, int r0, int r1, int b0, int b1,
                          unsigned char* smem) {
  if constexpr (K > kMaxK) {
    tile_loose<T, M>(job, r0, r1, b0, b1);
  } else {
    if (job.k == K) {
      tile_fixed<T, M, K>(job, rows, ipar, r0, r1, b0, b1, smem);
    } else {
      tile_by_k<T, M, K + 1>(job, rows, ipar, r0, r1, b0, b1, smem);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) group_kernel(const __grid_constant__ Jobs<T> jobs) {
  extern __shared__ __align__(128) unsigned char smem[];
  // this CTA's job: the last whose first CTA is at or below blockIdx.x,
  // read where it lies in parameter space (__grid_constant__), not copied
  // into each thread's local memory (tools/probe_k5.py: 0.0029 against
  // 0.0037 ms for A x at B = 64)
  int sel = 0;
#pragma unroll
  for (int i = 1; i < kMaxJobs; ++i) {
    if (i < jobs.n && static_cast<int>(blockIdx.x) >= jobs.job[i].cta0) sel = i;
  }
  const Job<T>& job = jobs.job[sel];
  const int local = blockIdx.x - job.cta0;
  const int run = local / job.tiles, tile = local - run * job.tiles;
  const int r0 = tile * jobs.rows, r1 = min(r0 + jobs.rows, job.R);
  const int b0 = run * jobs.run, b1 = min(b0 + jobs.run, jobs.B);
  switch (job.mode) {
    case kSum: tile_by_k<T, kSum>(job, jobs.rows, jobs.ipar, r0, r1, b0, b1, smem); break;
    case kWSum: tile_by_k<T, kWSum>(job, jobs.rows, jobs.ipar, r0, r1, b0, b1, smem); break;
    case kSq: tile_by_k<T, kSq>(job, jobs.rows, jobs.ipar, r0, r1, b0, b1, smem); break;
    case kMax: tile_by_k<T, kMax>(job, jobs.rows, jobs.ipar, r0, r1, b0, b1, smem); break;
    default: tile_by_k<T, kDiag>(job, jobs.rows, jobs.ipar, r0, r1, b0, b1, smem); break;
  }
}

template <typename T>
int launch_group(const long long* words, int njobs, int B, int rows, int ipar, int run, int ctas, cudaStream_t s) {
  Jobs<T> jobs{};
  jobs.n = njobs;
  jobs.B = B;
  jobs.rows = rows;
  jobs.ipar = ipar;
  jobs.run = run;
  size_t smem = 0;
  for (int i = 0; i < njobs; ++i) {
    const long long* w = words + static_cast<size_t>(i) * kJobWords;
    Job<T>& j = jobs.job[i];
    j.val = reinterpret_cast<const T*>(w[0]);
    j.idx = reinterpret_cast<const int32_t*>(w[1]);
    j.g = reinterpret_cast<const T*>(w[2]);
    j.w = reinterpret_cast<const T*>(w[3]);
    j.out = reinterpret_cast<T*>(w[4]);
    j.R = static_cast<int>(w[5]);
    j.k = static_cast<int>(w[6]);
    j.G = static_cast<int>(w[7]);
    j.mode = static_cast<int>(w[8]);
    j.tiles = static_cast<int>(w[9]);
    j.cta0 = static_cast<int>(w[10]);
    if (j.mode < kSum || j.mode > kDiag || j.R < 1 || j.k < 1 || j.tiles < 1) return cudaErrorInvalidValue;
    if (run > ipar && j.k <= kMaxK && ring_bytes<T>(rows, ipar, j.k) > smem) smem = ring_bytes<T>(rows, ipar, j.k);
  }
  cudaError_t err = allow_smem(group_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  group_kernel<T><<<ctas, rows * ipar, smem, s>>>(jobs);
  return cudaGetLastError();
}

template <typename T, int K>
__device__ __forceinline__ T wsum_fixed(const T* v, const int32_t* j, const T* __restrict__ w,
                                        const T* __restrict__ g) {
  T a[K], c[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    a[s] = v[s];
    const int32_t i = j[s];
    c[s] = mul(ldg(w + i), ldg(g + i));
  }
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < K; ++s) acc = add(acc, mul(a[s], c[s]));
  return acc;
}

template <typename T, int K>
__device__ __forceinline__ T wsum(const T* v, const int32_t* j, const T* w, const T* g, int k, int col) {
  if constexpr (K == 0) {
    return ell_row<T, kWSum>(v, j, g, w, k, col);
  } else {
    return wsum_fixed<T, K>(v, j, w, g);
  }
}

// One thread per (instance, column j): b, r = b - M x0 and z = dinv r
// (the header's formulas), K the transpose's slots (0: a run-time k).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
cg_start_kernel(const T* __restrict__ tv, const int32_t* __restrict__ ti, int k, const T* __restrict__ rhs_x,
                const T* __restrict__ rhs_z, const T* __restrict__ rho, const T* __restrict__ w,
                const T* __restrict__ Ax0, const T* __restrict__ Px0, const T* __restrict__ x0,
                const T* __restrict__ dinv, T sigma, T* __restrict__ b_out, T* __restrict__ r_out,
                T* __restrict__ z_out, int B, int n, int m) {
  const size_t total = static_cast<size_t>(B) * n;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total; e += stride) {
    const size_t b = e / n;
    const int col = static_cast<int>(e - b * n);
    const T* v = tv + e * k;
    const int32_t* j = ti + static_cast<size_t>(col) * k;
    const size_t o = b * m;
    T bj = rhs_x[e];
    if (rhs_z) {
      bj = add(bj, wsum<T, K>(v, j, rho + o, rhs_z + o, k, col));
      b_out[e] = bj;
    }
    const T vj = wsum<T, K>(v, j, w + o, Ax0 + o, k, col);
    const T Mx = add(add(Px0[e], mul(sigma, x0[e])), vj);
    const T r = sub(bj, Mx);
    r_out[e] = r;
    z_out[e] = mul(dinv[e], r);
  }
}

template <typename T, int K = 1>
void launch_start_by_k(int k, int grid, int threads, cudaStream_t s, const T* tv, const int32_t* ti,
                       const T* rhs_x, const T* rhs_z, const T* rho, const T* w, const T* Ax0, const T* Px0,
                       const T* x0, const T* dinv, T sigma, T* b, T* r, T* z, int B, int n, int m) {
  if constexpr (K > kMaxK) {
    cg_start_kernel<T, 0><<<grid, threads, 0, s>>>(tv, ti, k, rhs_x, rhs_z, rho, w, Ax0, Px0, x0, dinv, sigma, b,
                                                   r, z, B, n, m);
  } else {
    if (k == K) {
      cg_start_kernel<T, K><<<grid, threads, 0, s>>>(tv, ti, k, rhs_x, rhs_z, rho, w, Ax0, Px0, x0, dinv, sigma, b,
                                                     r, z, B, n, m);
    } else {
      launch_start_by_k<T, K + 1>(k, grid, threads, s, tv, ti, rhs_x, rhs_z, rho, w, Ax0, Px0, x0, dinv, sigma, b,
                                  r, z, B, n, m);
    }
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

}  // namespace

// dtype: 0 float32, 1 float64.  `words` holds njobs (1 to 8) jobs of 11
// int64 each: val, idx, g, w (0: none), out, R, k, G, mode (0 sum, 1
// weighted sum, 2 squared sum, 3 max, 4 diagonal; see above), tiles,
// cta0, with val (B,R,k), idx (R,k) int32, g and w (B,G), out (B,R), all
// contiguous, idx in [0, G).  The plan (ops/ell.py:plan): tiles of `rows`
// rows (32, 64, 128 or 256), CTAs of rows x ipar threads (at most 256),
// runs of `run` instances (a multiple of ipar), job i's CTAs from cta0
// on (tiles x runs of them), `ctas` in all.
extern "C" int osqp_ell_group(int dtype, const long long* words, int njobs, int B, int rows, int ipar, int run,
                              int ctas, void* stream) {
  if (njobs < 1 || njobs > kMaxJobs || rows < 32 || rows * ipar > kThreads || run < 1 || ctas < 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_group<float>(words, njobs, B, rows, ipar, run, ctas, s)
                    : launch_group<double>(words, njobs, B, rows, ipar, run, ctas, s);
}

// The CG's start (see above).  The transpose's values t_val (B,n,kt) and
// pattern t_idx (n,kt); rhs_x, x0, dinv, Px0 (B,n); rhs_z (0: b = rhs_x),
// rho, w, Ax0 (B,m); sigma already rounded to the dtype; outputs b (with
// rhs_z), r and z (B,n).  All contiguous; n, m >= 1.  CTAs of 256, 128
// or 64 threads, the largest that gives every one of `sm_count` SMs one.
extern "C" int osqp_ell_cg_start(int dtype, const void* t_val, const void* t_idx, int kt, const void* rhs_x,
                                 const void* rhs_z, const void* rho, const void* w, const void* Ax0, const void* Px0,
                                 const void* x0, const void* dinv, double sigma, void* b, void* r, void* z, int B,
                                 int n, int m, int sm_count, void* stream) {
  if (B == 0) return cudaSuccess;
  if (n < 1 || m < 1 || kt < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(B) * n;
  int threads = kThreads;
  while (threads > 64 && (total + threads - 1) / threads < static_cast<size_t>(sm_count)) threads /= 2;
  const size_t blocks = (total + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < 65536 ? blocks : 65536);
  const auto* ti = static_cast<const int32_t*>(t_idx);
  if (dtype == 0) {
    using T = float;
    launch_start_by_k<T>(kt, grid, threads, s, static_cast<const T*>(t_val), ti, static_cast<const T*>(rhs_x),
                         static_cast<const T*>(rhs_z), static_cast<const T*>(rho), static_cast<const T*>(w),
                         static_cast<const T*>(Ax0), static_cast<const T*>(Px0), static_cast<const T*>(x0),
                         static_cast<const T*>(dinv), static_cast<T>(sigma), static_cast<T*>(b), static_cast<T*>(r),
                         static_cast<T*>(z), B, n, m);
  } else {
    using T = double;
    launch_start_by_k<T>(kt, grid, threads, s, static_cast<const T*>(t_val), ti, static_cast<const T*>(rhs_x),
                         static_cast<const T*>(rhs_z), static_cast<const T*>(rho), static_cast<const T*>(w),
                         static_cast<const T*>(Ax0), static_cast<const T*>(Px0), static_cast<const T*>(x0),
                         static_cast<const T*>(dinv), sigma, static_cast<T*>(b), static_cast<T*>(r),
                         static_cast<T*>(z), B, n, m);
  }
  return cudaGetLastError();
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
