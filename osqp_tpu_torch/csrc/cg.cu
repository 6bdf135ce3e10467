// K6: the batched Jacobi-preconditioned conjugate gradient, warm-started,
// with converged instances frozen: one step's vector work per launch
// (cg_step, for the row-sharded operators, whose products wait on other
// ranks' collectives), and on ELL operands the whole solve in one launch,
// each instance's solve on one thread-block cluster (cg_loop).  Dense
// operands have a loop of their own, csrc/cg_dense.cu.
//
// Replaces the while loop of osqp_tpu/linsys/cg.py:129-169 (solve), which
// solves (P + sigma I + A' diag(rho) A) x = b for every instance of the
// batch, and polish's _pcg (osqp_tpu/polish.py:65-102), the same loop on
// S = P + d I + (MA)'(MA) / d.
//
// The step, three launches over the (B, n) vectors, from the caller's
// operator products (a row-sharded A's products and collectives, or any
// operator's):
//
//   dot_kernel        Mp = (P p + sigma p) + V p;  partials of p'Mp
//   update_kernel     alpha = rz / p'Mp, 0 where r'r <= tol^2 (the freeze);
//                     x += alpha p,  r -= alpha Mp,  z = dinv r;
//                     partials of r'z and r'r;  steps[b] += 1 where live
//   direction_kernel  beta = rz_new / rz;  p = z + beta p;  rz, r'r stored
//
// An instance's vectors are cut into `parts` parts of 256 entries' stride
// (blockIdx.x), so that B=1 at n=1e4 spreads over 40 SMs.  Each part's
// block writes its partial sums, and every block of the next phase adds
// all of its instance's partials itself, in the same fixed order: the dot
// products do not depend on scheduling, there is no floating atomic, and
// two runs are bit-identical.  rz and r'r go to the `next` slots of a
// ping-pong pair, since blocks of the direction pass still read the
// current rz.
//
// The loop (cluster_loop_kernel) runs the whole CG solve of every instance
// on ELL operands in one launch, an instance on one cluster of C <= 16 CTAs
// (above 8 non-portable).  Instances do not depend on each other, so there
// is no cooperative launch and no grid barrier: the grid is as many
// clusters as the card holds at once (cudaOccupancyMaxActiveClusters), at
// most B, and each cluster takes an instance from a counter in device
// memory, runs its solve to the end and takes the next, until none is
// left.  The plan (cluster size, CTA width, what is resident) is chosen on
// the host by ops/cg.py:loop_plan.
//
// CTA c of a cluster owns the parts [c P / C, (c + 1) P / C) of its
// instance (P = parts, at most ceil(P / C) a CTA) and the rows [c R,
// (c + 1) R) of A (R = ceil(m / C)).  The solve's state stays on chip:
// each CTA keeps its entries of x, r, z, p, dinv and Mp and its rows'
// weights in its shared memory for the whole solve and, where they fit,
// its rows of P, A' and A (patterns once a launch, values once an
// instance); where they do not, the rows are read from device memory at
// each step.  A step is four phases, each ended by a synchronisation of
// the cluster:
//
//   A p      its rows of A, gathering p;  w * (A p) in the cg form;
//            a cluster barrier
//   Mp       Mp = (P p + sigma p) + V p on its entries, gathering p and
//            A p (K5's row gathers, ell_gather.cuh);  its parts' partials
//            of p'Mp, pushed to every CTA;  the wait for all P of them
//   update   alpha, x, r, z on its entries;  its parts' partials of r'z
//            and r'r, pushed;  the wait for them
//   p        beta;  p = z + beta p on its entries;  a cluster barrier
//
// p and A p, the vectors that the other CTAs gather through the ELL
// patterns, are stored to device memory, where they stay in L2, and read
// after a cluster barrier (barrier.cluster.arrive.release / wait.acquire,
// cluster.cuh), by plain loads that L1 may serve; a CTA reads its own
// entries from its shared memory.  On the H100 this was as fast as
// gathering from the owners' shared memory on banded operands (LISWET1)
// and faster on scattered ones (CVXQP2_L), where the network between the
// SMs serves about one remote value a cycle (tools/probe_k6.py).  A part's
// partial goes to every CTA of the cluster by an asynchronous store into
// its shared memory (st.async) that completes on its mbarrier, and each
// CTA waits on its own mbarrier for all P partials: no release fence,
// which makes the cluster barrier cost ~1300-1500 cycles against ~500 for
// a relaxed one (tools/microbench_cluster_sync.cu).  One warp of each CTA
// then sums the P partials and forms alpha, or beta: every CTA holds the
// same alpha, beta, r'z and r'r.  A CTA runs 256 threads a part, up to
// four parts at once; a part's 256 threads add its products in the step
// kernels' grid-stride order, sum their warps by the same butterfly and
// hand the warps' sums to one warp, as block_sum does, and one warp sums
// the P partials as parts_sum does.  So every sum is the step kernels'
// whatever the plan, and two runs, or two plans, give the same bits.  Two
// operator forms, each rounded as its plain version: the cg backend's
// V p = A'(rho * A p) (K5's weighted transpose; w * (A p) is the product
// that the gather would form at each slot, formed once) and polish's
// V p = A'(A p) / d, divided after the transposed product.
//
// Each instance stops on its own: its cluster ends the solve when its r'r
// <= tol^2 or after max_iter steps.  The JAX loop, and the cooperative
// kernel that this one replaced, stopped the batch only when no instance
// was live.  There a frozen instance takes alpha = 0, so its x and r keep
// their bits, z = dinv r keeps its, and r'z and r'r, summed again from the
// same bits in the same order, keep theirs: it stays frozen to the end, and
// only its p moves.  The solve returns x and the steps alone, so a cluster
// that stops at its instance's freeze returns the same bits.  The one case
// outside this argument is at the start, whose r'z and r'r are PyTorch's
// sums (ops/cg.py: _start): an instance frozen by them, whose r'r summed
// in the kernel's order would lie above its tolerance, came alive again at
// the batch loop's second step if another instance was live there, and
// now stays stopped.  The two sums differ in their last bits, so that
// needs r'r within a few ulps of tol^2.
//
// Each product and sum is rounded on its own (no fused multiply-add), in
// the order the JAX loop writes them; the plain loop in ops/cg.py can sum
// its dot products in this order (kernel_dot), and from the same products
// the two then agree bit for bit.  So the step and the loop take the
// same steps to the same bits of x.
//
// What bounds it on the H100: latency and issue.  One step reads and
// writes some ten (B, n) vectors and the operands, ~3 MB at CVXQP2_L
// (n = 1e4, m = 1.25e4) in float64, 1 us at the HBM rate; issued step by
// step from the host a step costs three K5 and three K6 launches and some
// 0.2 ms of host time, and the cooperative kernel that this one replaced
// paid four grid barriers a step over vectors in device memory.  Here a
// step is a chain of two cluster barriers, two mbarrier waits, two sums of
// the partials with their divisions, and four phases of a few hundred
// instructions a thread (cycles by phase: tools/probe_k6.py); scattered
// gathers (CVXQP2_L) run at about one value a cycle an SM.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cg_sums.cuh"
#include "cluster.cuh"
#include "common.cuh"
#include "ell_gather.cuh"

namespace {

using namespace osqp_cuda;

// Sum of v over the block in a fixed order: a butterfly within each warp,
// then warp 0 adds the warps' sums.  Every thread gets the result.
template <typename T>
__device__ T block_sum(T v, T* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();  // sh may still be read from an earlier call
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    T s = lane < kWarps ? sh[lane] : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) sh[kWarps] = s;
  }
  __syncthreads();
  return sh[kWarps];
}

// Sum of the `parts` partials of one instance, in a fixed order.
template <typename T>
__device__ T parts_sum(const T* part, int parts, T* sh) {
  T s = T(0);
  for (int i = threadIdx.x; i < parts; i += kThreads) s = add(s, part[i]);
  return block_sum(s, sh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ p, const T* __restrict__ u, const T* __restrict__ v, T sigma, T* __restrict__ Mp,
           T* __restrict__ part, int n, int parts) {
  __shared__ T sh[kWarps + 1];
  const size_t b = blockIdx.y;
  const size_t o = b * n;
  T acc = T(0);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += parts * kThreads) {
    T t = add(u[o + i], mul(sigma, p[o + i]));
    if (v) t = add(t, v[o + i]);
    Mp[o + i] = t;
    acc = add(acc, mul(p[o + i], t));
  }
  const T s = block_sum(acc, sh);
  if (threadIdx.x == 0) part[b * parts + blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_kernel(const T* __restrict__ part_pm, const T* __restrict__ rz, const T* __restrict__ rr,
              const T* __restrict__ tol2, const T* __restrict__ p, const T* __restrict__ Mp,
              const T* __restrict__ dinv, T* __restrict__ x, T* __restrict__ r, T* __restrict__ z,
              T* __restrict__ part_rz, T* __restrict__ part_rr, int32_t* __restrict__ steps, int n, int parts) {
  __shared__ T sh[kWarps + 1];
  const size_t b = blockIdx.y;
  const size_t o = b * n;
  const T denom = parts_sum(part_pm + b * parts, parts, sh);
  const bool live = rr[b] > tol2[b];
  const T alpha = live ? rz[b] / (denom > T(0) ? denom : T(1)) : T(0);
  if (live && blockIdx.x == 0 && threadIdx.x == 0) steps[b] += 1;
  T acc_rz = T(0), acc_rr = T(0);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += parts * kThreads) {
    x[o + i] = add(x[o + i], mul(alpha, p[o + i]));
    const T ri = sub(r[o + i], mul(alpha, Mp[o + i]));
    const T zi = mul(dinv[o + i], ri);
    r[o + i] = ri;
    z[o + i] = zi;
    acc_rz = add(acc_rz, mul(ri, zi));
    acc_rr = add(acc_rr, mul(ri, ri));
  }
  const T s_rz = block_sum(acc_rz, sh);
  const T s_rr = block_sum(acc_rr, sh);
  if (threadIdx.x == 0) {
    part_rz[b * parts + blockIdx.x] = s_rz;
    part_rr[b * parts + blockIdx.x] = s_rr;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
direction_kernel(const T* __restrict__ part_rz, const T* __restrict__ part_rr, const T* __restrict__ rz,
                 T* __restrict__ rz_next, T* __restrict__ rr_next, const T* __restrict__ z, T* __restrict__ p,
                 int n, int parts) {
  __shared__ T sh[kWarps + 1];
  const size_t b = blockIdx.y;
  const size_t o = b * n;
  const T rz_new = parts_sum(part_rz + b * parts, parts, sh);
  const T rr_new = parts_sum(part_rr + b * parts, parts, sh);
  const T rz_old = rz[b];
  const T beta = rz_new / (rz_old > T(0) ? rz_old : T(1));
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += parts * kThreads)
    p[o + i] = add(z[o + i], mul(beta, p[o + i]));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    rz_next[b] = rz_new;
    rr_next[b] = rr_new;
  }
}

template <typename T>
int launch(void* const* a, double sigma, int B, int n, cudaStream_t s) {
  auto in = [&](int k) { return static_cast<const T*>(a[k]); };
  auto out = [&](int k) { return static_cast<T*>(a[k]); };
  const T *p_in = in(0), *u = in(1), *v = in(2), *dinv = in(3), *tol2 = in(4), *rz = in(5), *rr = in(6);
  T *Mp = out(7), *x = out(8), *r = out(9), *z = out(10), *p = out(11), *rz_next = out(12), *rr_next = out(13),
    *part = out(14);
  auto* steps = static_cast<int32_t*>(a[15]);
  const int parts = parts_of(n);
  const size_t np = static_cast<size_t>(B) * parts;
  T *part_pm = part, *part_rz = part + np, *part_rr = part + 2 * np;
  const dim3 grid(parts, B);
  dot_kernel<T><<<grid, kThreads, 0, s>>>(p_in, u, v, static_cast<T>(sigma), Mp, part_pm, n, parts);
  update_kernel<T><<<grid, kThreads, 0, s>>>(part_pm, rz, rr, tol2, p_in, Mp, dinv, x, r, z, part_rz, part_rr,
                                             steps, n, parts);
  direction_kernel<T><<<grid, kThreads, 0, s>>>(part_rz, part_rr, rz, rz_next, rr_next, z, p, n, parts);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The device loop: one CG solve per thread-block cluster.
// ---------------------------------------------------------------------------
constexpr int kLoopMaxCluster = 16;
constexpr int kLoopMaxThreads = 4 * kThreads;  // four parts at once

// The cut of one instance over a cluster of C CTAs: parts, the rounds of
// a part's grid-stride loop, the most parts a CTA, the entries a CTA
// (qmax parts of `rounds` x 256), and the rows of A a CTA (R, padded to
// Rp).
struct LoopGeom {
  int parts, rounds, qmax, E, R, Rp;
};

inline LoopGeom loop_geom(int n, int m, int C) {
  LoopGeom g;
  g.parts = parts_of(n);
  g.rounds = (n + g.parts * kThreads - 1) / (g.parts * kThreads);
  g.qmax = (g.parts + C - 1) / C;
  g.E = g.qmax * kThreads * g.rounds;
  g.R = m > 0 ? (m + C - 1) / C : 0;
  g.Rp = (g.R + 3) & ~3;
  return g;
}

// Bytes of a CTA's dynamic shared memory, in the kernel's order: two
// mbarriers; values (the partials of every part, the warps' sums, 8
// scalars; with `vres` the vectors x r z p dinv Mp of its entries, the
// weights and A p of its rows; with `res` its rows of P, A' and A); the
// patterns of those rows (int32).  ops/cg.py:loop_smem counts the same.
template <typename T>
size_t loop_smem(const LoopGeom& g, int kp, int ka, int kt, bool res, bool vres) {
  const size_t E = g.E, Rp = g.Rp;
  size_t vals = 3 * kMaxParts + 2 * static_cast<size_t>(g.qmax) * kWarps + 8, pats = 0;
  if (vres) vals += 6 * E + 2 * Rp;
  if (res) {
    pats = E * (kp + kt) + Rp * ka;
    vals += pats;
  }
  return 2 * sizeof(uint64_t) + vals * sizeof(T) + pats * sizeof(int32_t);
}

// The operands and state of the solves.  The ELL operands: P's rows
// (B, n, kp) with pattern (n, kp), A's rows (B, m, ka) with (m, ka) and
// A's transpose (B, n, kt) with (n, kt).  w (B, m) the cg form's weights,
// or null for polish's form, which divides by `div`.  x, r, z, p (B, n)
// the start (x the result, p where the CTAs publish it); rz, rr, tol2
// (B); Ap (B, m) where the CTAs publish (w *) A p; Mp (B, n) scratch
// where the vectors are not resident; steps (B + 1) zeros, the steps of
// each instance and, last, the instance counter.
template <typename T>
struct LoopArgs {
  const T *pv, *av, *tv, *w, *dinv, *tol2, *rz, *rr;
  const int32_t *pi, *ai, *ti;
  T *x, *r, *z, *p, *Ap, *Mp;
  int32_t* steps;
  T sigma, div;
  int kp, ka, kt, B, n, m, max_iter, C;
  LoopGeom g;
};

template <typename U>
__device__ __forceinline__ void copy_in(U* __restrict__ dst, const U* __restrict__ src, size_t count) {
  for (size_t e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

__device__ __forceinline__ uint32_t cluster_addr(const void* local, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_addr(local)), "r"(rank));
  return addr;
}

// *local in the shared memory of the cluster's CTA `rank` <- v, an
// asynchronous store whose bytes complete on that CTA's mbarrier at *bar:
// a CTA that waits on its mbarrier's phase sees the stores counted in it.
template <typename T>
__device__ __forceinline__ void st_async(T* local, uint64_t* bar, int rank, T v) {
  const uint32_t addr = cluster_addr(local, rank), mbar = cluster_addr(bar, rank);
  if constexpr (sizeof(T) == 8)
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];\n" ::"r"(addr), "d"(v),
                 "r"(mbar)
                 : "memory");
  else
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr), "f"(v),
                 "r"(mbar)
                 : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier at *bar has
// completed, acquiring at cluster scope what completed it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

#ifdef OSQP_STAMPS
// cycles by phase (tools/probe_k6.py): the instance's fetch and load; A p,
// its barrier; Mp, the partials' push, the wait for them; alpha, the
// update, the push, the wait; beta, p, its barrier; the result's store
__device__ unsigned long long cg_stamps[2][16];
#endif

// The loop's modes (ops/cg.py:LoopPlan): the vectors of the CTA's
// entries (x, r, z, p, dinv, Mp) and its rows' weights and A p in shared
// memory, with its rows of P, A' and A (values an instance, patterns once
// a launch) there too (kResident) or read from device memory at each step
// (kVectors); or everything in device memory (kStreamed: n beyond what
// the cluster's shared memory holds).
enum LoopMode { kResident = 0, kVectors = 1, kStreamed = 2 };

template <typename T, int kMode>
__global__ void __launch_bounds__(kLoopMaxThreads) cluster_loop_kernel(const LoopArgs<T> a) {
  namespace cg = cooperative_groups;
  constexpr bool kRes = kMode == kResident, kVres = kMode != kStreamed;
  extern __shared__ __align__(16) unsigned char loop_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const LoopGeom g = a.g;
  const int C = a.C, rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int G = nthreads / kThreads, grp = tid / kThreads, t256 = tid % kThreads;
  const int lane = tid & 31, warp = tid >> 5, wg = t256 >> 5;
  const int n = a.n, m = a.m, P = g.parts, Q = g.qmax, rounds = g.rounds;
  const int kp = a.kp, ka = a.ka, kt = a.kt;
  const int q0 = rank * P / C, Qc = (rank + 1) * P / C - q0;
  const int r0 = min(m, rank * g.R), r1 = min(m, r0 + g.R);

  uint64_t* bars = reinterpret_cast<uint64_t*>(loop_raw);  // the partials' arrivals: p'Mp, and r'z with r'r
  T* sv = reinterpret_cast<T*>(bars + 2);
  T* part = sv;  // partials of p'Mp, r'z and r'r by part: every CTA's own copy
  sv += 3 * kMaxParts;
  T* wsum = sv;  // the warps' sums of this CTA's parts, two sums
  sv += 2 * Q * kWarps;
  T* scal = sv;  // alpha, r'z, r'r, beta; the next instance (rank 0) and this CTA's copy of it
  sv += 8;
  T *xs = sv, *rs = xs + g.E, *zs = rs + g.E, *ps = zs + g.E, *ds = ps + g.E, *ms = ds + g.E, *ws = ms + g.E,
    *aps = ws + g.Rp;
  if (kVres) sv = aps + g.Rp;
  T *pvs = sv, *tvs = pvs + static_cast<size_t>(g.E) * kp, *avs = tvs + static_cast<size_t>(g.E) * kt;
  if (kRes) sv = avs + static_cast<size_t>(g.Rp) * ka;
  int32_t *pis = reinterpret_cast<int32_t*>(sv), *tis = pis + static_cast<size_t>(g.E) * kp,
          *ais = tis + static_cast<size_t>(g.E) * kt;
  int* next = reinterpret_cast<int*>(scal + 6);
  int* mine = reinterpret_cast<int*>(scal + 7);
  // a chunk of 256 entries: the CTA's qq-th part in round t
  auto first = [&](int qq, int t) { return (t * P + q0 + qq) * kThreads; };
  auto local = [&](int qq, int t) { return (t * Q + qq) * kThreads; };

  if constexpr (kRes) {  // the patterns, shared by the batch
    for (int c = 0; c < Qc * rounds; ++c) {
      const int qq = c % Qc, t = c / Qc, i0 = first(qq, t), l0 = local(qq, t);
      if (i0 >= n) continue;
      const size_t cnt = min(kThreads, n - i0);
      copy_in(pis + static_cast<size_t>(l0) * kp, a.pi + static_cast<size_t>(i0) * kp, cnt * kp);
      copy_in(tis + static_cast<size_t>(l0) * kt, a.ti + static_cast<size_t>(i0) * kt, cnt * kt);
    }
    copy_in(ais, a.ai + static_cast<size_t>(r0) * ka, static_cast<size_t>(r1 - r0) * ka);
  }
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t phase = 0;  // of both mbarriers: each completes once a step
  STAMP_DECL(cg_stamps)

  for (;;) {
    // the next instance, read by every CTA from rank 0 between two barriers
    if (rank == 0 && tid == 0) *next = atomicAdd(a.steps + a.B, 1);
    cluster_barrier();
    if (tid == 0) *mine = *cluster.map_shared_rank(next, 0);
    cluster_barrier();
    const int b = *mine;
    if (b >= a.B) break;
    const size_t bn = static_cast<size_t>(b) * n, bm = static_cast<size_t>(b) * m;
    T* const gp = a.p + bn;   // p, where the CTAs gather it
    T* const gap = a.Ap + bm; // (w *) A p, the same
    // a vector of the entries: the CTA's l-th entry in shared memory,
    // entry i in device memory
    T *X = kVres ? xs : a.x + bn, *Rv = kVres ? rs : a.r + bn, *Z = kVres ? zs : a.z + bn;
    T *Pv = kVres ? ps : gp, *M = kVres ? ms : a.Mp + bn;
    const T* D = kVres ? ds : a.dinv + bn;
    const T* W = a.w ? (kVres ? ws : a.w + bm) : nullptr;  // row j at j - wo
    const int wo = kVres ? r0 : 0;
    // the rows of the operands: the CTA's l-th (j - r0-th) in shared
    // memory, i-th (j-th) in device memory
    const T *PV = kRes ? pvs : a.pv + bn * kp, *TV = kRes ? tvs : a.tv + bn * kt, *AV = kRes ? avs : a.av + bm * ka;
    const int32_t *PI = kRes ? pis : a.pi, *TI = kRes ? tis : a.ti, *AI = kRes ? ais : a.ai;
    const int ro = kRes ? r0 : 0;

    if constexpr (kVres) {
      for (int qq = grp; qq < Qc; qq += G)
        for (int t = 0; t < rounds; ++t) {
          const int i = first(qq, t) + t256, l = local(qq, t) + t256;
          if (i >= n) break;
          xs[l] = a.x[bn + i], rs[l] = a.r[bn + i], zs[l] = a.z[bn + i], ps[l] = gp[i], ds[l] = a.dinv[bn + i];
        }
      if (a.w)
        for (int j = r0 + tid; j < r1; j += nthreads) ws[j - r0] = a.w[bm + j];
    }
    if constexpr (kRes) {
      for (int c = 0; c < Qc * rounds; ++c) {
        const int qq = c % Qc, t = c / Qc, i0 = first(qq, t), l0 = local(qq, t);
        if (i0 >= n) continue;
        const size_t cnt = min(kThreads, n - i0);
        copy_in(pvs + static_cast<size_t>(l0) * kp, a.pv + (bn + i0) * kp, cnt * kp);
        copy_in(tvs + static_cast<size_t>(l0) * kt, a.tv + (bn + i0) * kt, cnt * kt);
      }
      copy_in(avs, a.av + (bm + r0) * ka, static_cast<size_t>(r1 - r0) * ka);
    }
    T rz = a.rz[b], rr = a.rr[b];
    const T tol2 = a.tol2[b];

    // p and (w *) A p: the CTA's own from its shared memory, the others'
    // where their CTAs stored them, by plain loads, which L1 may serve (the
    // barriers' acquire orders them after the stores)
    const int p_lo = q0 * kThreads;
    const unsigned p_span = kVres && rounds == 1 ? Qc * kThreads : 0, ap_span = kVres ? r1 - r0 : 0;
    auto get_p = [&](int j) -> T {
      const unsigned o = j - p_lo;
      return o < p_span ? ps[o] : gp[j];
    };
    auto get_ap = [&](int j) -> T {
      const unsigned o = j - r0;
      return o < ap_span ? aps[o] : gap[j];
    };
    // the sums of this CTA's parts (wsum[(s Q + qq) kWarps + w]), pushed
    // into every CTA's partials part[(s0 + s) kMaxParts + q], completing on
    // its mbarrier bars[s0 > 0]; then warps [0, sums) wait for all P parts'
    // on this CTA's.  The next push to an mbarrier comes a step later,
    // after the cluster barrier of the next A p or p, which no CTA passes
    // before every CTA has waited on this phase.
    auto push = [&](int sums, int s0, int stamp) {
      uint64_t* bar = bars + (s0 > 0);
      __syncthreads();
      for (int qq = warp; qq < Qc; qq += nwarps)
        for (int s = 0; s < sums; ++s) {
          const T v = __shfl_sync(0xffffffffu, warps_sum(lane < kWarps ? wsum[(s * Q + qq) * kWarps + lane] : T(0)), 0);
          if (lane < C) st_async(part + (s0 + s) * kMaxParts + q0 + qq, bar, lane, v);
        }
      STAMP(stamp);
      if (warp < sums) {
        if (tid == 0) mbar_expect_tx(bar, static_cast<uint32_t>(sums * P * sizeof(T)));
        mbar_wait_cluster(bar, phase);
      }
      STAMP(stamp + 1);
    };
    cluster_barrier();  // the loads done: p in place
    STAMP(0);

    int k = 0;
    for (; k < a.max_iter && rr > tol2; ++k) {
      // A p
      if (m) {
        for (int j = r0 + tid; j < r1; j += nthreads) {
          const size_t o = static_cast<size_t>(j - ro) * ka;
          const T s = ell_row_sum(AV + o, AI + o, ka, get_p);
          const T v = W ? mul(W[j - wo], s) : s;
          gap[j] = v;
          if (kVres) aps[j - r0] = v;
        }
        STAMP(1);
        cluster_barrier();
        STAMP(2);
      }

      // Mp = (P p + sigma p) + V p and the partials of p'Mp (dot_kernel)
      for (int qq = grp; qq < Qc; qq += G) {
        T acc = T(0);
        for (int t = 0; t < rounds; ++t) {
          const int i = first(qq, t) + t256;
          if (i >= n) break;
          const int l = local(qq, t) + t256, e = kVres ? l : i, o = kRes ? l : i;
          const T p_i = Pv[e];
          T u = add(ell_row_sum(PV + static_cast<size_t>(o) * kp, PI + static_cast<size_t>(o) * kp, kp, get_p),
                    mul(a.sigma, p_i));
          if (m) {
            const T v = ell_row_sum(TV + static_cast<size_t>(o) * kt, TI + static_cast<size_t>(o) * kt, kt, get_ap);
            u = add(u, W ? v : quotient(v, a.div));
          }
          M[e] = u;
          acc = add(acc, mul(p_i, u));
        }
        acc = warp_sum(acc);
        if (lane == 0) wsum[qq * kWarps + wg] = acc;
      }
      STAMP(3);
      push(1, 0, 4);

      // alpha, x, r, z and the partials of r'z and r'r (update_kernel)
      if (warp == 0) {
        const T d = parts_total(part, P, lane);
        if (lane == 0) scal[0] = rz / (d > T(0) ? d : T(1));
      }
      __syncthreads();
      STAMP(6);
      const T alpha = scal[0];
      for (int qq = grp; qq < Qc; qq += G) {
        T acc_rz = T(0), acc_rr = T(0);
        for (int t = 0; t < rounds; ++t) {
          const int i = first(qq, t) + t256;
          if (i >= n) break;
          const int e = kVres ? local(qq, t) + t256 : i;
          X[e] = add(X[e], mul(alpha, Pv[e]));
          const T ri = sub(Rv[e], mul(alpha, M[e]));
          const T zi = mul(D[e], ri);
          Rv[e] = ri;
          Z[e] = zi;
          acc_rz = add(acc_rz, mul(ri, zi));
          acc_rr = add(acc_rr, mul(ri, ri));
        }
        acc_rz = warp_sum(acc_rz);
        acc_rr = warp_sum(acc_rr);
        if (lane == 0) {
          wsum[qq * kWarps + wg] = acc_rz;
          wsum[(Q + qq) * kWarps + wg] = acc_rr;
        }
      }
      STAMP(7);
      push(2, 1, 8);
      phase ^= 1;

      // beta, p, and the next r'z and r'r (direction_kernel)
      if (warp < 2) {
        const T s = parts_total(part + (1 + warp) * kMaxParts, P, lane);
        if (lane == 0) {
          scal[1 + warp] = s;
          if (warp == 0) scal[3] = s / (rz > T(0) ? rz : T(1));
        }
      }
      __syncthreads();
      STAMP(10);
      rz = scal[1];
      rr = scal[2];
      const T beta = scal[3];
      for (int qq = grp; qq < Qc; qq += G)
        for (int t = 0; t < rounds; ++t) {
          const int i = first(qq, t) + t256;
          if (i >= n) break;
          const int e = kVres ? local(qq, t) + t256 : i;
          const T p_i = add(Z[e], mul(beta, Pv[e]));
          Pv[e] = p_i;
          if (kVres) gp[i] = p_i;
        }
      STAMP(11);
      cluster_barrier();
      STAMP(12);
    }

    if constexpr (kVres)
      for (int qq = grp; qq < Qc; qq += G)
        for (int t = 0; t < rounds; ++t) {
          const int i = first(qq, t) + t256;
          if (i >= n) break;
          a.x[bn + i] = xs[local(qq, t) + t256];
        }
    if (rank == 0 && tid == 0) a.steps[b] = k;
    STAMP(13);
  }
}

// The launch of the loop in mode kMode: clusters of C CTAs of `threads`,
// `smem` bytes each; err is set where the plan is not served.
template <typename T, int kMode>
struct LoopLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;

  LoopLaunch(int C, int threads, size_t smem, int clusters, cudaStream_t s) {
    if (C < 1 || C > kLoopMaxCluster || threads < kThreads || threads > kLoopMaxThreads || threads % kThreads ||
        smem > static_cast<size_t>(kMaxSmem) || clusters < 1) {
      err = cudaErrorInvalidValue;
      return;
    }
    auto kernel = cluster_loop_kernel<T, kMode>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess && C > 8) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg.gridDim = dim3(static_cast<unsigned>(clusters) * C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

inline int loop_mode(int resident, int vectors) {
  return resident ? kResident : (vectors ? kVectors : kStreamed);
}

template <typename T, int kMode>
int launch_loop(LoopArgs<T> a, int threads, int clusters, cudaStream_t s) {
  a.g = loop_geom(a.n, a.m, a.C);
  if (a.C > a.g.parts) return cudaErrorInvalidValue;
  LoopLaunch<T, kMode> l(a.C, threads, loop_smem<T>(a.g, a.kp, a.ka, a.kt, kMode == kResident, kMode != kStreamed),
                         clusters < a.B ? clusters : a.B, s);
  if (l.err != cudaSuccess) return l.err;
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, cluster_loop_kernel<T, kMode>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int kMode>
int loop_clusters(int C, int threads, size_t smem) {
  LoopLaunch<T, kMode> l(C, threads, smem, 1, nullptr);
  int clusters = 0;
  if (l.err != cudaSuccess || cudaOccupancyMaxActiveClusters(&clusters, cluster_loop_kernel<T, kMode>, &l.cfg) != cudaSuccess)
    return -1;
  return clusters;
}

template <typename T>
int launch_loop_in(int mode, LoopArgs<T> a, int threads, int clusters, cudaStream_t s) {
  return mode == kResident ? launch_loop<T, kResident>(a, threads, clusters, s)
         : mode == kVectors ? launch_loop<T, kVectors>(a, threads, clusters, s)
                            : launch_loop<T, kStreamed>(a, threads, clusters, s);
}

template <typename T>
int loop_clusters_in(int mode, int C, int threads, size_t smem) {
  return mode == kResident ? loop_clusters<T, kResident>(C, threads, smem)
         : mode == kVectors ? loop_clusters<T, kVectors>(C, threads, smem)
                            : loop_clusters<T, kStreamed>(C, threads, smem);
}

}  // namespace

// Blocks per instance of a step at n variables: the partials buffer holds
// 3 * B * osqp_cg_parts(n) values.
extern "C" int osqp_cg_parts(int n) { return parts_of(n); }

// One CG step for B instances of n variables.  dtype: 0 float32, 1 float64.
// p (B,n) the direction, read and then overwritten with the next one;
// u = P p and v = A'(rho A p) (B,n), v null when A has no rows; dinv,
// tol2 (B), rz and rr (B) of the current step.  Written: Mp (B,n), x, r,
// z (B,n) updated in place, rz_next and rr_next (B), steps (B) int32
// incremented where the instance is live, and the partials (3,B,parts).
// All contiguous, B, n >= 1.
extern "C" int osqp_cg_step(int dtype, void* p, const void* u, const void* v, const void* dinv, const void* tol2,
                            const void* rz, const void* rr, void* Mp, void* x, void* r, void* z, void* rz_next,
                            void* rr_next, void* part, void* steps, double sigma, int B, int n, void* stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  void* const a[16] = {p, const_cast<void*>(u), const_cast<void*>(v), const_cast<void*>(dinv),
                       const_cast<void*>(tol2), const_cast<void*>(rz), const_cast<void*>(rr), Mp, x, r, z, p,
                       rz_next, rr_next, part, steps};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, sigma, B, n, s) : launch<double>(a, sigma, B, n, s);
}

// The whole CG solve of B instances of n variables on ELL operands, one
// launch, an instance on a cluster.  dtype: 0 float32, 1 float64.  P: pv
// (B,n,kp), pi (n,kp); A (m rows; m may be 0): av (B,m,ka), ai (m,ka), tv
// (B,n,kt), ti (n,kt) int32; w (B,m) for the cg form, null for polish's
// form, whose V p is divided by `div`.  dinv (B,n); tol2, rz, rr (B) at
// the start.  x, r, z, p (B,n) the start, x the result (r, z and p are
// overwritten); Ap (B,m) and Mp (B,n) scratch; steps (B + 1) int32 zeros:
// the steps of each instance, then the instance counter.  The plan
// (ops/cg.py:loop_plan): clusters of `cluster` CTAs (at most
// osqp_cg_parts(n)) of `threads` (256, 512, 768 or 1024), the operands'
// rows in shared memory when `resident`, the vectors when `vectors`
// (which `resident` needs), at most `clusters` clusters at once.  All
// contiguous, B, n >= 1.
extern "C" int osqp_cg_loop(int dtype, const void* pv, const void* pi, int kp, const void* av, const void* ai, int ka,
                            const void* tv, const void* ti, int kt, const void* w, double sigma, double div,
                            const void* dinv, const void* tol2, const void* rz, const void* rr, void* x, void* r,
                            void* z, void* p, void* Ap, void* Mp, void* steps, int B, int n, int m, int max_iter,
                            int cluster, int threads, int resident, int vectors, int clusters, void* stream) {
  if (B == 0 || n == 0 || max_iter <= 0) return cudaSuccess;
  if (resident && !vectors) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int mode = loop_mode(resident, vectors);
  auto fill = [&](auto a) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(a.pv)>>;
    a.pv = static_cast<const T*>(pv);
    a.av = static_cast<const T*>(av);
    a.tv = static_cast<const T*>(tv);
    a.w = static_cast<const T*>(w);
    a.dinv = static_cast<const T*>(dinv);
    a.tol2 = static_cast<const T*>(tol2);
    a.rz = static_cast<const T*>(rz);
    a.rr = static_cast<const T*>(rr);
    a.pi = static_cast<const int32_t*>(pi);
    a.ai = static_cast<const int32_t*>(ai);
    a.ti = static_cast<const int32_t*>(ti);
    a.x = static_cast<T*>(x);
    a.r = static_cast<T*>(r);
    a.z = static_cast<T*>(z);
    a.p = static_cast<T*>(p);
    a.Ap = static_cast<T*>(Ap);
    a.Mp = static_cast<T*>(Mp);
    a.steps = static_cast<int32_t*>(steps);
    a.sigma = static_cast<T>(sigma);
    a.div = static_cast<T>(div);
    a.kp = kp;
    a.ka = ka;
    a.kt = kt;
    a.B = B;
    a.n = n;
    a.m = m;
    a.max_iter = max_iter;
    a.C = cluster;
    return launch_loop_in<T>(mode, a, threads, clusters, s);
  };
  return dtype == 0 ? fill(LoopArgs<float>{}) : fill(LoopArgs<double>{});
}

// Bytes of shared memory of one CTA of the loop's plan (arguments as
// osqp_cg_loop's).
extern "C" int osqp_cg_loop_smem(int dtype, int n, int m, int kp, int ka, int kt, int cluster, int resident,
                                 int vectors) {
  const LoopGeom g = loop_geom(n, m, cluster);
  return static_cast<int>(dtype == 0 ? loop_smem<float>(g, kp, ka, kt, resident != 0, vectors != 0)
                                     : loop_smem<double>(g, kp, ka, kt, resident != 0, vectors != 0));
}

#ifdef OSQP_STAMPS
// The loop's cycles by phase since the last call (2 x 16: CTA 0 and the
// last CTA of the first cluster), then zeroed.
extern "C" int osqp_cg_stamps(unsigned long long* out) {
  static const unsigned long long zero[2][16] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, cg_stamps, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(cg_stamps, zero, sizeof(zero));
  return err;
}
#endif

// Clusters of the loop's plan that the card holds at once; negative on a
// CUDA error or a plan the kernel does not serve.
extern "C" int osqp_cg_loop_clusters(int dtype, int cluster, int threads, int smem, int resident, int vectors) {
  if (resident && !vectors) return -1;
  const int mode = loop_mode(resident, vectors);
  const size_t b = static_cast<size_t>(smem);
  return dtype == 0 ? loop_clusters_in<float>(mode, cluster, threads, b) : loop_clusters_in<double>(mode, cluster, threads, b);
}
