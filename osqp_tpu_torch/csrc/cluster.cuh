// What the kernels that spread one instance over a thread-block cluster
// share (K7's cluster path, K2's cluster leaf): the cluster barrier, the
// loads of what another CTA published through L2, and cycle stamps by
// phase, compiled in only with -DOSQP_STAMPS (the probes in
// tools/ build them; the library never does).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace osqp_cuda {

// A barrier over the cluster that orders every CTA's shared-memory writes
// before it against the other CTAs' reads after it: an arrive with
// release and a wait with acquire semantics at cluster scope
// (cluster.sync()'s ordering).  K8's cheaper form, a CTA-scope fence and
// a relaxed arrive, let K7's cluster path read a panel column before its
// owner's write had landed, in every one of 20 launches at b = 256 in
// clusters of 4 and 8 (tools/probe_k7_cluster.py; NVIDIA H100 80GB HBM3,
// 700.00 W), and costs 1.5% less.  It is a block barrier too.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a / d, correctly rounded.  A zero a over a finite nonzero d is the zero
// of sign sign(a) sign(d), as IEEE 754 divides, given here directly: the
// card's division takes a slow path for a zero dividend (K8's quotient),
// which a warp pays whenever one of its lanes divides a zero.
template <typename T>
__device__ __forceinline__ T quotient(T a, T d) {
  if (a == T(0) && d != T(0) && isfinite(d)) return (signbit(a) != signbit(d)) ? -T(0) : T(0);
  return a / d;
}

// Rows [0, nrows) x columns [0, ncols) of a row-major matrix in device
// memory (row pitch sp) into shared memory (row pitch dp), through L2
// (ld.global.cg: another CTA wrote them before the last cluster barrier,
// and this SM's L1 may hold an older line of them): the block's threads
// over the values in row order, so that a warp's loads fall on a few
// lines even where the rows are short (a panel of 16 columns), sixteen
// loads in flight a thread.  Every thread of the block calls it; the
// caller's block barrier ends it.
// Another CTA's shared memory serves remote reads at about one request a
// cycle, so a panel that every CTA of a cluster reads goes through L2.
template <typename T>
__device__ __forceinline__ void load_rows_l2(T* dst, int dp, const T* src, size_t sp, int nrows, int ncols) {
  const int total = nrows * ncols, nt = blockDim.x;
  const int step_r = nt / ncols, step_c = nt - step_r * ncols;
  int r = threadIdx.x / ncols, c = threadIdx.x - r * ncols;  // of element threadIdx.x + 16 nt i
  for (int e0 = threadIdx.x; e0 < total; e0 += 16 * nt) {
    T v[16];
    int rr = r, cc = c;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      v[u] = e0 + u * nt < total ? __ldcg(src + rr * sp + cc) : T(0);
      rr += step_r;
      cc += step_c;
      if (cc >= ncols) {
        cc -= ncols;
        ++rr;
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (e0 + u * nt < total) dst[r * dp + c] = v[u];
      r += step_r;
      c += step_c;
      if (c >= ncols) {
        c -= ncols;
        ++r;
      }
    }
  }
}

}  // namespace osqp_cuda

// Cycle stamps: STAMP(i) adds the cycles since the last stamp to phase i
// of this CTA's row of stamps (thread 0 of CTAs 0 and k - 1 of the first
// instance); the probe reads them through the file's osqp_*_stamps.
#ifdef OSQP_STAMPS
#define STAMP_DECL(table)                                                                               \
  long long stamp_last = clock64();                                                                     \
  unsigned long long* stamp_row = nullptr;                                                              \
  if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x + 1 == cooperative_groups::this_cluster().num_blocks())) \
    stamp_row = table[blockIdx.x == 0 ? 0 : 1];
#define STAMP(i)                                  \
  do {                                            \
    if (stamp_row) {                              \
      const long long now = clock64();            \
      stamp_row[i] += now - stamp_last;           \
      stamp_last = now;                           \
    }                                             \
  } while (0)
#else
#define STAMP_DECL(table)
#define STAMP(i) \
  do {           \
  } while (0)
#endif
