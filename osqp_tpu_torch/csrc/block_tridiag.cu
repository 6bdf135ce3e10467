// K7: the block-tridiagonal Cholesky factorization of the reduced KKT
// matrix M = P + sigma I + A' diag(rho) A, and the solve with its factors:
// a warp per instance for stages of b <= 32 variables; above that the
// factor deals each instance's rows round a thread-block cluster, in the
// CTAs' shared memory up to cluster_max_block (558 in float32, 361 in
// float64: the cluster path) and in the rows of its own outputs beyond
// (the device path), and the solve takes one CTA an instance by panels of
// 16 columns (the wide solve).
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
// where D_i = M[block i, block i] and O_i = M[block i, block i-1].  Both
// factor paths read those two blocks of each stage straight from M
// (strided; the rest of M is never read) and write C (B, Nb, b, b), lower
// with zeros above, and G (B, Nb-1, b, b).  A stage whose pivot is not
// positive gives NaN in the whole lower triangle of C_i, as
// jnp.linalg.cholesky does, and the NaN runs on through every later
// stage: it is not raised.  The solve walks both passes in one launch,
// keeping y in x's memory.
//
// b <= 32 (the MPC cell's b = 12): a warp per instance, four a block,
// lane r holding row r of the stage in registers.  The factor solves
// G_i's row by columns against C_{i-1} (shared memory, broadcast reads),
// forms D_i - G_i G_i' from G_i's rows in shared memory and runs the
// Cholesky by columns, column j's entries by shuffle; the solve holds
// rows of C_i and G_i (forward) or columns of C_i and G_{i+1} (backward),
// the other entries of y or x by shuffle, and every lane divides entry j
// by the diagonal at column step j.  No block barrier anywhere, and each
// stage's bytes are loaded into registers while the stage before runs.
// A ring of stages in shared memory fed by cp.async is not built: one
// stage in flight already hides the loads' latency.  On an NVIDIA H100
// 80GB HBM3 at 700.00 W at the MPC cell (tools/probe_k7_solve.py), the
// solve takes 0.0911 ms warm and 0.1044 with the L2 flushed before each
// call; with every stage's C and G read from stage 0's blocks instead
// (L1 hits, or loads hoisted out of the loop) it takes 0.0743 and
// 0.0841.  Flushing costs both about the same (0.013 and 0.010 ms), so
// no stage waits on device memory; the 0.017 ms the loads add warm is
// their instructions, which a ring would replace by as many
// shared-memory loads, and without them the chain alone misses 0.05 ms.
// Dividing on lane j alone behind a branch and shuffling the quotient
// takes 0.1165.
//
// b > 32, the factor (cluster_factor_kernel below): each instance over a
// cluster of up to 16 CTAs, by panels of 16 columns, np + 1 cluster
// barriers a stage; every CTA keeps the diagonal blocks (the band) and
// factors each itself, and what CTAs share goes through L2.  Up to
// cluster_max_block the rows sit in the CTAs' shared memory; from b = 64
// up that is several times faster at every batch size measured than the
// block per instance it replaced (tools/ab_k7_factor.py, PERF.md).  Above
// it (the device path) the same steps run on C_i's and G_i's own rows of
// the outputs, which stay in L2 (about 2 MB a stage an instance at b =
// 362 in float64), in CTAs of 512 threads, with the band and the panel
// buffer in shared memory up to b = 848 / 1705 and in a scratch beyond,
// and warp 0 factors each next diagonal block beside the other warps'
// trailing update.  At b = 362, B = 4, float64 that takes about 2.2 ms
// where one block an instance took 122.5 (tools/ab_k7_wide.py; NVIDIA
// H100 80GB HBM3, 700.00 W); what holds it is each diagonal block's chain
// of 16 square roots and quotients (about 750 cycles a column), the
// update loops' loads from shared memory and L2, and the panels fetched
// through L2 (tools/probe_k7_wide.py, PERF.md).
//
// b > 32, the solve (wide_solve_kernel): one CTA an instance, its three
// vectors of b in shared memory up to b = 7146 / 16832 (float64 /
// float32) and in a scratch of device memory beyond.  A round a panel:
// warp 0 runs the panel's 16 column steps by shuffles, each quotient by
// a route from the diagonal's reciprocal (worked out before the chain)
// and two corrections, which gives the division's bits with five
// dependent operations and no call; the other warps update the rows
// beyond the panel and copy the next round's blocks (cp.async).  At
// b = 362, B = 4, float64 about 0.32 ms where a 32-thread block with a
// barrier a column step took 3.16; the chain is about 180 cycles a
// column step in float64 (tools/probe_k7_wide.py).
//
// Every product, sum, quotient and square root is rounded on its own (no
// fused multiply-add in the arithmetic the plain versions define; the
// quotient route's fused residuals are how it reaches the correctly
// rounded quotient), in the order of the plain versions in
// ops/block_tridiag.py: the triangular solves by columns, the Cholesky
// right-looking, column by column.  So kernel and plain version agree bit
// for bit on every path.
//
// What bounds it on the H100: latency.  At the MPC cell (B = 1000, b = 12,
// Nb = 31, float32) the factor reads the band blocks of M and writes C
// and G, about 70 MB (0.02 ms at the HBM rate), and the solve reads C's
// lower triangles and G once, about 30 MB; the work is ~Nb b^3 operations per instance.  What
// sets the time is each instance's chain: per stage b column steps of the
// Cholesky or of each triangular solve, each a quotient (or square root)
// and a shuffle, with about 8 warps an SM to hide them.  The two GEMVs
// with A around the solve (linsys/block_tridiag.py) are not fused here.
// Above a warp the same chains bound it, with few instances on the card:
// at B = 4, b = 362 the factor's bound is 0.0279 ms (operations) and the
// solve's 0.0044 (bytes: C's lower triangles, G, r and x).
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "cluster.cuh"
#include "common.cuh"

namespace {

using osqp_cuda::allow_smem;
using osqp_cuda::mul;
using osqp_cuda::sub;

constexpr int kWarpMax = 32;  // largest b of the warp path
constexpr unsigned kFull = 0xffffffffu;

// Correctly rounded (nvcc's defaults, -prec-div and -prec-sqrt, with no
// --use_fast_math): the plain version's torch division and sqrt.
template <typename T>
__device__ __forceinline__ T quot(T a, T b) {
  return a / b;
}
__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return sqrt(a); }

template <typename T>
__device__ __forceinline__ T not_a_number() {
  return static_cast<T>(NAN);
}

// ---------------------------------------------------------------------------
// 32 < b <= cluster_max_block: one instance over a thread-block
// cluster of k <= 16 CTAs
// ---------------------------------------------------------------------------

#ifdef OSQP_STAMPS
// cycles by phase of the cluster and device paths (tools/probe_k7_cluster.py,
// tools/probe_k7_wide.py): load, G's fetch, G's earlier columns, G's
// panel, G's store and barrier, S's fetch, S's update, the diagonal block
// (on the device path the stage's first), the panel solve, the panel's
// barrier, its fetch, the trailing update (on the device path with the
// next diagonal block's factor), the stage's end
__device__ unsigned long long bt_stamps[2][16];
#endif

constexpr int kPanel = 16;          // columns of a panel, rows of a diagonal block
constexpr int kPitch = kPanel + 1;  // odd: a thread per row reads a column of a panel without bank conflicts
// CTAs of the cluster path: 256 threads, two of them an SM where shared
// memory allows (at most 128 registers a thread: with more, a batch of
// small stages ran in two waves and clusters of 16 fit fewer at a time,
// 2.2x slower at b = 33, B = 8 and 1000; tools/ab_k7_factor.py).
constexpr int kClusterThreads = 256;
// Threads of a CTA of the device path: more warps hide more of the
// strips' loads from L2 (512 against 256: b = 362 f64 2.22 against 2.41
// ms, b = 559 f32 3.74 against 4.96; tools/probe_k7_wide.py, NVIDIA H100
// 80GB HBM3, 700.00 W).
constexpr int kDeviceThreads = 512;
constexpr int kClusterMax = 16;
// Dynamic shared memory a CTA of the cluster path may take: the 227 KB a
// block may use less 64 bytes for the static flag (ops/block_tridiag.py
// sizes by the same figure).
constexpr int kClusterSmem = osqp_cuda::kMaxSmem - 64;

// Shared memory of one CTA of the cluster path, in values: two strips of
// s rows of a stage block (S_i, W_i), the panel buffer (16 rows of
// C_{i-1} at pitch b | 1, or a panel of b rows at pitch kPitch), and the
// diagonal band (every diagonal block of S_i, kPanel x kPitch each).
// ops/block_tridiag.py:_cluster_values repeats this sum.
__host__ __device__ inline size_t panel_values(int b) {
  const size_t rows16 = static_cast<size_t>(kPanel) * (b | 1), cols16 = static_cast<size_t>(kPitch) * b;
  return rows16 > cols16 ? rows16 : cols16;
}
// The panel buffer and the band: what the device path keeps in shared
// memory where it fits (ops/block_tridiag.py:_band_values repeats it), and
// otherwise in a scratch of device memory, this many values a CTA.
__host__ __device__ inline size_t band_values(int b) {
  const size_t blocks = (b + kPanel - 1) / kPanel;
  return panel_values(b) + blocks * kPanel * kPitch;
}
inline size_t cluster_values(int b, int s) { return 2 * static_cast<size_t>(s) * b + band_values(b); }

// Where the kernel below keeps what it works on: everything in shared
// memory (the cluster path); the strips in C_i's and G_i's own slots of
// the outputs, the panel buffer and the band in shared memory (the device
// path); the strips there and the panel buffer and band in a scratch of
// device memory (the device path where those two miss shared memory: b >
// 848 in float64, 1705 in float32).
constexpr int kInShared = 0;
constexpr int kStripsInOutputs = 1;
constexpr int kInDevice = 2;

// Where the quotient route below takes its operands: |d| and |a| within
// [lo, hi], so that 1 / d, a / d, the residuals and their corrections stay
// normal and far from overflow.
template <typename T>
struct RouteRange;
template <>
struct RouteRange<float> {
  static constexpr float lo = 0x1p-30f, hi = 0x1p30f;
};
template <>
struct RouteRange<double> {
  static constexpr double lo = 0x1p-400, hi = 0x1p400;
};

__device__ __forceinline__ float fused(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fused(double a, double b, double c) { return __fma_rn(a, b, c); }

// 1 / d correctly rounded where the route takes d, else 0: worked out for
// a whole stage's diagonal before its chain starts.
template <typename T>
__device__ __forceinline__ T route_reciprocal(T d) {
  const T m = fabs(d);
  return m >= RouteRange<T>::lo && m <= RouteRange<T>::hi ? T(1) / d : T(0);
}

// Whether the route below takes a / d, given rd = route_reciprocal(d): not
// for a zero, a NaN, a failed stage's NaN factor or extreme exponents.
template <typename T>
__device__ __forceinline__ bool route_takes(T a, T rd) {
  const T m = fabs(a);
  return rd != T(0) && m >= RouteRange<T>::lo && m <= RouteRange<T>::hi;
}

// a / d correctly rounded where route_takes(a, rd): q0 = a rd is within
// 1.5 ulp of a / d; one correction q1 = q0 + (a - q0 d) rd makes it
// faithful; a second, q1 + (a - q1 d) rd with the residual exact, is the
// correctly rounded quotient, since rd is the correctly rounded
// reciprocal (Markstein's theorem; the residuals and sums in fused
// multiply-adds, which compute them with one rounding).  Five dependent
// operations on the chain in place of the division's reciprocal
// refinement, and no call: the division's slow path, a call, would keep
// the compiler from loading the next step's operands early.
template <typename T>
__device__ __forceinline__ T route_fast(T a, T d, T rd) {
  const T q0 = mul(a, rd);
  const T q1 = fused(fused(-q0, d, a), rd, q0);
  return fused(fused(-q1, d, a), rd, q1);
}

// The route where it takes a / d, else the division (the zero dividend
// given directly): the same bits as a / d.  chip_smoke.py holds it to the
// division on random and edge-case pairs (osqp_bt_quotients).  The wide
// solve's column steps and the factor's row solves take the route.
template <typename T>
__device__ __forceinline__ T route_quotient(T a, T d, T rd) {
  return route_takes(a, rd) ? route_fast(a, d, rd) : osqp_cuda::quotient(a, d);
}

// Lane r of the calling warp factors row r of the kb x kb block D (pitch
// kPitch, lower) in place, right-looking by columns: column jj's entries
// by shuffle, each lane's row in registers shifted one column a step, so
// that every register index is static (the loop unrolled runs 4% faster
// than rolled, tools/probe_k7_cluster.py).  Returns whether a pivot was
// not positive (the same in every lane).
template <typename T>
__device__ bool factor_block(T* D, int kb) {
  const int r = threadIdx.x & 31;
  T a[kPanel];
#pragma unroll
  for (int u = 0; u < kPanel; ++u) a[u] = r < kb && u <= r ? D[r * kPitch + u] : T(0);
  bool failed = false;
#pragma unroll
  for (int jj = 0; jj < kPanel; ++jj) {
    if (jj >= kb) break;
    const T piv = __shfl_sync(kFull, a[0], jj);
    const T dj = root(piv);
    failed |= !(piv > T(0));
    if (r > jj) a[0] = osqp_cuda::quotient(a[0], dj);
    if (r == jj) a[0] = dj;
    if (r >= jj && r < kb) D[r * kPitch + jj] = a[0];
#pragma unroll
    for (int u = 1; u < kPanel; ++u) {
      const T l = __shfl_sync(kFull, a[0], min(jj + u, 31));
      if (jj + u < kb && r >= jj + u) a[u] = sub(a[u], mul(a[0], l));
    }
#pragma unroll
    for (int u = 0; u + 1 < kPanel; ++u) a[u] = a[u + 1];
    a[kPanel - 1] = T(0);
  }
  return failed;
}

// The steps of solve_row below on the row's values a, the results in out;
// with kDivide false each quotient takes the route (rdl: the reciprocals
// of L's diagonal) and the return says whether the route took them all.
template <bool kDivide, typename T>
__device__ __forceinline__ bool row_steps(T (&a)[kPanel], T (&out)[kPanel], const T* L, int pitch, const T* rdl,
                                          int kb) {
  bool ok = true;
#pragma unroll
  for (int jj = 0; jj < kPanel; ++jj) {
    if (jj >= kb) break;
    T v;
    if (kDivide) {
      v = osqp_cuda::quotient(a[0], L[jj * pitch + jj]);
    } else {
      ok &= route_takes(a[0], rdl[jj]);
      v = route_fast(a[0], L[jj * pitch + jj], rdl[jj]);
    }
    out[jj] = v;
#pragma unroll
    for (int u = 1; u < kPanel; ++u)
      if (jj + u < kb) a[u] = sub(a[u], mul(v, L[(jj + u) * pitch + jj]));
#pragma unroll
    for (int u = 0; u + 1 < kPanel; ++u) a[u] = a[u + 1];
    a[kPanel - 1] = T(0);
  }
  return ok;
}

// x[0, kb) <- x L^-T for the kb x kb lower L at pitch `pitch`, by one
// thread: x[j] = (x[j] - sum_{t<j} x[t] L[j, t]) / L[j, j], right-looking
// over the columns with the values shifted as in factor_block, each
// quotient by the route from rdl (the reciprocals of L's diagonal), or
// by the division where the route does not take one of them.
template <typename T>
__device__ void solve_row(T* x, const T* L, int pitch, const T* rdl, int kb) {
  T a[kPanel], out[kPanel];
#pragma unroll
  for (int u = 0; u < kPanel; ++u) a[u] = u < kb ? x[u] : T(0);
  if (!row_steps<false>(a, out, L, pitch, rdl, kb)) {
#pragma unroll
    for (int u = 0; u < kPanel; ++u) a[u] = u < kb ? x[u] : T(0);
    row_steps<true>(a, out, L, pitch, rdl, kb);
  }
#pragma unroll
  for (int u = 0; u < kPanel; ++u)
    if (u < kb) x[u] = out[u];
}

// The columns c in [c0 + lane, lim) (step 32) of a row sr take sr[c] -
// sum_{t<kt} x[t] P[(c - off) kPitch + t], t ascending, each product and
// difference rounded on its own, with the row's kt values x in
// registers: kIlp columns a lane at a time, so that their loads and
// chains overlap.
template <int kIlp, typename T>
__device__ __forceinline__ void row_update_by(T* sr, const T (&x)[kPanel], const T* P, int off, int c0, int lim,
                                              int kt) {
  for (int c = c0 + (threadIdx.x & 31); c < lim; c += 32 * kIlp) {
    T a[kIlp];
    const T* y[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const bool in = c + 32 * u < lim;
      a[u] = in ? sr[c + 32 * u] : T(0);
      y[u] = P + (in ? c + 32 * u - off : c - off) * kPitch;
    }
#pragma unroll
    for (int t = 0; t < kPanel; ++t)
      if (t < kt) {
#pragma unroll
        for (int u = 0; u < kIlp; ++u) a[u] = sub(a[u], mul(x[t], y[u][t]));
      }
#pragma unroll
    for (int u = 0; u < kIlp; ++u)
      if (c + 32 * u < lim) sr[c + 32 * u] = a[u];
  }
}

// Four columns a lane where the row has more than 32, one where it has
// fewer: the idle slots would cost a batch of small stages as much as the
// work.  The cluster path takes one always: four take registers it needs
// to keep two CTAs an SM without spilling.
template <int kPlace, typename T>
__device__ __forceinline__ void row_update(T* sr, const T (&x)[kPanel], const T* P, int off, int c0, int lim, int kt) {
  if (kPlace != kInShared && lim - c0 > 32)
    row_update_by<4>(sr, x, P, off, c0, lim, kt);
  else
    row_update_by<1>(sr, x, P, off, c0, lim, kt);
}

// The lower triangle of each diagonal block d0 <= d < d1 of the band
// (kPanel x kPitch blocks) less the products of its rows of the panel P,
// whose row r of the stage is at P + (r - off) kPitch: entry (r, c) takes
// sum_{t<kt} P[r][t] P[c][t], t ascending.  The 136 entries of each block
// spread over the nt threads from t0 on, kIlp a thread at a time.
template <int kIlp, typename T>
__device__ __forceinline__ void band_update_by(T* Db, const T* P, int off, int b, int d0, int d1, int kt, int t0,
                                               int nt) {
  constexpr int kTri = kPanel * (kPanel + 1) / 2;
  const int total = (d1 - d0) * kTri;
  for (int e0 = threadIdx.x - t0; e0 < total; e0 += kIlp * nt) {
    T a[kIlp];
    T* v[kIlp];
    const T* x[kIlp];
    const T* y[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int e = e0 + u * nt, w = e % kTri, d = d0 + e / kTri;
      int rr = static_cast<int>((sqrtf(8.0f * w + 1.0f) - 1.0f) * 0.5f);
      if ((rr + 1) * (rr + 2) / 2 <= w) ++rr;
      else if (rr * (rr + 1) / 2 > w) --rr;
      const int cc = w - rr * (rr + 1) / 2, r = d * kPanel + rr;
      const bool in = e < total && r < b;
      v[u] = in ? Db + (d * kPanel + rr) * kPitch + cc : nullptr;
      x[u] = in ? P + (r - off) * kPitch : P;
      y[u] = in ? P + (d * kPanel + cc - off) * kPitch : P;
      a[u] = in ? *v[u] : T(0);
    }
#pragma unroll
    for (int t = 0; t < kPanel; ++t)
      if (t < kt) {
#pragma unroll
        for (int u = 0; u < kIlp; ++u) a[u] = sub(a[u], mul(x[u][t], y[u][t]));
      }
#pragma unroll
    for (int u = 0; u < kIlp; ++u)
      if (v[u]) *v[u] = a[u];
  }
}

// Four entries a thread where the blocks have more than one a thread (not
// on the cluster path, as above).
template <int kPlace, typename T>
__device__ __forceinline__ void band_update(T* Db, const T* P, int off, int b, int d0, int d1, int kt, int t0,
                                            int nt) {
  if (kPlace != kInShared && (d1 - d0) * kPanel * (kPanel + 1) / 2 > nt)
    band_update_by<4>(Db, P, off, b, d0, d1, kt, t0, nt);
  else
    band_update_by<1>(Db, P, off, b, d0, d1, kt, t0, nt);
}

// One instance over a cluster of k CTAs.  CTA q holds rows q, q + k, q +
// 2k, ... of every stage block (s = ceil(b / k) of them at most, dealt
// round the cluster so that every CTA has rows of every length: a stage's
// work grows with the row, and strips of consecutive rows left the top
// CTAs waiting at the barriers for the bottom ones) in two strips: S_i
// (D_i, then D_i - G_i G_i', then C_i) and W_i (O_i, then G_i), in its
// shared memory on the cluster path, in C_i's and G_i's own rows of the
// outputs on the device path (kPlace).  Every CTA also keeps the diagonal
// band, all the 16 x 16 diagonal blocks of S_i, and brings it up to date
// itself, so that each factors every diagonal block on its own and knows
// a failed pivot without asking.  What every CTA needs of the others'
// rows (a panel of C_{i-1}, of G_i, of C_i) goes through L2: its owners
// write it to C or G in device memory, which the factor writes anyway,
// before a cluster barrier, and every CTA loads it from there; reading it
// from the owners' shared memory instead, about a request a cycle at each
// owner, took two to three times as long (PERF.md).  A stage, by panels
// of 16 columns:
//
//   G_i   the panel's 16 rows of C_{i-1}; each row of the strip takes
//         the earlier columns' products (a thread per row and column),
//         then the panel's own columns (a thread per row); no cluster
//         barrier.
//   S_i   after one cluster barrier (G_i whole), G_i's panel of 16
//         columns, all b rows; each CTA subtracts the panel's products
//         from its rows left of their diagonal block and from the band.
//   C_i   right-looking by panels: warp 0 factors the panel's diagonal
//         block from the band; each row of the strip below it solves its
//         panel columns (each quotient by the route from the block's
//         reciprocals), and the rows of the block take the block; one
//         cluster barrier; the panel's columns below the block; each CTA
//         updates its rows' trailing columns and the later diagonal
//         blocks.  On the device path (b above 558 / 361) warp 0 instead
//         brings the next diagonal block up to date first and factors it
//         during the update (a look-ahead: its chain of 16 square roots
//         and quotients runs beside the other warps' update; at b = 140
//         the chain is the longer and the look-ahead cost 10%).
//
// then a cluster barrier before the next stage reads C_i.  So a stage of
// np panels costs np + 1 cluster barriers and no block barrier per
// column.  Every entry takes its products and differences in the plain
// version's order (t ascending, then j ascending), each rounded on its
// own, whichever CTA holds its row: the same bits as the other paths.
template <typename T, int kPlace>
__global__ void __launch_bounds__(kPlace == kInShared ? kClusterThreads : kDeviceThreads,
                                  kPlace == kInShared ? 2 : 1)
cluster_factor_kernel(const T* __restrict__ M, T* __restrict__ C, T* __restrict__ G, T* __restrict__ scratch, int b,
                      int Nb, int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int bad;
  const int k = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int q = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const int rows = q < b ? (b - q + k - 1) / k : 0;  // rows q + k lr, lr < rows
  auto row_of = [&](int lr) { return q + k * lr; };
  const int nblk = (b + kPanel - 1) / kPanel, ldr = b | 1;
  const size_t sb = static_cast<size_t>(s) * b, bb = static_cast<size_t>(b) * b;
  // a strip's row pitch: b in shared memory, k b in the outputs
  const size_t ld = kPlace == kInShared ? static_cast<size_t>(b) : static_cast<size_t>(k) * b;
  constexpr bool kAhead = kPlace != kInShared;
  const size_t n = static_cast<size_t>(Nb) * b;
  const size_t inst = blockIdx.x / k;
  const T* Mi = M + inst * n * n;
  T* Ci = C + inst * static_cast<size_t>(Nb) * bb;
  T* Gi = G + inst * static_cast<size_t>(Nb - 1) * bb;
  T* Sb = reinterpret_cast<T*>(smem);
  T* Wb = Sb + sb;
  T* Pn = kPlace == kInShared ? Wb + sb                                                  // the panel buffer
        : kPlace == kStripsInOutputs ? reinterpret_cast<T*>(smem) : scratch + blockIdx.x * band_values(b);
  T* Db = Pn + panel_values(b);  // the band
  STAMP_DECL(bt_stamps)

  for (int i = 0; i < Nb; ++i) {
    const size_t st = static_cast<size_t>(i) * b;
    T* Cs = Ci + static_cast<size_t>(i) * bb;  // C_i in device memory
    if (kPlace != kInShared) {
      // the strips are this CTA's rows of C_i's and G_i's slots
      Sb = Cs + static_cast<size_t>(q) * b;
      Wb = Gi + (i > 0 ? static_cast<size_t>(i - 1) * bb + static_cast<size_t>(q) * b : 0);
    }
    for (int e = tid; e < rows * b; e += nt) {
      const int lr = e / b, c = e - lr * b;
      const T* row = Mi + (st + row_of(lr)) * n + st;
      Sb[lr * ld + c] = row[c];
      if (i > 0) Wb[lr * ld + c] = row[c - b];
    }
    for (int e = tid; e < nblk * kPanel * kPanel; e += nt) {
      const int d = e / (kPanel * kPanel), rr = (e / kPanel) % kPanel, cc = e % kPanel;
      const int r = d * kPanel + rr;
      if (r < b && cc <= rr) Db[(d * kPanel + rr) * kPitch + cc] = Mi[(st + r) * n + st + d * kPanel + cc];
    }
    if (tid == 0) bad = 0;
    __syncthreads();
    STAMP(0);

    if (i > 0) {
      // G_i = O_i C_{i-1}^-T: G[r, j] = (O[r, j] - sum_{t<j} G[r, t] C[j, t]) / C[j, j]
      const T* Cp = Cs - bb;
      for (int j0 = 0; j0 < b; j0 += kPanel) {
        const int kb = min(kPanel, b - j0);
        osqp_cuda::load_rows_l2(Pn, ldr, Cp + static_cast<size_t>(j0) * b, b, kb, j0 + kb);
        __syncthreads();
        STAMP(1);
        T* rdl = Pn + kPanel * ldr;  // the reciprocals of the panel's diagonal, past its 16 rows
        if (tid < kb) rdl[tid] = route_reciprocal(Pn[tid * ldr + j0 + tid]);
        for (int e = tid; e < rows * kb; e += nt) {
          const int lr = e / kb, jj = e - lr * kb;
          const T* wr = Wb + lr * ld;
          const T* cr = Pn + jj * ldr;
          T acc = wr[j0 + jj];
#pragma unroll 8
          for (int t = 0; t < j0; ++t) acc = sub(acc, mul(wr[t], cr[t]));
          Wb[lr * ld + j0 + jj] = acc;
        }
        __syncthreads();
        STAMP(2);
        for (int lr = tid; lr < rows; lr += nt) solve_row(Wb + lr * ld + j0, Pn + j0, ldr, rdl, kb);
        __syncthreads();
        STAMP(3);
      }
      if (kPlace == kInShared)
        for (int e = tid; e < rows * b; e += nt) {
          const int lr = e / b, c = e - lr * b;
          Gi[static_cast<size_t>(i - 1) * bb + static_cast<size_t>(row_of(lr)) * b + c] = Wb[lr * ld + c];
        }
      osqp_cuda::cluster_barrier();  // G_i whole in device memory
      STAMP(4);

      // D_i - G_i G_i', by panels of G_i's columns: the strip's rows left
      // of their diagonal block, and the band
      for (int t0 = 0; t0 < b; t0 += kPanel) {
        const int kt = min(kPanel, b - t0);
        osqp_cuda::load_rows_l2(Pn, kPitch, Gi + static_cast<size_t>(i - 1) * bb + t0, b, b, kt);
        __syncthreads();
        STAMP(5);
        for (int lr = warp; lr < rows; lr += warps) {
          const int lim = row_of(lr) & ~(kPanel - 1);
          if (lim == 0) continue;
          const T* wr = Wb + lr * ld + t0;
          T x[kPanel];
#pragma unroll
          for (int t = 0; t < kPanel; ++t) x[t] = t < kt ? wr[t] : T(0);
          row_update<kPlace>(Sb + lr * ld, x, Pn, 0, 0, lim, kt);
        }
        band_update<kPlace>(Db, Pn, 0, b, 0, nblk, kt, 0, nt);
        __syncthreads();
        STAMP(6);
      }
    }

    // C_i = chol(S_i), right-looking by panels; on the device path warp 0
    // factors each diagonal block after the first during the trailing
    // update before it (kAhead)
    if (kAhead && tid < 32) {
      const bool failed = factor_block(Db, min(kPanel, b));
      if (tid == 0 && failed) bad = 1;
    }
    for (int p = 0; p < nblk; ++p) {
      const int j0 = p * kPanel, kb = min(kPanel, b - j0), base = j0 + kb;
      T* D = Db + p * kPanel * kPitch;
      T* rdl = Pn;  // the reciprocals of the block's diagonal (the panel buffer is free until the next panel)
      if (tid < 32) {
        if (!kAhead) {
          const bool failed = factor_block(D, kb);
          if (tid == 0 && failed) bad = 1;
          __syncwarp();
        }
        if (tid < kb) rdl[tid] = route_reciprocal(D[tid * kPitch + tid]);
      }
      __syncthreads();
      STAMP(7);
      // the strip's rows below the block solve the panel's columns and
      // publish them in C_i; its rows of the block take the block
      for (int lr = tid; lr < rows; lr += nt) {
        const int r = row_of(lr);
        T* sr = Sb + lr * ld + j0;
        if (r >= base) {
          solve_row(sr, D, kPitch, rdl, kb);
          if (kPlace == kInShared)
            for (int jj = 0; jj < kb; ++jj) Cs[static_cast<size_t>(r) * b + j0 + jj] = sr[jj];
        } else if (r >= j0) {
          for (int c = 0; c <= r - j0; ++c) sr[c] = D[(r - j0) * kPitch + c];
        }
      }
      STAMP(8);
      if (base == b) break;
      osqp_cuda::cluster_barrier();  // the panel's columns below the block in device memory
      STAMP(9);
      osqp_cuda::load_rows_l2(Pn, kPitch, Cs + static_cast<size_t>(base) * b + j0, b, b - base, kb);
      __syncthreads();
      STAMP(10);
      // trailing update: warp 0 brings the next diagonal block up to date
      // and factors it; the other warps take the strip's rows below the
      // panel, left of their diagonal block, and the later diagonal blocks
      if (kAhead && warp == 0) {
        band_update<kPlace>(Db, Pn, base, b, p + 1, p + 2, kb, 0, 32);
        __syncwarp();
        const bool failed = factor_block(Db + (p + 1) * kPanel * kPitch, min(kPanel, b - base));
        if (lane == 0 && failed) bad = 1;
      } else {
        const int w0 = kAhead ? 1 : 0;
        for (int lr = warp - w0; lr < rows; lr += warps - w0) {
          T* sr = Sb + lr * ld;
          const int lim = row_of(lr) & ~(kPanel - 1);
          if (lim <= base) continue;
          T x[kPanel];
#pragma unroll
          for (int t = 0; t < kPanel; ++t) x[t] = t < kb ? sr[j0 + t] : T(0);
          row_update<kPlace>(sr, x, Pn, base, base, lim, kb);
        }
        band_update<kPlace>(Db, Pn, base, b, kAhead ? p + 2 : p + 1, nblk, kb, kAhead ? 32 : 0,
                            kAhead ? nt - 32 : nt);
      }
      __syncthreads();
      STAMP(11);
    }
    __syncthreads();
    const bool failed = bad != 0;
    for (int e = tid; e < rows * b; e += nt) {
      const int lr = e / b, c = e - lr * b, r = row_of(lr);
      Cs[static_cast<size_t>(r) * b + c] = c <= r ? (failed ? not_a_number<T>() : Sb[lr * ld + c]) : T(0);
    }
    // C_i whole in device memory for the next stage's G
    osqp_cuda::cluster_barrier();
    STAMP(12);
  }
}

// ---------------------------------------------------------------------------
// The solve at b > 32: one CTA an instance, by panels of 16 columns
// ---------------------------------------------------------------------------

constexpr int kSolveMaxWarps = 12;

// The column steps of a panel of the wide solve, by warp 0: lane r holds
// entry r of the panel in v and its line of the diagonal block D (pitch
// kPitch, lower) in dl, its row forward and its column backward; rd holds
// the reciprocals of D's diagonal.  Step j takes entry j from lane j, and
// every lane works out the quotient v_j / D_jj itself (no lane waits at a
// branch), lane j keeping it; forward the lanes k > j then take v_k -=
// D_kj y_j (j ascending), backward the lanes k < j take v_k -= D_jk x_j
// (j descending).  With kDivide false each quotient takes the route and
// the return says whether the route took them all; with kDivide true,
// the division.
template <bool kForward, bool kDivide, typename T>
__device__ __forceinline__ bool panel_chain(T& v, const T (&dl)[kPanel], const T* D, const T* rd, int kb) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
#pragma unroll
  for (int s = 0; s < kPanel; ++s) {
    const int jj = kForward ? s : kPanel - 1 - s;
    if (jj < kb) {
      const T a = __shfl_sync(kFull, v, jj), d = D[jj * kPitch + jj];
      T q;
      if (kDivide) {
        q = osqp_cuda::quotient(a, d);
      } else {
        ok &= route_takes(a, rd[jj]);
        q = route_fast(a, d, rd[jj]);
      }
      const T vk = sub(v, mul(dl[jj], q));
      v = lane == jj ? q : ((kForward ? lane > jj : lane < jj) ? vk : v);
    }
  }
  return ok;
}

template <typename T>
__global__ void quotient_kernel(const T* __restrict__ a, const T* __restrict__ d, T* __restrict__ out, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = route_quotient(a[e], d[e], route_reciprocal(d[e]));
}

// Copies the blocks of C_i a round of the solve reads, into one of two
// buffers (by round parity) of two kPanel x kPitch blocks: the diagonal
// block of the panel at rows [j0, j0 + kb), lower, and the block at rows
// [r1, r1 + kr) x columns [c1, c1 + 16) beside it (forward: the panel's
// rows, the panel before's columns; backward: the panel after's rows,
// this panel's columns), by threads [t0, t0 + nt) of the block, by
// asynchronous copies: the caller's copy_async_wait and block barrier end
// them.
template <typename T>
__device__ __forceinline__ void stage_blocks(T* buf, const T* c, int b, int j0, int kb, int r1, int kr, int c1,
                                             int t0, int nt) {
  for (int e = threadIdx.x - t0; e < 2 * kPanel * kPanel; e += nt) {
    const int which = e / (kPanel * kPanel), u = (e / kPanel) % kPanel, w = e % kPanel;
    if (which == 0) {
      if (u < kb && w <= u) osqp_cuda::copy_async(buf + u * kPitch + w, c + static_cast<size_t>(j0 + u) * b + j0 + w);
    } else if (u < kr) {
      osqp_cuda::copy_async(buf + (kPanel + u) * kPitch + w, c + static_cast<size_t>(r1 + u) * b + c1 + w);
    }
  }
}

// Rows [k0, k0 + 32) x columns [t0, t0 + kt) of A (row pitch lda, device
// memory; rows from kend on and columns from kt on read as 0) into the
// calling warp's registers, two rows an instruction: each row's 16 values
// are one line, so a load takes two lines and not 32.
template <typename T>
__device__ __forceinline__ void fetch_tile(T (&reg)[kPanel], const T* A, size_t lda, int k0, int kend, int t0,
                                           int kt) {
  const int lane = threadIdx.x & 31, half = lane >> 4, col = lane & 15;
#pragma unroll
  for (int u = 0; u < kPanel; ++u) {
    const int row = k0 + 2 * u + half;
    reg[u] = row < kend && col < kt ? __ldg(A + static_cast<size_t>(row) * lda + t0 + col) : T(0);
  }
}

// acc - sum_{tt < kt} A[k0 + lane][t0 + tt] v[t0 + tt], tt ascending,
// with the tile fetch_tile brought: through the warp's tile of shared
// memory, each lane reading its row back.
template <typename T>
__device__ __forceinline__ T minus_tile(T acc, const T (&reg)[kPanel], int t0, int kt, const T* v, T* tile) {
  const int lane = threadIdx.x & 31, half = lane >> 4, col = lane & 15;
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kPanel; ++u) tile[(2 * u + half) * kPitch + col] = reg[u];
  __syncwarp();
#pragma unroll
  for (int tt = 0; tt < kPanel; ++tt)
    if (tt < kt) acc = sub(acc, mul(tile[lane * kPitch + tt], v[t0 + tt]));
  return acc;
}

// x = M^-1 r for b > 32, one CTA an instance, y kept in x's memory.  A
// stage of either pass: the product with G (forward r_i - G_i y_{i-1}, a
// warp per 32 rows with G_i's rows through its tile and the next tile
// loading while one is taken; backward y_i - G_{i+1}' x_{i+1}, a thread
// per column; each entry's terms t ascending) and the reciprocals of C_i's
// diagonal; then one round a panel of 16 columns, each ended by a block
// barrier.  In round p warp 0 solves panel p: lane r brings entry r of the
// panel up to date with the panel before (its y_{p-1} or x_{p+1} read
// from shared memory) and holds its line of the diagonal block, then the
// 16 column steps run by shuffles (panel_chain), each quotient by the
// route from the reciprocals, with no call on the chain.  The other warps
// meanwhile bring the rows beyond the panel up to date with the panel
// before and copy the next round's two blocks of C_i into shared memory
// (cp.async).  So the chain a round is 16 quotients with their products
// and one barrier, and every entry takes its terms in the plain version's
// order (forward j ascending, backward j descending, each rounded on its
// own).  The stage's entries (then its y or x), the other stage's (y_{i-1}
// forward, x_{i+1} backward) and the reciprocals of C_i's diagonal live in
// shared memory, or with kVecsInDevice in vecs (3 b values an instance),
// where they do not fit beside the blocks and the tiles: a template
// parameter, so that the compiler knows every access to shared memory as
// such and makes none of them generic (a runtime choice cost the chain
// about 8%).
#ifdef OSQP_STAMPS
// cycles by phase of warp 0 of the wide solve (tools/probe_k7_wide.py),
// forward then backward: the stage's product with G, the panel's rows,
// the column steps, the stores, the round's barrier
__device__ unsigned long long bt_solve_stamps[2][16];
#endif
template <typename T, bool kVecsInDevice>
__global__ void __launch_bounds__(32 * kSolveMaxWarps)
wide_solve_kernel(const T* __restrict__ C, const T* __restrict__ G, const T* __restrict__ rhs, T* __restrict__ x,
                  T* vecs, int b, int Nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cur = kVecsInDevice ? vecs + blockIdx.x * 3 * static_cast<size_t>(b) : reinterpret_cast<T*>(smem);
  T* prev = cur + b;
  T* rd = prev + b;
  T* blocks = kVecsInDevice ? reinterpret_cast<T*>(smem) : rd + b;  // [2 rounds][2 blocks][kPanel][kPitch]
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  T* tile = blocks + 4 * kPanel * kPitch + warp * 32 * kPitch;  // this warp's 32 x 16 tile
  const int np = (b + kPanel - 1) / kPanel;
  const size_t bb = static_cast<size_t>(b) * b, n = static_cast<size_t>(Nb) * b;
  const T* Ci = C + blockIdx.x * static_cast<size_t>(Nb) * bb;
  const T* Gi = G + blockIdx.x * static_cast<size_t>(Nb - 1) * bb;
  const T* ri = rhs + blockIdx.x * n;
  T* xi = x + blockIdx.x * n;
  auto buffer = [&](int p) { return blocks + (p & 1) * 2 * kPanel * kPitch; };
  auto width = [&](int p) { return min(kPanel, b - p * kPanel); };
  STAMP_DECL(bt_solve_stamps)

  // Forward: y_i = C_i^-1 (r_i - G_i y_{i-1}).
  for (int i = 0; i < Nb; ++i) {
    const T* c = Ci + static_cast<size_t>(i) * bb;
    stage_blocks(buffer(0), c, b, 0, width(0), 0, 0, 0, 0, nt);
    for (int j = tid; j < b; j += nt) rd[j] = route_reciprocal(__ldg(c + static_cast<size_t>(j) * b + j));
    // r_i - G_i y_{i-1}: a warp per 32 rows, G_i's rows through its tile,
    // the next 16 columns loading while these are taken
    for (int k0 = warp * 32; k0 < b; k0 += nt) {
      const int j = k0 + lane;
      T acc = j < b ? ri[static_cast<size_t>(i) * b + j] : T(0);
      if (i > 0) {
        const T* g = Gi + static_cast<size_t>(i - 1) * bb;
        T reg[kPanel], next[kPanel];
        fetch_tile(next, g, b, k0, b, 0, min(kPanel, b));
        for (int t0 = 0; t0 < b; t0 += kPanel) {
#pragma unroll
          for (int u = 0; u < kPanel; ++u) reg[u] = next[u];
          if (t0 + kPanel < b) fetch_tile(next, g, b, k0, b, t0 + kPanel, min(kPanel, b - t0 - kPanel));
          acc = minus_tile(acc, reg, t0, min(kPanel, b - t0), prev, tile);
        }
      }
      if (j < b) cur[j] = acc;
    }
    osqp_cuda::copy_async_wait();
    __syncthreads();
    STAMP(0);
    for (int p = 0; p < np; ++p) {
      const int j0 = p * kPanel, kb = width(p);
      const T* D = buffer(p);
      if (warp == 0) {
        const T* L = D + kPanel * kPitch;  // rows of panel p, columns of panel p - 1
        T v = lane < kb ? cur[j0 + lane] : T(0), dl[kPanel];
#pragma unroll
        for (int u = 0; u < kPanel; ++u) dl[u] = lane < kb && u <= lane ? D[lane * kPitch + u] : T(0);
        if (p > 0 && lane < kb) {
#pragma unroll
          for (int jj = 0; jj < kPanel; ++jj) v = sub(v, mul(L[lane * kPitch + jj], cur[j0 - kPanel + jj]));
        }
        STAMP(1);
        const T v0 = v;
        if (!panel_chain<true, false>(v, dl, D, rd + j0, kb)) {
          v = v0;  // a quotient the route does not take: the panel again by the division
          panel_chain<true, true>(v, dl, D, rd + j0, kb);
        }
        STAMP(2);
        if (lane < kb) {
          cur[j0 + lane] = v;
          xi[static_cast<size_t>(i) * b + j0 + lane] = v;
        }
        STAMP(3);
      } else {
        if (p + 1 < np) stage_blocks(buffer(p + 1), c, b, j0 + kPanel, width(p + 1), j0 + kPanel, width(p + 1), j0, 32,
                                     nt - 32);
        if (p > 0) {
          // rows beyond this panel take the panel before, j ascending, a
          // warp per 32 rows, C_i's panel columns through its tile
          for (int k0 = j0 + kb + (warp - 1) * 32; k0 < b; k0 += nt - 32) {
            const int k = k0 + lane;
            T reg[kPanel];
            fetch_tile(reg, c, b, k0, b, j0 - kPanel, kPanel);
            const T acc = minus_tile(k < b ? cur[k] : T(0), reg, j0 - kPanel, kPanel, cur, tile);
            if (k < b) cur[k] = acc;
          }
        }
        osqp_cuda::copy_async_wait();
      }
      __syncthreads();
      STAMP(4);
    }
    T* t = cur;
    cur = prev;
    prev = t;
  }

  // Backward: x_i = C_i^-T (y_i - G_{i+1}' x_{i+1}).
  for (int i = Nb - 1; i >= 0; --i) {
    const T* c = Ci + static_cast<size_t>(i) * bb;
    stage_blocks(buffer(np - 1), c, b, (np - 1) * kPanel, width(np - 1), 0, 0, 0, 0, nt);
    for (int j = tid; j < b; j += nt) {
      T acc = xi[static_cast<size_t>(i) * b + j];
      if (i + 1 < Nb) {
        const T* g = Gi + static_cast<size_t>(i) * bb + j;
#pragma unroll 16
        for (int t = 0; t < b; ++t) acc = sub(acc, mul(__ldg(g + static_cast<size_t>(t) * b), prev[t]));
      }
      cur[j] = acc;
      rd[j] = route_reciprocal(__ldg(c + static_cast<size_t>(j) * b + j));
    }
    osqp_cuda::copy_async_wait();
    __syncthreads();
    STAMP(5);
    for (int p = np - 1; p >= 0; --p) {
      const int j0 = p * kPanel, kb = width(p);
      const T* D = buffer(p);
      if (warp == 0) {
        const T* U = D + kPanel * kPitch;  // rows of panel p + 1, columns of panel p
        T v = lane < kb ? cur[j0 + lane] : T(0), dl[kPanel];
#pragma unroll
        for (int u = 0; u < kPanel; ++u) dl[u] = lane < kb && u >= lane && u < kb ? D[u * kPitch + lane] : T(0);
        if (p + 1 < np && lane < kb) {
          const int jn = j0 + kPanel, kn = width(p + 1);
#pragma unroll
          for (int u = kPanel - 1; u >= 0; --u)
            if (u < kn) v = sub(v, mul(U[u * kPitch + lane], cur[jn + u]));
        }
        STAMP(6);
        const T v0 = v;
        if (!panel_chain<false, false>(v, dl, D, rd + j0, kb)) {
          v = v0;
          panel_chain<false, true>(v, dl, D, rd + j0, kb);
        }
        STAMP(7);
        if (lane < kb) {
          cur[j0 + lane] = v;
          xi[static_cast<size_t>(i) * b + j0 + lane] = v;
        }
        STAMP(8);
      } else {
        if (p > 0) stage_blocks(buffer(p - 1), c, b, j0 - kPanel, kPanel, j0, kb, j0 - kPanel, 32, nt - 32);
        if (p + 1 < np) {
          // rows above this panel take the panel after, j descending
          const int jn = j0 + kPanel, kn = width(p + 1);
          for (int k = tid - 32; k < j0; k += nt - 32) {
            T acc = cur[k];
#pragma unroll
            for (int u = kPanel - 1; u >= 0; --u)
              if (u < kn) acc = sub(acc, mul(__ldg(c + static_cast<size_t>(jn + u) * b + k), cur[jn + u]));
            cur[k] = acc;
          }
        }
        osqp_cuda::copy_async_wait();
      }
      __syncthreads();
      STAMP(9);
    }
    T* t = cur;
    cur = prev;
    prev = t;
  }
}

// ---------------------------------------------------------------------------
// b <= 32: a warp per instance, kWarpInstances instances a block
// ---------------------------------------------------------------------------

constexpr int kWarpInstances = 4;

// C_i, G_i of a warp's instance: lane r holds row r of the stage.  G_i's
// row by its column solve against C_{i-1} (in shared memory, read by
// broadcast), D_i - G_i G_i' from G_i's rows in shared memory, then the
// Cholesky right-looking by columns: column j's entries come by shuffle
// from the lanes that hold them.  The next stage's band rows (one
// contiguous segment of 2 b values a lane) are loaded while this stage
// runs.  Every value takes its operations in the plain version's order.
template <typename T, int BM>
__global__ void __launch_bounds__(32 * kWarpInstances)
warp_factor_kernel(const T* __restrict__ M, T* __restrict__ C, T* __restrict__ G, int B, int b, int Nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t inst = static_cast<size_t>(blockIdx.x) * kWarpInstances + warp;
  if (inst >= static_cast<size_t>(B)) return;
  const int bb = b * b;
  T* Cp = reinterpret_cast<T*>(smem) + static_cast<size_t>(warp) * 2 * bb;  // C_{i-1}
  T* Gs = Cp + bb;                                                          // G_i
  const bool own = lane < b;
  const int r = own ? lane : 0;
  const size_t n = static_cast<size_t>(Nb) * b;
  const T* Mi = M + inst * n * n;
  T* Ci = C + inst * static_cast<size_t>(Nb) * bb;
  T* Gi = G + inst * static_cast<size_t>(Nb - 1) * bb;

  // row r of D_i and of O_i
  T d[BM], o[BM], dn[BM], on[BM];
  auto load = [&](int i, T (&dr)[BM], T (&orow)[BM]) {
    const T* row = Mi + (static_cast<size_t>(i) * b + r) * n + static_cast<size_t>(i) * b;
#pragma unroll
    for (int t = 0; t < BM; ++t) {
      dr[t] = own && t < b ? row[t] : T(0);
      orow[t] = own && t < b && i > 0 ? row[t - b] : T(0);
    }
  };
  load(0, d, o);
  for (int i = 0; i < Nb; ++i) {
    if (i + 1 < Nb) load(i + 1, dn, on);
    T s[BM];
#pragma unroll
    for (int c = 0; c < BM; ++c) s[c] = d[c];
    if (i > 0) {
      // G_i = O_i C_{i-1}^-T: g[j] = (o[j] - sum_{t<j} g[t] C[j, t]) / C[j, j]
      T g[BM];
#pragma unroll
      for (int j = 0; j < BM; ++j) {
        if (j < b) {
          T acc = o[j];
#pragma unroll
          for (int t = 0; t < j; ++t) acc = sub(acc, mul(g[t], Cp[j * b + t]));
          g[j] = own ? quot(acc, Cp[j * b + j]) : T(0);
        } else {
          g[j] = T(0);
        }
      }
      __syncwarp();  // the last stage's Gs is read
      if (own) {
#pragma unroll
        for (int t = 0; t < BM; ++t) {
          if (t < b) {
            Gs[r * b + t] = g[t];
            Gi[static_cast<size_t>(i - 1) * bb + r * b + t] = g[t];
          }
        }
      }
      __syncwarp();
      // D_i - G_i G_i', in increasing t: the whole row, without a branch
      // by lane, so that the b chains interleave (the entries above the
      // diagonal are never read)
#pragma unroll
      for (int c = 0; c < BM; ++c) {
        if (c < b) {
          T acc = s[c];
#pragma unroll
          for (int t = 0; t < BM; ++t)
            if (t < b) acc = sub(acc, mul(g[t], Gs[c * b + t]));
          s[c] = acc;
        }
      }
    }
    // C_i = chol(S), right-looking, column by column
    bool bad = false;
#pragma unroll
    for (int j = 0; j < BM; ++j) {
      if (j < b) {
        const T piv = __shfl_sync(kFull, s[j], j);
        const T dj = root(piv);
        bad |= !(piv > T(0));
        if (lane > j && own) s[j] = quot(s[j], dj);
        if (lane == j) s[j] = dj;
#pragma unroll
        for (int c = j + 1; c < BM; ++c) {
          if (c < b) {
            const T scj = __shfl_sync(kFull, s[j], c);
            s[c] = sub(s[c], mul(s[j], scj));  // read where c <= lane only
          }
        }
      }
    }
    __syncwarp();  // Cp is read
    if (own) {
#pragma unroll
      for (int c = 0; c < BM; ++c) {
        if (c < b) {
          const T v = c <= r ? (bad ? not_a_number<T>() : s[c]) : T(0);
          Ci[static_cast<size_t>(i) * bb + r * b + c] = v;
          Cp[r * b + c] = v;
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < BM; ++t) {
      d[t] = dn[t];
      o[t] = on[t];
    }
  }
}

// Both passes of the solve, lane r holding entry r of the stage: forward
// with row r of C_i and G_i in registers, y_{i-1} by shuffle; backward
// with column r of C_i and of G_{i+1}, x_{i+1} by shuffle.  At column
// step j every lane takes entry j and the diagonal C_i[j][j] from lane j
// and divides them itself: every lane computes lane j's quotient, and no
// lane waits at a branch that lane j alone takes.  The next stage's
// blocks are loaded while this stage runs.  y is kept in x's memory,
// each entry read back by the lane that wrote it.
template <typename T, int BM>
__global__ void __launch_bounds__(32 * kWarpInstances)
warp_solve_kernel(const T* __restrict__ C, const T* __restrict__ G, const T* __restrict__ rhs, T* __restrict__ x,
                  int B, int b, int Nb) {
  const int lane = threadIdx.x & 31;
  const size_t inst = static_cast<size_t>(blockIdx.x) * kWarpInstances + (threadIdx.x >> 5);
  if (inst >= static_cast<size_t>(B)) return;
  const int bb = b * b;
  const bool own = lane < b;
  const int r = own ? lane : 0;
  const size_t n = static_cast<size_t>(Nb) * b;
  const T* Ci = C + inst * static_cast<size_t>(Nb) * bb;
  const T* Gi = G + inst * static_cast<size_t>(Nb - 1) * bb;
  const T* ri = rhs + inst * n;
  T* xi = x + inst * n;
  T c[BM], g[BM], cn[BM], gn[BM];
  T v, vn;

  // forward: row r of C_i and of G_i (stage i >= 1), entry r of r_i
  auto rows = [&](int i, T (&cr)[BM], T (&gr)[BM], T& rv) {
#pragma unroll
    for (int t = 0; t < BM; ++t) {
      cr[t] = own && t < b ? Ci[static_cast<size_t>(i) * bb + r * b + t] : T(0);
      gr[t] = own && t < b && i > 0 ? Gi[static_cast<size_t>(i - 1) * bb + r * b + t] : T(0);
    }
    rv = own ? ri[static_cast<size_t>(i) * b + r] : T(0);
  };
  rows(0, c, g, v);
  T y = T(0);  // entry `lane` of y_{i-1}
  for (int i = 0; i < Nb; ++i) {
    if (i + 1 < Nb) rows(i + 1, cn, gn, vn);
    if (i > 0) {
#pragma unroll
      for (int t = 0; t < BM; ++t) {
        const T yt = __shfl_sync(kFull, y, t);
        if (t < b) v = sub(v, mul(g[t], yt));
      }
    }
#pragma unroll
    for (int j = 0; j < BM; ++j) {
      if (j < b) {
        const T yj = quot(__shfl_sync(kFull, v, j), __shfl_sync(kFull, c[j], j));
        const T vk = sub(v, mul(c[j], yj));
        v = lane == j ? yj : (lane > j ? vk : v);
      }
    }
    y = v;
    if (own) xi[static_cast<size_t>(i) * b + r] = y;
#pragma unroll
    for (int t = 0; t < BM; ++t) {
      c[t] = cn[t];
      g[t] = gn[t];
    }
    v = vn;
  }

  // backward: column r of C_i and of G_{i+1}, entry r of y_i
  auto cols = [&](int i, T (&cc)[BM], T (&gc)[BM], T& yv) {
#pragma unroll
    for (int t = 0; t < BM; ++t) {
      cc[t] = own && t < b ? Ci[static_cast<size_t>(i) * bb + t * b + r] : T(0);
      gc[t] = own && t < b && i + 1 < Nb ? Gi[static_cast<size_t>(i) * bb + t * b + r] : T(0);
    }
    yv = own ? xi[static_cast<size_t>(i) * b + r] : T(0);
  };
  cols(Nb - 1, c, g, v);
  T xn = T(0);  // entry `lane` of x_{i+1}
  for (int i = Nb - 1; i >= 0; --i) {
    if (i > 0) cols(i - 1, cn, gn, vn);
    if (i + 1 < Nb) {
#pragma unroll
      for (int t = 0; t < BM; ++t) {
        const T xt = __shfl_sync(kFull, xn, t);
        if (t < b) v = sub(v, mul(g[t], xt));
      }
    }
#pragma unroll
    for (int j = BM - 1; j >= 0; --j) {
      if (j < b) {
        const T xj = quot(__shfl_sync(kFull, v, j), __shfl_sync(kFull, c[j], j));
        const T vk = sub(v, mul(c[j], xj));
        v = lane == j ? xj : (lane < j ? vk : v);
      }
    }
    xn = v;
    if (own) xi[static_cast<size_t>(i) * b + r] = xn;
#pragma unroll
    for (int t = 0; t < BM; ++t) {
      c[t] = cn[t];
      g[t] = gn[t];
    }
    v = vn;
  }
}

template <typename T, int BM>
int launch_warp(const void* M, void* C, void* G, const void* rhs, void* x, int B, int b, int Nb, bool factor,
                cudaStream_t s) {
  const int blocks = (B + kWarpInstances - 1) / kWarpInstances;
  if (factor) {
    const size_t smem = static_cast<size_t>(kWarpInstances) * 2 * b * b * sizeof(T);
    const cudaError_t err = allow_smem(warp_factor_kernel<T, BM>, smem);
    if (err != cudaSuccess) return err;
    warp_factor_kernel<T, BM><<<blocks, 32 * kWarpInstances, smem, s>>>(
        static_cast<const T*>(M), static_cast<T*>(C), static_cast<T*>(G), B, b, Nb);
  } else {
    warp_solve_kernel<T, BM><<<blocks, 32 * kWarpInstances, 0, s>>>(
        static_cast<const T*>(C), static_cast<const T*>(G), static_cast<const T*>(rhs), static_cast<T*>(x), B, b, Nb);
  }
  return cudaGetLastError();
}

// The warp path at b <= 32, its register arrays sized by b.
template <typename T>
int warp_path(const void* M, void* C, void* G, const void* rhs, void* x, int B, int b, int Nb, bool factor,
              cudaStream_t s) {
  if (b <= 8) return launch_warp<T, 8>(M, C, G, rhs, x, B, b, Nb, factor, s);
  if (b <= 16) return launch_warp<T, 16>(M, C, G, rhs, x, B, b, Nb, factor, s);
  return launch_warp<T, 32>(M, C, G, rhs, x, B, b, Nb, factor, s);
}

// B clusters of k CTAs, each CTA's strip s = ceil(b / k) rows, with what
// the kernel keeps placed by kPlace and `smem` bytes of shared memory.
template <typename T, int kPlace>
int launch_cluster(const T* M, T* C, T* G, T* scratch, int B, int b, int Nb, int k, size_t smem, cudaStream_t s) {
  const int strip = (b + k - 1) / k;
  auto kernel = cluster_factor_kernel<T, kPlace>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = allow_smem(kernel, smem, sizeof(int));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * k);
  cfg.blockDim = dim3(kPlace == kInShared ? kClusterThreads : kDeviceThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, M, C, G, scratch, b, Nb, strip);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The cluster path (strips in shared memory) and the device path (strips
// in the outputs; the panel buffer and the band in shared memory where
// they fit, else in `scratch`, band_values(b) values a CTA, which the
// caller allocates).  A size the card cannot take is refused
// (cudaErrorInvalidValue, or the launch's own error), never replaced by
// another path.
template <typename T>
int cluster_factor(const T* M, T* C, T* G, T* scratch, int B, int b, int Nb, int k, bool device,
                   cudaStream_t s) {
  if (k < 1 || k > kClusterMax || static_cast<long long>(B) * k > INT_MAX) return cudaErrorInvalidValue;
  if (!device) {
    const size_t smem = cluster_values(b, (b + k - 1) / k) * sizeof(T);
    if (smem > static_cast<size_t>(kClusterSmem)) return cudaErrorInvalidValue;
    return launch_cluster<T, kInShared>(M, C, G, nullptr, B, b, Nb, k, smem, s);
  }
  const size_t smem = band_values(b) * sizeof(T);
  if (smem <= static_cast<size_t>(kClusterSmem))
    return launch_cluster<T, kStripsInOutputs>(M, C, G, nullptr, B, b, Nb, k, smem, s);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  return launch_cluster<T, kInDevice>(M, C, G, scratch, B, b, Nb, k, 0, s);
}

// path: 0 the warp path (b <= 32), 1 the cluster path, 2 the device path,
// both in clusters of `cluster` CTAs.
template <typename T>
int factor(const void* M, void* C, void* G, void* scratch, int B, int b, int Nb, int path, int cluster,
           cudaStream_t s) {
  if (path == 0) {
    if (b > kWarpMax) return cudaErrorInvalidValue;
    return warp_path<T>(M, C, G, nullptr, nullptr, B, b, Nb, true, s);
  }
  if (path != 1 && path != 2) return cudaErrorInvalidValue;
  return cluster_factor<T>(static_cast<const T*>(M), static_cast<T*>(C), static_cast<T*>(G), static_cast<T*>(scratch),
                           B, b, Nb, cluster, path == 2, s);
}

// Shared memory of a CTA of the solve above a warp of `warps` warps: this
// stage's entries, the other stage's and the reciprocals (with
// `vectors`), two rounds of two blocks, a 32 x 16 tile a warp
// (ops/block_tridiag.py:_solve_values repeats it).
inline size_t solve_values(int b, int warps, bool vectors) {
  return (vectors ? 3 * static_cast<size_t>(b) : 0) + 4 * kPanel * kPitch + static_cast<size_t>(warps) * 32 * kPitch;
}

// warps: 0 the warp path (b <= 32), else the wide solve in CTAs of that
// many warps (2 to kSolveMaxWarps); vecs null keeps its vectors in shared
// memory, else it holds them (3 b values an instance).
template <typename T>
int solve(const void* C, const void* G, const void* rhs, void* x, void* vecs, int B, int b, int Nb, int warps,
          cudaStream_t s) {
  if (warps == 0) {
    if (b > kWarpMax) return cudaErrorInvalidValue;
    return warp_path<T>(nullptr, const_cast<void*>(C), const_cast<void*>(G), rhs, x, B, b, Nb, false, s);
  }
  if (warps < 2 || warps > kSolveMaxWarps) return cudaErrorInvalidValue;
  const size_t smem = solve_values(b, warps, vecs == nullptr) * sizeof(T);
  if (smem > static_cast<size_t>(osqp_cuda::kMaxSmem)) return cudaErrorInvalidValue;
  const auto kernel = vecs ? wide_solve_kernel<T, true> : wide_solve_kernel<T, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32 * warps, smem, s>>>(static_cast<const T*>(C), static_cast<const T*>(G), static_cast<const T*>(rhs),
                                     static_cast<T*>(x), static_cast<T*>(vecs), b, Nb);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  M (B, Nb b, Nb b) contiguous; writes C
// (B, Nb, b, b) and G (B, Nb-1, b, b), contiguous.  path as factor()
// above, named by the wrapper (ops/block_tridiag.py:factor_path, and
// cluster_plan / device_plan for the CTAs a cluster); scratch, used by the
// device path where its band misses shared memory, B cluster band_values
// values; a path that does not take b returns cudaErrorInvalidValue.
extern "C" int osqp_bt_factor(int dtype, const void* M, void* C, void* G, void* scratch, int B, int b, int Nb,
                              int path, int cluster, void* stream) {
  if (B == 0 || b == 0 || Nb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? factor<float>(M, C, G, scratch, B, b, Nb, path, cluster, s)
                    : factor<double>(M, C, G, scratch, B, b, Nb, path, cluster, s);
}

#ifdef OSQP_STAMPS
// The cluster and device paths' cycles by phase since the last call, [CTA
// 0, CTA k - 1 of the first instance][16 phases], and zero them; with
// `solve` nonzero the wide solve's ([CTA 0][16 phases]).
extern "C" int osqp_bt_stamps(unsigned long long* out, int solve) {
  static const unsigned long long zero[2][16] = {};
  cudaError_t err = solve ? cudaMemcpyFromSymbol(out, bt_solve_stamps, sizeof(zero))
                          : cudaMemcpyFromSymbol(out, bt_stamps, sizeof(zero));
  if (err == cudaSuccess)
    err = solve ? cudaMemcpyToSymbol(bt_solve_stamps, zero, sizeof(zero))
                : cudaMemcpyToSymbol(bt_stamps, zero, sizeof(zero));
  return err;
}
#endif

// x = M^-1 rhs with the factors above; rhs and x (B, Nb b), contiguous;
// warps and scratch (vecs) as solve() above (ops/block_tridiag.py:
// solve_plan, solve_scratch).
extern "C" int osqp_bt_solve(int dtype, const void* C, const void* G, const void* rhs, void* x, void* scratch, int B,
                             int b, int Nb, int warps, void* stream) {
  if (B == 0 || b == 0 || Nb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? solve<float>(C, G, rhs, x, scratch, B, b, Nb, warps, s)
                    : solve<double>(C, G, rhs, x, scratch, B, b, Nb, warps, s);
}

// Values of device scratch the entries above take, for the operators that
// allocate it (csrc/torch_ops.cpp): osqp_bt_factor's, a CTA, at block size
// b on `path` (the device path's panel buffer and band where they miss
// shared memory, else 0); osqp_bt_solve's, an instance, in CTAs of `warps`
// warps (the wide solve's three vectors where they miss shared memory,
// else 0).  ops/block_tridiag.py:device_scratch and solve_scratch size the
// same.
extern "C" long long osqp_bt_factor_scratch(int dtype, int b, int path) {
  const size_t values = band_values(b);
  return path == 2 && values * (dtype == 0 ? sizeof(float) : sizeof(double)) > static_cast<size_t>(kClusterSmem)
             ? static_cast<long long>(values)
             : 0;
}

extern "C" long long osqp_bt_solve_scratch(int dtype, int b, int warps) {
  if (warps == 0) return 0;
  const size_t bytes = solve_values(b, warps, true) * (dtype == 0 ? sizeof(float) : sizeof(double));
  return bytes > static_cast<size_t>(osqp_cuda::kMaxSmem) ? 3LL * b : 0;
}

// out = a / d elementwise by the solve's quotient route (route_quotient),
// n values; chip_smoke.py holds it to the division bit for bit.
extern "C" int osqp_bt_quotients(int dtype, const void* a, const void* d, void* out, int n, void* stream) {
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + 255) / 256;
  if (dtype == 0)
    quotient_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(d),
                                                 static_cast<float*>(out), n);
  else
    quotient_kernel<double><<<blocks, 256, 0, s>>>(static_cast<const double*>(a), static_cast<const double*>(d),
                                                  static_cast<double*>(out), n);
  return cudaGetLastError();
}
