// K7: the block-tridiagonal Cholesky factorization of the reduced KKT
// matrix M = P + sigma I + A' diag(rho) A, and the solve with its factors:
// a warp per instance for stages of b <= 32 variables; above that the
// factor spreads each instance over a thread-block cluster (the cluster
// path, up to cluster_max_block: 558 in float32, 361 in float64) and
// works in device memory, a block per instance, beyond, and the solve
// takes a block per instance.
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
// b > 32: the factor's cluster path (cluster_factor_kernel below) holds
// each instance's rows in the shared memory of up to 16 CTAs.  From b =
// 64 up it is several times faster, at every batch size measured, than
// the block per instance with the three stage blocks in shared memory
// that it replaced; it is slower only near b = 33 at large B
// (tools/ab_k7_factor.py, PERF.md).  Above cluster_max_block (the
// device path) one block per instance runs the same steps on C_i's and
// G_i's own slots of the outputs, which serve as its workspace: D_i -
// G_i G_i' is formed in C_i's slot, G_i in its slot, C_{i-1} read back
// from its slot.  Each stage's ~2 b^3 operations then read their
// operands from L1 and L2 (the stage just written, b^2 values, is
// L2-hot).  The solve keeps only b values in shared memory and runs at
// any b, a block per instance, column steps behind block barriers.
//
// Every product, sum, quotient and square root is rounded on its own (no
// fused multiply-add), in the order of the plain versions in
// ops/block_tridiag.py: the triangular solves by columns, the Cholesky
// right-looking, column by column.  So kernel and plain version agree bit
// for bit on every path.
//
// What bounds it on the H100: latency.  At the MPC cell (B = 1000, b = 12,
// Nb = 31, float32) the factor reads the band blocks of M and writes C
// and G, about 70 MB (0.02 ms at the HBM rate), and the solve reads C and
// G once, about 35 MB; the work is ~Nb b^3 operations per instance.  What
// sets the time is each instance's chain: per stage b column steps of the
// Cholesky or of each triangular solve, each a quotient (or square root)
// and a shuffle, with about 8 warps an SM to hide them.  The two GEMVs
// with A around the solve (linsys/block_tridiag.py) are not fused here.
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

constexpr int kFactorThreads = 128;
constexpr int kSolveThreads = 32;
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

// Above cluster_max_block (the device path, any b): one block per
// instance walks the stages in device memory, on C_i's and G_i's own
// slots of the outputs: D_i - G_i G_i' formed in C_i's slot, G_i in its
// slot of G, C_{i-1} read back from its slot; a block barrier orders
// them, and the stage just written is L2-hot.
template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
device_factor_kernel(const T* __restrict__ M, T* __restrict__ C, T* __restrict__ G, int b, int Nb) {
  __shared__ int bad;
  const int bb = b * b;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t n = static_cast<size_t>(Nb) * b;
  const T* Mi = M + blockIdx.x * n * n;
  T* Ci = C + blockIdx.x * static_cast<size_t>(Nb) * bb;
  T* Gi = G + blockIdx.x * static_cast<size_t>(Nb - 1) * bb;

  for (int i = 0; i < Nb; ++i) {
    const size_t r0 = static_cast<size_t>(i) * b;
    T* S = Ci + static_cast<size_t>(i) * bb;                           // D_i, then D_i - G_i G_i', then C_i
    const T* Cp = i > 0 ? Ci + static_cast<size_t>(i - 1) * bb : Ci;  // C_{i-1}
    T* W = i > 0 ? Gi + static_cast<size_t>(i - 1) * bb : Gi;          // O_i, then G_i
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
      // D_i - G_i G_i' on the lower triangle
      for (int e = tid; e < bb; e += nt) {
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
      S[e] = c <= r ? (failed ? not_a_number<T>() : S[e]) : T(0);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 32 < b <= cluster_max_block: one instance over a thread-block
// cluster of k <= 16 CTAs
// ---------------------------------------------------------------------------

#ifdef OSQP_STAMPS
// cycles by phase of the cluster path (tools/probe_k7_cluster.py): load,
// G's fetch, G's earlier columns, G's panel, G's store and barrier, S's
// fetch, S's update, the diagonal block, the panel solve, the panel's
// barrier, its fetch, the trailing update, the stage's end
__device__ unsigned long long bt_stamps[2][16];
#endif

constexpr int kPanel = 16;          // columns of a panel, rows of a diagonal block
constexpr int kPitch = kPanel + 1;  // odd: a thread per row reads a column of a panel without bank conflicts
constexpr int kClusterThreads = 256;
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
inline size_t cluster_values(int b, int s) {
  const size_t blocks = (b + kPanel - 1) / kPanel;
  return 2 * static_cast<size_t>(s) * b + panel_values(b) + blocks * kPanel * kPitch;
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

// x[0, kb) <- x L^-T for the kb x kb lower L at pitch `pitch`, by one
// thread: x[j] = (x[j] - sum_{t<j} x[t] L[j, t]) / L[j, j], right-looking
// over the columns with the values shifted as in factor_block.
template <typename T>
__device__ void solve_row(T* x, const T* L, int pitch, int kb) {
  T a[kPanel];
#pragma unroll
  for (int u = 0; u < kPanel; ++u) a[u] = u < kb ? x[u] : T(0);
#pragma unroll
  for (int jj = 0; jj < kPanel; ++jj) {
    if (jj >= kb) break;
    const T v = osqp_cuda::quotient(a[0], L[jj * pitch + jj]);
    x[jj] = v;
#pragma unroll
    for (int u = 1; u < kPanel; ++u)
      if (jj + u < kb) a[u] = sub(a[u], mul(v, L[(jj + u) * pitch + jj]));
#pragma unroll
    for (int u = 0; u + 1 < kPanel; ++u) a[u] = a[u + 1];
    a[kPanel - 1] = T(0);
  }
}

// acc - sum_{t<kt} x[t] y[t], t ascending, each product and difference
// rounded on its own; the loads of all 16 issued together.
template <typename T>
__device__ __forceinline__ T minus_dot16(T acc, const T* x, const T* y, int kt) {
  T p[kPanel];
#pragma unroll
  for (int t = 0; t < kPanel; ++t) p[t] = t < kt ? mul(x[t], y[t]) : T(0);
#pragma unroll
  for (int t = 0; t < kPanel; ++t)
    if (t < kt) acc = sub(acc, p[t]);
  return acc;
}

// One instance over a cluster of k CTAs.  CTA q holds rows [q s, q s + s)
// of every stage block in two strips of its shared memory: S_i (D_i, then
// D_i - G_i G_i', then C_i) and W_i (O_i, then G_i).  Every CTA also
// keeps the diagonal band, all the 16 x 16 diagonal blocks of S_i, and
// brings it up to date itself, so that each factors every diagonal block
// on its own and knows a failed pivot without asking.  What every CTA
// needs of the others' rows (a panel of C_{i-1}, of G_i, of C_i) goes
// through L2: its owners write it to C or G in device memory, which the
// factor writes anyway, before a cluster barrier, and every CTA loads it
// from there; reading it from the owners' shared memory instead, about a
// request a cycle at each owner, took two to three times as long
// (PERF.md).  A stage, by panels of 16 columns:
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
//         panel columns, and the rows of the block take the block; one
//         cluster barrier; the panel's columns below the block; each CTA
//         updates its rows' trailing columns and the later diagonal
//         blocks.
//
// then a cluster barrier before the next stage reads C_i.  So a stage of
// np panels costs np + 1 cluster barriers and no block barrier per
// column.  Every entry takes its products and differences in the plain
// version's order (t ascending, then j ascending), each rounded on its
// own: the same bits as the other paths.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
cluster_factor_kernel(const T* __restrict__ M, T* __restrict__ C, T* __restrict__ G, int b, int Nb, int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int bad;
  const int k = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int q = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const int r0 = q * s, rows = max(0, min(s, b - r0));
  const int nblk = (b + kPanel - 1) / kPanel, ldr = b | 1;
  const size_t sb = static_cast<size_t>(s) * b, bb = static_cast<size_t>(b) * b;
  T* Sb = reinterpret_cast<T*>(smem);
  T* Wb = Sb + sb;
  T* Pn = Wb + sb;               // the panel buffer
  T* Db = Pn + panel_values(b);  // the band
  const size_t n = static_cast<size_t>(Nb) * b;
  const size_t inst = blockIdx.x / k;
  const T* Mi = M + inst * n * n;
  T* Ci = C + inst * static_cast<size_t>(Nb) * bb;
  T* Gi = G + inst * static_cast<size_t>(Nb - 1) * bb;
  STAMP_DECL(bt_stamps)

  for (int i = 0; i < Nb; ++i) {
    const size_t st = static_cast<size_t>(i) * b;
    T* Cs = Ci + static_cast<size_t>(i) * bb;  // C_i in device memory
    for (int e = tid; e < rows * b; e += nt) {
      const int lr = e / b, c = e - lr * b;
      const T* row = Mi + (st + r0 + lr) * n + st;
      Sb[e] = row[c];
      if (i > 0) Wb[e] = row[c - b];
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
        for (int e = tid; e < rows * kb; e += nt) {
          const int lr = e / kb, jj = e - lr * kb;
          const T* wr = Wb + lr * b;
          const T* cr = Pn + jj * ldr;
          T acc = wr[j0 + jj];
#pragma unroll 8
          for (int t = 0; t < j0; ++t) acc = sub(acc, mul(wr[t], cr[t]));
          Wb[lr * b + j0 + jj] = acc;
        }
        __syncthreads();
        STAMP(2);
        for (int lr = tid; lr < rows; lr += nt) solve_row(Wb + lr * b + j0, Pn + j0, ldr, kb);
        __syncthreads();
        STAMP(3);
      }
      for (int e = tid; e < rows * b; e += nt) Gi[static_cast<size_t>(i - 1) * bb + r0 * b + e] = Wb[e];
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
          T* sr = Sb + lr * b;
          const T* wr = Wb + lr * b + t0;
          for (int c = lane; c < ((r0 + lr) & ~(kPanel - 1)); c += 32)
            sr[c] = minus_dot16(sr[c], wr, Pn + c * kPitch, kt);
        }
        for (int e = tid; e < nblk * kPanel * kPanel; e += nt) {
          const int d = e / (kPanel * kPanel), rr = (e / kPanel) % kPanel, cc = e % kPanel;
          const int r = d * kPanel + rr;
          if (r < b && cc <= rr) {
            T* v = Db + (d * kPanel + rr) * kPitch + cc;
            *v = minus_dot16(*v, Pn + r * kPitch, Pn + (d * kPanel + cc) * kPitch, kt);
          }
        }
        __syncthreads();
        STAMP(6);
      }
    }

    // C_i = chol(S_i), right-looking by panels
    for (int p = 0; p < nblk; ++p) {
      const int j0 = p * kPanel, kb = min(kPanel, b - j0), base = j0 + kb;
      T* D = Db + p * kPanel * kPitch;
      if (tid < 32) {
        const bool failed = factor_block(D, kb);
        if (tid == 0 && failed) bad = 1;
      }
      __syncthreads();
      STAMP(7);
      // the strip's rows below the block solve the panel's columns and
      // publish them in C_i; its rows of the block take the block
      for (int lr = tid; lr < rows; lr += nt) {
        const int r = r0 + lr;
        T* sr = Sb + lr * b + j0;
        if (r >= base) {
          solve_row(sr, D, kPitch, kb);
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
      // trailing update: the strip's rows below the panel, left of their
      // diagonal block, and the later diagonal blocks
      for (int lr = warp; lr < rows; lr += warps) {
        T* sr = Sb + lr * b;
        for (int c = base + lane; c < ((r0 + lr) & ~(kPanel - 1)); c += 32)
          sr[c] = minus_dot16(sr[c], sr + j0, Pn + (c - base) * kPitch, kb);
      }
      for (int e = tid; e < nblk * kPanel * kPanel; e += nt) {
        const int d = e / (kPanel * kPanel), rr = (e / kPanel) % kPanel, cc = e % kPanel;
        const int r = d * kPanel + rr;
        if (d > p && r < b && cc <= rr) {
          T* v = Db + (d * kPanel + rr) * kPitch + cc;
          *v = minus_dot16(*v, Pn + (r - base) * kPitch, Pn + (d * kPanel + cc - base) * kPitch, kb);
        }
      }
      __syncthreads();
      STAMP(11);
    }
    __syncthreads();
    const bool failed = bad != 0;
    for (int e = tid; e < rows * b; e += nt) {
      const int lr = e / b, c = e - lr * b;
      Cs[r0 * b + e] = c <= r0 + lr ? (failed ? not_a_number<T>() : Sb[e]) : T(0);
    }
    // C_i whole in device memory for the next stage's G
    osqp_cuda::cluster_barrier();
    STAMP(12);
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

// The cluster path: B clusters of k CTAs, each CTA's strip s = ceil(b / k)
// rows.  A size the card cannot take is refused (cudaErrorInvalidValue, or
// the launch's own error), never replaced by another path.
template <typename T>
int cluster_factor(const T* M, T* C, T* G, int B, int b, int Nb, int k, cudaStream_t s) {
  if (k < 1 || k > kClusterMax || static_cast<long long>(B) * k > INT_MAX) return cudaErrorInvalidValue;
  const int strip = (b + k - 1) / k;
  const size_t smem = cluster_values(b, strip) * sizeof(T);
  if (smem > static_cast<size_t>(kClusterSmem)) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(cluster_factor_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = allow_smem(cluster_factor_kernel<T>, smem, sizeof(int));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * k);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_factor_kernel<T>, M, C, G, b, Nb, strip);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// path: 0 the warp path (b <= 32), 1 the cluster path (clusters of
// `cluster` CTAs), 2 the device path (any b).
template <typename T>
int factor(const void* M, void* C, void* G, int B, int b, int Nb, int path, int cluster, cudaStream_t s) {
  if (path == 0) {
    if (b > kWarpMax) return cudaErrorInvalidValue;
    return warp_path<T>(M, C, G, nullptr, nullptr, B, b, Nb, true, s);
  }
  auto Mt = static_cast<const T*>(M);
  auto Ct = static_cast<T*>(C);
  auto Gt = static_cast<T*>(G);
  if (path == 1) return cluster_factor<T>(Mt, Ct, Gt, B, b, Nb, cluster, s);
  if (path != 2) return cudaErrorInvalidValue;
  device_factor_kernel<T><<<B, kFactorThreads, 0, s>>>(Mt, Ct, Gt, b, Nb);
  return cudaGetLastError();
}

template <typename T>
int solve(const void* C, const void* G, const void* rhs, void* x, int B, int b, int Nb, cudaStream_t s) {
  if (b <= kWarpMax)
    return warp_path<T>(nullptr, const_cast<void*>(C), const_cast<void*>(G), rhs, x, B, b, Nb, false, s);
  const size_t smem = static_cast<size_t>(b) * sizeof(T);
  const cudaError_t err = allow_smem(solve_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  solve_kernel<T><<<B, kSolveThreads, smem, s>>>(static_cast<const T*>(C), static_cast<const T*>(G),
                                                  static_cast<const T*>(rhs), static_cast<T*>(x), b, Nb);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  M (B, Nb b, Nb b) contiguous; writes C
// (B, Nb, b, b) and G (B, Nb-1, b, b), contiguous.  path as factor()
// above, named by the wrapper (ops/block_tridiag.py:factor_path, and
// cluster_plan for the cluster path's CTAs a cluster); a path that does
// not take b returns cudaErrorInvalidValue.
extern "C" int osqp_bt_factor(int dtype, const void* M, void* C, void* G, int B, int b, int Nb, int path,
                              int cluster, void* stream) {
  if (B == 0 || b == 0 || Nb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? factor<float>(M, C, G, B, b, Nb, path, cluster, s)
                    : factor<double>(M, C, G, B, b, Nb, path, cluster, s);
}

#ifdef OSQP_STAMPS
// The cluster path's cycles by phase since the last call, [CTA 0, CTA k -
// 1 of the first instance][16 phases], and zero them.
extern "C" int osqp_bt_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, bt_stamps, sizeof(bt_stamps));
  static const unsigned long long zero[2][16] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(bt_stamps, zero, sizeof(bt_stamps));
  return err;
}
#endif

// x = M^-1 rhs with the factors above; rhs and x (B, Nb b), contiguous.
extern "C" int osqp_bt_solve(int dtype, const void* C, const void* G, const void* rhs, void* x, int B, int b, int Nb,
                             void* stream) {
  if (B == 0 || b == 0 || Nb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? solve<float>(C, G, rhs, x, B, b, Nb, s) : solve<double>(C, G, rhs, x, B, b, Nb, s);
}
