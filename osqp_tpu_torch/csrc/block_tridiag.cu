// K7: the block-tridiagonal Cholesky factorization of the reduced KKT
// matrix M = P + sigma I + A' diag(rho) A, and the solve with its factors:
// a warp per instance for stages of b <= 32 variables, a block per
// instance above, with the factor's three stage blocks in shared memory
// up to max_block (139 in float32, 98 in float64) and in device memory
// beyond.
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
// b > 32: one block per instance, column steps behind block barriers.
// The factor holds C_{i-1}, D_i and O_i in shared memory (3 b^2 values)
// up to b = 139 in float32, 98 in float64 (the block path); above that
// (the device path) it runs the same steps on C_i's and G_i's own slots
// of the outputs, which serve as its workspace: D_i - G_i G_i' is formed
// in C_i's slot, G_i in its slot, C_{i-1} read back from its slot.  Each
// stage's ~2 b^3 operations then read their operands from L1 and L2 (the
// stage just written, b^2 values, is L2-hot) instead of shared memory;
// staging S_i or panels of it in shared memory is left for a later
// redesign.  The solve keeps only b values in shared memory and runs at
// any b.
//
// Every product, sum, quotient and square root is rounded on its own (no
// fused multiply-add), in the order of the plain versions in
// ops/block_tridiag.py: the triangular solves by columns, the Cholesky
// right-looking, column by column.  So kernel and plain version agree bit
// for bit on both paths.
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

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using osqp_cuda::allow_smem;
using osqp_cuda::mul;
using osqp_cuda::sub;

constexpr int kFactorThreads = 128;
constexpr int kSolveThreads = 32;
constexpr int kWarpMax = 32;  // largest b of the warp path

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

// One block per instance walks the stages.  kDevice false (the block
// path, b <= max_block): C_{i-1}, D_i and O_i in shared memory, 3 b^2
// values.  kDevice true (the device path, any b): the same steps in device
// memory, D_i - G_i G_i' formed in C_i's slot of C and G_i in its own slot
// of G, C_{i-1} read back from its slot; a block barrier orders them, and
// the stage just written is L2-hot.
template <typename T, bool kDevice>
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
    if (kDevice) {
      S = Ci + static_cast<size_t>(i) * bb;
      if (i > 0) {
        Cp = Ci + static_cast<size_t>(i - 1) * bb;
        W = Gi + static_cast<size_t>(i - 1) * bb;
      }
    }
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
      // D_i - G_i G_i' on the lower triangle; G_i to device memory (the
      // device path formed it there)
      for (int e = tid; e < bb; e += nt) {
        if (!kDevice) Gi[static_cast<size_t>(i - 1) * bb + e] = W[e];
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
      if (kDevice) {
        S[e] = v;  // S is C_i
      } else {
        Ci[static_cast<size_t>(i) * bb + e] = v;
        Cp[e] = v;
      }
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

// ---------------------------------------------------------------------------
// b <= 32: a warp per instance, kWarpInstances instances a block
// ---------------------------------------------------------------------------

constexpr int kWarpInstances = 4;
constexpr unsigned kFull = 0xffffffffu;

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

// path: 0 the warp path (b <= 32), 1 the block path (3 b^2 values in
// shared memory), 2 the device path (any b).
template <typename T>
int factor(const void* M, void* C, void* G, int B, int b, int Nb, int path, cudaStream_t s) {
  if (path == 0) {
    if (b > kWarpMax) return cudaErrorInvalidValue;
    return warp_path<T>(M, C, G, nullptr, nullptr, B, b, Nb, true, s);
  }
  auto Mt = static_cast<const T*>(M);
  auto Ct = static_cast<T*>(C);
  auto Gt = static_cast<T*>(G);
  if (path == 2) {
    factor_kernel<T, true><<<B, kFactorThreads, 0, s>>>(Mt, Ct, Gt, b, Nb);
    return cudaGetLastError();
  }
  if (path != 1) return cudaErrorInvalidValue;
  const size_t smem = 3 * static_cast<size_t>(b) * b * sizeof(T);
  if (smem > static_cast<size_t>(osqp_cuda::kMaxSmem)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(factor_kernel<T, false>, smem);
  if (err != cudaSuccess) return err;
  factor_kernel<T, false><<<B, kFactorThreads, smem, s>>>(Mt, Ct, Gt, b, Nb);
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
// above, named by the wrapper (ops/block_tridiag.py:factor_path); a path
// that does not take b returns cudaErrorInvalidValue.
extern "C" int osqp_bt_factor(int dtype, const void* M, void* C, void* G, int B, int b, int Nb, int path,
                              void* stream) {
  if (B == 0 || b == 0 || Nb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? factor<float>(M, C, G, B, b, Nb, path, s) : factor<double>(M, C, G, B, b, Nb, path, s);
}

// x = M^-1 rhs with the factors above; rhs and x (B, Nb b), contiguous.
extern "C" int osqp_bt_solve(int dtype, const void* C, const void* G, const void* rhs, void* x, int B, int b, int Nb,
                             void* stream) {
  if (B == 0 || b == 0 || Nb == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? solve<float>(C, G, rhs, x, B, b, Nb, s) : solve<double>(C, G, rhs, x, B, b, Nb, s);
}
