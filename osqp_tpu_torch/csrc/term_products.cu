// K3: the matrix products of the termination checks, the infeasibility
// certificates and the rho estimate, for a batch of dense QPs.
//
// Replaces the products of osqp_tpu/termination.py:compute_products
// (A x, P x, A'y), primal_infeasibility (A'dy), dual_infeasibility
// (P dx, A dx) and compute_rho_estimate, and of
// osqp_tpu/admm.py:segment_row_info.  The JAX package makes each a
// separate product, and so does the plain version (six bmm GEMVs on the
// card).  Here one pass over A gives A x, A dx (row dots) and A'y, A'dy
// (column sums), and one pass over P gives P x and P dx:
//
//   row_out[v][b][i] = sum_j M_ij vec_v[b][j]          v: x, dx
//   col_out[v][b][j] = sum_i M_ij wgt_v[b][i]          v: y, dy   (A only)
//
// What bounds it on the H100: device-memory bandwidth, since every
// matrix value is used for two to four multiply-adds.  The design reads
// each matrix once with coalesced loads and splits the rows of one
// instance over blocks, so that B=1 at n=1000 fills the card as B=8192
// at n=100 does.  A block takes a tile of rows by 256 columns, of A or
// of P: both matrices are one grid, and a call is one kernel launch at
// every shape.  A warp takes one row at a time, each lane eight columns
// of it, so that a row dot is a warp reduction and a column sum stays in
// the lane's registers until the warps of the block add theirs.
//
// Where a row dot spans several column chunks, or a column sum several
// row tiles, the blocks leave partial sums in scratch, and the last
// block of each group to finish (an atomic ticket per instance and row
// tile, or instance and column chunk, taken after a __threadfence and
// reset by that block for the next call) adds the group's partials in
// chunk or tile order, from zero: the result does not depend on
// scheduling.  With m = 0, the blocks of P's first row tile write
// A'y = 0.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "admm_passes.cuh"
#include "common.cuh"

namespace {

using namespace osqp_cuda;

template <typename T>
struct Args {
  const T *P, *A, *x, *y, *dx, *dy;
  T *row_out, *p_out, *col_out;  // [A x, A dx] (nv,B,m), [P x, P dx] (nv,B,n), [A'y, A'dy] (nv,B,n)
  T *row_ws_a, *row_ws_p, *col_ws;  // partials by chunk or tile, where there are several
  unsigned *tick_a, *tick_p, *tick_c;  // tickets: (b, tile of A), (b, tile of P), (b, chunk of A)
  int B, n, m, rows_a, rows_p, tiles_a, tiles_p, chunks, nv;
};

// Is this block the last of its group of `expected` to get here?  Every
// thread calls it after writing its partials; the last block resets the
// counter and its reads that follow see the others' partials.
__device__ bool last_block(unsigned* counter, unsigned expected, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const bool last = atomicAdd(counter, 1u) == expected - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

constexpr int kBatch = 16;  // partials a thread loads at once in finish

// dst[v][b][i] = the partials ws[v][b][p][i] for p < parts added in p
// order from zero, for i in [i0, i1) (ld values an instance).
template <typename T>
__device__ void finish(const T* ws, T* dst, int nv, size_t b, int B, int parts, int ld, int i0, int i1) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int w = i1 - i0;
  for (int e = tid; e < nv * w; e += kThreads) {
    const int v = e / w;
    const int i = i0 + (e - v * w);
    const size_t vb = static_cast<size_t>(v) * B + b;
    const T* src = ws + vb * parts * ld + i;
    T s = T(0);
    int p = 0;
    for (; p + kBatch <= parts; p += kBatch) {  // the loads of a batch in flight together, the adds in order
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = __ldcg(src + static_cast<size_t>(p + u) * ld);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s += v[u];
    }
    for (; p < parts; ++p) s += __ldcg(src + static_cast<size_t>(p) * ld);
    dst[vb * ld + i] = s;
  }
}

// One tile of rows [r0, r1) of M (R x C, instance b's) by the columns
// [c0, c0 + 256) of chunk `chunk`: row dots with x (and dx when nv == 2)
// to rowdst; with kColSums (M is A) column sums weighted by y (and dy)
// to coldst.  A and P take separate instances of this code, so that P's
// blocks carry no column sums and their registers.
template <bool kColSums, typename T>
__device__ __forceinline__ void tile_products(const T* __restrict__ Mb, const T* __restrict__ v0,
                                              const T* __restrict__ v1, const T* __restrict__ w0,
                                              const T* __restrict__ w1, int B, int R, int C, int nv, int chunks,
                                              int tiles_a, int r0, int r1, int tile, int chunk, size_t b,
                                              T* __restrict__ rowdst, T* __restrict__ coldst,
                                              T (&red)[2][kWarps][kChunk]) {
  const int c0 = chunk * kChunk;
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int tid = w * 32 + lane;
  const bool two = nv > 1;
  const size_t rb = static_cast<size_t>(chunks) * R;
  const size_t rv = static_cast<size_t>(B) * rb;
  const size_t cb = static_cast<size_t>(tiles_a) * C;
  const size_t cv = static_cast<size_t>(B) * cb;

  T x0[kPerLane], x1[kPerLane], col0[kPerLane], col1[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = c0 + lane + 32 * k;
    x0[k] = c < C ? v0[b * C + c] : T(0);
    x1[k] = two && c < C ? v1[b * C + c] : T(0);
    col0[k] = T(0);
    col1[k] = T(0);
  }

#pragma unroll 2
  for (int r = r0 + w; r < r1; r += kWarps) {
    T v[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + lane + 32 * k;
      v[k] = c < C ? Mb[static_cast<size_t>(r) * C + c] : T(0);
    }
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      s0 += v[k] * x0[k];
      s1 += v[k] * x1[k];
    }
    if (kColSums) {
      const T y0 = w0[b * R + r];
      const T y1 = two ? w1[b * R + r] : T(0);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        col0[k] += v[k] * y0;
        col1[k] += v[k] * y1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (lane == 0) {
      const size_t at = b * rb + static_cast<size_t>(chunk) * R + r;
      rowdst[at] = s0;
      if (two) rowdst[rv + at] = s1;
    }
  }

  if (kColSums) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      red[0][w][lane + 32 * k] = col0[k];
      red[1][w][lane + 32 * k] = col1[k];
    }
    __syncthreads();
    const int c = c0 + tid;
    if (c < C) {
      T s0 = red[0][0][tid], s1 = red[1][0][tid];
      for (int k = 1; k < kWarps; ++k) {
        s0 += red[0][k][tid];
        s1 += red[1][k][tid];
      }
      const size_t at = b * cb + static_cast<size_t>(tile) * C + c;
      coldst[at] = s0;
      if (two) coldst[cv + at] = s1;
    }
  }
}

// Block (b, y, chunk): y < tiles_a a tile of rows of A, else of P, by
// columns [256 chunk, 256 chunk + 256).  Row dots with x (and dx when
// nv == 2) go to row_out / p_out, or by chunk to scratch; column sums
// of A weighted by y (and dy) to col_out, or by tile to scratch.
// kTickets: some group has several blocks (chunks > 1 or tiles_a > 1).
// Registers capped so that four blocks (float) or two (double) share an
// SM: a streaming kernel needs the loads of many warps in flight.
template <typename T, bool kTickets>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2) products_kernel(Args<T> a) {
  __shared__ T red[2][kWarps][kChunk];
  __shared__ bool flag;
  const size_t b = blockIdx.x;
  const bool on_a = static_cast<int>(blockIdx.y) < a.tiles_a;
  const int tile = on_a ? blockIdx.y : blockIdx.y - a.tiles_a;
  const int R = on_a ? a.m : a.n;
  const int C = a.n;
  const int rows = on_a ? a.rows_a : a.rows_p;
  const int chunk = blockIdx.z;
  const int r0 = tile * rows;
  const int r1 = min(R, r0 + rows);
  const int c0 = chunk * kChunk;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const bool parted = a.chunks > 1;
  T* rowdst = parted ? (on_a ? a.row_ws_a : a.row_ws_p) : (on_a ? a.row_out : a.p_out);
  if (on_a) {
    tile_products<true>(a.A + b * R * C, a.x, a.dx, a.y, a.dy, a.B, R, C, a.nv, a.chunks, a.tiles_a, r0, r1, tile,
                        chunk, b, rowdst, a.tiles_a > 1 ? a.col_ws : a.col_out, red);
  } else {
    tile_products<false>(a.P + b * R * C, a.x, a.dx, a.y, a.dy, a.B, R, C, a.nv, a.chunks, a.tiles_a, r0, r1, tile,
                         chunk, b, rowdst, static_cast<T*>(nullptr), red);
    if (a.m == 0 && tile == 0) {  // A'y and A'dy of an empty A
      for (int e = tid; e < a.nv * kChunk; e += kThreads) {
        const int v = e / kChunk, c = c0 + (e - v * kChunk);
        if (c < C) a.col_out[(static_cast<size_t>(v) * a.B + b) * C + c] = T(0);
      }
    }
  }

  if (!kTickets) return;
  // the last block of a group adds its partials
  if (parted) {
    unsigned* tick = on_a ? a.tick_a + b * a.tiles_a + tile : a.tick_p + b * a.tiles_p + tile;
    if (last_block(tick, a.chunks, &flag))
      finish(rowdst, on_a ? a.row_out : a.p_out, a.nv, b, a.B, a.chunks, R, r0, r1);
  }
  if (on_a && a.tiles_a > 1) {
    if (last_block(a.tick_c + b * a.chunks + chunk, a.tiles_a, &flag))
      finish(a.col_ws, a.col_out, a.nv, b, a.B, a.tiles_a, C, c0, min(C, c0 + kChunk));
  }
}

// The scratch of a call, carved from one allocation; with a null base it
// only counts the bytes.  Tickets are zero in a fresh allocation, and
// every call leaves them zero.
template <typename T>
struct Plan {
  int tiles_a, tiles_p, chunks;
  T *row_ws_a = nullptr, *row_ws_p = nullptr, *col_ws = nullptr;
  unsigned *tick_a = nullptr, *tick_p = nullptr, *tick_c = nullptr;
  size_t bytes;
  Plan(int B, int n, int m, int rows_a, int rows_p, int nv, unsigned char* scratch) {
    chunks = chunks_of(n);
    tiles_a = m > 0 ? tiles_of(m, rows_a) : 0;
    tiles_p = tiles_of(n, rows_p);
    const size_t Bv = static_cast<size_t>(B) * nv;
    Carve c{scratch};
    if (chunks > 1) {
      row_ws_a = c.take<T>(Bv * chunks * m);
      row_ws_p = c.take<T>(Bv * chunks * n);
      tick_a = c.take<unsigned>(static_cast<size_t>(B) * tiles_a);
      tick_p = c.take<unsigned>(static_cast<size_t>(B) * tiles_p);
    }
    if (tiles_a > 1) {
      col_ws = c.take<T>(Bv * tiles_a * n);
      tick_c = c.take<unsigned>(static_cast<size_t>(B) * chunks);
    }
    bytes = c.used;
  }
};

template <typename T>
int launch(void* const* p, unsigned char* scratch, int B, int n, int m, int rows_a, int rows_p, cudaStream_t s) {
  auto in = [&](int k) { return static_cast<const T*>(p[k]); };
  auto out = [&](int k) { return static_cast<T*>(p[k]); };
  const int nv = p[4] ? 2 : 1;
  const Plan<T> pl(B, n, m, rows_a, rows_p, nv, scratch);
  const Args<T> a{in(0), in(1), in(2), in(3), in(4), in(5), out(6), out(7), out(8),
                  pl.row_ws_a, pl.row_ws_p, pl.col_ws, pl.tick_a, pl.tick_p, pl.tick_c,
                  B, n, m, rows_a, rows_p, pl.tiles_a, pl.tiles_p, pl.chunks, nv};
  const dim3 grid(B, pl.tiles_a + pl.tiles_p, pl.chunks);
  if (pl.chunks > 1 || pl.tiles_a > 1)
    products_kernel<T, true><<<grid, dim3(32, kWarps), 0, s>>>(a);
  else
    products_kernel<T, false><<<grid, dim3(32, kWarps), 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  P (B,n,n), A (B,m,n), x (B,n), y (B,m);
// dx (B,n) and dy (B,m) both given or both null.  Outputs, nv = 2 with
// dx and dy else 1: row_out (nv,B,m) = [A x, A dx], p_out (nv,B,n) =
// [P x, P dx], col_out (nv,B,n) = [A'y, A'dy].  scratch holds
// osqp_term_products_scratch(dtype, B, n, m, rows_a, rows_p, nv) bytes,
// zeroed before its first use and left zeroed by every call (null where
// that is 0); calls that share it run in order on one stream.  rows_a
// and rows_p are the rows of A and P a block takes.  All contiguous,
// n >= 1.  One kernel launch.
extern "C" int osqp_term_products(int dtype, const void* P, const void* A, const void* x,
                                  const void* y, const void* dx, const void* dy, void* row_out,
                                  void* p_out, void* col_out, void* scratch, int B, int n, int m,
                                  int rows_a, int rows_p, void* stream) {
  if (B == 0) return cudaSuccess;
  void* const p[9] = {const_cast<void*>(P), const_cast<void*>(A), const_cast<void*>(x),
                      const_cast<void*>(y), const_cast<void*>(dx), const_cast<void*>(dy),
                      row_out, p_out, col_out};
  auto s = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<unsigned char*>(scratch);
  return dtype == 0 ? launch<float>(p, ws, B, n, m, rows_a, rows_p, s)
                    : launch<double>(p, ws, B, n, m, rows_a, rows_p, s);
}

// Bytes of scratch that osqp_term_products takes (nv = 1 or 2 as above).
extern "C" long long osqp_term_products_scratch(int dtype, int B, int n, int m, int rows_a, int rows_p, int nv) {
  return static_cast<long long>(dtype == 0 ? Plan<float>(B, n, m, rows_a, rows_p, nv, nullptr).bytes
                                           : Plan<double>(B, n, m, rows_a, rows_p, nv, nullptr).bytes);
}
