// What the kernels of osqp_tpu_torch share: the block and tile geometry,
// correctly rounded arithmetic, the sizes of a split launch, and the
// bulk-copy ring through which the split ADMM passes stream a row tile.
//
// The geometry lives here only.  The Python wrappers ask the library for
// what they must size (osqp_split_geometry, osqp_*_scratch in the .cu
// files) instead of repeating these constants.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace osqp_cuda {

constexpr int kWarps = 8;                // warps of every block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 8;              // columns a lane takes in the split kernels
constexpr int kChunk = 32 * kPerLane;    // columns one block of a split kernel takes
constexpr int kMaxTileRows = 4096;       // rows of a tile of the split ADMM passes (K1, K1r)
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory above this needs an opt-in
constexpr int kMaxSmem = 232448;          // shared memory one block may use (227 KB)

// Each operation rounded on its own, as PyTorch rounds it: nvcc may not
// contract these into fused multiply-adds.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// Blocks of a grid-stride loop over `total` elements.
inline int grid_size(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65536 ? (blocks > 0 ? blocks : 1) : 65536);
}

// Column chunks of an n-column matrix in a split kernel.
inline int chunks_of(int n) { return (n + kChunk - 1) / kChunk; }

// Rows of an R-row matrix that one block of a split kernel takes: enough
// tiles that B x chunks x tiles blocks give every SM four, and at least
// one row per warp.  At B=8192 one tile spans the matrix; at B=1 the
// rows of one instance spread over the card.
inline int rows_per_tile(int B, int chunks, int R, int sm_count) {
  const long long want = 4LL * sm_count;
  const long long blocks = static_cast<long long>(B) * chunks;
  long long tiles = (want + blocks - 1) / (blocks > 0 ? blocks : 1);
  const long long most = (R + kWarps - 1) / kWarps;
  tiles = tiles < most ? tiles : most;
  tiles = tiles > 1 ? tiles : 1;
  const long long rows = (R + tiles - 1) / tiles;
  return static_cast<int>(rows > 1 ? rows : 1);
}

// The same, capped at kMaxTileRows so that a tile's per-row weights fit
// in shared memory beside the ring (the split ADMM passes).
inline int tile_rows(int B, int chunks, int R, int sm_count) {
  const int rows = rows_per_tile(B, chunks, R, sm_count);
  return rows < kMaxTileRows ? rows : kMaxTileRows;
}

// Tiles of `rows` rows that cover R rows (0 when R is 0).
inline int tiles_of(int R, int rows) { return (R + rows - 1) / rows; }

// Opt a kernel in to `smem` bytes of dynamic shared memory when that and
// its `static_smem` bytes of static shared memory are above the default
// (without the opt-in a launch may take the default less the static).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t static_smem = 0) {
  if (smem + static_smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// Ask for the largest shared-memory carveout of the SM for a kernel whose
// blocks hold their data in shared memory, so that as many fit an SM as
// its shared memory allows.
template <typename Kernel>
cudaError_t prefer_shared(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------------------
// Hopper's bulk copies (cp.async.bulk, the TMA's 1-D form) on mbarriers.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// *dst <- *src, shared from device memory, without a register: a thread
// issues all its copies back to back, and cp.async.wait_all (then a block
// barrier) makes them visible.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Arrive once and expect `bytes` more of bulk copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// shared memory to device memory, as one bulk group of this thread.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_addr(src)),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's writes to shared memory visible to bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A ring of kStages slots in shared memory, each holding kWarps rows of
// up to kChunk values, through which a block streams a tile of rows by
// columns [c0, c0 + cw) of a row-major R x C matrix.  One thread issues
// the bulk copies, kStages slots ahead; every warp takes one row of each
// slot, warp w the slot's row w, and hands it to `f(r, row)`, where
// row[j] is the value at column c0 + j (j < cw).
//
// A bulk copy needs 16-byte aligned addresses and sizes, and a row of
// an odd width starts anywhere.  So each copy takes the 16-byte aligned
// window around the wanted bytes, at most 15 bytes more on each side:
// those bytes lie in the same 16-byte segments of device memory as
// wanted ones, so they are inside the allocation.  Where one chunk spans
// the whole row (C <= kChunk) the rows of a slot are contiguous and one
// copy brings all of them.
template <typename T>
struct Ring {
  static constexpr int kStages = sizeof(T) == 4 ? 4 : 3;
  static constexpr int kPad = 16 / sizeof(T);         // window slack, in values, on each side
  static constexpr int kPitch = kChunk + 2 * kPad;    // values per row slot
  static constexpr size_t kBarBytes = 128;            // the stages' mbarriers, ahead of the slots
  static constexpr size_t kBytes = kBarBytes + sizeof(T) * kStages * kWarps * kPitch;
};

// The aligned window [lo, hi) of device memory around `bytes` bytes at p.
__device__ __forceinline__ void window(const void* p, size_t bytes, uintptr_t& lo, uint32_t& size) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  lo = a & ~uintptr_t(15);
  size = static_cast<uint32_t>(((a + bytes + 15) & ~uintptr_t(15)) - lo);
}

template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Issue the copies of rows [rb, re) into slot `s` (one thread).
template <typename T>
__device__ void ring_issue(const T* M, int C, int rb, int re, int c0, int cw, unsigned char* smem, int s) {
  using RT = Ring<T>;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + s;
  T* slot = reinterpret_cast<T*>(smem + RT::kBarBytes) + static_cast<size_t>(s) * kWarps * RT::kPitch;
  uintptr_t lo;
  uint32_t size;
  if (cw == C) {
    window(M + static_cast<size_t>(rb) * C, sizeof(T) * static_cast<size_t>(re - rb) * C, lo, size);
    mbar_expect_tx(bar, size);
    bulk_load(slot, reinterpret_cast<const void*>(lo), size, bar);
    return;
  }
  uint32_t total = 0;
  for (int r = rb; r < re; ++r) {
    window(M + static_cast<size_t>(r) * C + c0, sizeof(T) * cw, lo, size);
    total += size;
  }
  mbar_expect_tx(bar, total);
  for (int r = rb; r < re; ++r) {
    window(M + static_cast<size_t>(r) * C + c0, sizeof(T) * cw, lo, size);
    bulk_load(slot + (r - rb) * RT::kPitch, reinterpret_cast<const void*>(lo), size, bar);
  }
}

// Stream rows [r0, r1) x columns [c0, c0 + cw) of M (R x C, row-major)
// through the ring at `smem` (Ring<T>::kBytes, 128-byte aligned), calling
// f(r, row) for each row in the warp that takes it.  Every thread of the
// block must call it; it ends with a block barrier, after which the ring
// is free for other use.
template <typename T, typename F>
__device__ void stream_rows(const T* M, int C, int r0, int r1, int c0, int cw, unsigned char* smem, F&& f) {
  using RT = Ring<T>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const T* slots = reinterpret_cast<const T*>(smem + RT::kBarBytes);
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int groups = (r1 - r0 + kWarps - 1) / kWarps;
  const bool whole = cw == C;
  auto issue = [&](int g) {
    const int rb = r0 + g * kWarps;
    ring_issue(M, C, rb, min(rb + kWarps, r1), c0, cw, smem, g % RT::kStages);
  };
  if (tid == 0) {
    for (int s = 0; s < RT::kStages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < groups && g < RT::kStages; ++g) issue(g);
  }
  __syncthreads();
  for (int g = 0; g < groups; ++g) {
    const int s = g % RT::kStages;
    mbar_wait(bars + s, (g / RT::kStages) & 1);
    const int rb = r0 + g * kWarps;
    const int r = rb + threadIdx.y;
    if (r < r1) {
      const T* slot = slots + static_cast<size_t>(s) * kWarps * RT::kPitch;
      const T* row = whole ? slot + misalign(M + static_cast<size_t>(rb) * C) + static_cast<size_t>(r - rb) * C
                           : slot + threadIdx.y * RT::kPitch + misalign(M + static_cast<size_t>(r) * C + c0);
      f(r, row);
    }
    __syncthreads();  // slot s is read; the copies may refill it
    if (tid == 0 && g + RT::kStages < groups) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(g + RT::kStages);
    }
  }
}

}  // namespace osqp_cuda
