// Latency of the synchronisation that K8's cluster panel
// (osqp_tpu_torch/csrc/kkt_lu.cu, cluster_panel_kernel) pays once per
// column: a write to shared memory, a cluster barrier, and a read of
// another CTA's shared memory, in clusters of 1, 4 and 16 CTAs of 256
// threads, for five forms of the barrier; and the latency of a float and
// a double division by a dividend that is zero, normal or tiny.
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o /tmp/microbench_cluster_sync tools/microbench_cluster_sync.cu
//   /tmp/microbench_cluster_sync
//
// Prints cycles per round (clock64 of CTA 0's thread 0, 2000 rounds) and
// cycles per division (a chain of 1000 in one warp).
#include <cooperative_groups.h>

#include <cstdio>

namespace cg = cooperative_groups;

__device__ __forceinline__ void arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void arrive_release() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wait_acquire() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void fence_cta() { asm volatile("fence.acq_rel.cta;\n" ::: "memory"); }
__device__ __forceinline__ void fence_cluster() { asm volatile("fence.acq_rel.cluster;\n" ::: "memory"); }

template <int kForm>
__global__ void rounds(long long* out, int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ double v[64];
  v[threadIdx.x & 63] = threadIdx.x;
  cluster.sync();
  const int C = static_cast<int>(cluster.num_blocks());
  double acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (threadIdx.x == 0) v[i & 63] = i;
    if (kForm == 0) cluster.sync();
    if (kForm == 1) {
      fence_cta();
      arrive_relaxed();
      wait_acquire();
    }
    if (kForm == 2) {
      arrive_relaxed();
      wait_acquire();
    }
    if (kForm == 3) {
      arrive_release();
      wait_acquire();
    }
    if (kForm == 4) {
      fence_cluster();
      arrive_relaxed();
      wait_acquire();
    }
    if (threadIdx.x == 0) acc += *cluster.map_shared_rank(&v[i & 63], (cluster.block_rank() + 1) % C);
  }
  const long long t1 = clock64();
  cluster.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = static_cast<long long>(acc);
  }
}

template <int kForm>
void run(const char* name, long long* d) {
  cudaFuncSetAttribute(rounds<kForm>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int C : {1, 4, 16}) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(256);
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = C;
    a[0].val.clusterDim.y = 1;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, rounds<kForm>, d, 2000);
    const cudaError_t e = cudaDeviceSynchronize();
    long long h[2];
    cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
    printf("%-46s C=%2d: %.1f cycles per round%s\n", name, C, h[0] / 2000.0, e == cudaSuccess ? "" : " (CUDA error)");
  }
}

template <typename T>
__global__ void divisions(long long* out, T num, T den, int iters) {
  T x = num + threadIdx.x * T(0), d = den + threadIdx.x * T(0), acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    acc += x / d;
    x = x * T(1) + acc * T(0);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = static_cast<long long>(acc);
  }
}

int main() {
  long long* d;
  cudaMalloc(&d, 64);
  run<0>("cluster.sync()", d);
  run<1>("fence.acq_rel.cta, arrive.relaxed, wait", d);
  run<2>("arrive.relaxed, wait (no fence)", d);
  run<3>("arrive.release, wait", d);
  run<4>("fence.acq_rel.cluster, arrive.relaxed, wait", d);
  for (double n : {1.5, 0.0, 1e-300}) {
    long long h[2];
    divisions<double><<<1, 32>>>(d, n, 3.7, 1000);
    cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
    printf("double %g / 3.7: %.1f cycles per division\n", n, h[0] / 1000.0);
    divisions<float><<<1, 32>>>(d, static_cast<float>(n), 3.7f, 1000);
    cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
    printf("float %g / 3.7: %.1f cycles per division\n", static_cast<float>(n), h[0] / 1000.0);
  }
  return 0;
}
