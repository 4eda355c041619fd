// What one round of a block-wide reduction costs on the card when the block
// becomes a thread block cluster: the question behind running the K1 LM level
// (sdvo_tpu_torch/csrc/lm_align.cu) on several SMs with the windows in
// distributed shared memory. An LM iteration is a chain of about fifteen
// barriers (eight reductions of two barriers each); in a cluster each becomes
// a cluster barrier and the partials cross SMs.
//
// Build and run on a Hopper card, from the repository root:
//   nvcc -arch=sm_90a -O3 -o build/cluster_sync_cost tools/cluster_sync_cost.cu
//   build/cluster_sync_cost
//
// Prints, in cycles of thread 0's clock64() per round over 1000 rounds, for
// one block of 1024 threads and for clusters of 4 × 256, 4 × 1024 and
// 8 × 128 threads: a pair of barriers alone, and a full reduction round of
// one float (warp shuffles, partials to the shared memory of block 0, a
// barrier, warp 0 of block 0 combines and publishes to every block, a
// barrier, every thread reads the total). Exits non-zero on any CUDA error.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

constexpr int kRounds = 1000;
constexpr int kMaxWarps = 128;  // in the whole cluster
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// kCluster: the barriers are cluster barriers and block 0 holds the partials.
template <bool kCluster>
__global__ void rounds(long long* cycles, float* sink, int reduce) {
  __shared__ float part[kMaxWarps];
  __shared__ float tot;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int rank = kCluster ? (int)cluster.block_rank() : 0;
  const int blocks = kCluster ? (int)cluster.num_blocks() : 1;
  float* part0 = kCluster ? cluster.map_shared_rank(part, 0) : part;
  const auto barrier = [&] {
    if (kCluster)
      cluster.sync();
    else
      __syncthreads();
  };
  float x = 1e-3f * (float)threadIdx.x;
  barrier();
  const long long t0 = clock64();
  for (int r = 0; r < kRounds; ++r) {
    if (reduce) {
      const float v = warp_sum(x);
      if (lane == 0) part0[rank * warps + warp] = v;
    }
    barrier();
    if (reduce && rank == 0 && warp == 0) {
      float v = 0.f;
      for (int i = lane; i < blocks * warps; i += 32) v += part[i];
      v = warp_sum(v);
      if (lane < blocks) {
        float* out = kCluster ? cluster.map_shared_rank(&tot, lane) : &tot;
        *out = v;
      }
    }
    barrier();
    if (reduce) x = x + 1e-9f * tot;  // the next round depends on this one
  }
  const long long t1 = clock64();
  if (blockIdx.x == 0 && threadIdx.x == 0) cycles[0] = t1 - t0;
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

static int fail(const char* what, cudaError_t e) {
  std::fprintf(stderr, "cluster_sync_cost: %s: %s\n", what, cudaGetErrorString(e));
  return 1;
}

static int measure(int blocks, int threads, int reduce, long long* d_cycles, float* d_sink) {
  cudaError_t e;
  if (blocks == 1) {
    rounds<false><<<1, threads>>>(d_cycles, d_sink, reduce);
    e = cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = blocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, rounds<true>, d_cycles, d_sink, reduce);
  }
  if (e != cudaSuccess) return fail("launch", e);
  if ((e = cudaDeviceSynchronize()) != cudaSuccess) return fail("synchronize", e);
  long long cycles = 0;
  if ((e = cudaMemcpy(&cycles, d_cycles, sizeof(cycles), cudaMemcpyDeviceToHost)) != cudaSuccess)
    return fail("copy", e);
  std::printf("%d x %4d threads, %s: %8.1f cycles a round\n", blocks, threads,
              reduce ? "reduction round " : "two barriers alone", (double)cycles / kRounds);
  return 0;
}

int main() {
  cudaDeviceProp prop;
  cudaError_t e = cudaGetDeviceProperties(&prop, 0);
  if (e != cudaSuccess) return fail("no device", e);
  std::printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  long long* d_cycles;
  float* d_sink;
  if ((e = cudaMalloc(&d_cycles, sizeof(long long))) != cudaSuccess) return fail("malloc", e);
  if ((e = cudaMalloc(&d_sink, 8 * 1024 * sizeof(float))) != cudaSuccess) return fail("malloc", e);
  const int forms[4][2] = {{1, 1024}, {4, 256}, {4, 1024}, {8, 128}};
  for (int pass = 0; pass < 2; ++pass) {
    std::printf(pass == 0 ? "first pass (warm-up):\n" : "second pass:\n");
    for (const auto& f : forms)
      for (int reduce = 0; reduce < 2; ++reduce)
        if (measure(f[0], f[1], reduce, d_cycles, d_sink)) return 1;
  }
  cudaFree(d_cycles);
  cudaFree(d_sink);
  return 0;
}
