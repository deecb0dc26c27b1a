// Step 2 of yCHG and the per-image totals, shared by ychg_fused.cu and
// ychg_colscan.cu, and the programmatic dependent launch that puts a step-2
// kernel right behind its step-1 kernel on Hopper (sm_90).
//
//  * finish_column: births, deaths and the transition flag of one column
//    from its run count and its left neighbour's.
//  * add_block_totals: the block's births and transitions summed by warp
//    shuffles and shared memory, then one int32 atomicAdd each into the
//    image's totals. Integer sums: the same result in any order.
//  * launch_dependent: launches a kernel with
//    cudaLaunchAttributeProgrammaticStreamSerialization, so the card may
//    schedule its blocks while the kernel ahead of it in the stream is
//    still running; the launch latency overlaps that kernel's tail. Such a
//    kernel calls wait_for_prior_grid() before its first read of what the
//    kernel ahead of it wrote. Every step-2 launch goes out this way: on
//    the H100 it beat plain stream order by about 5% on the serving batch
//    (chip_smoke.py's pdl: line, which times it against
//    ychg_colscan_analyze_stream_order).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cudaGridDependencySynchronize(), written as the PTX it compiles to: waits
// until the grid ahead of this one in the stream has ended and its stores
// are visible. Returns at once in a grid launched in plain stream order.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Step 2 for one column at flat offset o; returns (births, transition).
__device__ __forceinline__ int2 finish_column(int run, int left, int64_t o,
                                              uint8_t* __restrict__ trans,
                                              int* __restrict__ births,
                                              int* __restrict__ deaths) {
  const int delta = run - left;
  const int born = delta > 0 ? delta : 0;
  const int t = delta != 0;
  trans[o] = static_cast<uint8_t>(t);  // torch.bool: the byte is 0 or 1
  births[o] = born;
  deaths[o] = delta < 0 ? -delta : 0;
  return make_int2(born, t);
}

// Sums births and transitions over a block of kBlock threads and adds them
// to the image's totals. Every thread of the block must call it.
template <int kBlock>
__device__ __forceinline__ void add_block_totals(int births, int trans,
                                                 int* nh, int* nt) {
  constexpr int kWarps = kBlock / 32;
  __shared__ int s_births[kWarps];
  __shared__ int s_trans[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    births += __shfl_down_sync(0xffffffffu, births, o);
    trans += __shfl_down_sync(0xffffffffu, trans, o);
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    s_births[warp] = births;
    s_trans[warp] = trans;
  }
  __syncthreads();
  if (warp == 0) {
    births = lane < kWarps ? s_births[lane] : 0;
    trans = lane < kWarps ? s_trans[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      births += __shfl_down_sync(0xffffffffu, births, o);
      trans += __shfl_down_sync(0xffffffffu, trans, o);
    }
    if (lane == 0) {
      if (births) atomicAdd(nh, births);
      if (trans) atomicAdd(nt, trans);
    }
  }
}

// Launches kernel<<<grid, block, 0, stream>>>(args...) as a programmatic
// dependent launch; returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace
