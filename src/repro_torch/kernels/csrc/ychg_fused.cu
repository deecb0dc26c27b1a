// Both yCHG steps for a (B, H, W) mask stack, for Hopper (sm_90a).
//
// ychg_fused_full replaces the Pallas kernel
//   src/repro/kernels/ychg_fused.py::_fused_kernel (wrapper fused_analyze_pallas).
// ychg_fused_splith replaces
//   src/repro/kernels/ychg_fused.py::_fused_streamed_kernel (wrapper
//   fused_analyze_streamed).
//
// What bounds them: device-memory bytes. Each pixel is read once and costs
// about three integer operations; the outputs are 13 bytes a column plus 8 a
// image. The serving batch, 8 x 8192^2 uint8, reads 536,870,912 B: about
// 0.16 ms at 3.35 TB/s. A 21000^2 scene reads 441 MB: about 0.13 ms.
//
// What the design does about it:
//  * One thread per column (the paper's own CUDA mapping). Consecutive
//    threads take consecutive columns of one image, so each row's loads
//    coalesce, and the row loop is unrolled so that several rows' loads are
//    in flight per thread.
//  * The mask is read in its own dtype (uint8/bool, int32 or float32) and
//    the ragged right edge is masked here: no cast-and-pad pass over device
//    memory before the launch, as the TPU wrapper needs.
//  * The TPU kernels carry the left neighbour's run count from one W tile
//    to the next in a (1, 1) VMEM scratch, which relies on the TPU's
//    sequential grid. CUDA blocks run in no order, so no block depends on
//    another: in ychg_fused_full the column tiles overlap by one column
//    (kThreads threads own kThreads - 1 columns; thread 0 scans the left
//    neighbour), and step 2 diffs against shared memory.
//  * Per-image totals: a block reduction, then one int32 atomicAdd per
//    block. Integer addition is exact in any order, so the totals are
//    deterministic.
//  * ychg_fused_splith cuts H into segments of block_h rows, one grid z
//    index each, so that a few wide images (a 21000^2 scene gives only
//    21,000 columns, about 8% of the card's resident warps) still fill the
//    card. A segment starts `prev` from the row just above it instead of a
//    carried row, and adds its partial count into `runs` with atomicAdd.
//    Step 2 and the totals then run in a second small launch over (B, W),
//    once every segment is in (chosen over a last-arriving-block counter:
//    it needs no extra zeroed scratch and no memory fences).
//  * Pixel offsets are 64-bit: 8 x 21000^2 is more than 2^31.
//
// Binding: plain C entry points, loaded with ctypes. Each launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
// The caller zeroes nh, nt and (for split-H) runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum DType : int { kU8 = 0, kI32 = 1, kF32 = 2 };

template <typename T>
__device__ __forceinline__ int foreground(T v) {
  return v != T(0);
}

// float32 as the reference's XLA decides it: +-0 and every subnormal (all
// exponent bits zero) are background, NaN and +-inf foreground. Tested on
// the bits, so no compiler flush mode can change it.
template <>
__device__ __forceinline__ int foreground<float>(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0u;
}

// Step 1 over `rows` rows of one column, starting at p, entered with the
// foreground bit of the row above (0 at the top of the image).
template <typename T>
__device__ __forceinline__ int scan_column(const T* __restrict__ p, int64_t W,
                                           int64_t rows, int prev) {
  int runs = 0;
#pragma unroll 16
  for (int64_t r = 0; r < rows; ++r) {
    const int x = foreground(p[r * W]);
    runs += x & (prev ^ 1);
    prev = x;
  }
  return runs;
}

// Sums births and transitions over the block and adds them to the image's
// totals. Every thread of the block must call it.
__device__ __forceinline__ void add_block_totals(int births, int trans,
                                                 int* nh, int* nt) {
  __shared__ int s_births[kWarps];
  __shared__ int s_trans[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    births += __shfl_down_sync(0xffffffffu, births, o);
    trans += __shfl_down_sync(0xffffffffu, trans, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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

// Grid (ceil(W / (kThreads - 1)), B). Thread t of block x scans column
// x * (kThreads - 1) - 1 + t; threads 1.. own their columns, thread 0 only
// supplies the left neighbour of thread 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_full_kernel(const T* __restrict__ img, int64_t H, int64_t W,
                  int* __restrict__ runs, uint8_t* __restrict__ trans,
                  int* __restrict__ births, int* __restrict__ deaths,
                  int* __restrict__ nh, int* __restrict__ nt) {
  __shared__ int s_runs[kThreads];
  const int64_t b = blockIdx.y;
  const int64_t col =
      static_cast<int64_t>(blockIdx.x) * (kThreads - 1) - 1 + threadIdx.x;
  int run = 0;
  if (col >= 0 && col < W) run = scan_column(img + b * H * W + col, W, H, 0);
  s_runs[threadIdx.x] = run;
  __syncthreads();
  int2 tot = make_int2(0, 0);
  if (threadIdx.x > 0 && col < W) {
    runs[b * W + col] = run;
    tot = finish_column(run, s_runs[threadIdx.x - 1], b * W + col, trans,
                        births, deaths);
  }
  add_block_totals(tot.x, tot.y, nh + b, nt + b);
}

// Grid (ceil(W / kThreads), B, ceil(H / block_h)): one H segment of one
// column per thread, its count added into runs (zeroed by the caller).
template <typename T>
__global__ void __launch_bounds__(kThreads)
splith_scan_kernel(const T* __restrict__ img, int64_t H, int64_t W,
                   int64_t block_h, int* __restrict__ runs) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= W) return;
  const int64_t b = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.z) * block_h;
  const int64_t rows = (H - r0 < block_h) ? H - r0 : block_h;
  const T* p = img + b * H * W + r0 * W + col;
  const int prev = r0 > 0 ? foreground(p[-W]) : 0;
  const int part = scan_column(p, W, rows, prev);
  if (part) atomicAdd(runs + b * W + col, part);
}

// Grid (ceil(W / kThreads), B): step 2 and the totals over complete counts.
__global__ void __launch_bounds__(kThreads)
splith_finish_kernel(int64_t W, const int* __restrict__ runs,
                     uint8_t* __restrict__ trans, int* __restrict__ births,
                     int* __restrict__ deaths, int* __restrict__ nh,
                     int* __restrict__ nt) {
  const int64_t b = blockIdx.y;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int2 tot = make_int2(0, 0);
  if (col < W) {
    const int64_t o = b * W + col;
    const int left = col > 0 ? runs[o - 1] : 0;
    tot = finish_column(runs[o], left, o, trans, births, deaths);
  }
  add_block_totals(tot.x, tot.y, nh + b, nt + b);
}

template <typename T>
void launch_full(const void* img, int64_t B, int64_t H, int64_t W, void* runs,
                 void* trans, void* births, void* deaths, void* nh, void* nt,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((W + kThreads - 2) / (kThreads - 1)),
                  static_cast<unsigned>(B));
  fused_full_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), H, W, static_cast<int*>(runs),
      static_cast<uint8_t*>(trans), static_cast<int*>(births),
      static_cast<int*>(deaths), static_cast<int*>(nh), static_cast<int*>(nt));
}

template <typename T>
void launch_splith_scan(const void* img, int64_t B, int64_t H, int64_t W,
                        int64_t block_h, void* runs, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B),
                  static_cast<unsigned>((H + block_h - 1) / block_h));
  splith_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), H, W, block_h, static_cast<int*>(runs));
}

bool valid_args(int dtype, int64_t B, int64_t H, int64_t W) {
  // grid y holds B; a grid dimension of 0 is an invalid launch
  return (dtype == kU8 || dtype == kI32 || dtype == kF32) && B >= 1 &&
         B <= 65535 && H >= 0 && W >= 1 &&
         (W + kThreads - 1) / kThreads <= 0x7fffffff;
}

}  // namespace

extern "C" int ychg_fused_full(const void* img, int dtype, int64_t B, int64_t H,
                               int64_t W, void* runs, void* trans,
                               void* births, void* deaths, void* nh, void* nt,
                               void* stream) {
  if (!valid_args(dtype, B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kU8:
      launch_full<uint8_t>(img, B, H, W, runs, trans, births, deaths, nh, nt, s);
      break;
    case kI32:
      launch_full<int32_t>(img, B, H, W, runs, trans, births, deaths, nh, nt, s);
      break;
    case kF32:
      launch_full<float>(img, B, H, W, runs, trans, births, deaths, nh, nt, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ychg_fused_splith(const void* img, int dtype, int64_t B,
                                 int64_t H, int64_t W, int64_t block_h,
                                 void* runs, void* trans, void* births,
                                 void* deaths, void* nh, void* nt,
                                 void* stream) {
  if (!valid_args(dtype, B, H, W) || block_h < 1 ||
      (H + block_h - 1) / block_h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H > 0) {
    switch (dtype) {
      case kU8:
        launch_splith_scan<uint8_t>(img, B, H, W, block_h, runs, s);
        break;
      case kI32:
        launch_splith_scan<int32_t>(img, B, H, W, block_h, runs, s);
        break;
      case kF32:
        launch_splith_scan<float>(img, B, H, W, block_h, runs, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  splith_finish_kernel<<<grid, kThreads, 0, s>>>(
      W, static_cast<const int*>(runs), static_cast<uint8_t*>(trans),
      static_cast<int*>(births), static_cast<int*>(deaths),
      static_cast<int*>(nh), static_cast<int*>(nt));
  return static_cast<int>(cudaGetLastError());
}
