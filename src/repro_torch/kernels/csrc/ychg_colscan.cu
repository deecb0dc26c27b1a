// The paper's two-kernel yCHG for one (H, W) mask, for Hopper (sm_90a):
// step 1 (per-column maximal-run counts), then step 2 (neighbour diff).
//
// ychg_colscan_full replaces the Pallas kernel
//   src/repro/kernels/ychg_colscan.py::_colscan_kernel (wrapper
//   colscan_runs_pallas).
// ychg_colscan_splith replaces
//   src/repro/kernels/ychg_colscan.py::_colscan_streamed_kernel (wrapper
//   colscan_runs_streamed).
// ychg_diff replaces
//   src/repro/kernels/ychg_colscan.py::_diff_kernel (wrapper
//   transitions_pallas).
//
// What bounds them:
//  * Step 1 (both kernels): device-memory bytes. Each pixel is read once
//    and costs about three integer operations; the output is 4 bytes a
//    column. One 8192^2 uint8 mask reads 67,108,864 B: about 0.020 ms at
//    3.35 TB/s. But one image is little work for the card: 8192 columns at
//    one thread each are about two warps an SM, so the latency of the loads
//    down each column, not the bytes, sets the time unless more threads
//    share a column.
//  * Step 2: launch latency. At W = 8192 it reads 32,768 B and writes
//    73,728 B, about 32 ns at 3.35 TB/s, far below the few microseconds a
//    launch takes.
//
// What the design does about it:
//  * ychg_colscan_full is the full-column scan of ychg_scan.cuh (which
//    states its design) for one image, without the halo column: wide vector
//    loads along a row, uint8 counted four pixels a 32-bit word, H cut into
//    row segments among the warps of a block, each entered with the row
//    just above it, and summed in shared memory; the block's lanes chosen
//    at launch so that one image fills the card. Each block writes its
//    tile's runs.
//  * The TPU's streamed kernel carries the last row of one H block to the
//    next in VMEM scratch, which relies on the TPU running the grid in
//    order. CUDA blocks run in no order, so in ychg_colscan_splith every
//    block_h-row segment (one grid y index) starts from the row above itself
//    instead, and adds its count into `runs` with an int32 atomicAdd.
//    Integer addition gives the same sum in any order.
//  * The mask is read in place in its own dtype (uint8/bool, int32 or
//    float32), and ragged H and W are masked here: no (img != 0).astype(int8)
//    pass and no pad to a lane multiple, the TPU wrapper's extra passes over
//    device memory.
//  * ychg_diff reads runs[j] and runs[j - 1] directly (0 left of column 0),
//    where the TPU wrapper first writes a shifted copy of the runs, and
//    writes transitions as torch.bool bytes, births and deaths as int32.
//
// Binding: plain C entry points, loaded with ctypes. Each launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
// The caller zeroes `runs` for ychg_colscan_splith.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ychg_scan.cuh"

namespace {

constexpr int kThreads = 256;  // the split-H and diff kernels' blocks

// Maximal runs that start within `rows` rows of one column from p, entered
// with the foreground bit of the row above (0 at the top of the image).
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

// Grid tiles, block (lanes, kScanThreads / lanes): step 1 for one tile of
// lanes vectors (ychg_scan.cuh), its runs written.
template <typename T, int V>
__global__ void __launch_bounds__(kScanThreads, 1)
colscan_full_kernel(const uint8_t* __restrict__ img, int64_t H, int64_t W,
                    int64_t nvec, int* __restrict__ runs) {
  constexpr int E = V / static_cast<int>(sizeof(T));
  __shared__ ScanTile tile;
  scan_tile<T, V, false>(img, H, W, nvec, tile);
  const int lanes = blockDim.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * lanes * E;
  for (int c = threadIdx.y * lanes + threadIdx.x; c < lanes * E;
       c += kScanThreads) {
    if (c0 + c >= W) break;
    runs[c0 + c] = tile.runs[tile_index<E>(c)];
  }
}

// Grid (ceil(W / kThreads), ceil(H / block_h)): one segment of one column a
// thread, its count added into runs (zeroed by the caller).
template <typename T>
__global__ void __launch_bounds__(kThreads)
colscan_splith_kernel(const T* __restrict__ img, int64_t H, int64_t W,
                      int64_t block_h, int* __restrict__ runs) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= W) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * block_h;
  const int64_t rows = (H - r0 < block_h) ? H - r0 : block_h;
  const T* p = img + r0 * W + col;
  const int part = scan_column(p, W, rows, r0 > 0 ? foreground(p[-W]) : 0);
  if (part) atomicAdd(runs + col, part);
}

// Grid ceil(W / kThreads): step 2 for one column a thread.
__global__ void __launch_bounds__(kThreads)
diff_kernel(const int* __restrict__ runs, int64_t W,
            uint8_t* __restrict__ trans, int* __restrict__ births,
            int* __restrict__ deaths) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= W) return;
  const int delta = runs[j] - (j > 0 ? runs[j - 1] : 0);
  trans[j] = static_cast<uint8_t>(delta != 0);  // torch.bool: 0 or 1
  births[j] = delta > 0 ? delta : 0;
  deaths[j] = delta < 0 ? -delta : 0;
}

template <typename T>
void launch_splith(const void* img, int64_t H, int64_t W, int64_t block_h,
                   void* runs, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>((H + block_h - 1) / block_h));
  colscan_splith_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), H, W, block_h, static_cast<int*>(runs));
}

bool valid_width(int64_t W) {
  // a grid dimension of 0 is an invalid launch; x holds at most 2^31 - 1
  return W >= 1 && (W + kThreads - 1) / kThreads <= 0x7fffffff;
}

}  // namespace

extern "C" int ychg_colscan_full(const void* img, int dtype, int64_t H,
                                 int64_t W, void* runs, void* stream) {
  if (!valid_width(W) || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int isz = itemsize_of(dtype);
  const int vec = vec_bytes(img, W, isz);
  const int64_t nvec = W * isz / vec;
  const int lanes = choose_lanes(1, nvec, sm_count());
  const dim3 grid(static_cast<unsigned>((nvec + lanes - 1) / lanes));
  const dim3 block(lanes, kScanThreads / lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_layout(dtype, vec, [&](auto layout) {
    using T = typename decltype(layout)::type;
    colscan_full_kernel<T, decltype(layout)::vec><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(img), H, W, nvec, static_cast<int*>(runs));
  });
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ychg_colscan_splith(const void* img, int dtype, int64_t H,
                                   int64_t W, int64_t block_h, void* runs,
                                   void* stream) {
  // grid y holds the H segments, at most 65535
  if (!valid_width(W) || H < 1 || block_h < 1 ||
      (H + block_h - 1) / block_h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kU8:
      launch_splith<uint8_t>(img, H, W, block_h, runs, s);
      break;
    case kI32:
      launch_splith<int32_t>(img, H, W, block_h, runs, s);
      break;
    case kF32:
      launch_splith<float>(img, H, W, block_h, runs, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ychg_diff(const void* runs, int64_t W, void* trans,
                         void* births, void* deaths, void* stream) {
  if (!valid_width(W)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads));
  diff_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(runs), W, static_cast<uint8_t*>(trans),
      static_cast<int*>(births), static_cast<int*>(deaths));
  return static_cast<int>(cudaGetLastError());
}
