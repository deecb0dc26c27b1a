// The paper's two-kernel yCHG, for Hopper (sm_90a): step 1 (per-column
// maximal-run counts), then step 2 (neighbour diff), for one (H, W) mask or,
// in one host call, for a (B, H, W) stack.
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
//  * Step 2: launch latency and the host. At W = 8192 it reads 32,768 B
//    and writes 73,728 B (106,496 B with the cut vertices), about 32 ns at
//    3.35 TB/s, far below the few microseconds a launch takes; a PyTorch
//    op or allocation a mask on the host costs more than both kernels.
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
//    A second instantiation of it ends the two-kernel path of
//    ychg_colscan_analyze: it also writes the cut vertices (2 * runs) and
//    adds the image's n_hyperedges and n_transitions (a block reduction,
//    then one int32 atomicAdd a block; ychg_step2.cuh), the fields that
//    kernels/ops.py and core.ychg.analyze put after step 2, so no PyTorch
//    op runs on the result.
//  * ychg_colscan_analyze runs the two-kernel path for a whole (B, H, W)
//    stack in one host call: for each mask, step 1 (ychg_colscan_full, or
//    ychg_colscan_splith when block_h > 0) and then step 2, two launches a
//    mask as the JAX package's pallas backend makes. Step 2 goes out as a
//    programmatic dependent launch (ychg_step2.cuh: its launch overlaps
//    the tail of step 1) and waits for step 1 before its first read of
//    runs. The SM count is read once a call. ychg_colscan_analyze_stream_order
//    is the same call with step 2 in plain stream order, kept only for the
//    diagnostic that times the two launches against each other.
//
// Binding: plain C entry points, loaded with ctypes. Each launches on the
// stream it is given, allocates nothing, and returns the first launch
// error. The caller zeroes `runs` for ychg_colscan_splith, and the totals
// (and, when block_h > 0, `runs`) for ychg_colscan_analyze.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ychg_scan.cuh"
#include "ychg_step2.cuh"

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
  scan_tile<T, V, false>(img, 0, H, W, nvec, tile);
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

// Grid ceil(W / kThreads): step 2 for one column a thread; with kTotals
// also the cut vertices and the image's totals.
template <bool kTotals>
__global__ void __launch_bounds__(kThreads)
diff_kernel(const int* __restrict__ runs, int64_t W, int* __restrict__ cut,
            uint8_t* __restrict__ trans, int* __restrict__ births,
            int* __restrict__ deaths, int* __restrict__ nh,
            int* __restrict__ nt) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int2 t = make_int2(0, 0);
  wait_for_prior_grid();  // step 1 has written runs
  if (j < W) {
    const int run = runs[j];
    if constexpr (kTotals) cut[j] = 2 * run;
    t = finish_column(run, j > 0 ? runs[j - 1] : 0, j, trans, births, deaths);
  }
  if constexpr (kTotals) add_block_totals<kThreads>(t.x, t.y, nh, nt);
}

// Step 1 of one (H, W) mask over whole columns, on `sms` SMs; false for a
// dtype code no kernel takes.
bool launch_full(const void* img, int dtype, int64_t H, int64_t W, void* runs,
                 int sms, cudaStream_t s) {
  const int isz = itemsize_of(dtype);
  const int vec = vec_bytes(img, W, isz);
  const int64_t nvec = W * isz / vec;
  const int lanes = choose_lanes(1, nvec, sms);
  const dim3 grid(static_cast<unsigned>((nvec + lanes - 1) / lanes));
  const dim3 block(lanes, kScanThreads / lanes);
  return with_layout(dtype, vec, [&](auto layout) {
    using T = typename decltype(layout)::type;
    colscan_full_kernel<T, decltype(layout)::vec><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(img), H, W, nvec, static_cast<int*>(runs));
  });
}

template <typename T>
void launch_splith_as(const void* img, int64_t H, int64_t W, int64_t block_h,
                      void* runs, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>((H + block_h - 1) / block_h));
  colscan_splith_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), H, W, block_h, static_cast<int*>(runs));
}

// Step 1 of one (H, W) mask, H >= 1, in block_h-row segments; false for a
// dtype code no kernel takes.
bool launch_splith(const void* img, int dtype, int64_t H, int64_t W,
                   int64_t block_h, void* runs, cudaStream_t s) {
  switch (dtype) {
    case kU8:
      launch_splith_as<uint8_t>(img, H, W, block_h, runs, s);
      return true;
    case kI32:
      launch_splith_as<int32_t>(img, H, W, block_h, runs, s);
      return true;
    case kF32:
      launch_splith_as<float>(img, H, W, block_h, runs, s);
      return true;
  }
  return false;
}

bool valid_width(int64_t W) {
  // a grid dimension of 0 is an invalid launch; x holds at most 2^31 - 1
  return W >= 1 && (W + kThreads - 1) / kThreads <= 0x7fffffff;
}

bool valid_segments(int64_t H, int64_t block_h) {
  // grid y holds the H segments, at most 65535
  return block_h >= 1 && (H + block_h - 1) / block_h <= 65535;
}

// The two-kernel path over a (B, H, W) stack: for each mask, step 1
// (split-H when block_h > 0), then step 2 with the cut vertices and the
// totals, as a programmatic dependent launch (in plain stream order when
// `pdl` is false: the diagnostic ychg_colscan_analyze_stream_order).
int analyze_stack(const void* img, int dtype, int64_t B, int64_t H, int64_t W,
                  int64_t block_h, void* runs, void* cut, void* trans,
                  void* births, void* deaths, void* nh, void* nt,
                  void* stream, bool pdl) {
  if (!valid_width(W) || B < 0 || H < 0 || block_h < 0 ||
      (block_h > 0 && !valid_segments(H, block_h)) ||
      (dtype != kU8 && dtype != kI32 && dtype != kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  const int64_t image = H * W * itemsize_of(dtype);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads));
  for (int64_t b = 0; b < B; ++b) {
    const void* x = static_cast<const uint8_t*>(img) + b * image;
    int* r = static_cast<int*>(runs) + b * W;
    bool launched = true;
    if (block_h == 0)
      launched = launch_full(x, dtype, H, W, r, sms, s);
    else if (H > 0)  // else no segment: runs stays zero
      launched = launch_splith(x, dtype, H, W, block_h, r, s);
    if (!launched) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    int* c = static_cast<int*>(cut) + b * W;
    uint8_t* t = static_cast<uint8_t*>(trans) + b * W;
    int* bo = static_cast<int*>(births) + b * W;
    int* de = static_cast<int*>(deaths) + b * W;
    int* h = static_cast<int*>(nh) + b;
    int* n = static_cast<int*>(nt) + b;
    if (pdl) {
      err = launch_dependent(diff_kernel<true>, grid, dim3(kThreads), s, r, W,
                             c, t, bo, de, h, n);
    } else {
      diff_kernel<true><<<grid, kThreads, 0, s>>>(r, W, c, t, bo, de, h, n);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ychg_colscan_full(const void* img, int dtype, int64_t H,
                                 int64_t W, void* runs, void* stream) {
  if (!valid_width(W) || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!launch_full(img, dtype, H, W, runs, sm_count(),
                   static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ychg_colscan_splith(const void* img, int dtype, int64_t H,
                                   int64_t W, int64_t block_h, void* runs,
                                   void* stream) {
  if (!valid_width(W) || H < 1 || !valid_segments(H, block_h))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!launch_splith(img, dtype, H, W, block_h, runs,
                     static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ychg_diff(const void* runs, int64_t W, void* trans,
                         void* births, void* deaths, void* stream) {
  if (!valid_width(W)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads));
  diff_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(runs), W, nullptr, static_cast<uint8_t*>(trans),
      static_cast<int*>(births), static_cast<int*>(deaths), nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// block_h = 0: the full-column route; block_h > 0: split-H.
extern "C" int ychg_colscan_analyze(const void* img, int dtype, int64_t B,
                                    int64_t H, int64_t W, int64_t block_h,
                                    void* runs, void* cut, void* trans,
                                    void* births, void* deaths, void* nh,
                                    void* nt, void* stream) {
  return analyze_stack(img, dtype, B, H, W, block_h, runs, cut, trans, births,
                       deaths, nh, nt, stream, true);
}

// The same with step 2 in plain stream order: a diagnostic, which times the
// programmatic dependent launch above against it.
extern "C" int ychg_colscan_analyze_stream_order(
    const void* img, int dtype, int64_t B, int64_t H, int64_t W,
    int64_t block_h, void* runs, void* cut, void* trans, void* births,
    void* deaths, void* nh, void* nt, void* stream) {
  return analyze_stack(img, dtype, B, H, W, block_h, runs, cut, trans, births,
                       deaths, nh, nt, stream, false);
}
