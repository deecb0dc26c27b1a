// Both yCHG steps for a (B, H, W) mask stack, for Hopper (sm_90a).
//
// ychg_fused_full replaces the Pallas kernel
//   src/repro/kernels/ychg_fused.py::_fused_kernel (wrapper fused_analyze_pallas).
// ychg_fused_splith replaces
//   src/repro/kernels/ychg_fused.py::_fused_streamed_kernel (wrapper
//   fused_analyze_streamed).
//
// What bounds them: device-memory bytes. Each pixel is read once and costs
// a few integer operations; the outputs are 13 bytes a column plus 8 a
// image. The serving batch, 8 x 8192^2 uint8, reads 536,870,912 B: about
// 0.16 ms at 3.35 TB/s. A 21000^2 scene reads 441 MB: about 0.13 ms.
//
// What the design does about it:
//  * ychg_fused_full is the full-column scan of ychg_scan.cuh (which states
//    its design): wide vector loads along a row, uint8 counted four pixels
//    a 32-bit word, H cut into row segments among the warps of a block and
//    summed in shared memory, the lanes of a block chosen at launch so
//    that one image fills the card, and a halo column for step 2. Then, in
//    the same launch, step 2 for the block's columns from shared memory and
//    the totals. Grid (tiles, B).
//  * The mask is read in its own dtype (uint8/bool, int32 or float32) and
//    every row is whole vectors: no cast-and-pad pass over device memory
//    before the launch, as the TPU wrapper needs.
//  * The TPU kernels carry the left neighbour's run count from one W tile
//    to the next in a (1, 1) VMEM scratch, which relies on the TPU's
//    sequential grid. CUDA blocks run in no order, so no block depends on
//    another: a ychg_fused_full block scans the column left of its tile
//    itself (the halo), and ychg_fused_splith runs step 2 in a second small
//    launch.
//  * Per-image totals: a block reduction, then one int32 atomicAdd per
//    block. Integer addition is exact in any order, so the totals are
//    deterministic.
//  * ychg_fused_splith is the same scan over a range of rows: grid z cuts H
//    into ranges of block_h rows, the block_h of the API and of the plain
//    version, and each block scans one range of one tile, its row segments
//    entered from the image row above, as in ychg_fused_full. Grid (tiles,
//    B, ceil(H / block_h)); the lanes are chosen as if each (image, range)
//    pair were an image, so one tall image fills the card. Each block adds
//    its tile's counts into the zeroed `runs`, one int32 atomicAdd a column.
//    Step 2 and the totals then run in a second small kernel over (B, W),
//    once every range is in (chosen over a last-arriving-block counter: it
//    needs no extra zeroed scratch and no memory fences), launched as a
//    programmatic dependent launch (ychg_step2.cuh).
//  * Pixel offsets are 64-bit: 8 x 21000^2 is more than 2^31.
//
// Binding: plain C entry points, loaded with ctypes. Each launches on the
// stream it is given, allocates nothing, and returns the first launch error.
// The caller zeroes nh, nt and (for split-H) runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ychg_scan.cuh"
#include "ychg_step2.cuh"

namespace {

constexpr int kThreads = 256;  // the split-H step-2 kernel's blocks

// Grid (tiles, B), block (lanes, kScanThreads / lanes): step 1 for one tile
// of lanes vectors of one image (ychg_scan.cuh), then step 2 and the totals
// for the tile's columns.
template <typename T, int V>
__global__ void __launch_bounds__(kScanThreads, 1)
fused_full_kernel(const uint8_t* __restrict__ img, int64_t H, int64_t W,
                  int64_t nvec, int* __restrict__ runs,
                  uint8_t* __restrict__ trans, int* __restrict__ births,
                  int* __restrict__ deaths, int* __restrict__ nh,
                  int* __restrict__ nt) {
  constexpr int E = V / static_cast<int>(sizeof(T));
  __shared__ ScanTile tile;
  const int64_t b = blockIdx.y;
  scan_tile<T, V, true>(img + b * H * W * static_cast<int64_t>(sizeof(T)), 0,
                        H, W, nvec, tile);
  const int lanes = blockDim.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * lanes * E;
  int born = 0;
  int changed = 0;
  for (int c = threadIdx.y * lanes + threadIdx.x; c < lanes * E;
       c += kScanThreads) {
    if (c0 + c >= W) break;
    const int run = tile.runs[tile_index<E>(c)];
    const int left = c > 0 ? tile.runs[tile_index<E>(c - 1)] : tile.halo;
    const int64_t o = b * W + c0 + c;
    runs[o] = run;
    const int2 t = finish_column(run, left, o, trans, births, deaths);
    born += t.x;
    changed += t.y;
  }
  add_block_totals<kScanThreads>(born, changed, nh + b, nt + b);
}

// Grid (tiles, B, ceil(H / block_h)), block (lanes, kScanThreads / lanes):
// step 1 for one tile of lanes vectors over one range of block_h rows of
// one image (ychg_scan.cuh), its counts added into runs (zeroed by the
// caller).
template <typename T, int V>
__global__ void __launch_bounds__(kScanThreads, 1)
splith_scan_kernel(const uint8_t* __restrict__ img, int64_t H, int64_t W,
                   int64_t nvec, int64_t block_h, int* __restrict__ runs) {
  constexpr int E = V / static_cast<int>(sizeof(T));
  __shared__ ScanTile tile;
  const int64_t b = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.z) * block_h;
  const int64_t nrows = H - row0 < block_h ? H - row0 : block_h;
  scan_tile<T, V, false>(img + b * H * W * static_cast<int64_t>(sizeof(T)),
                         row0, nrows, W, nvec, tile);
  const int lanes = blockDim.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * lanes * E;
  int* out = runs + b * W + c0;
  for (int c = threadIdx.y * lanes + threadIdx.x; c < lanes * E;
       c += kScanThreads) {
    if (c0 + c >= W) break;
    const int part = tile.runs[tile_index<E>(c)];
    if (part) atomicAdd(out + c, part);
  }
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
  wait_for_prior_grid();  // every range's counts are in runs
  if (col < W) {
    const int64_t o = b * W + col;
    const int left = col > 0 ? runs[o - 1] : 0;
    tot = finish_column(runs[o], left, o, trans, births, deaths);
  }
  add_block_totals<kThreads>(tot.x, tot.y, nh + b, nt + b);
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
  const int isz = itemsize_of(dtype);
  const int vec = vec_bytes(img, W, isz);
  const int64_t nvec = W * isz / vec;
  const int lanes = choose_lanes(B, nvec, sm_count());
  const dim3 grid(static_cast<unsigned>((nvec + lanes - 1) / lanes),
                  static_cast<unsigned>(B));
  const dim3 block(lanes, kScanThreads / lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool launched = with_layout(dtype, vec, [&](auto layout) {
    using T = typename decltype(layout)::type;
    fused_full_kernel<T, decltype(layout)::vec><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(img), H, W, nvec, static_cast<int*>(runs),
        static_cast<uint8_t*>(trans), static_cast<int*>(births),
        static_cast<int*>(deaths), static_cast<int*>(nh),
        static_cast<int*>(nt));
  });
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
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
    const int isz = itemsize_of(dtype);
    const int vec = vec_bytes(img, W, isz);
    const int64_t nvec = W * isz / vec;
    const int64_t ranges = (H + block_h - 1) / block_h;
    const int lanes = choose_lanes(B * ranges, nvec, sm_count());
    const dim3 grid(static_cast<unsigned>((nvec + lanes - 1) / lanes),
                    static_cast<unsigned>(B), static_cast<unsigned>(ranges));
    const dim3 block(lanes, kScanThreads / lanes);
    const bool launched = with_layout(dtype, vec, [&](auto layout) {
      using T = typename decltype(layout)::type;
      splith_scan_kernel<T, decltype(layout)::vec><<<grid, block, 0, s>>>(
          static_cast<const uint8_t*>(img), H, W, nvec, block_h,
          static_cast<int*>(runs));
    });
    if (!launched) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  const cudaError_t err = launch_dependent(
      splith_finish_kernel, grid, dim3(kThreads), s, W,
      static_cast<const int*>(runs), static_cast<uint8_t*>(trans),
      static_cast<int*>(births), static_cast<int*>(deaths),
      static_cast<int*>(nh), static_cast<int*>(nt));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
