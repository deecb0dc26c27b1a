// yCHG step 1 (and both steps) on a bit-packed mask, for Hopper (sm_90a).
//
// The mask comes packed eight rows to a byte: bit i of packed[r, c] is the
// foreground bit of row 8r + i of column c (LSB = top row), as
// kernels/ychg_packed.py::pack_rows makes it.
//
// ychg_packed_colscan replaces the Pallas kernel
//   src/repro/kernels/ychg_packed.py::_packed_colscan_kernel (wrapper
//   packed_colscan): (ceil(H/8), W) uint8 -> (W,) int32 run counts.
// ychg_packed_fused replaces
//   src/repro/kernels/ychg_packed.py::_packed_fused_kernel (wrapper
//   packed_analyze): the same count, then step 2 (transitions, births,
//   deaths), 2 * runs and the two totals, in one launch.
//
// What bounds them: device-memory bytes. The paper's 21000^2 scene packs
// to 2625 x 21000 = 55,125,000 B: about 0.0165 ms at 3.35 TB/s, an eighth
// of the unpacked scans' bound; the outputs are 4 bytes a column for the
// scan and 17 for the fused kernel. A byte of a popcount design costs at
// least five integer operations, and __popc issues at a quarter of the
// integer rate on sm_90: that alone would take 0.013 ms on the scene.
//
// What the design does about it: both kernels are the column scan of
// ychg_scan.cuh (which states its design) with the packed element kind
// PackedRows, so they load a packed row as uint8 is loaded, V bytes a
// thread (16, 8, 4, 2 or 1, from the base address and the pitch), and
// count four packed bytes in one 32-bit word with shifts, logic ops and
// adds: about 13 operations a word, 3.3 a byte, all at the full rate
// (0.011 ms on the scene at 16.7 x 10^12 op/s, under its byte bound).
//  * Each column is cut into row segments, each entered with the packed
//    word just above it (0 at the top: the seam identity of
//    ychg_colscan_splith, a word at a time); the segments' counts are
//    summed in shared memory. The TPU kernel instead holds a whole packed
//    column tile in VMEM and shifts the MSB plane down one row.
//  * A packed mask has an eighth of the rows of the mask it packs, so the
//    tiles are chosen for it (choose_packed_lanes): 256-thread blocks, four
//    a SM at 64 registers a thread, and the widest tile whose blocks reach
//    two a SM. The packed scene (2625 vectors of 8 B a row) takes 8 lanes
//    (64 B a row), 329 blocks in one wave of 528 slots, 32 segments of 83
//    packed rows; the packed 8192^2 mask (512 vectors of 16 B) takes 4
//    lanes, 128 blocks, 64 segments of 16 packed rows. On the H100 these
//    were the fastest of twelve tilings, from 2 to 32 lanes and 256 to
//    1024 threads, for both kernels on both masks, or within 3% of it;
//    16 x 512 took 16% longer for the fused kernel on the scene (PERF.md).
//  * The TPU's fused kernel diffs within its W tile and leaves the first
//    column of every tile to a stitch in its wrapper, because the left
//    neighbour's count lives in another grid step. Here, as in
//    ychg_fused_full, the tile's first lane also scans the column left of
//    the tile (the halo), so the block has every left neighbour itself.
//    Step 2 is finish_column, the totals add_block_totals (ychg_step2.cuh:
//    a block reduction, one int32 atomicAdd each a block; integer sums are
//    exact in any order), and 2 * runs is written in the same pass.
//  * The ragged W edge is masked here: no padded copy of the packed mask.
//
// Binding: plain C entry points, loaded with ctypes. Each launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
// The caller zeroes nh and nt for ychg_packed_fused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ychg_scan.cuh"
#include "ychg_step2.cuh"

namespace {

// the packed kernels' block: four a SM at 64 registers a thread
constexpr int kPackedThreads = 256;

// Grid tiles, block (lanes, kPackedThreads / lanes): step 1 for one tile
// of lanes vectors, its runs written.
template <int V>
__global__ void __launch_bounds__(kPackedThreads,
                                  kScanThreads / kPackedThreads)
packed_colscan_kernel(const uint8_t* __restrict__ pk, int64_t Hp, int64_t W,
                      int64_t nvec, int* __restrict__ runs) {
  __shared__ ScanTile tile;
  scan_tile<PackedRows, V, false, kPackedThreads>(pk, 0, Hp, W, nvec, tile);
  const int lanes = blockDim.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * lanes * V;
  for (int c = threadIdx.y * lanes + threadIdx.x; c < lanes * V;
       c += kPackedThreads) {
    if (c0 + c >= W) break;
    runs[c0 + c] = tile.runs[tile_index<V>(c)];
  }
}

// Grid tiles, block (lanes, kPackedThreads / lanes): step 1 for one tile
// with its halo column, then step 2, the cut vertices and the totals for
// the tile's columns.
template <int V>
__global__ void __launch_bounds__(kPackedThreads,
                                  kScanThreads / kPackedThreads)
packed_fused_kernel(const uint8_t* __restrict__ pk, int64_t Hp, int64_t W,
                    int64_t nvec, int* __restrict__ runs,
                    int* __restrict__ cut, uint8_t* __restrict__ trans,
                    int* __restrict__ births, int* __restrict__ deaths,
                    int* __restrict__ nh, int* __restrict__ nt) {
  __shared__ ScanTile tile;
  scan_tile<PackedRows, V, true, kPackedThreads>(pk, 0, Hp, W, nvec, tile);
  const int lanes = blockDim.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * lanes * V;
  int born = 0;
  int changed = 0;
  for (int c = threadIdx.y * lanes + threadIdx.x; c < lanes * V;
       c += kPackedThreads) {
    if (c0 + c >= W) break;
    const int run = tile.runs[tile_index<V>(c)];
    const int left = c > 0 ? tile.runs[tile_index<V>(c - 1)] : tile.halo;
    const int64_t o = c0 + c;
    runs[o] = run;
    cut[o] = 2 * run;
    const int2 t = finish_column(run, left, o, trans, births, deaths);
    born += t.x;
    changed += t.y;
  }
  add_block_totals<kPackedThreads>(born, changed, nh, nt);
}

// Lanes of a kPackedThreads block for `nvec` vectors a row: the widest
// tile whose blocks reach two a SM, else the narrowest.
int choose_packed_lanes(int64_t nvec, int sms) {
  int lanes = kMaxLanes;
  while (lanes > kMinLanes && (nvec + lanes - 1) / lanes < 2 * sms)
    lanes >>= 1;
  return lanes;
}

// The vector width a launch takes, as a tag for a generic lambda.
template <int V>
struct Vec {
  static constexpr int bytes = V;
};

// Calls f(Vec<vec>{}); false for a width no kernel is built for.
template <typename F>
bool with_vec(int vec, F&& f) {
  switch (vec) {
    case 16: f(Vec<16>{}); return true;
    case 8: f(Vec<8>{}); return true;
    case 4: f(Vec<4>{}); return true;
    case 2: f(Vec<2>{}); return true;
    case 1: f(Vec<1>{}); return true;
  }
  return false;
}

bool valid_shape(int64_t Hp, int64_t W) {
  // a grid dimension of 0 is an invalid launch; x holds at most 2^31 - 1
  return Hp >= 0 && W >= 1 && W <= 0x7fffffff;
}

// Calls launch(Vec<V>{}, grid, block, nvec) for the vector width of
// `packed` and the tiles chosen for it; returns the launch's error code.
template <typename Launch>
int launch_packed(const void* packed, int64_t W, Launch&& launch) {
  const int vec = vec_bytes(packed, W, 1);
  const int64_t nvec = W / vec;
  const int lanes = choose_packed_lanes(nvec, sm_count());
  const dim3 grid(static_cast<unsigned>((nvec + lanes - 1) / lanes));
  const dim3 block(lanes, kPackedThreads / lanes);
  if (!with_vec(vec, [&](auto v) { launch(v, grid, block, nvec); }))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ychg_packed_colscan(const void* packed, int64_t Hp, int64_t W,
                                   void* runs, void* stream) {
  if (!valid_shape(Hp, W)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return launch_packed(packed, W, [&](auto v, dim3 grid, dim3 block,
                                      int64_t nvec) {
    packed_colscan_kernel<decltype(v)::bytes><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(packed), Hp, W, nvec,
        static_cast<int*>(runs));
  });
}

extern "C" int ychg_packed_fused(const void* packed, int64_t Hp, int64_t W,
                                 void* runs, void* cut, void* trans,
                                 void* births, void* deaths, void* nh,
                                 void* nt, void* stream) {
  if (!valid_shape(Hp, W)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return launch_packed(packed, W, [&](auto v, dim3 grid, dim3 block,
                                      int64_t nvec) {
    packed_fused_kernel<decltype(v)::bytes><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(packed), Hp, W, nvec,
        static_cast<int*>(runs), static_cast<int*>(cut),
        static_cast<uint8_t*>(trans), static_cast<int*>(births),
        static_cast<int*>(deaths), static_cast<int*>(nh),
        static_cast<int*>(nt));
  });
}
