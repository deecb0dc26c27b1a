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
// In a byte b entered with `carry`, the foreground bit of the row above its
// top row (the MSB of the byte above), the runs that start in the byte are
//   rising = b & ~((b << 1) | carry)
// and their count is __popc(rising).
//
// What bounds them: device-memory bytes. Each packed byte is read once and
// costs five integer operations (a shift, one three-input logic op, the
// popcount, an add and the shift that takes the next carry); the
// outputs are 4 bytes a column for the scan and 17 for the fused kernel. The
// paper's 21000^2 scene packs to 2625 x 21000 = 55,125,000 B: about 0.017
// ms at 3.35 TB/s, an eighth of the unpacked scans' bound. As with the
// unpacked scans, one image is little work for the card: 21,000 columns at
// one thread each are under five warps an SM, so the latency of the loads
// down each column, not the bytes, sets the time unless more threads share
// a column.
//
// What the design does about it:
//  * Each column gets kSegs threads of one block: thread (x, y) scans
//    packed rows [y * seg, (y + 1) * seg) of column x, entered with the MSB
//    of the byte just above its segment (0 at the top: the seam identity of
//    ychg_colscan_splith, a byte at a time), and the block sums the kSegs
//    partial counts in shared memory. Consecutive threads of a warp take
//    consecutive columns, so each packed row's loads coalesce. The TPU
//    kernel instead holds a whole packed column tile in VMEM and shifts the
//    MSB plane down one row.
//  * The TPU's fused kernel diffs within its W tile and leaves the first
//    column of every tile to a stitch in its wrapper (a Python list and two
//    scatters a call), because the left neighbour's count lives in another
//    grid step. Here the column tiles overlap by one column instead: the
//    block's x = 0 threads count the column left of the tile, so every
//    column's left neighbour is in shared memory and no stitch is needed.
//  * Totals: one warp (y = 0) reduces births and transitions with shuffles
//    and adds them with one int32 atomicAdd each a block. Integer addition
//    is exact in any order, so the totals are deterministic.
//  * The ragged W edge is masked here: no padded copy of the packed mask.
//
// Binding: plain C entry points, loaded with ctypes. Each launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
// The caller zeroes nh and nt for ychg_packed_fused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // columns of one block (a warp across them)
constexpr int kSegs = 8;   // threads sharing one column

// Runs that start in `rows` packed bytes of one column from p, entered with
// the MSB of the byte above (0 at the top of the image).
__device__ __forceinline__ int scan_packed(const uint8_t* __restrict__ p,
                                           int64_t W, int64_t rows,
                                           unsigned carry) {
  int runs = 0;
#pragma unroll 16
  for (int64_t r = 0; r < rows; ++r) {
    const unsigned b = p[r * W];
    runs += __popc(b & ~((b << 1) | carry));
    carry = b >> 7;
  }
  return runs;
}

// Thread (x, y)'s share of column `col`: its segment of packed rows.
__device__ __forceinline__ int segment_count(const uint8_t* __restrict__ pk,
                                             int64_t Hp, int64_t W,
                                             int64_t col) {
  const int64_t seg = (Hp + kSegs - 1) / kSegs;
  const int64_t r0 = threadIdx.y * seg;
  if (col < 0 || col >= W || r0 >= Hp) return 0;
  const int64_t rows = (Hp - r0 < seg) ? Hp - r0 : seg;
  const uint8_t* p = pk + r0 * W + col;
  return scan_packed(p, W, rows, r0 > 0 ? static_cast<unsigned>(p[-W]) >> 7
                                        : 0u);
}

// Grid ceil(W / kCols), block (kCols, kSegs).
__global__ void __launch_bounds__(kCols * kSegs)
packed_colscan_kernel(const uint8_t* __restrict__ pk, int64_t Hp, int64_t W,
                      int* __restrict__ runs) {
  __shared__ int part[kSegs][kCols];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x;
  part[threadIdx.y][threadIdx.x] = segment_count(pk, Hp, W, col);
  __syncthreads();
  if (threadIdx.y == 0 && col < W) {
    int total = 0;
#pragma unroll
    for (int k = 0; k < kSegs; ++k) total += part[k][threadIdx.x];
    runs[col] = total;
  }
}

// Grid ceil(W / (kCols - 1)), block (kCols, kSegs). Threads x of block i
// count column i * (kCols - 1) - 1 + x; x = 1.. own their columns, x = 0
// only supplies the left neighbour of x = 1 (column -1 counts 0).
__global__ void __launch_bounds__(kCols * kSegs)
packed_fused_kernel(const uint8_t* __restrict__ pk, int64_t Hp, int64_t W,
                    int* __restrict__ runs, int* __restrict__ cut,
                    uint8_t* __restrict__ trans, int* __restrict__ births,
                    int* __restrict__ deaths, int* __restrict__ nh,
                    int* __restrict__ nt) {
  __shared__ int part[kSegs][kCols];
  __shared__ int col_runs[kCols];
  const int x = threadIdx.x;
  const int64_t col =
      static_cast<int64_t>(blockIdx.x) * (kCols - 1) - 1 + x;
  part[threadIdx.y][x] = segment_count(pk, Hp, W, col);
  __syncthreads();
  if (threadIdx.y != 0) return;  // one warp: the y = 0 threads
  int run = 0;
#pragma unroll
  for (int k = 0; k < kSegs; ++k) run += part[k][x];
  col_runs[x] = run;
  __syncwarp();
  int born = 0, t = 0;
  if (x > 0 && col < W) {
    const int delta = run - col_runs[x - 1];
    born = delta > 0 ? delta : 0;
    t = delta != 0;
    runs[col] = run;
    cut[col] = 2 * run;
    trans[col] = static_cast<uint8_t>(t);  // torch.bool: the byte is 0 or 1
    births[col] = born;
    deaths[col] = delta < 0 ? -delta : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    born += __shfl_down_sync(0xffffffffu, born, o);
    t += __shfl_down_sync(0xffffffffu, t, o);
  }
  if (x == 0) {
    if (born) atomicAdd(nh, born);
    if (t) atomicAdd(nt, t);
  }
}

bool valid_shape(int64_t Hp, int64_t W) {
  // a grid dimension of 0 is an invalid launch; x holds at most 2^31 - 1
  return Hp >= 0 && W >= 1 && (W + kCols - 2) / (kCols - 1) <= 0x7fffffff;
}

}  // namespace

extern "C" int ychg_packed_colscan(const void* packed, int64_t Hp, int64_t W,
                                   void* runs, void* stream) {
  if (!valid_shape(Hp, W)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kCols - 1) / kCols));
  const dim3 block(kCols, kSegs);
  packed_colscan_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), Hp, W, static_cast<int*>(runs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ychg_packed_fused(const void* packed, int64_t Hp, int64_t W,
                                 void* runs, void* cut, void* trans,
                                 void* births, void* deaths, void* nh,
                                 void* nt, void* stream) {
  if (!valid_shape(Hp, W)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((W + kCols - 2) / (kCols - 1)));
  const dim3 block(kCols, kSegs);
  packed_fused_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), Hp, W, static_cast<int*>(runs),
      static_cast<int*>(cut), static_cast<uint8_t*>(trans),
      static_cast<int*>(births), static_cast<int*>(deaths),
      static_cast<int*>(nh), static_cast<int*>(nt));
  return static_cast<int>(cudaGetLastError());
}
