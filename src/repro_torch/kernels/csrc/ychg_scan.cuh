// The step-1 scan shared by ychg_fused_full and ychg_fused_splith
// (ychg_fused.cu), ychg_colscan_full (ychg_colscan.cu) and the two packed
// kernels (ychg_packed.cu), for Hopper (sm_90a): per-column maximal-run
// counts of a (H, W) mask over a range of its rows, runs[j] = the number of
// rows i of the range where x[i][j] is foreground and x[i-1][j] is not
// (x[-1] = 0). The full-column kernels scan all H rows in one block a tile;
// ychg_fused_splith gives each block one range of block_h rows (grid z) and
// sums the ranges' counts. A packed mask (element kind PackedRows) holds
// eight rows of a column in a byte, so its "rows" are packed rows.
//
// What bounds it: device-memory bytes. A pixel is read once and costs a few
// integer operations; the outputs are a few bytes a column.
//
// What the design does about it:
//  * Wide loads along a row. A thread owns one vector of V bytes of a row
//    (16 uint8 columns or 4 int32/float32 columns at V = 16) and loads it
//    with one read-only vector load a row. V is chosen at each launch as
//    the widest of 16, 8, 4, 2 (uint8 only) and the item size that divides
//    both the base address and the row pitch W * itemsize, so every row
//    starts on a vector boundary and no load reaches past a row's end (a
//    21000-byte row gives V = 8). A template parameter, so each width is
//    its own kernel.
//  * uint8 in SIMD within a 32-bit word: the foreground flags of four
//    pixels are one 0x01 per byte lane (no branch, no byte loads), a rising
//    edge is f & ~f_above, and the counts grow in byte lanes. A byte lane
//    holds 255, so every kChunk rows (at most 255) the lanes are added into
//    16-bit lanes of two words, and those into shared memory before they
//    could reach 65535 (every kPairChunks chunks: a segment longer than
//    64,000 rows, else only at its end). int32 and float32 take one column
//    a 32-bit word and count in it directly. float32 is foreground by its
//    exponent bits: +-0 and subnormals are background, NaN and inf are not.
//  * A packed mask is read as uint8 is, a byte a column, but a byte holds
//    eight rows (bit i is row 8r + i, LSB the top). A row step takes the
//    word w of four packed bytes and the word a of the same columns one
//    packed row above; the runs that start in each byte are
//      rising = w & ~(((w << 1) & 0xfefefefe) | ((a >> 7) & 0x01010101))
//    (a byte's rows shifted down one, the MSB of the byte above at the
//    top). Two rising bits are never adjacent, so a byte holds at most 4
//    and three SWAR steps count them in place, all at the full integer
//    rate (no __popc, a quarter of it on sm_90). At 4 a row a byte lane
//    fills in 63 rows, so its chunk is kPackedChunk rows; the 16-bit lanes
//    take kPairChunks of those chunks (60 * 4 * 256 < 65536). A segment is
//    entered with the packed word just above it (only its MSBs count), 0
//    at the top of the image.
//  * Several threads a column. A block is kScanThreads threads: `lanes`
//    vectors across (blockDim.x) times kScanThreads / lanes row segments
//    (blockDim.y) of its row range. Each segment is a contiguous run of
//    rows, entered with the foreground flags of the image row just above
//    it (none above image row 0), so no segment depends on another and a
//    range needs no halo row. The segments of one warp hold the same columns and are
//    summed by shuffles, then one lane a column adds into shared memory
//    (integer sums: exact in any order). No atomics on device memory.
//  * The lanes are chosen at launch (choose_lanes) from B, the vectors a
//    row and the SM count: the widest tile whose blocks reach half of the
//    SMs (8 x 8192^2 uint8: 32 lanes, 512 B a row, 256 rows a segment, 128
//    blocks; the 21000^2 scene: 32 lanes of 8 B, 83 blocks), narrower ones
//    for one smaller image (1 x 8192^2: 4 lanes, 64 B, 32 rows a segment,
//    128 blocks). ychg_fused_splith counts each (image, row range) pair as
//    an image: choose_lanes(B * ceil(H / block_h), ...), so the scene's 11
//    ranges of 2048 rows take 32 lanes, 83 tiles x 11 = 913 blocks of 64
//    rows a segment, and 8 x 8192^2 takes 32 lanes, 16 x 8 x 4 = 512
//    blocks. One block a SM: 32 warps, at most 64 registers a thread
//    (__launch_bounds__(kScanThreads, 1)). The packed kernels take
//    smaller blocks (ychg_packed.cu): scan_tile takes the block's thread
//    count as kThreads.
//  * Step 2 needs the run count of the column left of a tile, which another
//    block owns; blocks run in no order and none waits for another. With
//    `halo`, the segments of the tile's first vector also scan that column
//    (one more element load a row), so the block has its left neighbour's
//    count itself.
//  * Pixel offsets are 64-bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType : int { kU8 = 0, kI32 = 1, kF32 = 2 };

// the scan's block: lanes x segments threads, one block a SM
constexpr int kScanThreads = 1024;
constexpr int kMinLanes = 4;
constexpr int kMaxLanes = 32;
constexpr int kMaxVecBytes = 16;
// the vector rows loaded before any is used, per thread
constexpr int kUnroll = 4;
// rows between two flushes of the byte lanes (at most 255 rising edges)
constexpr int kChunk = 252;
// the same for packed rows, at most 4 rising edges a byte each
constexpr int kPackedChunk = 60;
// chunks between two flushes of the 16-bit lanes (252 * 256 < 65536)
constexpr int kPairChunks = 256;

// The element kind of a packed mask: eight rows of one column, bit i row
// 8r + i (LSB the top row).
struct PackedRows {
  uint8_t bits;
};

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

// Foreground flags of the pixels of one 32-bit word: 0x01 in each byte lane
// that holds a nonzero uint8 (bit 7 of ((x & 0x7f) + 0x7f) | x is x != 0,
// with no carry out of the lane); 0 or 1 for the one int32 or float32.
template <typename T>
__device__ __forceinline__ uint32_t fg_lanes(uint32_t w);

template <>
__device__ __forceinline__ uint32_t fg_lanes<uint8_t>(uint32_t w) {
  return ((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) >> 7) & 0x01010101u;
}

template <>
__device__ __forceinline__ uint32_t fg_lanes<int32_t>(uint32_t w) {
  return w != 0u;
}

template <>
__device__ __forceinline__ uint32_t fg_lanes<float>(uint32_t w) {
  return (w & 0x7f800000u) != 0u;
}

// A packed word is its own foreground bits: eight rows of each byte lane.
template <>
__device__ __forceinline__ uint32_t fg_lanes<PackedRows>(uint32_t w) {
  return w;
}

template <typename T>
constexpr bool kPacked = false;
template <>
constexpr bool kPacked<PackedRows> = true;

// The runs that start in each byte of a packed word f, given the word
// `prev` of the same columns one packed row up, counted in f's byte lanes.
__device__ __forceinline__ uint32_t packed_rising(uint32_t f, uint32_t prev) {
  const uint32_t r =
      f & ~(((f << 1) & 0xfefefefeu) | ((prev >> 7) & 0x01010101u));
  // no two bits of r are adjacent: each bit pair, then nibble, then byte
  // holds at most 1, 2, 4, so no sum carries out of its field
  const uint32_t y = (r | (r >> 1)) & 0x55555555u;
  const uint32_t z = (y + (y >> 2)) & 0x33333333u;
  return (z + (z >> 4)) & 0x0f0f0f0fu;
}

// rows between two flushes of the byte lanes
template <typename T>
constexpr int kChunkRows = kChunk;
template <>
constexpr int kChunkRows<PackedRows> = kPackedChunk;

// 32-bit words in a vector of V bytes (a narrower vector is one word,
// zero-extended)
template <int V>
__host__ __device__ constexpr int vec_words() {
  return V >= 4 ? V / 4 : 1;
}

template <int V>
__device__ __forceinline__ void load_vec(const uint8_t* __restrict__ p,
                                         uint32_t* w) {
  if constexpr (V == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (V == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (V == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (V == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(p);
  }
}

// One pixel of type T at p, zero-extended to a word.
template <typename T>
__device__ __forceinline__ uint32_t load_pixel(const uint8_t* __restrict__ p) {
  if constexpr (sizeof(T) == 1) {
    return __ldg(p);
  } else {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// What one block leaves in shared memory: the run counts of its columns,
// column c of the tile at runs[(c / E) * (E + 1) + c % E] (a padding word
// per vector spreads the lanes over the banks), and the count of the
// column left of the tile (0 without a halo, or at column 0).
struct ScanTile {
  int runs[kMaxLanes * (kMaxVecBytes + 1)];
  int halo;
};

template <int E>
__device__ __forceinline__ int tile_index(int c) {
  return (c / E) * (E + 1) + c % E;
}

// Per-column counts of one segment: uint8 keeps them in 16-bit lanes until
// they are spilled; 32-bit types count one column a word.
template <typename T, int V>
struct SegmentCounts {
  static constexpr int kWords = vec_words<V>();
  // uint8: pair[2i] holds columns 4i (low half) and 4i + 2, pair[2i + 1]
  // columns 4i + 1 and 4i + 3; 32-bit: pair[i] is column i
  static constexpr int kPairs = sizeof(T) == 1 ? 2 * kWords : kWords;
  uint32_t pair[kPairs];

  __device__ __forceinline__ int column(int e) const {
    if constexpr (sizeof(T) == 1) {
      const uint32_t p = pair[2 * (e / 4) + (e & 1)];
      return static_cast<int>((e & 2) ? p >> 16 : p & 0xffffu);
    } else {
      return static_cast<int>(pair[e]);
    }
  }
};

// The runs that start at the rows of element kind T's foreground word f,
// given the word p of the same columns one row up, counted in f's lanes.
// A macro, not a function: on the card, an inlined function here changed
// the machine code of the int32 and float32 scans (scripts/time_packed.py
// compares it), and a macro keeps it as it was.
#define YCHG_RISING(T, f, p) \
  (kPacked<T> ? packed_rising((f), (p)) : ((f) & ~(p)))

// Scans rows [row0, row0 + nrows) of a (H, W) image whose first byte is
// `img` for the block's tile of `lanes` vectors (blockIdx.x), and leaves
// its counts in `tile`. `nvec` vectors of V bytes make a row. The block
// has kThreads threads; every one must call it. It returns after a
// __syncthreads(), with `tile` complete.
template <typename T, int V, bool kHalo, int kThreads = kScanThreads>
__device__ __forceinline__ void scan_tile(const uint8_t* __restrict__ img,
                                          int64_t row0, int64_t nrows,
                                          int64_t W, int64_t nvec,
                                          ScanTile& tile) {
  constexpr int kWords = vec_words<V>();
  constexpr int E = V / static_cast<int>(sizeof(T));
  using Counts = SegmentCounts<T, V>;
  const int lanes = blockDim.x;
  const int segs = blockDim.y;
  const int lx = threadIdx.x;
  const int tid = threadIdx.y * lanes + lx;
  for (int i = tid; i < lanes * (E + 1); i += kThreads) tile.runs[i] = 0;
  if (tid == 0) tile.halo = 0;
  __syncthreads();

  const int64_t pitch = W * static_cast<int64_t>(sizeof(T));
  const int64_t vec = static_cast<int64_t>(blockIdx.x) * lanes + lx;
  const int64_t seg = (nrows + segs - 1) / segs;
  // this segment's first image row
  const int64_t r0 = row0 + threadIdx.y * seg;
  const int64_t range_end = row0 + nrows;
  int64_t rows = range_end - r0 < seg ? range_end - r0 : seg;
  if (vec >= nvec || rows < 0) rows = 0;
  const int64_t col0 = vec * E;  // this thread's first column
  // the column left of the tile, scanned by the tile's first lane
  const bool halo = kHalo && lx == 0 && col0 > 0 && rows > 0;

  const uint8_t* p = img + r0 * pitch + vec * V;
  const uint8_t* h = p - sizeof(T);
  uint32_t prev[kWords];
  uint32_t hprev = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) prev[i] = 0;
  if (r0 > 0 && rows > 0) {
    uint32_t w[kWords];
    load_vec<V>(p - pitch, w);
#pragma unroll
    for (int i = 0; i < kWords; ++i) prev[i] = fg_lanes<T>(w[i]);
    if (halo) hprev = fg_lanes<T>(load_pixel<T>(h - pitch));
  }

  Counts counts;
#pragma unroll
  for (int i = 0; i < Counts::kPairs; ++i) counts.pair[i] = 0;
  int hcount = 0;
  int chunks = 0;
  for (int64_t r = 0; r < rows;) {
    const int64_t end = rows - r < kChunkRows<T> ? rows : r + kChunkRows<T>;
    uint32_t acc[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) acc[i] = 0;
    for (; r + kUnroll <= end; r += kUnroll) {
      uint32_t w[kUnroll][kWords];
      uint32_t hw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_vec<V>(p + u * pitch, w[u]);
      if (halo) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) hw[u] = load_pixel<T>(h + u * pitch);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          const uint32_t f = fg_lanes<T>(w[u][i]);
          acc[i] += YCHG_RISING(T, f, prev[i]);
          prev[i] = f;
        }
      }
      if (halo) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const uint32_t f = fg_lanes<T>(hw[u]);
          hcount += static_cast<int>(YCHG_RISING(T, f, hprev));
          hprev = f;
        }
      }
      p += kUnroll * pitch;
      h += kUnroll * pitch;
    }
    for (; r < end; ++r) {
      uint32_t w[kWords];
      load_vec<V>(p, w);
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const uint32_t f = fg_lanes<T>(w[i]);
        acc[i] += YCHG_RISING(T, f, prev[i]);
        prev[i] = f;
      }
      if (halo) {
        const uint32_t f = fg_lanes<T>(load_pixel<T>(h));
        hcount += static_cast<int>(YCHG_RISING(T, f, hprev));
        hprev = f;
      }
      p += pitch;
      h += pitch;
    }
    if constexpr (sizeof(T) == 1) {
      // byte lanes into 16-bit lanes
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        counts.pair[2 * i] += acc[i] & 0x00ff00ffu;
        counts.pair[2 * i + 1] += (acc[i] >> 8) & 0x00ff00ffu;
      }
      // 16-bit lanes into shared memory before they could overflow (only a
      // segment longer than kChunkRows<T> * kPairChunks rows gets here)
      if (++chunks == kPairChunks && r < rows) {
        chunks = 0;
#pragma unroll
        for (int e = 0; e < E; ++e)
          atomicAdd(&tile.runs[lx * (E + 1) + e], counts.column(e));
#pragma unroll
        for (int i = 0; i < Counts::kPairs; ++i) counts.pair[i] = 0;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) counts.pair[i] += acc[i];
    }
  }

  // the 32 / lanes segments of a warp hold the same columns
  int cnt[E];
#pragma unroll
  for (int e = 0; e < E; ++e) cnt[e] = counts.column(e);
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) cnt[e] += __shfl_xor_sync(0xffffffffu, cnt[e], o);
    if (kHalo) hcount += __shfl_xor_sync(0xffffffffu, hcount, o);
  }
  if ((tid & 31) < lanes) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (cnt[e]) atomicAdd(&tile.runs[lx * (E + 1) + e], cnt[e]);
    if (kHalo && lx == 0 && hcount) atomicAdd(&tile.halo, hcount);
  }
  __syncthreads();
}

#undef YCHG_RISING

// The widest vector (16, 8, 4, 2 or 1 bytes, at least one pixel) that
// divides both the base address and the row pitch.
inline int vec_bytes(const void* img, int64_t W, int itemsize) {
  const uint64_t a = static_cast<uint64_t>(reinterpret_cast<uintptr_t>(img)) |
                     static_cast<uint64_t>(W * itemsize);
  int v = kMaxVecBytes;
  while (v > itemsize && a % v != 0) v >>= 1;
  return v;
}

// SMs of the current device. A failed query leaves its error for the
// cudaGetLastError() that follows the launch.
inline int sm_count() {
  int dev = 0;
  int n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Lanes of a block for B images (for split-H, B (image, row range) pairs)
// of `nvec` vectors a row: the widest tile whose blocks still reach half of
// the SMs, else the narrowest. A wide tile
// reads whole 128-byte lines and fewer entry rows, and a block draws more
// than its share of the memory rate when some SMs are idle: on the H100 a
// wide tile on half the SMs beat a narrow one on all of them.
inline int choose_lanes(int64_t B, int64_t nvec, int sms) {
  int lanes = kMaxLanes;
  while (lanes > kMinLanes && B * ((nvec + lanes - 1) / lanes) < sms / 2)
    lanes >>= 1;
  return lanes;
}

// The (T, V) pair a launch takes, as a tag for a generic lambda.
template <typename T, int V>
struct Layout {
  using type = T;
  static constexpr int vec = V;
};

// Calls f(Layout<T, V>{}) for the dtype code and vector width; returns
// false for a pair no kernel takes.
template <typename F>
bool with_layout(int dtype, int vec, F&& f) {
  switch (dtype) {
    case kU8:
      switch (vec) {
        case 16: f(Layout<uint8_t, 16>{}); return true;
        case 8: f(Layout<uint8_t, 8>{}); return true;
        case 4: f(Layout<uint8_t, 4>{}); return true;
        case 2: f(Layout<uint8_t, 2>{}); return true;
        case 1: f(Layout<uint8_t, 1>{}); return true;
      }
      return false;
    case kI32:
      switch (vec) {
        case 16: f(Layout<int32_t, 16>{}); return true;
        case 8: f(Layout<int32_t, 8>{}); return true;
        case 4: f(Layout<int32_t, 4>{}); return true;
      }
      return false;
    case kF32:
      switch (vec) {
        case 16: f(Layout<float, 16>{}); return true;
        case 8: f(Layout<float, 8>{}); return true;
        case 4: f(Layout<float, 4>{}); return true;
      }
      return false;
  }
  return false;
}

inline int itemsize_of(int dtype) { return dtype == kU8 ? 1 : 4; }

}  // namespace
