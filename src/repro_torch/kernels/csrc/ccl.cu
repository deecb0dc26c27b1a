// 4-neighbour connected-components labelling of a (B, H, W) stack, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/ccl.py::_ccl_kernel (wrapper labels_pallas).
//
// Output: the reference's fixpoint. Each foreground (nonzero) pixel gets
// its component's minimum linear index within the image + 1, background 0,
// as int32. The canonical re-ranking (_canonicalize) runs after the kernel,
// as it does in the reference.
//
// What bounds it: device-memory bytes. Each input pixel is read once and
// each int32 label written once: the serving batch, 8 x 8192^2 uint8,
// moves 536,870,912 B in and 2,147,483,648 B out, about 0.80 ms at
// 3.35 TB/s (5 B/px). This design moves about 6.6 B/px for uint8 input:
// the input twice (2 B), the labels once (4 B), the tile borders and tile
// roots once more (about 0.3 B/px) and the seam links (about 0.3 B/px).
// The passes inside a tile are latency-bound: a block reads its tile once
// and then works on it in shared memory.
//
// What the design does about it:
//  * The TPU kernel holds a whole image in VMEM and sweeps neighbour minima
//    until nothing changes. An 8192^2 image of int32 labels (256 MiB) is
//    far beyond a block's 227 KB of shared memory, and sweeps cost a
//    number of passes that grows with a component's diameter. So this
//    kernel is union-find (linking the larger root under the smaller, so
//    that every root ends as its tree's minimum index), done where the
//    links are: almost every link of a mask joins two pixels of one small
//    neighbourhood. A tile is kTileH x kTileW = 32 x 128 pixels; a block of
//    256 threads owns one, each thread a kSeg = 16-pixel segment of one
//    tile row, held as 16 foreground bits (consecutive threads on
//    consecutive segments, so loads coalesce: one 16 B load a thread for
//    uint8). Three launches:
//      1. local: the block reads its tile and builds a union-find forest
//         in shared memory over tile-local indices. Row-major order within
//         a rectangle is row-major order, so each piece's tile root is its
//         smallest global index. It writes to the labels buffer the tile's
//         first and last row and column (each foreground pixel gets the
//         global index + 1 of its tile root, background 0) and, for each
//         of those pixels, its tile root's own entry (index + 1).
//      2. seams: one thread a seam pair (a pixel of a tile's first row and
//         the one above it; a pixel of a tile's first column and the one to
//         its left) unites the two tile roots in the labels buffer, which
//         at the tile-root entries is the global forest. find_root halves
//         paths as it walks (atomicMin with an ancestor).
//      3. final: the block reads its tile again, rebuilds the same shared
//         forest, finds the global root once for each tile root whose
//         piece touches the tile border, and writes every pixel's final
//         label once (16 B stores where W allows).
//    The labels are written once (pass 3) but for the borders; keeping
//    the tile-local labels in device memory between passes 1 and 3
//    instead would cost about 13 B/px.
//  * Work inside a tile goes a run at a time, not a pixel at a time: a run
//    of foreground pixels within a segment is one node of the shared forest
//    (its first pixel), found from the bits (__ffs, __clz), so links,
//    finds, flags and label look-ups cost once a run. Only the label fill
//    and its stores are per pixel. One word of padding after each segment's
//    16 words of the forest puts pixel j of the 32 segments of a warp in 32
//    different banks.
//  * The forest in device memory only ever holds tile-root indices: border
//    entries point at their tile roots, roots at roots. So only border and
//    tile-root entries are ever read, and pass 1 writes all of those.
//  * Races in passes 2 and 3. A root entry changes only by atomicMin in
//    unite, which links a root under a smaller root of the same pair; any
//    other entry only falls to an ancestor (path halving: atomicMin with the
//    grandparent; pass 3: the global root, which is the tree's minimum and
//    so at most every value the entry held). Every value ever stored is an
//    ancestor, at most the entry's own index + 1, and a pointer never
//    leaves its tree. So a find that reads an old or a new value reaches
//    the same root, and pass 3 may overwrite border and root entries that
//    other blocks' finds still walk through. Reads of the forest bypass L1
//    (__ldcg): another SM may have lowered an entry since.
//  * The 2 x 2 skip. In a 2 x 2 foreground block, the up link of the
//    bottom-right pixel is implied by the two left links and the up link of
//    the bottom-left pixel. Every left link inside a tile is performed
//    (within a segment by the run structure, at a segment start by a
//    unite), so pass 1 skips an up link when its left and up-left
//    neighbours lie in the tile and are foreground. Pass 2 applies two
//    global rules, each implied by links that do not depend on it: it
//    skips an up seam link when the pixel has a left neighbour and the
//    2 x 2 block is foreground (its left links are performed or implied;
//    by induction along the seam row, so is the up link to its left); and
//    it skips a left seam link below a tile's first row when the two pixels
//    above the pair are foreground (both up links are tile-local, the left
//    seam link above it implied by induction down the tile row).
//  * Ragged tiles (H or W not a multiple of the tile) read nothing outside
//    the image; their border is their last real row and column. Indices
//    are int32 within one image (21000^2 = 441,000,000 < 2^30, the
//    reference's sentinel); the batch offset is 64-bit. Tiles run along
//    gridDim.x, images along gridDim.y (at most 65535).
//  * The input is read in its own dtype (uint8/bool, int32 or float32);
//    float32 foreground is tested on the exponent bits.
//
// Binding: plain C entry points, loaded with ctypes. ccl runs the three
// passes on the stream it is given; ccl_local, ccl_seams and ccl_final run
// one each (for timing them apart). They allocate nothing (the labels
// buffer is the global forest) and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kSeg = 16;                      // pixels a thread, one row
constexpr int kSegs = kTileW / kSeg;          // threads a tile row
constexpr int kThreads = kTileH * kSegs;      // 256
constexpr int kTilePx = kTileH * kTileW;
constexpr int kShared = kTilePx + kTilePx / kSeg;  // words, padding included
constexpr int kSeamThreads = 256;
constexpr unsigned kSegMask = (1u << kSeg) - 1;

enum DType : int { kU8 = 0, kI32 = 1, kF32 = 2 };

// Foreground bits of one 32-bit word: for uint8, bit i = byte i is
// nonzero; for int32, bit 0 = the word is nonzero; for float32, bit 0 =
// the exponent bits are not all zero (+-0 and every subnormal are
// background as under the reference's XLA, NaN and +-inf foreground),
// tested on the bits so that no compiler flush mode can change it.
template <typename T>
__device__ __forceinline__ unsigned word_bits(uint32_t w);
template <>
__device__ __forceinline__ unsigned word_bits<uint8_t>(uint32_t w) {
  const uint32_t t = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) |
         ((t >> 28) & 8u);
}
template <>
__device__ __forceinline__ unsigned word_bits<int32_t>(uint32_t w) {
  return w != 0u;
}
template <>
__device__ __forceinline__ unsigned word_bits<float>(uint32_t w) {
  return (w & 0x7f800000u) != 0u;
}

template <typename T>
__device__ __forceinline__ unsigned foreground(T v) {
  return v != T(0);
}
template <>
__device__ __forceinline__ unsigned foreground<float>(float v) {
  return word_bits<float>(__float_as_uint(v));
}

// Foreground bits of the kSeg pixels row[c .. c + kSeg), 0 beyond W. vec:
// row + c is 16 B aligned and the segment lies inside the row.
template <typename T>
__device__ __forceinline__ unsigned load_segment(const T* __restrict__ row,
                                                 int c, int W, bool vec) {
  unsigned m = 0;
  if (vec && c + kSeg <= W) {
    const uint4* p = reinterpret_cast<const uint4*>(row + c);
    constexpr int kPerWord = 4 / sizeof(T);
#pragma unroll
    for (int v = 0; v < kSeg * static_cast<int>(sizeof(T)) / 16; ++v) {
      const uint4 q = __ldg(p + v);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m |= word_bits<T>(w[i]) << ((v * 4 + i) * kPerWord);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      if (c + j < W) m |= foreground(row[c + j]) << j;
  }
  return m;
}

// ---------------------------------------------------- the shared forest

// Shared word of tile-local index k: one word of padding after each
// segment, so that the 32 lanes of a warp, each on its own segment, touch
// pixel j of their segments in 32 different banks (without it, 16-way
// bank conflicts made the shared-memory pipe the limit).
__device__ __forceinline__ int at(int k) {
  return k + static_cast<int>(static_cast<unsigned>(k) / kSeg);
}

// Root of tile-local index x. Path halving with plain stores: x is not a
// root, so only finds write its entry, and each writes an ancestor.
__device__ __forceinline__ int find_local(volatile int* s, int x) {
  int p = s[at(x)];
  while (p != x) {
    const int gp = s[at(p)];
    if (gp == p) return p;
    s[at(x)] = gp;
    x = gp;
    p = s[at(x)];
  }
  return x;
}

// Root of tile-local index x, without writing: while one thread flattens
// its own entries, no other may change them.
__device__ __forceinline__ int root_of(volatile int* s, int x) {
  int p = s[at(x)];
  while (p != x) {
    x = p;
    p = s[at(x)];
  }
  return x;
}

__device__ __forceinline__ void unite_local(volatile int* s, int a, int b) {
  while (true) {
    a = find_local(s, a);
    b = find_local(s, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(const_cast<int*>(s + at(a)), b);
    if (old == a) return;
    a = old;
  }
}

struct Tile {
  int r0, c0;  // the tile's first row and column in the image
  int th, tw;  // its real height and width (smaller at a ragged edge)
  int lr, lc;  // this thread's tile row and the first column of its segment
};

__device__ __forceinline__ Tile tile_of(int H, int W, int tiles_w) {
  Tile t;
  const int ty = blockIdx.x / tiles_w;
  const int tx = blockIdx.x - ty * tiles_w;
  t.r0 = ty * kTileH;
  t.c0 = tx * kTileW;
  t.th = min(kTileH, H - t.r0);
  t.tw = min(kTileW, W - t.c0);
  t.lr = threadIdx.x / kSegs;
  t.lc = (threadIdx.x % kSegs) * kSeg;
  return t;
}

// Global index of tile-local index k.
__device__ __forceinline__ int global_index(const Tile& t, int W, int k) {
  const unsigned u = static_cast<unsigned>(k);
  return (t.r0 + static_cast<int>(u / kTileW)) * W + t.c0 +
         static_cast<int>(u % kTileW);
}

// Bits of this thread's segment that lie on the tile border.
__device__ __forceinline__ unsigned border_bits(const Tile& t) {
  if (t.lr >= t.th) return 0u;
  const int n = min(kSeg, t.tw - t.lc);  // pixels of the segment in the tile
  if (n <= 0) return 0u;
  const unsigned inside = (1u << n) - 1u;
  if (t.lr == 0 || t.lr == t.th - 1) return inside;
  unsigned m = 0;
  if (t.lc == 0) m |= 1u;
  if (t.tw - 1 - t.lc < kSeg) m |= 1u << (t.tw - 1 - t.lc);
  return m;
}

// Run-start bits of a segment's foreground bits.
__device__ __forceinline__ unsigned run_starts(unsigned fg) {
  return fg & ~(fg << 1);
}

// The run of foreground bits starting at bit j, as a mask.
__device__ __forceinline__ unsigned run_at(unsigned fg, int j) {
  const unsigned x = fg >> j;
  return (x & ~(x + 1u)) << j;
}

// First bit of the run holding bit j (which is set).
__device__ __forceinline__ int run_start(unsigned fg, int j) {
  const unsigned gaps = ~fg & ((1u << j) - 1u);  // background bits before j
  return gaps ? 32 - __clz(gaps) : 0;
}

// Reads the tile and builds its forest in s over the run starts of the
// segments (tile-local indices; no other entry is ever read); returns this
// thread's foreground bits. Ends with __syncthreads, so the forest is
// complete on return.
template <typename T>
__device__ __forceinline__ unsigned build_forest(const T* __restrict__ img,
                                                 int H, int W, bool vec,
                                                 const Tile& t,
                                                 volatile int* s,
                                                 unsigned* fgm) {
  const int r = t.r0 + t.lr;
  const int c = t.c0 + t.lc;
  unsigned fg = 0;
  if (r < H && c < W)
    fg = load_segment(img + static_cast<int64_t>(r) * W, c, W, vec);
  // a run within the segment is one node: its first pixel, its own root
  const int k0 = t.lr * kTileW + t.lc;
  for (unsigned st = run_starts(fg); st; st &= st - 1) {
    const int k = k0 + __ffs(st) - 1;
    s[at(k)] = k;
  }
  fgm[threadIdx.x] = fg;
  __syncthreads();

  const bool has_left = t.lc > 0;
  const bool has_up = t.lr > 0;
  const unsigned left = has_left ? fgm[threadIdx.x - 1] : 0u;
  const unsigned up = has_up ? fgm[threadIdx.x - kSegs] : 0u;
  const unsigned up_left =
      has_left && has_up ? fgm[threadIdx.x - kSegs - 1] : 0u;
  // the left link at the segment's first pixel, to the left segment's run
  // that holds its last pixel
  if ((fg & 1u) && (left >> (kSeg - 1)))
    unite_local(s, k0, k0 - kSeg + run_start(left, kSeg - 1));
  // bit j: pixel j's left neighbour; its up-left neighbour
  const unsigned lft = ((fg << 1) | (left >> (kSeg - 1))) & kSegMask;
  const unsigned up_lft = ((up << 1) | (up_left >> (kSeg - 1))) & kSegMask;
  // up links, but where the 2 x 2 block is foreground (implied): at most
  // one a stretch where a run lies under a run
  for (unsigned need = fg & up & ~(lft & up_lft); need; need &= need - 1) {
    const int j = __ffs(need) - 1;
    unite_local(s, k0 + run_start(fg, j), k0 - kTileW + run_start(up, j));
  }
  __syncthreads();
  return fg;
}

// ---------------------------------------------------- the global forest

// Root (1-based) of the tree holding the 1-based label x, halving the path.
__device__ __forceinline__ int find_root(int* L, int x) {
  int p = __ldcg(L + x - 1);
  while (p != x) {
    const int gp = __ldcg(L + p - 1);
    if (gp == p) return p;
    atomicMin(L + x - 1, gp);
    x = gp;
    p = __ldcg(L + x - 1);
  }
  return x;
}

// Joins the trees of 1-based labels a and b, linking the larger root under
// the smaller one.
__device__ __forceinline__ void unite(int* L, int a, int b) {
  while (true) {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // a > b: link a under b if a is still a root; else retry from the
    // parent a was given meanwhile
    const int old = atomicMin(L + a - 1, b);
    if (old == a) return;
    a = old;
  }
}

// ------------------------------------------------------------- the passes

// Grid (tiles, B). Pass 1: the tile's forest; border entries and the
// entries of their tile roots.
template <typename T>
__global__ void __launch_bounds__(kThreads)
local_kernel(const T* __restrict__ img, int H, int W, int tiles_w, bool vec,
             int* __restrict__ L) {
  __shared__ int forest[kShared];
  __shared__ unsigned fgm[kThreads];
  volatile int* s = forest;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * H * W;
  const Tile t = tile_of(H, W, tiles_w);
  const unsigned fg = build_forest(img + off, H, W, vec, t, s, fgm);
  int* Lb = L + off;
  const int k0 = t.lr * kTileW + t.lc;
  // border pixels: background 0; each run that reaches the border, its
  // tile root's label, found once
  const unsigned border = border_bits(t);
  int* dst = Lb + static_cast<int64_t>(t.r0 + t.lr) * W + t.c0 + t.lc;
  for (unsigned bg = border & ~fg; bg; bg &= bg - 1) dst[__ffs(bg) - 1] = 0;
  for (unsigned rest = fg; rest;) {
    const int j = __ffs(rest) - 1;
    const unsigned run = run_at(fg, j);
    rest &= ~run;
    unsigned on = run & border;
    if (!on) continue;
    const int root = global_index(t, W, find_local(s, k0 + j)) + 1;
    Lb[root - 1] = root;
    for (; on; on &= on - 1) dst[__ffs(on) - 1] = root;
  }
}

// Grid (ceil(seam pairs / kSeamThreads), B). Pass 2: one thread a seam
// pair; the up seams first (coalesced along the row), then the left seams.
__global__ void __launch_bounds__(kSeamThreads)
seam_kernel(int H, int W, int tiles_h, int tiles_w, int* L) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSeamThreads +
                    threadIdx.x;
  const int64_t n_up = static_cast<int64_t>(tiles_h - 1) * W;
  const int64_t n_left = static_cast<int64_t>(tiles_w - 1) * H;
  int* Lb = L + static_cast<int64_t>(blockIdx.y) * H * W;
  if (i < n_up) {
    const int seam = static_cast<int>(i / W);
    const int c = static_cast<int>(i - static_cast<int64_t>(seam) * W);
    const int p = (seam + 1) * kTileH * W + c;  // first row of a tile
    const int q = p - W;                         // the row above
    const int a = __ldcg(Lb + p);
    const int b = __ldcg(Lb + q);
    if (a == 0 || b == 0) return;
    if (c > 0 && __ldcg(Lb + p - 1) != 0 && __ldcg(Lb + q - 1) != 0) return;
    unite(Lb, a, b);
  } else if (i < n_up + n_left) {
    const int64_t j = i - n_up;
    const int seam = static_cast<int>(j / H);
    const int r = static_cast<int>(j - static_cast<int64_t>(seam) * H);
    const int p = r * W + (seam + 1) * kTileW;  // first column of a tile
    const int q = p - 1;                         // the column to its left
    const int a = __ldcg(Lb + p);
    const int b = __ldcg(Lb + q);
    if (a == 0 || b == 0) return;
    if (r % kTileH != 0 && __ldcg(Lb + p - W) != 0 &&
        __ldcg(Lb + q - W) != 0)
      return;
    unite(Lb, a, b);
  }
}

// Grid (tiles, B). Pass 3: the same forest again, the global root of each
// tile root whose piece touches the border, then every label once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
final_kernel(const T* __restrict__ img, int H, int W, int tiles_w,
             bool vec_in, bool vec_out, int* L) {
  __shared__ int forest[kShared];
  __shared__ __align__(4) unsigned char flag[kShared];
  __shared__ unsigned fgm[kThreads];
  volatile int* s = forest;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * H * W;
  const Tile t = tile_of(H, W, tiles_w);
  const int k0 = t.lr * kTileW + t.lc;
  for (int i = threadIdx.x; i < kShared / 4; i += kThreads)
    reinterpret_cast<int*>(flag)[i] = 0;
  const unsigned fg = build_forest(img + off, H, W, vec_in, t, s, fgm);
  int* Lb = L + off;

  // each run's node points at its tile root (only this thread writes it);
  // mark the roots of the pieces that touch the border
  const unsigned border = border_bits(t);
  for (unsigned rest = fg; rest;) {
    const int j = __ffs(rest) - 1;
    const unsigned run = run_at(fg, j);
    rest &= ~run;
    const int root = root_of(s, k0 + j);
    if (root != k0 + j) s[at(k0 + j)] = root;
    if (run & border) flag[at(root)] = 1;
  }
  __syncthreads();

  // each tile root's global root, stored negated in its own entry
  for (unsigned st = run_starts(fg); st; st &= st - 1) {
    const int k = k0 + __ffs(st) - 1;
    if (s[at(k)] == k) {
      const int g = global_index(t, W, k) + 1;
      s[at(k)] = -(flag[at(k)] ? find_root(Lb, g) : g);
    }
  }
  __syncthreads();

  const int r = t.r0 + t.lr;
  const int c = t.c0 + t.lc;
  if (r >= H || c >= W) return;
  const unsigned starts = run_starts(fg);
  int lab[kSeg];
  int run_label = 0;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    if ((starts >> j) & 1u) {
      const int v = s[at(k0 + j)];
      run_label = v < 0 ? -v : -s[at(v)];
    }
    lab[j] = ((fg >> j) & 1u) ? run_label : 0;
  }
  int* dst = Lb + static_cast<int64_t>(r) * W + c;
  if (vec_out && c + kSeg <= W) {
#pragma unroll
    for (int v = 0; v < kSeg / 4; ++v)
      reinterpret_cast<int4*>(dst)[v] = make_int4(
          lab[4 * v], lab[4 * v + 1], lab[4 * v + 2], lab[4 * v + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      if (c + j < W) dst[j] = lab[j];
  }
}

struct Grid {
  int H, W, tiles_h, tiles_w;
  dim3 tiles;
};

// Checks the shape; false when a launch would be invalid.
bool make_grid(int64_t B, int64_t H, int64_t W, Grid* g) {
  // one image's labels must stay below the reference's sentinel 2^30; a
  // grid dimension of 0 is an invalid launch, and y holds at most 65535
  if (B < 1 || B > 65535 || H < 1 || W < 1 || H * W >= (int64_t{1} << 30))
    return false;
  g->H = static_cast<int>(H);
  g->W = static_cast<int>(W);
  g->tiles_h = static_cast<int>((H + kTileH - 1) / kTileH);
  g->tiles_w = static_cast<int>((W + kTileW - 1) / kTileW);
  g->tiles = dim3(static_cast<unsigned>(g->tiles_h * g->tiles_w),
                  static_cast<unsigned>(B));
  return true;
}

// Whether 16-byte loads of a tile's segments are aligned.
bool vector_loads(const void* img, int64_t W, int itemsize) {
  return (W * itemsize) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(img) % 16 == 0;
}

template <typename T>
void launch_local(const void* img, const Grid& g, int* L, cudaStream_t s) {
  local_kernel<T><<<g.tiles, kThreads, 0, s>>>(
      static_cast<const T*>(img), g.H, g.W, g.tiles_w,
      vector_loads(img, g.W, sizeof(T)), L);
}

template <typename T>
void launch_final(const void* img, const Grid& g, int* L, cudaStream_t s) {
  // 16 B label stores: W a multiple of 4 and the buffer aligned
  const bool vec_out =
      g.W % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  final_kernel<T><<<g.tiles, kThreads, 0, s>>>(
      static_cast<const T*>(img), g.H, g.W, g.tiles_w,
      vector_loads(img, g.W, sizeof(T)), vec_out, L);
}

// Calls launch with a value of the element type that dtype names.
template <typename F>
int by_dtype(int dtype, F launch) {
  switch (dtype) {
    case kU8:
      launch(uint8_t{});
      break;
    case kI32:
      launch(int32_t{});
      break;
    case kF32:
      launch(float{});
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int seams(const Grid& g, int* L, cudaStream_t s) {
  const int64_t pairs = static_cast<int64_t>(g.tiles_h - 1) * g.W +
                        static_cast<int64_t>(g.tiles_w - 1) * g.H;
  if (pairs > 0) {  // a one-tile image has no seam; a 0 grid is invalid
    const dim3 grid(
        static_cast<unsigned>((pairs + kSeamThreads - 1) / kSeamThreads),
        g.tiles.y);
    seam_kernel<<<grid, kSeamThreads, 0, s>>>(g.H, g.W, g.tiles_h, g.tiles_w,
                                              L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ccl_local(const void* img, int dtype, int64_t B, int64_t H,
                         int64_t W, void* labels, void* stream) {
  Grid g;
  if (!make_grid(B, H, W, &g)) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto v) {
    launch_local<decltype(v)>(img, g, static_cast<int*>(labels),
                              static_cast<cudaStream_t>(stream));
  });
}

extern "C" int ccl_seams(int64_t B, int64_t H, int64_t W, void* labels,
                         void* stream) {
  Grid g;
  if (!make_grid(B, H, W, &g)) return static_cast<int>(cudaErrorInvalidValue);
  return seams(g, static_cast<int*>(labels),
               static_cast<cudaStream_t>(stream));
}

extern "C" int ccl_final(const void* img, int dtype, int64_t B, int64_t H,
                         int64_t W, void* labels, void* stream) {
  Grid g;
  if (!make_grid(B, H, W, &g)) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(dtype, [&](auto v) {
    launch_final<decltype(v)>(img, g, static_cast<int*>(labels),
                              static_cast<cudaStream_t>(stream));
  });
}

extern "C" int ccl(const void* img, int dtype, int64_t B, int64_t H, int64_t W,
                   void* labels, void* stream) {
  int err = ccl_local(img, dtype, B, H, W, labels, stream);
  if (err != 0) return err;
  err = ccl_seams(B, H, W, labels, stream);
  if (err != 0) return err;
  return ccl_final(img, dtype, B, H, W, labels, stream);
}
