// The service's content digest of a request's bytes, for Hopper (sm_90a):
// BLAKE2b in its tree-hashing mode, 16-byte digests.
//
// Replaces no Pallas kernel: the JAX package keys each request by a plain
// blake2b over the mask's bytes on the host. The port keys a request on the
// card, because the mask goes there anyway: the submitting thread copies it
// to the device once, this kernel digests the copy, and the flush pads the
// device tensors with nothing left to copy. A blake2b over 67 MB on the
// host (one 8192^2 uint8 mask) takes about 200 ms on one core of an H100
// host, and BLAKE2b itself is sequential; its tree mode is not.
//
// The digest (kernels/keyhash.py, whose plain version is hashlib's blake2b
// node by node): leaves of kLeafBytes bytes, fanout kFanout, every node's
// digest kDigestBytes long; depth is the number of levels the length needs
// (1 for at most one leaf, which is then the root). Every node carries the
// same parameter block but for its node_offset (its index in its level)
// and node_depth (0 for leaves), and the last node of each level sets
// last_node. An inner node hashes its children's digests, concatenated.
//
// What bounds it: int32 operations. A 128-byte block is one compression:
// 12 rounds of 8 G functions, each 22 int32 instructions once 64-bit adds
// are IADD3 pairs (three-operand where they can), xors LOP3 pairs and
// rotations funnel-shift pairs; the SASS for sm_90a counts 2,228
// instructions on a whole block's path, the loads and the state's set-up
// included. An 8192^2 uint8 mask is 524,288 compressions of leaves (plus
// 2,064 of inner nodes): about 1.17e9 int32 instructions, 0.070 ms at 132
// SMs x 64 int32 lanes x 1.98 GHz. Its 67,108,864 bytes take 0.02 ms at
// 3.35 TB/s.
//
// What the design does about it:
//  * One thread a leaf: the 16,384 leaves of an 8192^2 mask are 16,384
//    independent chains of 32 compressions, 128 threads a block. The
//    state, the message block and the working vector stay in registers:
//    the 12 rounds are unrolled with the message schedule as constants
//    (msg<R, K>), so no message word is indexed at run time.
//  * 64-bit words are 32-bit pairs: an add is two 32-bit adds with the
//    carry, a rotation by 32 swaps the halves, by 24, 16 and 63 two funnel
//    shifts.
//  * A block of 128 bytes is eight 16-byte vector loads, through L2
//    (__ldcg); only the last block of the last leaf, and a length that
//    is not a multiple of 16, reads bytes.
//  * The inner levels and the root run in the same launch: each block
//    writes its leaves' digests, fences, and counts itself done; the last
//    block to finish hashes the inner levels, one thread an inner node,
//    with __syncthreads between levels, and writes the root. The inner
//    levels are 1/128 of the leaves' work and more; the root is one
//    thread's 16 compressions.
//  * The caller's stream alone: the counter is zeroed, the kernel runs and
//    the 16 bytes come back on that stream, and only that stream is
//    synchronised, so submitting threads each on a stream of their own do
//    not wait for one another or for the dispatcher's kernels.
//
// Binding: a plain C entry point, loaded with ctypes. It uses the scratch
// it is given (a counter, the root digest, then every level's digests but
// the root's: kernels/keyhash.py::scratch_bytes), copies the root digest to
// the host buffer and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kLeafBytes = 4096;
constexpr uint32_t kFanout = 128;
constexpr uint32_t kDigestBytes = 16;
constexpr uint32_t kBlockBytes = 128;
constexpr int kThreads = 128;     // leaves a block; inner nodes a pass
constexpr int kMaxDepth = 8;      // 4096 * 128^7 bytes is far past any mask
constexpr uint32_t kHeadBytes = 32;  // the counter, then the root digest

struct W {  // a 64-bit word as two 32-bit halves, little-endian
  uint32_t lo, hi;
};

__host__ __device__ constexpr W iv(int i) {
  constexpr W k[8] = {
      {0xf3bcc908u, 0x6a09e667u}, {0x84caa73bu, 0xbb67ae85u},
      {0xfe94f82bu, 0x3c6ef372u}, {0x5f1d36f1u, 0xa54ff53au},
      {0xade682d1u, 0x510e527fu}, {0x2b3e6c1fu, 0x9b05688cu},
      {0xfb41bd6bu, 0x1f83d9abu}, {0x137e2179u, 0x5be0cd19u}};
  return k[i];
}

// the message schedule: word k of round r (rounds 10 and 11 repeat 0 and 1)
__host__ __device__ constexpr int sigma(int r, int k) {
  constexpr unsigned char s[10][16] = {
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
      {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
      {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
      {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
      {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
      {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
      {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
      {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
      {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
      {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};
  return s[r % 10][k];
}

__device__ __forceinline__ W add(W a, W b) {  // two 32-bit adds, carried
  const uint64_t s = (static_cast<uint64_t>(a.hi) << 32 | a.lo) +
                     (static_cast<uint64_t>(b.hi) << 32 | b.lo);
  return {static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)};
}

__device__ __forceinline__ W xor_(W a, W b) { return {a.lo ^ b.lo, a.hi ^ b.hi}; }

__device__ __forceinline__ W rotr32(W a) { return {a.hi, a.lo}; }

template <int N>  // 0 < N < 32
__device__ __forceinline__ W rotr(W a) {
  return {__funnelshift_r(a.lo, a.hi, N), __funnelshift_r(a.hi, a.lo, N)};
}

__device__ __forceinline__ W rotr63(W a) {  // a rotation left by one
  return {__funnelshift_l(a.hi, a.lo, 1), __funnelshift_l(a.lo, a.hi, 1)};
}

__device__ __forceinline__ void g(W& a, W& b, W& c, W& d, W x, W y) {
  a = add(add(a, b), x);
  d = rotr32(xor_(d, a));
  c = add(c, d);
  b = rotr<24>(xor_(b, c));
  a = add(add(a, b), y);
  d = rotr<16>(xor_(d, a));
  c = add(c, d);
  b = rotr63(xor_(b, c));
}

// message word sigma(R, K) of round R, its index a compile-time constant
template <int R, int K>
__device__ __forceinline__ W msg(const W (&m)[16]) {
  constexpr int i = sigma(R, K);
  return m[i];
}

template <int R>
__device__ __forceinline__ void round_(W (&v)[16], const W (&m)[16]) {
  g(v[0], v[4], v[8], v[12], msg<R, 0>(m), msg<R, 1>(m));
  g(v[1], v[5], v[9], v[13], msg<R, 2>(m), msg<R, 3>(m));
  g(v[2], v[6], v[10], v[14], msg<R, 4>(m), msg<R, 5>(m));
  g(v[3], v[7], v[11], v[15], msg<R, 6>(m), msg<R, 7>(m));
  g(v[0], v[5], v[10], v[15], msg<R, 8>(m), msg<R, 9>(m));
  g(v[1], v[6], v[11], v[12], msg<R, 10>(m), msg<R, 11>(m));
  g(v[2], v[7], v[8], v[13], msg<R, 12>(m), msg<R, 13>(m));
  g(v[3], v[4], v[9], v[14], msg<R, 14>(m), msg<R, 15>(m));
}

// F: one block into the state; t the bytes hashed so far, this block's too
// (a node is at most kLeafBytes long, so the counter's high words are 0)
__device__ __forceinline__ void compress(W (&h)[8], const W (&m)[16],
                                         uint32_t t, bool final,
                                         bool last_node) {
  W v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = iv(i);
  }
  v[12].lo ^= t;
  if (final) {
    v[14] = {~v[14].lo, ~v[14].hi};
    if (last_node) v[15] = {~v[15].lo, ~v[15].hi};
  }
  round_<0>(v, m);
  round_<1>(v, m);
  round_<2>(v, m);
  round_<3>(v, m);
  round_<4>(v, m);
  round_<5>(v, m);
  round_<6>(v, m);
  round_<7>(v, m);
  round_<8>(v, m);
  round_<9>(v, m);
  round_<10>(v, m);
  round_<11>(v, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = xor_(h[i], xor_(v[i], v[i + 8]));
}

__device__ __forceinline__ void put(W (&m)[16], int c, uint4 q) {
  m[2 * c] = {q.x, q.y};
  m[2 * c + 1] = {q.z, q.w};
}

// 16 bytes at p, of which the first n (< 16) are there, the rest zeros
__device__ __forceinline__ uint4 load_tail(const uint8_t* p, uint32_t n) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (uint32_t k = 0; k < 16; ++k)
    if (k < n) w[k / 4] |= static_cast<uint32_t>(p[k]) << (8 * (k % 4));
  return {w[0], w[1], w[2], w[3]};
}

// the message block at p (16-byte aligned) of which n bytes are there
__device__ __forceinline__ void load_block(const uint8_t* p, uint32_t n,
                                           W (&m)[16]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t at = 16u * c;
    uint4 q = {0, 0, 0, 0};
    if (at + 16 <= n)
      q = __ldcg(reinterpret_cast<const uint4*>(p + at));
    else if (at < n)
      q = load_tail(p + at, n - at);
    put(m, c, q);
  }
}

// one node's digest: len bytes at p (16-byte aligned)
__device__ uint4 hash_node(const uint8_t* p, uint32_t len, uint32_t offset,
                           uint32_t node_depth, uint32_t depth,
                           bool last_node) {
  W h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = iv(i);
  // the parameter block: digest_length, key_length 0, fanout, depth,
  // leaf_length; node_offset; node_depth, inner_length
  h[0].lo ^= kDigestBytes | (kFanout << 16) | (depth << 24);
  h[0].hi ^= kLeafBytes;
  h[1].lo ^= offset;
  h[2].lo ^= node_depth | (kDigestBytes << 8);
  const uint32_t blocks = len == 0 ? 1 : (len + kBlockBytes - 1) / kBlockBytes;
  W m[16];
  for (uint32_t b = 0; b < blocks; ++b) {
    const bool final = b + 1 == blocks;
    const uint32_t start = b * kBlockBytes;
    load_block(p + start, final ? len - start : kBlockBytes, m);
    compress(h, m, final ? len : start + kBlockBytes, final,
             final && last_node);
  }
  return {h[0].lo, h[0].hi, h[1].lo, h[1].hi};
}

__global__ void __launch_bounds__(kThreads)
    keyhash_kernel(const uint8_t* __restrict__ data, uint64_t n,
                   uint32_t leaves, uint32_t depth, uint8_t* scratch) {
  unsigned* done = reinterpret_cast<unsigned*>(scratch);
  uint4* root = reinterpret_cast<uint4*>(scratch + kDigestBytes);
  uint4* level = reinterpret_cast<uint4*>(scratch + kHeadBytes);
  const uint32_t leaf = blockIdx.x * kThreads + threadIdx.x;
  if (leaf < leaves) {
    const uint64_t at = static_cast<uint64_t>(leaf) * kLeafBytes;
    const uint64_t left = n - at;
    const uint32_t len = left < kLeafBytes ? static_cast<uint32_t>(left)
                                           : kLeafBytes;
    const uint4 d = hash_node(data + at, len, leaf, 0, depth,
                              leaf + 1 == leaves);
    if (depth == 1) {
      *root = d;
      return;
    }
    level[leaf] = d;
  }
  if (depth == 1) return;
  // the last block to finish hashes the inner levels (every other block's
  // digests are in device memory once its fence and count are)
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) + 1 == gridDim.x;
  __syncthreads();
  if (!last) return;
  __threadfence();
  uint32_t count = leaves;
  for (uint32_t d = 1; d < depth; ++d) {
    const uint32_t nodes = (count + kFanout - 1) / kFanout;
    uint4* next = level + count;
    for (uint32_t j = threadIdx.x; j < nodes; j += kThreads) {
      const uint32_t kids = min(count - j * kFanout, kFanout);
      const uint4 dg = hash_node(
          reinterpret_cast<const uint8_t*>(level + j * kFanout),
          kids * kDigestBytes, j, d, depth, j + 1 == nodes);
      if (d + 1 == depth)
        *root = dg;
      else
        next[j] = dg;
    }
    __syncthreads();
    level = next;
    count = nodes;
  }
}

// leaves and depth for n bytes; false past the grid's reach
bool tree_shape(uint64_t n, uint32_t* leaves, uint32_t* depth,
                uint64_t* digests) {
  const uint64_t l = n == 0 ? 1 : (n + kLeafBytes - 1) / kLeafBytes;
  if (l > 0x7fffffffull) return false;
  *leaves = static_cast<uint32_t>(l);
  uint64_t count = l, stored = 0;
  uint32_t d = 1;
  while (count > 1) {
    stored += count;
    count = (count + kFanout - 1) / kFanout;
    ++d;
  }
  if (d > static_cast<uint32_t>(kMaxDepth)) return false;
  *depth = d;
  *digests = stored;
  return true;
}

}  // namespace

extern "C" int keyhash(const void* data, int64_t n, void* scratch,
                       int64_t scratch_bytes, void* digest, void* stream) {
  uint32_t leaves, depth;
  uint64_t digests;
  if (n < 0 || (n > 0 && data == nullptr) ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      !tree_shape(static_cast<uint64_t>(n), &leaves, &depth, &digests) ||
      scratch_bytes < static_cast<int64_t>(kHeadBytes + digests * kDigestBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* head = static_cast<uint8_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(head, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = (leaves + kThreads - 1) / kThreads;
  keyhash_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(data),
                                           static_cast<uint64_t>(n), leaves,
                                           depth, head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(digest, head + kDigestBytes, kDigestBytes,
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(s));
}
