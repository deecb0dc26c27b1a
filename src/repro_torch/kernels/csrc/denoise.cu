// P-HGRMS impulse filter for a (B, H, W) stack, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/denoise.py::_denoise_kernel (wrapper denoise_pallas).
//
// Each output pixel: the zero-padded 3x3 window's sum s and sum of squares
// q, mean = s * float32(1/9), rms = sqrt(q * float32(1/9)), and
// out = rms if |x - mean| > 0.75 * rms else x, all in float32.
//
// What bounds it: device-memory bytes. Each input pixel is read once and
// each float32 output written once: 5 B/px for uint8 input, 8 B/px for
// float32. The serving batch, 8 x 8192^2 uint8, moves 536,870,912 B in and
// 2,147,483,648 B out: about 0.80 ms at 3.35 TB/s; the same batch as
// float32 about 1.28 ms. This design reads each input row (R + 2) / R
// times (R = kStripH = 32: 1.0625) and writes each output once. The
// arithmetic, about 25 float32 instructions a pixel and a correctly
// rounded square root, comes close to the bytes at uint8.
//
// What the design does about it:
//  * A thread owns kCols = 4 adjacent output columns; a warp a 128-column
//    strip, a block of kWarps = 4 warps 512 columns. The warp walks down
//    kStripH rows and keeps three input rows (values and squares) in
//    registers: each row's pixels are loaded, converted, flushed and
//    squared once, and used by the three output rows whose windows hold
//    them. The left and right neighbours of a thread's columns come from
//    the neighbouring lanes (__shfl_up/down_sync); lanes 0 and 31 load the
//    one halo pixel at the warp's edge. No shared memory and no
//    __syncthreads: warps are independent.
//  * Loads are one 4-pixel vector a thread a row (4 B for uint8, 16 B for
//    int32 or float32) where W is a multiple of 4 and the base pointer
//    aligned to the vector; otherwise (a ragged width, or a view with a
//    storage offset) the same kernel's scalar-load instantiation runs.
//    Stores are one float4 a thread a row where W is a multiple of 4,
//    coalesced. The next input row is loaded before the current output row
//    is computed, so a load is in flight while the arithmetic runs; at most
//    64 registers a thread keep 8 blocks (32 warps) on an SM.
//  * The TPU kernel holds one whole image per grid step in VMEM; a whole
//    8192^2 float32 image is 256 MiB, far beyond a block's 227 KB of shared
//    memory, so each block walks a 512 x 32 strip and re-reads its two
//    halo rows.
//  * The input is read in its own dtype (uint8/bool, int32 or float32) and
//    converted in the kernel, as the reference's astype(float32) does.
//  * Bit parity with the reference: the arithmetic is the reference's,
//    operation for operation. The nine taps are added left to right in
//    row-major order (no row or column partial sums: float addition does
//    not associate); two multiply-adds are fused, as XLA:CPU contracts
//    them: the centre tap of the sum of squares and the deviation
//    x - mean = fma(-sum, 1/9, x) (__fmaf_rn); every other add and
//    multiply is __fadd_rn / __fmul_rn, because nvcc contracts a * b + c
//    into an FMA by default; sqrt is IEEE (__fsqrt_rn). A square is the
//    same bits whichever window uses it, so sharing it across windows is
//    exact. A NaN comparison is false, so a NaN pixel passes through, as
//    jnp.where does.
//  * Subnormals as the reference's XLA treats float32: each arithmetic
//    step reads a subnormal as zero and writes a subnormal result as a zero
//    of its sign. Each float32 tap is flushed on load, and the library is
//    built with -ftz=true, so that __fadd_rn, __fmul_rn, __fmaf_rn and
//    __fsqrt_rn flush their results too. The select passes the centre
//    pixel through as it was read, unflushed, as the reference's does.
//
// Binding: a plain C entry point, loaded with ctypes. It launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCols = 4;                   // output columns a thread
constexpr int kWarpCols = 32 * kCols;      // 128
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStripW = kWarps * kWarpCols;  // 512 columns a block
constexpr int kStripH = 32;                  // output rows a block
constexpr unsigned kFull = 0xffffffffu;

enum DType : int { kU8 = 0, kI32 = 1, kF32 = 2 };

// A byte as float32, exactly: 2^23 + v has v in its low mantissa bits.
__device__ __forceinline__ float to_float(uint8_t v) {
  return __fsub_rn(__uint_as_float(0x4b000000u | v), 8388608.0f);
}
__device__ __forceinline__ float to_float(int32_t v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// v, or a zero of its sign when v is subnormal; tested on the bits. Only a
// float32 input can hold a subnormal.
template <typename T>
__device__ __forceinline__ float flushed(T raw) {
  const float v = to_float(raw);
  if constexpr (!std::is_same<T, float>::value) return v;
  const unsigned u = __float_as_uint(v);
  return (u & 0x7f800000u) ? v : __uint_as_float(u & 0x80000000u);
}

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

template <typename T> struct Vec;
template <> struct Vec<uint8_t> { using type = uchar4; };
template <> struct Vec<int32_t> { using type = int4; };
template <> struct Vec<float> { using type = float4; };

// One input row as loaded: this thread's kCols pixels and, on lanes 0 and
// 31, the halo pixel left or right of the warp's strip.
template <typename T>
struct Raw {
  T v[kCols];
  T halo;
};

// One input row as the window uses it: v[0] the pixel left of the thread's
// columns, v[1..4] its own, v[5] the one to the right (zero outside the
// image), the squares of all six, and the own pixels unflushed.
struct Row {
  float v[kCols + 2];
  float q[kCols + 2];
  float centre[kCols];
};

// Loads row r (zeros outside the image). aligned: W % kCols == 0 and the
// base pointer aligned to a vector, so a thread's columns are all inside
// the image or all outside.
template <typename T, bool kAligned>
__device__ __forceinline__ void load(const T* __restrict__ src, int r, int H,
                                     int W, int c, int lane, Raw<T>& raw) {
#pragma unroll
  for (int i = 0; i < kCols; ++i) raw.v[i] = T(0);
  raw.halo = T(0);
  if (r < 0 || r >= H) return;
  const T* row = src + static_cast<int64_t>(r) * W;
  if constexpr (kAligned) {
    if (c < W) {
      const typename Vec<T>::type q =
          __ldg(reinterpret_cast<const typename Vec<T>::type*>(row + c));
      raw.v[0] = q.x;
      raw.v[1] = q.y;
      raw.v[2] = q.z;
      raw.v[3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (c + i < W) raw.v[i] = __ldg(row + c + i);
  }
  if (lane == 0 && c > 0) raw.halo = __ldg(row + c - 1);
  if (lane == 31 && c + kCols < W) raw.halo = __ldg(row + c + kCols);
}

template <typename T>
__device__ __forceinline__ void convert(const Raw<T>& raw, int lane,
                                        Row& row) {
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    row.v[i + 1] = flushed(raw.v[i]);
    row.centre[i] = to_float(raw.v[i]);
  }
  const float halo = flushed(raw.halo);
  const float left = __shfl_up_sync(kFull, row.v[kCols], 1);
  const float right = __shfl_down_sync(kFull, row.v[1], 1);
  row.v[0] = lane == 0 ? halo : left;
  row.v[kCols + 1] = lane == 31 ? halo : right;
#pragma unroll
  for (int i = 0; i < kCols + 2; ++i) row.q[i] = sq(row.v[i]);
}

// Output column i of the thread, from the rows above, at and below it.
__device__ __forceinline__ float filter(const Row& a, const Row& b,
                                        const Row& c, int i) {
  float s = __fadd_rn(a.v[i], a.v[i + 1]);
  s = __fadd_rn(s, a.v[i + 2]);
  s = __fadd_rn(s, b.v[i]);
  s = __fadd_rn(s, b.v[i + 1]);
  s = __fadd_rn(s, b.v[i + 2]);
  s = __fadd_rn(s, c.v[i]);
  s = __fadd_rn(s, c.v[i + 1]);
  s = __fadd_rn(s, c.v[i + 2]);

  const float t11 = b.v[i + 1];
  float q = __fadd_rn(a.q[i], a.q[i + 1]);
  q = __fadd_rn(q, a.q[i + 2]);
  q = __fadd_rn(q, b.q[i]);
  q = __fmaf_rn(t11, t11, q);  // the centre tap, contracted as XLA:CPU does
  q = __fadd_rn(q, b.q[i + 2]);
  q = __fadd_rn(q, c.q[i]);
  q = __fadd_rn(q, c.q[i + 1]);
  q = __fadd_rn(q, c.q[i + 2]);

  const float ninth = static_cast<float>(1.0 / 9.0);
  const float rms = __fsqrt_rn(__fmul_rn(q, ninth));
  const float dev = fabsf(__fmaf_rn(-s, ninth, t11));
  return dev > __fmul_rn(0.75f, rms) ? rms : b.centre[i];
}

// Output row r from rows a (r - 1) and b (r), with c taking row r + 1 from
// raw; raw then takes row r + 2 if the strip needs it.
template <typename T, bool kAligned>
__device__ __forceinline__ void step(const T* __restrict__ src,
                                     float* __restrict__ dst, int r, int r1,
                                     int H, int W, int c, int lane,
                                     Raw<T>& raw, const Row& a, const Row& b,
                                     Row& below) {
  convert(raw, lane, below);
  if (r + 2 <= r1) load<T, kAligned>(src, r + 2, H, W, c, lane, raw);
  float o[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) o[i] = filter(a, b, below, i);
  float* out = dst + static_cast<int64_t>(r) * W + c;
  if constexpr (kAligned) {
    if (c < W) *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (c + i < W) out[i] = o[i];
  }
}

// Grid (ceil(W / kStripW), ceil(H / kStripH), B), kThreads a block; at
// most 64 registers a thread, so that 8 blocks share an SM.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads, 8)
denoise_kernel(const T* __restrict__ img, int H, int W,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp_c0 = blockIdx.x * kStripW + (threadIdx.x >> 5) * kWarpCols;
  if (warp_c0 >= W) return;  // the whole warp: shuffles need every lane
  const int c = warp_c0 + lane * kCols;
  const int r0 = blockIdx.y * kStripH;
  const int r1 = min(r0 + kStripH, H);
  const int64_t off = static_cast<int64_t>(blockIdx.z) * H * W;
  const T* src = img + off;
  float* dst = out + off;

  Raw<T> raw;
  Row x, y, z;
  load<T, kAligned>(src, r0 - 1, H, W, c, lane, raw);
  convert(raw, lane, x);
  load<T, kAligned>(src, r0, H, W, c, lane, raw);
  convert(raw, lane, y);
  load<T, kAligned>(src, r0 + 1, H, W, c, lane, raw);
  // three steps a turn, the rows rotating through x, y and z in place
  for (int r = r0; r < r1; r += 3) {
    step<T, kAligned>(src, dst, r, r1, H, W, c, lane, raw, x, y, z);
    if (r + 1 >= r1) break;
    step<T, kAligned>(src, dst, r + 1, r1, H, W, c, lane, raw, y, z, x);
    if (r + 2 >= r1) break;
    step<T, kAligned>(src, dst, r + 2, r1, H, W, c, lane, raw, z, x, y);
  }
}

template <typename T>
void launch(const void* img, int64_t B, int64_t H, int64_t W, void* out,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((W + kStripW - 1) / kStripW),
                  static_cast<unsigned>((H + kStripH - 1) / kStripH),
                  static_cast<unsigned>(B));
  const T* src = static_cast<const T*>(img);
  float* dst = static_cast<float*>(out);
  const bool aligned =
      W % kCols == 0 &&
      reinterpret_cast<uintptr_t>(img) % (kCols * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned)
    denoise_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        src, static_cast<int>(H), static_cast<int>(W), dst);
  else
    denoise_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        src, static_cast<int>(H), static_cast<int>(W), dst);
}

}  // namespace

extern "C" int denoise(const void* img, int dtype, int64_t B, int64_t H,
                       int64_t W, void* out, void* stream) {
  // a grid dimension of 0 is an invalid launch; y and z hold at most
  // 65535; rows and columns are int32 in the kernel
  if (B < 1 || B > 65535 || H < 1 || W < 1 || W > 0x7fffffff - kStripW ||
      (H + kStripH - 1) / kStripH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kU8:
      launch<uint8_t>(img, B, H, W, out, s);
      break;
    case kI32:
      launch<int32_t>(img, B, H, W, out, s);
      break;
    case kF32:
      launch<float>(img, B, H, W, out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
