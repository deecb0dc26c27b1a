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
// each float32 output written once, against about 30 flops a pixel. The
// serving batch, 8 x 8192^2 uint8, moves 536,870,912 B in and
// 2,147,483,648 B out: about 0.80 ms at 3.35 TB/s; the same batch as
// float32 about 1.28 ms.
//
// What the design does about it:
//  * One thread per output pixel, a 32 x 8 block per 32 x 8 output tile.
//    The block stages its (8 + 2) x (32 + 2) input tile, halo included, in
//    shared memory as float32, zero outside the image, so each input byte
//    comes from device memory about 1.4 times (the halo) instead of nine.
//    Consecutive threads take consecutive columns, so loads and the float32
//    stores coalesce.
//  * The TPU kernel holds one whole image per grid step in VMEM; a whole
//    8192^2 float32 image is 256 MiB, far beyond Hopper's 227 KB of shared
//    memory a block, so the image is tiled and the halo re-read instead.
//  * The input is read in its own dtype (uint8/bool, int32 or float32) and
//    converted in the kernel, as the reference's astype(float32) does.
//  * Bit parity with the reference: the arithmetic is the reference's,
//    operation for operation. The nine taps are added left to right in
//    row-major order; two multiply-adds are fused, as XLA:CPU contracts
//    them: the centre tap of the sum of squares and the deviation
//    x - mean = fma(-sum, 1/9, x) (__fmaf_rn); every other add and
//    multiply is __fadd_rn / __fmul_rn, because nvcc contracts a * b + c
//    into an FMA by default; sqrt is IEEE (__fsqrt_rn). A NaN comparison
//    is false, so a NaN pixel passes through, as jnp.where does.
//  * Subnormals as the reference's XLA treats float32: each arithmetic
//    step reads a subnormal as zero and writes a subnormal result as a zero
//    of its sign. The tile holds the flushed pixels, and the library is
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

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;

enum DType : int { kU8 = 0, kI32 = 1, kF32 = 2 };

__device__ __forceinline__ float to_float(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(int32_t v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

// v, or a zero of its sign when v is subnormal; tested on the bits.
__device__ __forceinline__ float flush(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x7f800000u) ? v : __uint_as_float(u & 0x80000000u);
}

// Grid (ceil(W / kTileW), ceil(H / kTileH), B), block kTileW x kTileH.
template <typename T>
__global__ void __launch_bounds__(kThreads)
denoise_kernel(const T* __restrict__ img, int64_t H, int64_t W,
               float* __restrict__ out) {
  __shared__ float tile[kTileH + 2][kTileW + 2];
  const int64_t b = blockIdx.z;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTileH;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTileW;
  const T* src = img + b * H * W;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int k = tid; k < (kTileH + 2) * (kTileW + 2); k += kThreads) {
    const int ty = k / (kTileW + 2);
    const int tx = k - ty * (kTileW + 2);
    const int64_t r = r0 + ty - 1;
    const int64_t c = c0 + tx - 1;
    float v = 0.0f;
    if (r >= 0 && r < H && c >= 0 && c < W)
      v = flush(to_float(src[r * W + c]));
    tile[ty][tx] = v;
  }
  __syncthreads();
  const int64_t r = r0 + threadIdx.y;
  const int64_t c = c0 + threadIdx.x;
  if (r >= H || c >= W) return;
  const int y = threadIdx.y;
  const int x = threadIdx.x;
  const float t00 = tile[y][x], t01 = tile[y][x + 1], t02 = tile[y][x + 2];
  const float t10 = tile[y + 1][x], t11 = tile[y + 1][x + 1],
              t12 = tile[y + 1][x + 2];
  const float t20 = tile[y + 2][x], t21 = tile[y + 2][x + 1],
              t22 = tile[y + 2][x + 2];

  float s = __fadd_rn(t00, t01);
  s = __fadd_rn(s, t02);
  s = __fadd_rn(s, t10);
  s = __fadd_rn(s, t11);
  s = __fadd_rn(s, t12);
  s = __fadd_rn(s, t20);
  s = __fadd_rn(s, t21);
  s = __fadd_rn(s, t22);

  float q = __fadd_rn(sq(t00), sq(t01));
  q = __fadd_rn(q, sq(t02));
  q = __fadd_rn(q, sq(t10));
  q = __fmaf_rn(t11, t11, q);  // the centre tap, contracted as XLA:CPU does
  q = __fadd_rn(q, sq(t12));
  q = __fadd_rn(q, sq(t20));
  q = __fadd_rn(q, sq(t21));
  q = __fadd_rn(q, sq(t22));

  const float ninth = static_cast<float>(1.0 / 9.0);
  const float rms = __fsqrt_rn(__fmul_rn(q, ninth));
  const float dev = fabsf(__fmaf_rn(-s, ninth, t11));
  // only a float32 input can hold a subnormal, which the tile flushed
  float centre = t11;
  if constexpr (std::is_same<T, float>::value) centre = src[r * W + c];
  out[b * H * W + r * W + c] = dev > __fmul_rn(0.75f, rms) ? rms : centre;
}

template <typename T>
void launch(const void* img, int64_t B, int64_t H, int64_t W, void* out,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((W + kTileW - 1) / kTileW),
                  static_cast<unsigned>((H + kTileH - 1) / kTileH),
                  static_cast<unsigned>(B));
  const dim3 block(kTileW, kTileH);
  denoise_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(img), H,
                                                W, static_cast<float*>(out));
}

}  // namespace

extern "C" int denoise(const void* img, int dtype, int64_t B, int64_t H,
                       int64_t W, void* out, void* stream) {
  // a grid dimension of 0 is an invalid launch; y and z hold at most 65535
  if (B < 1 || B > 65535 || H < 1 || W < 1 ||
      (H + kTileH - 1) / kTileH > 65535 ||
      (W + kTileW - 1) / kTileW > 0x7fffffff)
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
