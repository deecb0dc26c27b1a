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
// 3.35 TB/s. The labels are also read and updated in between (merge and
// flatten passes), so the kernel cannot reach that bound; how far it stays
// from it depends on the data (chain lengths in the union-find forest).
//
// What the design does about it:
//  * The TPU kernel holds a whole image in VMEM and sweeps neighbour minima
//    until nothing changes: a number of sweeps that grows with a
//    component's diameter, and an 8192^2 image (256 MiB of int32 labels)
//    far beyond Hopper's 227 KB of shared memory a block. So this kernel
//    does not propagate; it is union-find in device memory (Playne &
//    Hawick 2018; Allegretti et al., "BUF"), three passes over the pixels:
//      1. init:    each fg pixel's parent is itself, bg is 0;
//      2. merge:   for the left and the up neighbour, find both roots and
//                  link the larger root under the smaller with atomicMin,
//                  retrying until they agree;
//      3. flatten: each fg pixel writes its root.
//    A pixel's parent is never above its own index, so the root of every
//    component ends as its minimum index: the reference's fixpoint, whatever
//    order the threads ran in.
//  * Labels are stored 1-based (parent index + 1), so background is 0 from
//    the init pass on, the merge pass tests a neighbour's label for
//    foreground without re-reading the image, and the flatten pass writes
//    the output in place.
//  * The input is read once, in its own dtype (uint8/bool, int32 or
//    float32), by the init pass.
//  * Reads of parents during merge bypass L1 (__ldcg): another SM may have
//    lowered a parent since. A stale parent is still an ancestor, and the
//    value atomicMin returns decides whether a link held, so staleness costs
//    a retry, never a wrong label.
//  * Indices are int32 within one image (21000^2 = 441,000,000 < 2^30,
//    the reference's sentinel); the batch offset is 64-bit.
//  * In a 2 x 2 foreground block, the up link of the bottom-right pixel
//    is implied by the other three links, so it is skipped.
//
// Binding: a plain C entry point, loaded with ctypes. It launches its three
// passes on the stream it is given, allocates nothing (the labels buffer is
// the union-find forest), and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum DType : int { kU8 = 0, kI32 = 1, kF32 = 2 };

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

// Root (1-based) of the tree holding the 1-based label x.
__device__ __forceinline__ int find_root(const int* L, int x) {
  int p = __ldcg(L + x - 1);
  while (p != x) {
    x = p;
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

// Grid (ceil(H * W / kThreads), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
init_kernel(const T* __restrict__ img, int HW, int* __restrict__ L) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= HW) return;
  const int64_t o = static_cast<int64_t>(blockIdx.y) * HW;
  L[o + i] = foreground(img[o + i]) ? i + 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(int H, int W, int* L) {
  const int HW = H * W;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= HW) return;
  int* Lb = L + static_cast<int64_t>(blockIdx.y) * HW;
  if (Lb[i] == 0) return;
  const int r = i / W;
  const int c = i - r * W;
  const bool left = c > 0 && Lb[i - 1] != 0;
  const bool up = r > 0 && Lb[i - W] != 0;
  if (left) unite(Lb, i + 1, i);
  if (up && !(left && Lb[i - W - 1] != 0)) unite(Lb, i + 1, i - W + 1);
}

__global__ void __launch_bounds__(kThreads)
flatten_kernel(int HW, int* L) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= HW) return;
  int* Lb = L + static_cast<int64_t>(blockIdx.y) * HW;
  if (Lb[i] != 0) Lb[i] = find_root(Lb, i + 1);
}

template <typename T>
void launch_init(const void* img, int HW, dim3 grid, int* L,
                 cudaStream_t stream) {
  init_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(img),
                                                HW, L);
}

}  // namespace

extern "C" int ccl(const void* img, int dtype, int64_t B, int64_t H, int64_t W,
                   void* labels, void* stream) {
  // one image's labels must stay below the reference's sentinel 2^30; a
  // grid dimension of 0 is an invalid launch, and y holds at most 65535
  if (B < 1 || B > 65535 || H < 1 || W < 1 || H * W >= (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hw = static_cast<int>(H * W);
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* L = static_cast<int*>(labels);
  switch (dtype) {
    case kU8:
      launch_init<uint8_t>(img, hw, grid, L, s);
      break;
    case kI32:
      launch_init<int32_t>(img, hw, grid, L, s);
      break;
    case kF32:
      launch_init<float>(img, hw, grid, L, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<grid, kThreads, 0, s>>>(static_cast<int>(H),
                                         static_cast<int>(W), L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flatten_kernel<<<grid, kThreads, 0, s>>>(hw, L);
  return static_cast<int>(cudaGetLastError());
}
