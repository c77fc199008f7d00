// MaxPool2d(kernel 3, stride 2, padding 0, ceil_mode=True) on NCHW or
// channels-last (NHWC in memory) input, fp32 or bf16; the output keeps the
// input's memory format.
//
// Replaces the JAX package's ops/pallas_pool.py:ceil_max_pool2d_pallas
// (pallas_call at :88, kernel _pool_kernel at :39): the towers' stride-2
// ceil-mode max pools (stem pool1 and pool2, the passthrough branch of
// inception 3c and 4e).
//
// Bound: pure data movement. Each input element is read once and each
// output written once; 8 comparisons per output are nothing against the
// card's rate, so the bound is (input + output bytes) / HBM bandwidth.
//
// Design: one thread per output element (NCHW) or per 16-byte channel
// vector of one output pixel (channels-last), grid over every row, channel
// and pixel. Ceil mode only shortens the last window of a row or column
// (2 taps instead of 3 at even H or W); torch guarantees that no window
// starts past the input. The window's 3x3 neighbours overlap between
// adjacent outputs and are served from L1/L2, so the HBM traffic stays
// close to one read of the input. NaN propagates as in torch (a NaN tap
// wins). The TPU kernel's whole-image block, even-start selection matmul
// and row loop were Mosaic workarounds and have no counterpart here.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float take_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

template <typename T>
__global__ void max_pool_nchw_kernel(const T* __restrict__ x, T* __restrict__ out,
                                     int64_t planes, int h, int w, int oh, int ow) {
  const int64_t total = planes * oh * ow;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int ox = static_cast<int>(i % ow);
    const int oy = static_cast<int>((i / ow) % oh);
    const int64_t plane = i / (static_cast<int64_t>(ow) * oh);
    const T* src = x + plane * h * w;
    const int y0 = 2 * oy, x0 = 2 * ox;
    const int y1 = min(y0 + 3, h), x1 = min(x0 + 3, w);
    float m = -INFINITY;
    for (int y = y0; y < y1; ++y) {
      for (int xx = x0; xx < x1; ++xx) m = take_max(m, to_float(src[y * w + xx]));
    }
    out[i] = from_float<T>(m);
  }
}

// VEC consecutive channels of one pixel move as one 16-byte access (VEC = 4
// fp32 or 8 bf16) when the channel count allows it, else one at a time.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void max_pool_nhwc_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                                     int c, int h, int w, int oh, int ow) {
  const int cv = c / VEC;  // channel vectors per pixel
  const int64_t total = static_cast<int64_t>(n) * oh * ow * cv;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int vec = static_cast<int>(i % cv);
    const int64_t pixel = i / cv;  // (b, oy, ox) of the output
    const int ox = static_cast<int>(pixel % ow);
    const int oy = static_cast<int>((pixel / ow) % oh);
    const int64_t b = pixel / (static_cast<int64_t>(ow) * oh);
    const int y0 = 2 * oy, x0 = 2 * ox;
    const int y1 = min(y0 + 3, h), x1 = min(x0 + 3, w);
    float m[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) m[k] = -INFINITY;
    for (int y = y0; y < y1; ++y) {
      for (int xx = x0; xx < x1; ++xx) {
        const int64_t offset = ((b * h + y) * w + xx) * c + static_cast<int64_t>(vec) * VEC;
        const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + offset);
#pragma unroll
        for (int k = 0; k < VEC; ++k) m[k] = take_max(m[k], to_float(p.v[k]));
      }
    }
    Pack<T, VEC> r;
#pragma unroll
    for (int k = 0; k < VEC; ++k) r.v[k] = from_float<T>(m[k]);
    *reinterpret_cast<Pack<T, VEC>*>(out + pixel * c + static_cast<int64_t>(vec) * VEC) = r;
  }
}

int grid_for(int64_t work) {
  // grid-stride loops: enough blocks to fill the card many times over, capped
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65535 * 8 ? (blocks > 0 ? blocks : 1) : 65535 * 8);
}

template <typename T>
int launch(const void* x, void* out, int n, int c, int h, int w, int oh, int ow,
           int channels_last, cudaStream_t stream) {
  const T* src = static_cast<const T*>(x);
  T* dst = static_cast<T*>(out);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (!channels_last) {
    const int64_t planes = static_cast<int64_t>(n) * c;
    max_pool_nchw_kernel<T><<<grid_for(planes * oh * ow), kThreads, 0, stream>>>(
        src, dst, planes, h, w, oh, ow);
  } else if (c % kVec == 0 && aligned) {
    const int64_t work = static_cast<int64_t>(n) * oh * ow * (c / kVec);
    max_pool_nhwc_kernel<T, kVec><<<grid_for(work), kThreads, 0, stream>>>(
        src, dst, n, c, h, w, oh, ow);
  } else {
    const int64_t work = static_cast<int64_t>(n) * oh * ow * c;
    max_pool_nhwc_kernel<T, 1><<<grid_for(work), kThreads, 0, stream>>>(
        src, dst, n, c, h, w, oh, ow);
  }
  return last_launch_error();
}

}  // namespace

extern "C" {

// x (n, c, h, w) in NCHW or, with channels_last, NHWC memory order; out
// (n, c, oh, ow) in the same order. Returns 0 or a cudaError_t code.
int max_pool_forward(int dtype, int device, const void* x, void* out, int n, int c, int h,
                     int w, int oh, int ow, int channels_last, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(x, out, n, c, h, w, oh, ow, channels_last, s);
  }
  return launch<float>(x, out, n, c, h, w, oh, ow, channels_last, s);
}

const char* max_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
