// Fused inference stem of a BN-Inception tower: normalize -> 7x7 / stride 2
// / pad 3 conv with the BatchNorm folded in -> + float32 bias -> ReLU ->
// 3x3 / stride 2 / pad 0 ceil-mode max pool, in one pass.
//
// Replaces the JAX package's ops/fused_stem.py:fused_stem_pallas
// (pallas_call at :264, kernel _stem_kernel at :126).
//
// Input: (B, H, W, C) NHWC memory, uint8 (RGB 3 / Flow 10 channels, with a
// per-channel affine) or float32 / bfloat16 (the audio spectrogram, C = 1,
// affine 1 / 0); H and W multiples of 4. Weight: (64, C, 7, 7) in the
// compute type T, the BN scale already folded in. Bias, scale, offset:
// float32. Output: (B, H/4, W/4, 64) NHWC memory in T, which is a
// channels-last (B, 64, H/4, W/4) tensor for the next convolution.
//
// Numerics as the Pallas kernel: the input is normalized in float32 and
// rounded once to T; products accumulate in float32; bias and ReLU in
// float32; the pool takes the max in float32 and the result is rounded to
// T once (rounding is monotone, so pool-then-round equals round-then-pool).
//
// Bound: operations. The 7x7 conv does 2 * 49 * C * 64 operations per conv
// output against C input bytes and (a quarter of) 128 output bytes, far
// above the card's ridge point. This first kernel runs them on the fp32
// FMA units, not the tensor cores (a later PR's work: an implicit GEMM on
// wgmma with K = 49 * C).
//
// Design: one block of 256 threads per (image, tile of 4 x 8 pooled
// outputs). The tile needs 9 x 17 conv outputs (the pool windows overlap
// by one conv row and column, recomputed by the neighbouring tile) and a
// 23 x 39 x C input patch, staged once in shared memory, normalized and
// zero-padded. Weights stream through shared memory one input channel at a
// time (49 x 64 floats, 13 KB), so even the 10-channel Flow stem needs
// only ~49 KB (hence the dynamic shared-memory opt-in above 48 KB). Each
// thread holds 8 output channels x 5 conv positions in registers: per tap
// two 16-byte weight loads and five broadcast input loads feed 40 FMAs.
// The conv tile then goes to shared memory (aliasing the patch) with bias
// and ReLU, and the pooled 4 x 8 x 64 outputs are written with consecutive
// threads on consecutive channels. The TPU kernel's column packing, 14-way
// row chunking and lane-padding workarounds have no counterpart here.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 64;                      // stem output channels
constexpr int kTileH = 4;                     // pooled rows per block
constexpr int kTileW = 8;                     // pooled columns per block
constexpr int kConvH = 2 * kTileH + 1;        // conv rows the tile's windows read
constexpr int kConvW = 2 * kTileW + 1;
constexpr int kPos = kConvH * kConvW;         // 153 conv positions
constexpr int kPatchH = 4 * kTileH + 7;       // input rows behind them
constexpr int kPatchW = 4 * kTileW + 7;
constexpr int kTaps = 49;
constexpr int kGroups = 8;                    // 8 groups of 8 output channels
constexpr int kLanes = kThreads / kGroups;    // 32 position lanes
constexpr int kSlots = (kPos + kLanes - 1) / kLanes;  // 5 positions per thread
constexpr int kWStride = kOut + 4;            // padded tap row: 4-way, not 32-way, store conflicts

enum InputCode : int { kInFloat32 = 0, kInBFloat16 = 1, kInUInt8 = 2 };

__device__ __forceinline__ float load_input(const float* p) { return *p; }
__device__ __forceinline__ float load_input(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_input(const uint8_t* p) {
  return static_cast<float>(*p);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Floats of the patch, rounded up so the weights after it stay 16-byte aligned.
__host__ __device__ __forceinline__ int patch_floats(int c) {
  return (c * kPatchH * kPatchW + 3) & ~3;
}

int smem_bytes(int c) {
  const int stage = (patch_floats(c) + kTaps * kWStride) * static_cast<int>(sizeof(float));
  const int pool = kPos * kOut * static_cast<int>(sizeof(float));
  return stage > pool ? stage : pool;
}

template <typename In, typename T>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const In* __restrict__ x, const T* __restrict__ weight,
                  const float* __restrict__ bias, const float* __restrict__ scale,
                  const float* __restrict__ offset, T* __restrict__ out, int c, int h, int w,
                  int tiles_w) {
  extern __shared__ __align__(16) float smem[];
  float* patch = smem;                              // [c][kPatchH][kPatchW]
  float* wts = smem + patch_floats(c);              // [tap][kWStride], one input channel
  float* conv = smem;                               // [pos][kOut], after the conv

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const int conv_h = h / 2, conv_w = w / 2;
  const int out_h = h / 4, out_w = w / 4;
  const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;  // input coordinates of patch (0, 0)

  // 1. the normalized, zero-padded input patch; consecutive threads read
  //    consecutive bytes of an input row (channels innermost)
  const In* xb = x + static_cast<int64_t>(b) * h * w * c;
  for (int i = threadIdx.x; i < kPatchH * kPatchW * c; i += kThreads) {
    const int ci = i % c;
    const int col = (i / c) % kPatchW;
    const int row = i / (c * kPatchW);
    const int iy = iy0 + row, ix = ix0 + col;
    float v = 0.0f;  // the conv pads the normalized input with zeros
    if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
      const float raw = load_input(xb + (static_cast<int64_t>(iy) * w + ix) * c + ci);
      v = round_to<T>(__fadd_rn(__fmul_rn(raw, scale[ci]), offset[ci]));
    }
    patch[(ci * kPatchH + row) * kPatchW + col] = v;
  }

  // 2. the conv: thread (group, lane) accumulates output channels
  //    8*group .. 8*group+7 at conv positions lane + 32*k
  const int group = threadIdx.x % kGroups;
  const int lane = threadIdx.x / kGroups;
  int base[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int p = min(lane + k * kLanes, kPos - 1);  // spare slots recompute the last
    base[k] = 2 * (p / kConvW) * kPatchW + 2 * (p % kConvW);
  }
  float acc[kSlots][8];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.0f;
  }
  for (int ci = 0; ci < c; ++ci) {
    __syncthreads();  // the patch is complete; the previous channel's weights are consumed
    for (int i = threadIdx.x; i < kOut * kTaps; i += kThreads) {
      const int o = i / kTaps, tap = i % kTaps;
      wts[tap * kWStride + o] = to_float(weight[(static_cast<int64_t>(o) * c + ci) * kTaps + tap]);
    }
    __syncthreads();
    const float* pc = patch + ci * kPatchH * kPatchW;
    for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
        const float* wt = wts + (ky * 7 + kx) * kWStride + group * 8;
        const float4 w0 = *reinterpret_cast<const float4*>(wt);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + 4);
        const int off = ky * kPatchW + kx;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const float v = pc[base[k] + off];
          acc[k][0] = fmaf(v, w0.x, acc[k][0]);
          acc[k][1] = fmaf(v, w0.y, acc[k][1]);
          acc[k][2] = fmaf(v, w0.z, acc[k][2]);
          acc[k][3] = fmaf(v, w0.w, acc[k][3]);
          acc[k][4] = fmaf(v, w1.x, acc[k][4]);
          acc[k][5] = fmaf(v, w1.y, acc[k][5]);
          acc[k][6] = fmaf(v, w1.z, acc[k][6]);
          acc[k][7] = fmaf(v, w1.w, acc[k][7]);
        }
      }
    }
  }

  // 3. bias + ReLU into the conv tile (aliases the patch: wait for all reads)
  __syncthreads();
  float bias8[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias8[j] = bias[group * 8 + j];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int p = lane + k * kLanes;
    if (p < kPos) {
      float4 r0, r1;
      r0.x = fmaxf(acc[k][0] + bias8[0], 0.0f);
      r0.y = fmaxf(acc[k][1] + bias8[1], 0.0f);
      r0.z = fmaxf(acc[k][2] + bias8[2], 0.0f);
      r0.w = fmaxf(acc[k][3] + bias8[3], 0.0f);
      r1.x = fmaxf(acc[k][4] + bias8[4], 0.0f);
      r1.y = fmaxf(acc[k][5] + bias8[5], 0.0f);
      r1.z = fmaxf(acc[k][6] + bias8[6], 0.0f);
      r1.w = fmaxf(acc[k][7] + bias8[7], 0.0f);
      float* dst = conv + p * kOut + group * 8;
      *reinterpret_cast<float4*>(dst) = r0;
      *reinterpret_cast<float4*>(dst + 4) = r1;
    }
  }
  __syncthreads();

  // 4. the 3x3 / 2 ceil pool; the last window of the image is clipped to
  //    the conv output (ceil mode), never to the tile
  const int rows_left = conv_h - 2 * oy0, cols_left = conv_w - 2 * ox0;
  for (int i = threadIdx.x; i < kTileH * kTileW * kOut; i += kThreads) {
    const int o = i % kOut, q = i / kOut;
    const int qy = q / kTileW, qx = q % kTileW;
    const int oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= out_h || ox >= out_w) continue;
    const int r0 = 2 * qy, c0 = 2 * qx;
    const int r1 = min(r0 + 3, rows_left), c1 = min(c0 + 3, cols_left);
    float m = -INFINITY;
    for (int r = r0; r < r1; ++r) {
      for (int cc = c0; cc < c1; ++cc) m = fmaxf(m, conv[(r * kConvW + cc) * kOut + o]);
    }
    out[((static_cast<int64_t>(b) * out_h + oy) * out_w + ox) * kOut + o] = from_float<T>(m);
  }
}

template <typename In, typename T>
int launch(const void* x, const void* weight, const float* bias, const float* scale,
           const float* offset, void* out, int batch, int c, int h, int w,
           cudaStream_t stream) {
  const int bytes = smem_bytes(c);
  auto kernel = fused_stem_kernel<In, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (h / 4 + kTileH - 1) / kTileH;
  const int tiles_w = (w / 4 + kTileW - 1) / kTileW;
  const dim3 grid(tiles_h * tiles_w, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const In*>(x), static_cast<const T*>(weight), bias, scale, offset,
      static_cast<T*>(out), c, h, w, tiles_w);
  return last_launch_error();
}

template <typename T>
int launch_for_input(int input_code, const void* x, const void* weight, const float* bias,
                     const float* scale, const float* offset, void* out, int batch, int c,
                     int h, int w, cudaStream_t stream) {
  switch (input_code) {
    case kInUInt8:
      return launch<uint8_t, T>(x, weight, bias, scale, offset, out, batch, c, h, w, stream);
    case kInBFloat16:
      return launch<__nv_bfloat16, T>(x, weight, bias, scale, offset, out, batch, c, h, w,
                                      stream);
    case kInFloat32:
      return launch<float, T>(x, weight, bias, scale, offset, out, batch, c, h, w, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x (batch, h, w, c) NHWC of type input_code; weight (64, c, 7, 7) and out
// (batch, h/4, w/4, 64) of type dtype; bias (64,), scale and offset (c,)
// float32. h and w multiples of 4, batch <= 65535 (checked by the caller).
// Returns 0 or a cudaError_t code.
int fused_stem_forward(int input_code, int dtype, int device, const void* x, const void* weight,
                       const void* bias, const void* scale, const void* offset, void* out,
                       int batch, int c, int h, int w, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  const float* sf = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  if (dtype == kBFloat16) {
    return launch_for_input<__nv_bfloat16>(input_code, x, weight, bf, sf, of, out, batch, c,
                                           h, w, s);
  }
  return launch_for_input<float>(input_code, x, weight, bf, sf, of, out, batch, c, h, w, s);
}

const char* fused_stem_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
