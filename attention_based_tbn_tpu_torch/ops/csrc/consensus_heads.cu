// Segment consensus fused with the classifier heads: per clip, the float32
// mean of (N, F) features over N, then each head's logits
// pooled @ W_h^T + b_h in float32, all heads in one launch.
//
// Replaces the JAX package's ops/pallas_kernels.py:consensus_heads_pallas
// (pallas_call at :299; reference consensus_heads_reference at :264).
//
// Input: features (B, N, F) float32 or bfloat16 (the Fusion output, B clips
// of N segment rows, or N = 10 x segments under 10-crop); per head a
// (C_h, F) float32 weight in torch layout and a (C_h,) float32 bias.
// Output: per head (B, C_h) float32.
//
// Bound: bytes. Each feature is read once and each weight once per clip
// (from L2 after the first), 2 * (F + C) operations per feature row: far
// below the card's ridge point, and at the flagship shapes (10 x 250 x 512
// features, 477 classes) a few microseconds of traffic, so launch overhead
// dominates; one launch for all heads is the design's point.
//
// Design: grid (class chunks, B). Each block sums its clip's N rows into a
// float32 mean in shared memory (thread i owns features i, i + 256, ...,
// reading rows in order, consecutive threads on consecutive features), then
// each warp takes classes of the chunk, one at a time: lanes stride F, fp32
// FMAs, a shuffle reduction, lane 0 adds the bias and writes. Chunks of 64
// classes give 8 blocks per clip for 477 classes; each block recomputes the
// mean, which costs one more read of the clip's features from L2. The TPU
// kernel's batch tiles and _pad_batch were Mosaic constraints and have no
// counterpart here.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFeatures = 4096;  // 16 KB of shared memory for the mean
constexpr int kMaxHeads = 4;
constexpr int kClassesPerBlock = 64;

struct Heads {
  const float* weight[kMaxHeads];
  const float* bias[kMaxHeads];
  float* out[kMaxHeads];
  int classes[kMaxHeads];
  int count;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
consensus_heads_kernel(const T* __restrict__ x, Heads heads, int n, int f) {
  __shared__ float pooled[kMaxFeatures];
  const int b = blockIdx.y;
  const T* xb = x + static_cast<int64_t>(b) * n * f;
  for (int i = threadIdx.x; i < f; i += kThreads) {
    float sum = 0.0f;
    for (int row = 0; row < n; ++row) sum += to_float(xb[static_cast<int64_t>(row) * f + i]);
    pooled[i] = sum / static_cast<float>(n);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = warp; k < kClassesPerBlock; k += kWarps) {
    int cls = blockIdx.x * kClassesPerBlock + k;  // over the heads' classes, concatenated
    int h = 0;
    while (h < heads.count && cls >= heads.classes[h]) cls -= heads.classes[h++];
    if (h == heads.count) break;  // past the last class; later k are too
    const float* row = heads.weight[h] + static_cast<int64_t>(cls) * f;
    float dot = 0.0f;
    for (int i = lane; i < f; i += 32) dot = fmaf(pooled[i], row[i], dot);
#pragma unroll
    for (int delta = 16; delta > 0; delta >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, delta);
    if (lane == 0) {
      heads.out[h][static_cast<int64_t>(b) * heads.classes[h] + cls] = dot + heads.bias[h][cls];
    }
  }
}

}  // namespace

extern "C" {

// x (batch, n, f) of type dtype; per head h < count: weights[h] (classes[h],
// f), biases[h] (classes[h],) and outs[h] (batch, classes[h]), all float32.
// f <= consensus_heads_max_features(), count <= consensus_heads_max_heads(),
// batch <= 65535 (checked by the caller). Returns 0 or a cudaError_t code.
int consensus_heads_forward(int dtype, int device, const void* x, const void* const* weights,
                            const void* const* biases, void* const* outs, const int* classes,
                            int count, int batch, int n, int f, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 1 || count > kMaxHeads || f > kMaxFeatures) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Heads heads{};
  int total = 0;
  for (int h = 0; h < count; ++h) {
    heads.weight[h] = static_cast<const float*>(weights[h]);
    heads.bias[h] = static_cast<const float*>(biases[h]);
    heads.out[h] = static_cast<float*>(outs[h]);
    heads.classes[h] = classes[h];
    total += classes[h];
  }
  heads.count = count;
  const dim3 grid((total + kClassesPerBlock - 1) / kClassesPerBlock, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    consensus_heads_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), heads, n, f);
  } else {
    consensus_heads_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                            heads, n, f);
  }
  return last_launch_error();
}

int consensus_heads_max_features() { return kMaxFeatures; }

int consensus_heads_max_heads() { return kMaxHeads; }

const char* consensus_heads_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
