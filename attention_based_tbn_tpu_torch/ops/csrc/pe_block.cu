// PE block: [x | PE] @ W^T + b, then GroupNorm, in one pass.
//
// Replaces attention_based_tbn_tpu/ops/pallas_kernels.py:pe_block_pallas
// (the Pallas kernel at :65, pallas_call at :122). Same contract:
//   x (B, S, C_in) fp32 or bf16; PE table (S, D), read through its
//   strides; W (C_out, C_in + D) and bias (C_out,), the 1x1 conv over
//   [x | PE]; GroupNorm over (S x C_out/G) per sample and group with
//   single-pass statistics, variance clamped at 0, affine (C_out,) scale
//   and bias; output in x's type. The table and every parameter come in
//   x's type: at bf16 the model rounds them once, as the JAX call site does
//   (attention.py:115-119), and the kernel widens each to fp32 as it reads
//   it (the Pallas kernel's .astype(f32), pallas_kernels.py:85-90 and
//   :122-124); all arithmetic is fp32.
//
// Bound: at the flagship shape (B = 25 b, S = 13, 1024 -> 1024) the work is
// a 2 B S C_in C_out-operation product over ~17 MB of operands, so the card
// is compute-bound on it. This first design runs the product on the fp32
// cores (no tensor cores yet): a block owns kRows whole samples (every row
// a GroupNorm group needs) and kTileC output channels, so the normalization
// happens in registers with one 4-lane shuffle reduction and the
// pre-normalization activations never reach device memory. Each thread
// keeps S x 4 accumulators; [x | PE] and W stream through shared memory in
// kTileK-deep slices, read as float4 so that shared-memory loads stay below
// the FMA rate. The D PE columns follow in a slice loop of their own, so
// their products stay in fp32 like x's (the TPU wrapper folded them into an
// (S, C_out) bias outside its kernel instead). Keep the two loops apart: one
// loop whose loads branch per element between x and the table ran 26-60%
// slower on an H100.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileC = 64;                  // output channels per block
constexpr int kQuads = kTileC / 4;          // threads per sample row
constexpr int kRows = kThreads / kQuads;    // samples per block
constexpr int kMaxS = 16;                   // longest sequence supported
constexpr int kTileK = 32;                  // input channels per slice
constexpr int kPadK = kTileK + 4;           // keeps float4 rows 16-byte aligned
constexpr int kPadC = kTileC + 4;

// W's columns [k0, k0 + kTileK) of output channels [c0, c0 + kTileC) into
// shared memory, k-major; zero past column k_end.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w, int ldw, int c0,
                                              int k0, int k_end, float (&ws)[kTileK][kPadC]) {
  for (int i = threadIdx.x; i < kTileC * kTileK; i += kThreads) {
    const int kk = i % kTileK;
    const int cc = i / kTileK;
    const int k = k0 + kk;
    ws[kk][cc] = (k < k_end) ? to_float(w[(size_t)(c0 + cc) * ldw + k]) : 0.f;
  }
}

// acc[s][j] += xs_r[s][:] . ws[:][4q + j] over one kTileK-deep slice.
__device__ __forceinline__ void accumulate(const float (&xs_r)[kMaxS][kPadK],
                                           const float (&ws)[kTileK][kPadC], int q, int S,
                                           float (&acc)[kMaxS][4]) {
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 4) {
    float4 wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wv[j] = *reinterpret_cast<const float4*>(&ws[kk + j][4 * q]);
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s < S) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs_r[s][kk]);
        acc[s][0] += xv.x * wv[0].x + xv.y * wv[1].x + xv.z * wv[2].x + xv.w * wv[3].x;
        acc[s][1] += xv.x * wv[0].y + xv.y * wv[1].y + xv.z * wv[2].y + xv.w * wv[3].y;
        acc[s][2] += xv.x * wv[0].z + xv.y * wv[1].z + xv.z * wv[2].z + xv.w * wv[3].z;
        acc[s][3] += xv.x * wv[0].w + xv.y * wv[1].w + xv.z * wv[2].w + xv.w * wv[3].w;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pe_block_kernel(
    const T* __restrict__ x, const T* __restrict__ pe, int pe_ss, int pe_sd,
    const T* __restrict__ w, const T* __restrict__ bias,
    const T* __restrict__ gamma, const T* __restrict__ beta,
    T* __restrict__ out, int B, int S, int c_in, int d, int c_out, int group_lanes,
    float eps) {
  __shared__ __align__(16) float xs[kRows][kMaxS][kPadK];
  __shared__ __align__(16) float ws[kTileK][kPadC];

  const int tid = threadIdx.x;
  const int q = tid % kQuads;  // channel quad inside the tile
  const int r = tid / kQuads;  // sample inside the block
  const int b0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kTileC;
  const int b = b0 + r;

  float acc[kMaxS][4];
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[s][j] = 0.f;
  }

  const int ldw = c_in + d;  // W's row: x's columns, then the PE's
  for (int k0 = 0; k0 < c_in; k0 += kTileK) {
    for (int i = tid; i < kRows * kMaxS * kTileK; i += kThreads) {
      const int kk = i % kTileK;
      const int s = (i / kTileK) % kMaxS;
      const int rr = i / (kTileK * kMaxS);
      const int bb = b0 + rr;
      const int k = k0 + kk;
      float v = 0.f;
      if (bb < B && s < S && k < c_in) v = to_float(x[((size_t)bb * S + s) * c_in + k]);
      xs[rr][s][kk] = v;
    }
    stage_weights(w, ldw, c0, k0, c_in, ws);
    __syncthreads();
    accumulate(xs[r], ws, q, S, acc);
    __syncthreads();
  }
  // The PE columns: the same (S, D) table for every sample, after x's.
  for (int k0 = 0; k0 < d; k0 += kTileK) {
    for (int i = tid; i < kRows * kMaxS * kTileK; i += kThreads) {
      const int kk = i % kTileK;
      const int s = (i / kTileK) % kMaxS;
      const int rr = i / (kTileK * kMaxS);
      const int k = k0 + kk;
      xs[rr][s][kk] = (s < S && k < d) ? to_float(pe[s * pe_ss + k * pe_sd]) : 0.f;
    }
    stage_weights(w + c_in, ldw, c0, k0, d, ws);
    __syncthreads();
    accumulate(xs[r], ws, q, S, acc);
    __syncthreads();
  }

  // Epilogue: conv bias, group statistics over S rows x group channels. The
  // lanes of one group are group_lanes adjacent quads of the same sample.
  const int c = c0 + 4 * q;
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    if (s < S) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = acc[s][j] + to_float(bias[c + j]);
        acc[s][j] = h;
        sum += h;
        sq += h * h;
      }
    }
  }
  for (int off = 1; off < group_lanes; off <<= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float n = static_cast<float>(S * 4 * group_lanes);
  const float mean = sum / n;
  const float var = fmaxf(sq / n - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  if (b >= B) return;
  float g[4], be[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    g[j] = to_float(gamma[c + j]) * inv;
    be[j] = to_float(beta[c + j]);
  }
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    if (s < S) {
      T* dst = out + ((size_t)b * S + s) * c_out + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = from_float<T>((acc[s][j] - mean) * g[j] + be[j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* pe, int pe_ss, int pe_sd, const void* w,
           const void* bias, const void* gamma, const void* beta, void* out, int B,
           int S, int c_in, int d, int c_out, int num_groups, float eps,
           cudaStream_t stream) {
  const int group_lanes = c_out / num_groups / 4;
  const dim3 grid((B + kRows - 1) / kRows, c_out / kTileC);
  pe_block_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pe), pe_ss, pe_sd,
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<const T*>(gamma),
      static_cast<const T*>(beta),
      static_cast<T*>(out), B, S, c_in, d, c_out, group_lanes, eps);
  return last_launch_error();
}

}  // namespace

extern "C" {

// Shape limits the wrapper checks before calling (ops/kernels.py).
int pe_block_max_seq() { return kMaxS; }
int pe_block_channel_tile() { return kTileC; }

// x, pe, w, bias, gamma, beta and out all of type dtype.
int pe_block_forward(int dtype, int device, const void* x, const void* pe, int pe_ss,
                     int pe_sd, const void* w, const void* bias, const void* gamma,
                     const void* beta, void* out, int B, int S, int c_in, int d,
                     int c_out, int num_groups, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, pe, pe_ss, pe_sd, w, bias, gamma, beta, out, B, S, c_in, d,
                         c_out, num_groups, eps, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, pe, pe_ss, pe_sd, w, bias, gamma, beta, out, B, S,
                                 c_in, d, c_out, num_groups, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pe_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
