// Single-query multi-head attention with key == value.
//
// Replaces attention_based_tbn_tpu/ops/pallas_kernels.py:mha_pallas (the
// Pallas kernel at :164, pallas_call at :232). Same contract:
//   query (B, E), keyval (B, S, E) in fp32 or bf16; torch-layout weights
//   in_proj (3E, E) = [Wq; Wk; Wv], in_proj_bias (3E), out_proj (E, E) and
//   its bias, all fp32; per head: scaled dot product, softmax over S,
//   weighted sum of v; output projection; head-averaged weights (B, S).
//   fp32 accumulation throughout; outputs in the query's type.
//
// Bound: the k/v projection over the B*S rows is ~93% of the operations
// (2 * B*S * E * 2E), the weights are 16 MB of fp32, so at the flagship
// shape the card is compute-bound. The TPU kernel kept a whole batch tile
// in VMEM; here the work is four launches on one stream:
//   1. q  = query  @ Wq^T + bq             (linear_kernel, fp32 scratch)
//   2. kv = keyval @ [Wk; Wv]^T + [bk; bv] (linear_kernel, fp32 scratch)
//   3. per sample: logits, softmax, weighted sum of v, head-mean weights
//      (attend_kernel, one block per sample, everything in shared memory)
//   4. out = attended @ Wo^T + bo          (linear_kernel, output type)
// linear_kernel is a plain 64x64-tile fp32-core GEMM (no tensor cores yet):
// each thread owns a 4x4 output patch and reads float4 operands from shared
// memory, so the loop is bound by FMAs and not by shared-memory loads.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kLinThreads = 256;

// Y[M, N] = X[M, K] @ W[N, K]^T + bias[N]; X rows ldx apart, W rows ldw.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kLinThreads) linear_kernel(
    const TIn* __restrict__ X, int ldx, const float* __restrict__ W, int ldw,
    const float* __restrict__ bias, TOut* __restrict__ Y, int M, int N, int K) {
  __shared__ __align__(16) float xs[kBK][kBM + 4];
  __shared__ __align__(16) float ws[kBK][kBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column quad
  const int ty = tid / 16;  // row quad
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kLinThreads) {
      const int kk = i % kBK;
      const int mm = i / kBK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = (m < M && k < K) ? to_float(X[(size_t)m * ldx + k]) : 0.f;
    }
    for (int i = tid; i < kBN * kBK; i += kLinThreads) {
      const int kk = i % kBK;
      const int nn = i / kBK;
      const int n = n0 + nn, k = k0 + kk;
      ws[kk][nn] = (n < N && k < K) ? W[(size_t)n * ldw + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * cv[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) Y[(size_t)m * N + n] = from_float<TOut>(acc[i][j] + bias[n]);
    }
  }
}

constexpr int kAttThreads = 256;
constexpr int kMaxHeads = 16;
constexpr int kMaxSeq = 64;

// One block per sample. q (B, E) and kv (B, S, 2E: k then v) are the fp32
// projections; writes the attended values (B, E) fp32 and the head-mean
// softmax weights (B, S) in the output type.
template <typename T>
__global__ void __launch_bounds__(kAttThreads) attend_kernel(
    const float* __restrict__ q, const float* __restrict__ kv,
    float* __restrict__ attended, T* __restrict__ wts, int S, int E, int H,
    float scale) {
  __shared__ float probs[kMaxHeads][kMaxSeq];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int hd = E / H;
  const float* qb = q + (size_t)b * E;
  const float* kvb = kv + (size_t)b * S * 2 * E;

  for (int p = warp; p < H * S; p += kAttThreads / 32) {
    const int h = p / S, s = p % S;
    const float* qp = qb + h * hd;
    const float* kp = kvb + (size_t)s * 2 * E + h * hd;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc += qp[d] * kp[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) probs[h][s] = acc * scale;
  }
  __syncthreads();

  if (tid < H) {
    float mx = -INFINITY;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, probs[tid][s]);
    float denom = 0.f;
    for (int s = 0; s < S; ++s) {
      const float e = expf(probs[tid][s] - mx);
      probs[tid][s] = e;
      denom += e;
    }
    const float inv = 1.f / denom;
    for (int s = 0; s < S; ++s) probs[tid][s] *= inv;
  }
  __syncthreads();

  if (tid < S) {
    float m = 0.f;
    for (int h = 0; h < H; ++h) m += probs[h][tid];
    wts[(size_t)b * S + tid] = from_float<T>(m / H);
  }
  for (int e = tid; e < E; e += kAttThreads) {
    const int h = e / hd;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += probs[h][s] * kvb[(size_t)s * 2 * E + E + e];
    attended[(size_t)b * E + e] = acc;
  }
}

template <typename TIn, typename TOut>
int linear(const TIn* X, int ldx, const float* W, int ldw, const float* bias, TOut* Y,
           int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  linear_kernel<TIn, TOut><<<grid, kLinThreads, 0, stream>>>(X, ldx, W, ldw, bias, Y, M, N, K);
  return last_launch_error();
}

template <typename T>
int launch(const void* query, const void* keyval, const float* in_w, const float* in_b,
           const float* out_w, const float* out_b, float* q_buf, float* kv_buf,
           float* att_buf, void* out, void* wts, int B, int S, int E, int H,
           cudaStream_t stream) {
  const T* qin = static_cast<const T*>(query);
  const T* kvin = static_cast<const T*>(keyval);
  int err = linear<T, float>(qin, E, in_w, E, in_b, q_buf, B, E, E, stream);
  if (err) return err;
  err = linear<T, float>(kvin, E, in_w + (size_t)E * E, E, in_b + E, kv_buf, B * S,
                         2 * E, E, stream);
  if (err) return err;
  attend_kernel<T><<<B, kAttThreads, 0, stream>>>(q_buf, kv_buf, att_buf,
                                                  static_cast<T*>(wts), S, E, H,
                                                  1.f / std::sqrt(static_cast<float>(E / H)));
  err = last_launch_error();
  if (err) return err;
  return linear<float, T>(att_buf, E, out_w, E, out_b, static_cast<T*>(out), B, E, E,
                          stream);
}

}  // namespace

extern "C" {

// Shape limits the wrapper checks before calling (ops/kernels.py).
int mha_max_heads() { return kMaxHeads; }
int mha_max_seq() { return kMaxSeq; }

int mha_forward(int dtype, int device, const void* query, const void* keyval,
                const float* in_w, const float* in_b, const float* out_w,
                const float* out_b, float* q_buf, float* kv_buf, float* att_buf,
                void* out, void* wts, int B, int S, int E, int H, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(query, keyval, in_w, in_b, out_w, out_b, q_buf, kv_buf, att_buf,
                         out, wts, B, S, E, H, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(query, keyval, in_w, in_b, out_w, out_b, q_buf, kv_buf,
                                 att_buf, out, wts, B, S, E, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
