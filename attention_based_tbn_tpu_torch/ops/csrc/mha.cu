// Single-query multi-head attention with key == value.
//
// Replaces attention_based_tbn_tpu/ops/pallas_kernels.py:mha_pallas (the
// Pallas kernel at :164-258, pallas_call at :232). Same contract:
//   query (B, E), keyval (B, S, E) in fp32 or bf16; torch-layout weights
//   in_proj (3E, E) = [Wq; Wk; Wv], in_proj_bias (3E), out_proj (E, E) and
//   its bias, in the activations' type (at bf16 the model rounds its fp32
//   parameters once, as the JAX call site does: attention.py:181-186). All
//   arithmetic on them is fp32: products of bf16 operands are exact and
//   accumulate in fp32; q, k and v stay fp32 with their bias added in fp32;
//   per head the logits are scaled after the dot product, softmax over S;
//   weighted sum of v; output projection; outputs (result and head-mean
//   weights) in the activations' type.
//
// Bound: the k/v projection over the B*S rows is ~93% of the operations
// (2 * B*S * E * 2E); at the flagship shape (B = 250, S = 13, E = 1024) it
// is 13.6 GFLOP, ~14 us at the bf16 tensor-core peak, and the fp32 k/v
// scratch it writes and the attention reads back (26.6 MB each way) is ~16
// us of HBM traffic, the larger term. The work is three launches:
//   1. q  = query  @ Wq^T + bq and kv = keyval @ [Wk; Wv]^T + [bk; bv], one
//      grid walking both problems' tiles (fp32 scratch);
//   2. per sample: logits, softmax, weighted sum of v, head-mean weights
//      (attend_kernel, one block per sample, everything in shared memory);
//   3. out = attended @ Wo^T + bo (output type).
// bf16 route: 1 and 3 are gemm_kernel, on the bf16 tensor cores through
// wgmma (wgmma.cuh). A block of two warpgroups owns 128 rows x 64 columns
// of Y; a 4-stage shared-memory ring of 64-deep K slices, filled by
// cp.async with the 128-byte swizzle, keeps three slices in flight while
// the tensor cores run the fourth; fp32 accumulators stay in registers; the
// epilogue adds the fp32 bias and stores. 64-column tiles keep the grid at
// 112 blocks for the 325 k/v rows of a b=1 request (128-column tiles would
// leave half of the 132 SMs idle) and at 864 for the 3,250 of b=10. The
// attention's output is fp32; the output projection takes it as the sum of
// two bf16 halves (hi = bf16(a), lo = bf16(a - hi)), a K = 2E product whose
// two halves meet the same Wo, so it keeps ~16 of fp32's 24 mantissa bits
// instead of adding a bf16 rounding the contract does not have.
// fp32 route (the parity route): linear_kernel, a 64x64-tile fp32-core GEMM
// in which each thread owns a 4x4 output patch and reads float4 operands
// from shared memory.

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kLinThreads = 256;

// Y[M, N] = X[M, K] @ W[N, K]^T + bias[N]; X rows ldx apart, W rows ldw.
__global__ void __launch_bounds__(kLinThreads) linear_kernel(
    const float* __restrict__ X, int ldx, const float* __restrict__ W, int ldw,
    const float* __restrict__ bias, float* __restrict__ Y, int M, int N, int K) {
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
      xs[kk][mm] = (m < M && k < K) ? X[(size_t)m * ldx + k] : 0.f;
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
      if (n < N) Y[(size_t)m * N + n] = acc[i][j] + bias[n];
    }
  }
}

constexpr int kAttThreads = 256;
constexpr int kMaxHeads = 16;
constexpr int kMaxSeq = 64;

// The attended values of sample b, channel e: fp32 rows (B, E), or the
// bf16 pair hi | lo of rows (B, 2E) that the bf16 output projection takes.
__device__ __forceinline__ void store_attended(float* att, int E, int b, int e, float v) {
  att[(size_t)b * E + e] = v;
}
__device__ __forceinline__ void store_attended(__nv_bfloat16* att, int E, int b, int e,
                                               float v) {
  const __nv_bfloat16 hi = __float2bfloat16(v);
  att[(size_t)b * 2 * E + e] = hi;
  att[(size_t)b * 2 * E + E + e] = __float2bfloat16(v - __bfloat162float(hi));
}

// One block per sample. q (B, E) and kv (B, S, 2E: k then v) are the fp32
// projections; writes the attended values and the head-mean softmax
// weights (B, S) in the output type.
template <typename T, typename TAtt>
__global__ void __launch_bounds__(kAttThreads) attend_kernel(
    const float* __restrict__ q, const float* __restrict__ kv,
    TAtt* __restrict__ attended, T* __restrict__ wts, int S, int E, int H,
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
    store_attended(attended, E, b, e, acc);
  }
}

int linear(const float* X, int ldx, const float* W, int ldw, const float* bias, float* Y,
           int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  linear_kernel<<<grid, kLinThreads, 0, stream>>>(X, ldx, W, ldw, bias, Y, M, N, K);
  return last_launch_error();
}

int launch_fp32(const float* qin, const float* kvin, const float* in_w, const float* in_b,
                const float* out_w, const float* out_b, float* q_buf, float* kv_buf,
                float* att_buf, float* out, float* wts, int B, int S, int E, int H,
                cudaStream_t stream) {
  int err = linear(qin, E, in_w, E, in_b, q_buf, B, E, E, stream);
  if (err) return err;
  err = linear(kvin, E, in_w + (size_t)E * E, E, in_b + E, kv_buf, B * S, 2 * E, E, stream);
  if (err) return err;
  attend_kernel<float, float><<<B, kAttThreads, 0, stream>>>(
      q_buf, kv_buf, att_buf, wts, S, E, H, 1.f / std::sqrt(static_cast<float>(E / H)));
  err = last_launch_error();
  if (err) return err;
  return linear(att_buf, E, out_w, E, out_b, out, B, E, E, stream);
}

// ------------------------------------------------------------- bf16 route

using bf16 = __nv_bfloat16;

constexpr int kGemmBM = 128;                   // rows of Y per block: two warpgroups
constexpr int kGemmBN = 64;                    // columns of Y per block
constexpr int kGemmBK = 64;                    // K per stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kGemmThreads = 256;
constexpr int kATileBytes = kGemmBM * wgmma::kRowBytes;  // 16 KB
constexpr int kBTileBytes = kGemmBN * wgmma::kRowBytes;  // 8 KB
constexpr int kStageBytes = kATileBytes + kBTileBytes;
constexpr int kGemmSmem = kStages * kStageBytes + 1024;  // + the 1024-byte alignment

// Y[m, n] = sum_k X[m, k] W[n, k % kw] + bias[n] over k < K: X (M, K) bf16
// rows ldx apart; W (N, kw) bf16 rows ldw apart (kw = K, or K / 2 for the
// hi | lo output projection); bias (N,) bf16; Y (M, N) rows ldy apart.
struct Problem {
  const bf16* x;
  const bf16* w;
  const bf16* bias;
  void* y;
  int ldx, ldw, kw, ldy, m, n, k;
  int tiles_n, first_tile;
};

struct Problems {
  Problem p[2];
  int count;
};

// K slice kt of the block's X rows and W rows into one stage, swizzled;
// rows of X past M are zero-filled.
__device__ __forceinline__ void load_stage(const Problem& p, int m0, int n0, int kt,
                                           uint8_t* stage) {
  const int k0 = kt * kGemmBK;
  const int kw0 = k0 % p.kw;
  const uint32_t a_base = wgmma::smem_address(stage);
  const uint32_t b_base = a_base + kATileBytes;
#pragma unroll
  for (int i = 0; i < kGemmBM * 8 / kGemmThreads; ++i) {
    const int idx = threadIdx.x + i * kGemmThreads;
    const int row = idx / 8, chunk = idx % 8;
    const int m = m0 + row;
    const bf16* src = m < p.m ? p.x + (size_t)m * p.ldx + k0 + chunk * 8 : p.x;
    cp_async16(a_base + wgmma::swizzled_offset(row, chunk), src, m < p.m);
  }
#pragma unroll
  for (int i = 0; i < kGemmBN * 8 / kGemmThreads; ++i) {
    const int idx = threadIdx.x + i * kGemmThreads;
    const int row = idx / 8, chunk = idx % 8;
    const bf16* src = p.w + (size_t)(n0 + row) * p.ldw + kw0 + chunk * 8;
    cp_async16(b_base + wgmma::swizzled_offset(row, chunk), src, true);
  }
}

__device__ __forceinline__ void store_pair(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* y, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}

// One 128 x 64 tile of Y per block; the blocks of problem 1 follow those
// of problem 0 (the q and k/v projections in one launch).
template <typename TOut>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(const Problems problems) {
  extern __shared__ uint8_t gemm_smem_raw[];
  uint8_t* smem = wgmma::align_1024(gemm_smem_raw);
  const int tile = blockIdx.x;
  const Problem p = (problems.count > 1 && tile >= problems.p[1].first_tile) ? problems.p[1]
                                                                             : problems.p[0];
  const int m0 = ((tile - p.first_tile) / p.tiles_n) * kGemmBM;
  const int n0 = ((tile - p.first_tile) % p.tiles_n) * kGemmBN;
  const int ktiles = p.k / kGemmBK;
  const int wg = threadIdx.x / 128;  // this warpgroup's 64 rows of the tile
  const int t = threadIdx.x % 128;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(p, m0, n0, s, smem + s * kStageBytes);
    cp_async_commit();
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice kt landed
    wgmma::proxy_fence();
    __syncthreads();  // everyone's copies landed; slice kt - 1's products retired
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(p, m0, n0, next, smem + (next % kStages) * kStageBytes);
    cp_async_commit();

    const uint8_t* a_tile = smem + (kt % kStages) * kStageBytes + wg * 64 * wgmma::kRowBytes;
    const uint8_t* b_tile = smem + (kt % kStages) * kStageBytes + kATileBytes;
    wgmma::fence_accumulators(acc);
    wgmma::fence();
#pragma unroll
    for (int step = 0; step < kGemmBK / 16; ++step) {
      wgmma::mma_m64n64k16(acc, wgmma::swizzled_descriptor(a_tile, step),
                           wgmma::swizzled_descriptor(b_tile, step));
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_accumulators(acc);
  }

  TOut* y = static_cast<TOut*>(p.y);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int m = m0 + wg * 64 + wgmma::accumulator_row(i, t);
    const int n = n0 + wgmma::accumulator_col(i, t);
    if (m < p.m) {
      store_pair(y + (size_t)m * p.ldy + n, acc[i] + __bfloat162float(p.bias[n]),
                 acc[i + 1] + __bfloat162float(p.bias[n + 1]));
    }
  }
}

Problem make_problem(const bf16* x, int ldx, const bf16* w, int ldw, int kw,
                     const bf16* bias, void* y, int ldy, int m, int n, int k,
                     int first_tile) {
  return Problem{x, w, bias, y, ldx, ldw, kw, ldy, m, n, k, n / kGemmBN, first_tile};
}

int tiles(const Problem& p) { return ((p.m + kGemmBM - 1) / kGemmBM) * p.tiles_n; }

template <typename TOut>
int gemm(const Problems& problems, cudaStream_t stream) {
  const Problem& last = problems.p[problems.count - 1];
  const int blocks = last.first_tile + tiles(last);
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<TOut>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<TOut><<<blocks, kGemmThreads, kGemmSmem, stream>>>(problems);
  return last_launch_error();
}

int launch_bf16(const bf16* qin, const bf16* kvin, const bf16* in_w, const bf16* in_b,
                const bf16* out_w, const bf16* out_b, float* q_buf, float* kv_buf,
                bf16* att_buf, bf16* out, bf16* wts, int B, int S, int E, int H,
                cudaStream_t stream) {
  Problems qkv{};
  qkv.p[0] = make_problem(qin, E, in_w, E, E, in_b, q_buf, E, B, E, E, 0);
  qkv.p[1] = make_problem(kvin, E, in_w + (size_t)E * E, E, E, in_b + E, kv_buf, 2 * E,
                          B * S, 2 * E, E, tiles(qkv.p[0]));
  qkv.count = 2;
  int err = gemm<float>(qkv, stream);
  if (err) return err;
  attend_kernel<bf16, bf16><<<B, kAttThreads, 0, stream>>>(
      q_buf, kv_buf, att_buf, wts, S, E, H, 1.f / std::sqrt(static_cast<float>(E / H)));
  err = last_launch_error();
  if (err) return err;
  Problems proj{};
  proj.p[0] = make_problem(att_buf, 2 * E, out_w, E, E, out_b, out, E, B, E, 2 * E, 0);
  proj.count = 1;
  return gemm<bf16>(proj, stream);
}

// The descriptor check of chip_smoke.py --quick: c (64, 64) fp32 = a @ b^T
// for a and b (64, K) bf16 row-major, one warpgroup. swizzle 0: K = 16 in
// the interleaved layout (8x8 core matrices of 128 contiguous bytes, the two
// along K 128 bytes apart, 8-row groups 256 apart), one m64n64k16. swizzle
// 1: K = 64 in the kernels' 128-byte-swizzled tile, four k16 steps.
__global__ void __launch_bounds__(128) wgmma_probe_kernel(const bf16* a, const bf16* b,
                                                          float* c, int swizzle) {
  __shared__ __align__(1024) uint8_t raw[2 * 8192 + 1024];
  uint8_t* sa = wgmma::align_1024(raw);
  uint8_t* sb = sa + 8192;
  const int K = swizzle ? 64 : 16;
  for (int i = threadIdx.x; i < 64 * K; i += 128) {
    const int r = i / K, k = i % K;
    const uint32_t off = swizzle ? wgmma::swizzled_offset(r, k / 8) + (k % 8) * 2
                                 : ((r / 8) * 2 + k / 8) * 128 + (r % 8) * 16 + (k % 8) * 2;
    *reinterpret_cast<bf16*>(sa + off) = a[i];
    *reinterpret_cast<bf16*>(sb + off) = b[i];
  }
  wgmma::proxy_fence();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma::fence_accumulators(acc);
  wgmma::fence();
  if (swizzle) {
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      wgmma::mma_m64n64k16(acc, wgmma::swizzled_descriptor(sa, step),
                           wgmma::swizzled_descriptor(sb, step));
    }
  } else {
    wgmma::mma_m64n64k16(acc, wgmma::descriptor(sa, 128, 256, wgmma::kInterleave),
                         wgmma::descriptor(sb, 128, 256, wgmma::kInterleave));
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_accumulators(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    c[wgmma::accumulator_row(i, threadIdx.x) * 64 + wgmma::accumulator_col(i, threadIdx.x)] =
        acc[i];
  }
}

}  // namespace

extern "C" {

// Shape limits the wrapper checks before calling (ops/kernels.py).
int mha_max_heads() { return kMaxHeads; }
int mha_max_seq() { return kMaxSeq; }
// The bf16 route tiles E by this (K slices and 64-column tiles).
int mha_bf16_tile() { return kGemmBK; }

// dtype 0: every pointer fp32, att_buf (B, E). dtype 1: activations,
// parameters, out and wts bf16, q_buf and kv_buf fp32, att_buf (B, 2E) bf16.
// Returns 0 or a cudaError_t code.
int mha_forward(int dtype, int device, const void* query, const void* keyval,
                const void* in_w, const void* in_b, const void* out_w, const void* out_b,
                float* q_buf, float* kv_buf, void* att_buf, void* out, void* wts, int B,
                int S, int E, int H, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_fp32(static_cast<const float*>(query), static_cast<const float*>(keyval),
                       static_cast<const float*>(in_w), static_cast<const float*>(in_b),
                       static_cast<const float*>(out_w), static_cast<const float*>(out_b),
                       q_buf, kv_buf, static_cast<float*>(att_buf), static_cast<float*>(out),
                       static_cast<float*>(wts), B, S, E, H, st);
  }
  if (dtype == kBFloat16) {
    return launch_bf16(static_cast<const bf16*>(query), static_cast<const bf16*>(keyval),
                       static_cast<const bf16*>(in_w), static_cast<const bf16*>(in_b),
                       static_cast<const bf16*>(out_w), static_cast<const bf16*>(out_b),
                       q_buf, kv_buf, static_cast<bf16*>(att_buf), static_cast<bf16*>(out),
                       static_cast<bf16*>(wts), B, S, E, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// c (64, 64) fp32 = a @ b^T, a and b (64, 16) bf16 (swizzle 0) or (64, 64)
// (swizzle 1), through one warpgroup's wgmma. Returns 0 or a cudaError_t.
int mha_wgmma_probe(int swizzle, int device, const void* a, const void* b, void* c,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(c),
      swizzle);
  return last_launch_error();
}

const char* mha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
