// PE block: [x | PE] @ W^T + b, then GroupNorm, in one pass.
//
// Replaces attention_based_tbn_tpu/ops/pallas_kernels.py:pe_block_pallas
// (the Pallas kernel at :65, pallas_call at :122). Same contract:
//   x (B, S, C_in) fp32 or bf16; the 1x1 conv over [x | PE] with W
//   (C_out, C_in + D) and bias (C_out,); GroupNorm over (S x C_out/G) per
//   sample and group with single-pass statistics, variance clamped at 0,
//   affine (C_out,) scale and bias; output in x's type. Every parameter
//   comes in x's type: at bf16 the model rounds them once, as the JAX call
//   site does (attention.py:115-119); all arithmetic is fp32.
//
// Bound: at the flagship shape (B = 25 b, S = 13, 1024 -> 1024) the work is
// a 2 B S C_in C_out-operation product over ~17 MB (fp32) or ~8.5 MB (bf16)
// of operands, so the card is compute-bound on it.
//
// bf16 route: pe_block_mma_kernel, one wgmma GEMM x (B S, C_in) @ W_x^T
// with the GroupNorm in its epilogue. As the TPU wrapper does
// (pallas_kernels.py:82-90), [x | PE] @ W + b splits into x @ W_x + (PE @
// W_pe + b); the second term is an (S, C_out) fp32 bias that does not
// depend on the batch, computed outside the kernel from the rounded table
// and weight (ops/kernels.pe_block_split), and W_x comes as its own
// contiguous (C_out, C_in) tensor: W's rows are (C_in + D) * 2 = 2068 bytes
// apart, no multiple of 16, so cp.async could not read them. A block of
// one or two warpgroups owns 64 or 128 rows x 64 output channels. The rows
// hold whole samples (4 or 9 at S = 13: 52 of 64 or 117 of 128 rows; the
// rest are zero-filled by cp.async's src-size 0 and never read from x), so
// every GroupNorm group (S rows x 16 channels of one sample) lies in one
// block. One warpgroup where two would leave fewer than two blocks per SM:
// a b=1 request (25 samples) makes 7 x 16 = 112 blocks for the 132 SMs;
// b=10 takes two (28 x 16 = 448 blocks), which read each W slice half as
// often. The mainloop is mha.cu's: a 4-stage cp.async ring of 64-deep
// K slices in the 128-byte-swizzled layout of wgmma.cuh, fp32 accumulators
// in registers. The epilogue stores accumulator + PE bias to shared memory
// (reusing the ring), takes each (sample, group)'s sum and sum of squares
// there, one warp per pair (the accumulator layout spreads a sample's rows
// over the warps, so the reduction goes through shared memory), and writes
// ((h - mean) * rsqrt(var + eps)) * scale + bias as bf16 in 16-byte
// stores: the pre-normalization activations never reach device memory.
//
// fp32 route (the parity route): pe_block_kernel, the fp32 cores. A block
// owns kRows whole samples and kTileC output channels, so the
// normalization happens in registers with one 4-lane shuffle reduction.
// Each thread keeps S x 4 accumulators; [x | PE] and W stream through
// shared memory in kTileK-deep slices, read as float4. The D PE columns
// follow in a slice loop of their own (one loop whose loads branch per
// element between x and the table ran 26-60% slower on an H100).

#include "common.cuh"
#include "wgmma.cuh"

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
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, int ldw, int c0,
                                              int k0, int k_end, float (&ws)[kTileK][kPadC]) {
  for (int i = threadIdx.x; i < kTileC * kTileK; i += kThreads) {
    const int kk = i % kTileK;
    const int cc = i / kTileK;
    const int k = k0 + kk;
    ws[kk][cc] = (k < k_end) ? w[(size_t)(c0 + cc) * ldw + k] : 0.f;
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

__global__ void __launch_bounds__(kThreads) pe_block_kernel(
    const float* __restrict__ x, const float* __restrict__ pe, int pe_ss, int pe_sd,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out, int B, int S, int c_in, int d, int c_out, int group_lanes,
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
      if (bb < B && s < S && k < c_in) v = x[((size_t)bb * S + s) * c_in + k];
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
      xs[rr][s][kk] = (s < S && k < d) ? pe[s * pe_ss + k * pe_sd] : 0.f;
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
        const float h = acc[s][j] + (bias[c + j]);
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
    g[j] = gamma[c + j] * inv;
    be[j] = beta[c + j];
  }
#pragma unroll
  for (int s = 0; s < kMaxS; ++s) {
    if (s < S) {
      float* dst = out + ((size_t)b * S + s) * c_out + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = (acc[s][j] - mean) * g[j] + be[j];
    }
  }
}

int launch_fp32(const float* x, const float* pe, int pe_ss, int pe_sd, const float* w,
                const float* bias, const float* gamma, const float* beta, float* out, int B,
                int S, int c_in, int d, int c_out, int num_groups, float eps,
                cudaStream_t stream) {
  if (S < 1 || S > kMaxS || c_out % kTileC) return static_cast<int>(cudaErrorInvalidValue);
  const int group_lanes = c_out / num_groups / 4;
  const dim3 grid((B + kRows - 1) / kRows, c_out / kTileC);
  pe_block_kernel<<<grid, kThreads, 0, stream>>>(x, pe, pe_ss, pe_sd, w, bias, gamma,
                                                        beta, out, B, S, c_in, d, c_out,
                                                        group_lanes, eps);
  return last_launch_error();
}

// ------------------------------------------------------------- bf16 route

using bf16 = __nv_bfloat16;

constexpr int kMmaCols = 64;     // output channels per block
constexpr int kMmaK = 64;        // K per stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kWgRows = 64;      // rows of one warpgroup's product
constexpr int kBTileBytes = kMmaCols * wgmma::kRowBytes;  // 8 KB

// A block of WG warpgroups owns 64 WG rows (whole samples) x 64 channels.
template <int WG>
struct Tile {
  static constexpr int kRows = kWgRows * WG;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kATileBytes = kRows * wgmma::kRowBytes;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + the 1024-byte alignment
  static constexpr int kPadCols = kMmaCols + 4;               // the epilogue's fp32 rows
  static constexpr int kMaxPairs = kRows * (kMmaCols / 4);    // (sample, group), >= 4 channels
  static_assert((kRows * kPadCols + 2 * kMaxPairs) * 4 <= kStages * kStageBytes,
                "the epilogue reuses the ring");
};

// K slice k0 of the block's x rows (zero past `valid`) and W_x rows.
template <int WG>
__device__ __forceinline__ void load_stage(const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int c_in, int m0,
                                           int valid, int n0, int k0, uint8_t* stage) {
  using L = Tile<WG>;
  const uint32_t a = smem_u32(stage);
  const uint32_t b = a + L::kATileBytes;
#pragma unroll
  for (int i = 0; i < L::kRows * 8 / L::kThreads; ++i) {
    const int idx = threadIdx.x + i * L::kThreads;
    const int row = idx / 8, chunk = idx % 8;
    const bool ok = row < valid;
    const bf16* src = ok ? x + (size_t)(m0 + row) * c_in + k0 + chunk * 8 : x;
    cp_async16(a + wgmma::swizzled_offset(row, chunk), src, ok);
  }
#pragma unroll
  for (int i = 0; i < kMmaCols * 8 / L::kThreads; ++i) {
    const int idx = threadIdx.x + i * L::kThreads;
    const int row = idx / 8, chunk = idx % 8;
    cp_async16(b + wgmma::swizzled_offset(row, chunk),
               w + (size_t)(n0 + row) * c_in + k0 + chunk * 8, true);
  }
}

// grid (row tiles of 64 WG / S samples, C_out / 64); rows = B * S.
template <int WG>
__global__ void __launch_bounds__(Tile<WG>::kThreads) pe_block_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ pe_bias,
    const bf16* __restrict__ gamma, const bf16* __restrict__ beta, bf16* __restrict__ out,
    int rows, int S, int c_in, int c_out, int cg, float eps) {
  using L = Tile<WG>;
  extern __shared__ uint8_t pe_smem_raw[];
  uint8_t* smem = wgmma::align_1024(pe_smem_raw);
  const int samples = L::kRows / S;
  const int tile_rows = samples * S;
  const int m0 = blockIdx.x * tile_rows;
  const int n0 = blockIdx.y * kMmaCols;
  const int valid = min(tile_rows, rows - m0);
  const int ktiles = c_in / kMmaK;
  const int t = threadIdx.x;
  const int wg = t / 128;  // this warpgroup's 64 rows of the tile

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_stage<WG>(x, w, c_in, m0, valid, n0, s * kMmaK, smem + s * L::kStageBytes);
    }
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
    if (next < ktiles) {
      load_stage<WG>(x, w, c_in, m0, valid, n0, next * kMmaK,
                     smem + (next % kStages) * L::kStageBytes);
    }
    cp_async_commit();

    const uint8_t* stage = smem + (kt % kStages) * L::kStageBytes;
    const uint8_t* a_tile = stage + wg * kWgRows * wgmma::kRowBytes;
    wgmma::fence_accumulators(acc);
    wgmma::fence();
#pragma unroll
    for (int step = 0; step < kMmaK / 16; ++step) {
      wgmma::mma_m64n64k16(acc, wgmma::swizzled_descriptor(a_tile, step),
                           wgmma::swizzled_descriptor(stage + L::kATileBytes, step));
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_accumulators(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read and every product retired: the ring is free

  // h = accumulator + PE bias (row r of the tile is sequence step r % S).
  float* tile = reinterpret_cast<float*>(smem);
  float* mean_s = tile + L::kRows * L::kPadCols;
  float* inv_s = mean_s + L::kMaxPairs;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = wg * kWgRows + wgmma::accumulator_row(i, t % 128);
    const int c = wgmma::accumulator_col(i, t % 128);
    if (r < tile_rows) {
      const float* pb = pe_bias + (r % S) * c_out + n0 + c;
      tile[r * L::kPadCols + c] = acc[i] + pb[0];
      tile[r * L::kPadCols + c + 1] = acc[i + 1] + pb[1];
    }
  }
  __syncthreads();

  // Statistics: one warp per (sample, group) pair, S x cg values each.
  const int groups = kMmaCols / cg;
  const int n = S * cg;
  const float inv_n = 1.f / static_cast<float>(n);
  const int lane = t % 32;
  for (int p = t / 32; p < samples * groups; p += L::kThreads / 32) {
    const int sample = p / groups, g = p % groups;
    float sum = 0.f, sq = 0.f;
    for (int e = lane; e < n; e += 32) {
      const float h = tile[(sample * S + e / cg) * L::kPadCols + g * cg + e % cg];
      sum += h;
      sq += h * h;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (lane == 0) {
      const float mean = sum * inv_n;
      mean_s[p] = mean;
      inv_s[p] = rsqrtf(fmaxf(sq * inv_n - mean * mean, 0.f) + eps);
    }
  }
  __syncthreads();

  // ((h - mean) * inv) * scale + bias, eight channels per 16-byte store.
  for (int idx = t; idx < valid * (kMmaCols / 8); idx += L::kThreads) {
    const int r = idx / (kMmaCols / 8);
    const int c0 = (idx % (kMmaCols / 8)) * 8;
    const int pair0 = (r / S) * groups;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j;
      const int p = pair0 + c / cg;
      const float normed =
          __fmul_rn(__fsub_rn(tile[r * L::kPadCols + c], mean_s[p]), inv_s[p]);
      v[j] = __float2bfloat16(__fadd_rn(__fmul_rn(normed, __bfloat162float(gamma[n0 + c])),
                                        __bfloat162float(beta[n0 + c])));
    }
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * c_out + n0 + c0) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The launch for (B, S, C_out): two warpgroups per block (128-row tiles,
// which read each W slice half as often) where the one-warpgroup grid
// would hold at least two blocks per SM, else one (64-row tiles, so a b=1
// request still spreads over the SMs). grid[0] row tiles, grid[1] channel
// tiles, grid[2] warpgroups.
int mma_plan(int device, int B, int S, int c_out, int* grid) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int one = (B + kWgRows / S - 1) / (kWgRows / S);
  const int wg = one * (c_out / kMmaCols) >= 2 * sms ? 2 : 1;
  const int samples = wg * kWgRows / S;
  grid[0] = (B + samples - 1) / samples;
  grid[1] = c_out / kMmaCols;
  grid[2] = wg;
  return 0;
}

template <int WG>
int launch_tiles(const int* plan, const bf16* x, const bf16* w, const float* pe_bias,
                 const bf16* gamma, const bf16* beta, bf16* out, int B, int S, int c_in,
                 int c_out, int cg, float eps, cudaStream_t stream) {
  using L = Tile<WG>;
  cudaError_t err = cudaFuncSetAttribute(pe_block_mma_kernel<WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pe_block_mma_kernel<WG><<<dim3(plan[0], plan[1]), L::kThreads, L::kSmem, stream>>>(
      x, w, pe_bias, gamma, beta, out, B * S, S, c_in, c_out, cg, eps);
  return last_launch_error();
}

int launch_bf16(int device, const bf16* x, const bf16* w, const float* pe_bias,
                const bf16* gamma, const bf16* beta, bf16* out, int B, int S, int c_in,
                int c_out, int num_groups, float eps, cudaStream_t stream) {
  const int cg = c_out / num_groups;
  if (S < 1 || S > kWgRows || c_in % kMmaK || c_out % kMmaCols || c_out % num_groups ||
      cg < 4 || kMmaCols % cg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int plan[3];
  const int err = mma_plan(device, B, S, c_out, plan);
  if (err) return err;
  if (plan[2] == 2)
    return launch_tiles<2>(plan, x, w, pe_bias, gamma, beta, out, B, S, c_in, c_out, cg, eps,
                           stream);
  return launch_tiles<1>(plan, x, w, pe_bias, gamma, beta, out, B, S, c_in, c_out, cg, eps,
                         stream);
}

}  // namespace

extern "C" {

// fp32 route: x, pe (read through its strides), w (C_out, C_in + D), bias,
// gamma, beta and out all fp32. Returns 0 or a cudaError_t code.
int pe_block_forward(int device, const void* x, const void* pe, int pe_ss, int pe_sd,
                     const void* w, const void* bias, const void* gamma, const void* beta,
                     void* out, int B, int S, int c_in, int d, int c_out, int num_groups,
                     float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_fp32(static_cast<const float*>(x), static_cast<const float*>(pe), pe_ss, pe_sd,
                     static_cast<const float*>(w), static_cast<const float*>(bias),
                     static_cast<const float*>(gamma), static_cast<const float*>(beta),
                     static_cast<float*>(out), B, S, c_in, d, c_out, num_groups, eps,
                     static_cast<cudaStream_t>(stream));
}

// bf16 route: x (B, S, C_in), w_x (C_out, C_in) contiguous, gamma, beta
// and out bf16; pe_bias (S, C_out) fp32 = PE @ W_pe^T + b. Returns 0 or a
// cudaError_t code.
int pe_block_forward_bf16(int device, const void* x, const void* w_x, const float* pe_bias,
                          const void* gamma, const void* beta, void* out, int B, int S,
                          int c_in, int c_out, int num_groups, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_bf16(device, static_cast<const bf16*>(x), static_cast<const bf16*>(w_x), pe_bias,
                     static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                     static_cast<bf16*>(out), B, S, c_in, c_out, num_groups, eps,
                     static_cast<cudaStream_t>(stream));
}

// The route's limits (dtype 0 fp32, 1 bf16): limits[0] the longest
// sequence, limits[1] the multiple C_out must be, limits[2] the multiple
// C_in must be. ops/kernels.PE_BLOCK_LIMITS states the same numbers, so a
// call is checked without a card; the smoke compares the two. Returns 0 or
// a cudaError_t code.
int pe_block_limits(int dtype, int* limits) {
  if (dtype != kFloat32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = dtype == kBFloat16;
  limits[0] = mma ? kWgRows : kMaxS;
  limits[1] = mma ? kMmaCols : kTileC;
  limits[2] = mma ? kMmaK : 1;
  return 0;
}

// The bf16 route's launch for (B, S, C_out): grid[0] row tiles, grid[1]
// channel tiles, grid[2] warpgroups per block. Returns 0 or a cudaError_t.
int pe_block_bf16_grid(int device, int B, int S, int c_out, int* grid) {
  return mma_plan(device, B, S, c_out, grid);
}

const char* pe_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
