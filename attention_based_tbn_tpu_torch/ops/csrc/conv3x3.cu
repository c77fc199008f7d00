// 3x3 / stride 1 / zero pad 1 convolution -> + float32 bias -> ReLU on NHWC
// input, in one pass: the fused-block probe's convolution.
//
// Replaces benchmarks/fused_block_probe.py:conv3x3_pallas (pallas_call at
// :76, kernel conv3x3_kernel at :27-69).
//
// Input: x (B, H, W, C_in) NHWC memory, fp32 or bf16. Weight: at fp32 the
// torch layout (C_out, C_in, 3, 3); at bf16 the implicit GEMM's B operand,
// (C_out rounded up to 64, K) K-major with k = (ky * 3 + kx) * C_in + c
// and zeros from 9 C_in up to K = 9 C_in rounded up to 64, and in the
// padding rows (ops/kernels.pack_conv3x3_weight). Bias: (C_out,) fp32.
// Output: (B, H, W, C_out) NHWC memory in x's type.
//
// Numerics as the Pallas kernel: products accumulate in fp32, the fp32
// bias is added to the sum, ReLU, and the result is rounded once to the
// output type.
//
// Bound: operations. 2 * 9 * C_in * C_out operations per output position
// against (C_in + C_out) * 2 bytes at bf16: at the probe's default (200 x
// 28 x 28 x 96 -> 128) 34.7 GFLOP over 70.5 MB, above the card's ridge.
//
// bf16 route (conv3x3_mma_kernel): an implicit GEMM on the bf16 tensor
// cores through wgmma (wgmma.cuh). M = the B H W output positions in NHWC
// order, so a tile may cross image rows and images: each row decodes its
// own (y, x). N = C_out in 64-wide wgmma tiles, two per block where C_out
// rounded up to 64 is a multiple of 128. K = 9 C_in in (ky, kx, c) order,
// 64 deep per stage. A block of two warpgroups owns 128 positions; the
// stage's A tile is 128 rows x 64 K, and each 16-byte chunk of a row (8
// channels of one tap: C_in is a multiple of 8) is one cp.async straight
// from x into the 128-byte-swizzled K-major layout, with src-size 0 where
// the tap falls outside the image (the conv's zero padding), past 9 C_in
// (K padding: zero on both operands, since 0 x NaN is NaN) or past the
// last position: no im2col buffer, no shifted copies. The mainloop is
// pe_block.cu's: a 3-stage cp.async ring, the products of one stage retired
// before its slot is refilled. The epilogue adds the fp32 bias, applies
// ReLU, rounds once to bf16 into a tile in shared memory (reusing the
// ring), and writes it in 16-byte stores, masked to C_out (a multiple of 8).
//
// fp32 route (conv3x3_kernel, the parity route): fp32 FMAs. A block of 256
// threads owns 64 positions x 64 output channels, each thread 4 x 4 in
// registers; for every tap and 16-channel slice the shifted input rows
// (zero outside the image) and the weights stage through shared memory.
//
// The TPU kernel's three column-shifted VMEM copies, its row padding to a
// multiple of 16 and its one image per grid step were Mosaic workarounds
// and have no counterpart here.
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// NaN-propagating ReLU, as torch's and jnp.maximum's.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// ------------------------------------------------------------- fp32 route

constexpr int kThreads = 256;
constexpr int kTileM = 64;            // output positions per block
constexpr int kTileN = 64;            // output channels per block
constexpr int kTileK = 16;            // input channels per slice
constexpr int kPadM = kTileM + 4;     // keeps float4 rows 16-byte aligned
constexpr int kPadN = kTileN + 4;
constexpr int kStagedRows = kTileM * kTileK / kThreads;  // positions each thread stages

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out, int positions, int h,
               int wd, int c_in, int c_out) {
  __shared__ __align__(16) float xs[kTileK][kPadM];  // [channel][position]
  __shared__ __align__(16) float ws[kTileK][kPadN];  // [channel][output channel]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const int kk = tid % kTileK;  // the channel this thread stages
  // the positions this thread stages: row tid / 16 + 16 i of the tile
  int pos[kStagedRows], py[kStagedRows], px[kStagedRows];
#pragma unroll
  for (int i = 0; i < kStagedRows; ++i) {
    pos[i] = m0 + tid / kTileK + i * (kThreads / kTileK);
    py[i] = (pos[i] / wd) % h;
    px[i] = pos[i] % wd;
  }
  const int q = tid % 16;  // output channels 4q .. 4q + 3 of the tile
  const int r = tid / 16;  // positions 4r .. 4r + 3 of the tile
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < c_in; c0 += kTileK) {
      const int c = c0 + kk;
#pragma unroll
      for (int i = 0; i < kStagedRows; ++i) {
        const int iy = py[i] + dy, ix = px[i] + dx;
        const bool ok = pos[i] < positions && c < c_in && iy >= 0 && iy < h && ix >= 0 &&
                        ix < wd;
        xs[kk][tid / kTileK + i * (kThreads / kTileK)] =
            ok ? x[(static_cast<int64_t>(pos[i]) + dy * wd + dx) * c_in + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTileN * kTileK / kThreads; ++i) {
        const int n = tid / kTileK + i * (kThreads / kTileK);
        ws[kk][n] = (n0 + n < c_out && c < c_in)
                        ? w[(static_cast<int64_t>(n0 + n) * c_in + c) * 9 + tap]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTileK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * r]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[k][4 * q]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * r + i;
    if (m >= positions) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * q + j;
      if (n < c_out) out[static_cast<int64_t>(m) * c_out + n] = relu(acc[i][j] + bias[n]);
    }
  }
}

int launch_fp32(const float* x, const float* w, const float* bias, float* out, int positions,
                int h, int wd, int c_in, int c_out, cudaStream_t stream) {
  const dim3 grid((positions + kTileM - 1) / kTileM, (c_out + kTileN - 1) / kTileN);
  conv3x3_kernel<<<grid, kThreads, 0, stream>>>(x, w, bias, out, positions, h, wd, c_in, c_out);
  return last_launch_error();
}

// ------------------------------------------------------------- bf16 route

namespace mma {

constexpr int kRows = 128;                 // output positions per block: two warpgroups
constexpr int kWgRows = 64;                // rows of one warpgroup's products
constexpr int kThreads = 256;
constexpr int kK = 64;                     // K per stage: one 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kChannelMultiple = 8;        // C_in and C_out: 16-byte chunks of bf16
constexpr int kATileBytes = kRows * wgmma::kRowBytes;  // 16 KB
constexpr int kARowsPerThread = kRows * 8 / kThreads;   // 8 chunks per row

// A block owns kRows positions x 64 NT output channels.
template <int NT>
struct Tile {
  static constexpr int kCols = 64 * NT;
  static constexpr int kStageBytes = kATileBytes + kCols * wgmma::kRowBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + the 1024-byte alignment
  static constexpr int kOutStride = kCols + 8;  // bf16 per staged output row: 16-byte rows
  static_assert(kRows * kOutStride * 2 <= kStages * kStageBytes, "the epilogue reuses the ring");
};

__host__ __device__ __forceinline__ int k_padded(int c_in) { return (9 * c_in + kK - 1) / kK * kK; }
__host__ __device__ __forceinline__ int cols_padded(int c_out) { return (c_out + 63) / 64 * 64; }

// Stage kt: the A tile (this thread's chunk of its kARowsPerThread rows,
// zero outside the image, past 9 C_in and past the last position) and the
// block's B rows.
template <int NT>
__device__ __forceinline__ void load_stage(const bf16* __restrict__ x,
                                           const bf16* __restrict__ packed, int k_pad,
                                           int n0, int kt, int c_in, int h, int wd,
                                           const int (&pos)[kARowsPerThread],
                                           const int (&py)[kARowsPerThread],
                                           const int (&px)[kARowsPerThread], int positions,
                                           uint8_t* stage) {
  const uint32_t a = smem_u32(stage);
  const uint32_t b = a + kATileBytes;
  const int chunk = threadIdx.x % 8;
  const int k0 = kt * kK + chunk * 8;  // one tap's 8 channels
  const int tap = k0 / c_in;
  const int c = k0 - tap * c_in;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const bool k_ok = tap < 9;
#pragma unroll
  for (int i = 0; i < kARowsPerThread; ++i) {
    const int row = threadIdx.x / 8 + i * (kThreads / 8);
    const int iy = py[i] + dy, ix = px[i] + dx;
    const bool ok = k_ok && pos[i] < positions && iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const bf16* src = ok ? x + (static_cast<int64_t>(pos[i]) + dy * wd + dx) * c_in + c : x;
    cp_async16(a + wgmma::swizzled_offset(row, chunk), src, ok);
  }
#pragma unroll
  for (int i = 0; i < Tile<NT>::kCols * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int row = idx / 8, ch = idx % 8;
    cp_async16(b + wgmma::swizzled_offset(row, ch),
               packed + static_cast<int64_t>(n0 + row) * k_pad + kt * kK + ch * 8, true);
  }
}

// grid (position tiles of 128, padded C_out / 64 NT).
template <int NT>
__global__ void __launch_bounds__(kThreads)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ packed,
                   const float* __restrict__ bias, bf16* __restrict__ out, int positions, int h,
                   int wd, int c_in, int c_out) {
  using L = Tile<NT>;
  extern __shared__ uint8_t conv3x3_smem_raw[];
  uint8_t* smem = wgmma::align_1024(conv3x3_smem_raw);
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * L::kCols;
  const int k_pad = k_padded(c_in);
  const int ktiles = k_pad / kK;
  const int t = threadIdx.x;
  const int wg = t / 128;  // this warpgroup's 64 rows of the tile

  int pos[kARowsPerThread], py[kARowsPerThread], px[kARowsPerThread];
#pragma unroll
  for (int i = 0; i < kARowsPerThread; ++i) {
    pos[i] = m0 + t / 8 + i * (kThreads / 8);
    py[i] = (pos[i] / wd) % h;
    px[i] = pos[i] % wd;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_stage<NT>(x, packed, k_pad, n0, s, c_in, h, wd, pos, py, px, positions,
                     smem + s * L::kStageBytes);
    }
    cp_async_commit();
  }
  float acc[NT][32];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage kt landed
    wgmma::proxy_fence();
    __syncthreads();  // everyone's copies landed; stage kt - 1's products retired
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      load_stage<NT>(x, packed, k_pad, n0, next, c_in, h, wd, pos, py, px, positions,
                     smem + (next % kStages) * L::kStageBytes);
    }
    cp_async_commit();

    const uint8_t* stage = smem + (kt % kStages) * L::kStageBytes;
    const uint8_t* a_tile = stage + wg * kWgRows * wgmma::kRowBytes;
#pragma unroll
    for (int j = 0; j < NT; ++j) wgmma::fence_accumulators(acc[j]);
    wgmma::fence();
#pragma unroll
    for (int step = 0; step < kK / 16; ++step) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* b_tile = stage + kATileBytes + j * 64 * wgmma::kRowBytes;
        wgmma::mma_m64n64k16(acc[j], wgmma::swizzled_descriptor(a_tile, step),
                             wgmma::swizzled_descriptor(b_tile, step));
      }
    }
    wgmma::commit();
    wgmma::wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) wgmma::fence_accumulators(acc[j]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read and every product retired: the ring is free

  // bias + ReLU in fp32, rounded once to bf16, into a tile in shared memory
  bf16* tile = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = wg * kWgRows + wgmma::accumulator_row(i, t % 128);
      const int col = j * 64 + wgmma::accumulator_col(i, t % 128);
      const int n = n0 + col;
      const float b0 = n < c_out ? bias[n] : 0.f;
      const float b1 = n + 1 < c_out ? bias[n + 1] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(tile + r * L::kOutStride + col) =
          __floats2bfloat162_rn(relu(acc[j][i] + b0), relu(acc[j][i + 1] + b1));
    }
  }
  __syncthreads();

  // 16-byte stores of 8 channels; C_out is a multiple of 8
  constexpr int kVecs = L::kCols / 8;
  for (int idx = t; idx < kRows * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c8 = (idx % kVecs) * 8;
    const int m = m0 + r, n = n0 + c8;
    if (m < positions && n < c_out) {
      *reinterpret_cast<uint4*>(out + static_cast<int64_t>(m) * c_out + n) =
          *reinterpret_cast<const uint4*>(tile + r * L::kOutStride + c8);
    }
  }
}

template <int NT>
int launch_tiles(const bf16* x, const bf16* packed, const float* bias, bf16* out, int positions,
                 int h, int wd, int c_in, int c_out, cudaStream_t stream) {
  using L = Tile<NT>;
  // Set once, at the first launch: never inside a CUDA graph's capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((positions + kRows - 1) / kRows, cols_padded(c_out) / L::kCols);
  conv3x3_mma_kernel<NT><<<grid, kThreads, L::kSmem, stream>>>(x, packed, bias, out, positions,
                                                              h, wd, c_in, c_out);
  return last_launch_error();
}

int launch_bf16(const bf16* x, const bf16* packed, const float* bias, bf16* out, int positions,
                int h, int wd, int c_in, int c_out, cudaStream_t stream) {
  if (c_in % kChannelMultiple || c_out % kChannelMultiple) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cols_padded(c_out) % 128 == 0) {
    return launch_tiles<2>(x, packed, bias, out, positions, h, wd, c_in, c_out, stream);
  }
  return launch_tiles<1>(x, packed, bias, out, positions, h, wd, c_in, c_out, stream);
}

}  // namespace mma

}  // namespace

extern "C" {

// dtype 0: x, weight (C_out, C_in, 3, 3) and out fp32. dtype 1: x and out
// bf16, weight the packed (C_out rounded up to 64, K) bf16 operand (see the
// header). bias (C_out,) fp32. x (batch, h, w, c_in) and out (batch, h, w,
// c_out) NHWC; fewer than 2^31 elements each (checked by the caller).
// Returns 0 or a cudaError_t code.
int conv3x3_forward(int dtype, int device, const void* x, const void* weight, const float* bias,
                    void* out, int batch, int h, int w, int c_in, int c_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int positions = batch * h * w;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return mma::launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(weight), bias,
                            static_cast<bf16*>(out), positions, h, w, c_in, c_out, s);
  }
  if (dtype == kFloat32) {
    return launch_fp32(static_cast<const float*>(x), static_cast<const float*>(weight), bias,
                       static_cast<float*>(out), positions, h, w, c_in, c_out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The route's limits (dtype 0 fp32, 1 bf16): limits[0] the multiple C_in
// must be, limits[1] the multiple C_out must be. ops/kernels.CONV3X3_LIMITS
// states the same numbers, so a call is checked without a card; the smoke
// compares the two. Returns 0 or a cudaError_t code.
int conv3x3_limits(int dtype, int* limits) {
  if (dtype != kFloat32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const int multiple = dtype == kBFloat16 ? mma::kChannelMultiple : 1;
  limits[0] = multiple;
  limits[1] = multiple;
  return 0;
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
