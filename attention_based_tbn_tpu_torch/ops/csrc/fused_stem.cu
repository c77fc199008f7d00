// Fused inference stem of a BN-Inception tower: normalize -> 7x7 / stride 2
// / pad 3 conv with the BatchNorm folded in -> + float32 bias -> ReLU ->
// 3x3 / stride 2 / pad 0 ceil-mode max pool, in one pass.
//
// Replaces the JAX package's ops/fused_stem.py:fused_stem_pallas (:218-285,
// pallas_call at :264, kernel _stem_kernel at :126-212).
//
// Input: (B, H, W, C) NHWC memory, uint8 (RGB 3 / Flow 10 channels, with a
// per-channel affine) or float32 / bfloat16 (the audio spectrogram, C = 1,
// affine 1 / 0); H and W multiples of 4. Bias, scale, offset: float32.
// Output: (B, H/4, W/4, 64) NHWC memory in the compute type T, which is a
// channels-last (B, 64, H/4, W/4) tensor for the next convolution. Weight,
// the BN scale already folded in: at float32 (64, C, 7, 7); at bfloat16 the
// implicit GEMM's B operand, (64, K) K-major with k = (ky * 7 + kx) * C + c
// and zeros from 49 C up to K = 49 C rounded up to 16 (RGB 160, Flow 496,
// Audio 64; ops/kernels.pack_stem_weight).
//
// Numerics as the Pallas kernel: the input is normalized in float32 and
// rounded once to T; products accumulate in float32; bias and ReLU in
// float32; the pool takes the max and the result is rounded to T once
// (rounding is monotone, so pool-then-round equals round-then-pool).
//
// Bound: operations. The 7x7 conv does 2 * 49 * C * 64 operations per conv
// output against C input bytes and (a quarter of) 128 output bytes, far
// above the card's ridge point.
//
// bf16 route (stem_mma_kernel): an implicit GEMM on the bf16 tensor cores
// through wgmma (wgmma.cuh). M = the 17 x 29 = 493 conv positions behind a
// block's 8 x 14 pooled outputs (8 m64 tiles), N = the 64 output channels,
// K = 49 C padded to 16. The tile divides the 56 x 56 pooled map of a 224^2
// crop exactly (the 4 x 8 tile of the fp32 route recomputes 1.42x the conv
// rows its outputs need, this one 1.10x, and pads 493 rows to 512); its
// normalized bf16 input patch, 39 x 63 x C (Flow: 49 KB), and the packed
// weights in the 128-byte-swizzled K-major layout (Flow: 8 K-atoms of 64,
// 64 KB) are staged in shared memory once per block (each thread issues 8
// input loads before its first store; the stems' channel counts 1, 3 and
// 10 are compile-time constants, which fold the index divisions: together
// 23% off the Flow stem on an H100). Four warpgroups own
// two m64 tiles each; for every 64-deep K atom a warpgroup gathers its
// tile's im2col rows from the patch into a swizzled 8 KB A tile (K order
// (ky, kx, c): the 7 C values of one kernel row are contiguous in the
// patch; k >= 49 C is written as zero, as the packed weights are: one zero
// side is not enough, 0 x NaN is NaN) and issues up to four m64n64k16
// products, double-buffered so that the next tile's gather overlaps them.
// The epilogue adds the bias, applies ReLU, rounds once to bf16 into a conv
// tile in shared memory (aliasing the staged operands), and the pool reads
// it; the last window of the image is clipped to the conv output (ceil
// mode), never to the tile.
//
// fp32 route (fused_stem_kernel, the parity route): fp32 FMAs. One block of
// 256 threads per (image, tile of 4 x 8 pooled outputs). The tile needs 9 x
// 17 conv outputs and a 23 x 39 x C input patch, staged once in shared
// memory, normalized and zero-padded. Weights stream through shared memory
// one input channel at a time (49 x 64 floats, 13 KB), so even the
// 10-channel Flow stem needs only ~49 KB (hence the dynamic shared-memory
// opt-in above 48 KB). Each thread holds 8 output channels x 5 conv
// positions in registers: per tap two 16-byte weight loads and five
// broadcast input loads feed 40 FMAs. The conv tile then goes to shared
// memory (aliasing the patch) with bias and ReLU, and the pooled 4 x 8 x 64
// outputs are written with consecutive threads on consecutive channels.
// The TPU kernel's column packing, 14-way row chunking and lane-padding
// workarounds have no counterpart here.
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

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

// Floats of the patch, rounded up so the weights after it stay 16-byte aligned.
__host__ __device__ __forceinline__ int patch_floats(int c) {
  return (c * kPatchH * kPatchW + 3) & ~3;
}

int smem_bytes(int c) {
  const int stage = (patch_floats(c) + kTaps * kWStride) * static_cast<int>(sizeof(float));
  const int pool = kPos * kOut * static_cast<int>(sizeof(float));
  return stage > pool ? stage : pool;
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const In* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, const float* __restrict__ scale,
                  const float* __restrict__ offset, float* __restrict__ out, int c, int h, int w,
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
      v = __fadd_rn(__fmul_rn(raw, scale[ci]), offset[ci]);
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
    out[((static_cast<int64_t>(b) * out_h + oy) * out_w + ox) * kOut + o] = m;
  }
}

// ---------------------------------------------------------- bf16 route

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTileH = 8;                     // pooled rows per block
constexpr int kTileW = 14;                    // pooled columns per block
constexpr int kConvH = 2 * kTileH + 1;        // 17 conv rows
constexpr int kConvW = 2 * kTileW + 1;        // 29 conv columns
constexpr int kPos = kConvH * kConvW;         // 493 conv positions: M
constexpr int kPatchH = 4 * kTileH + 7;       // 39 input rows
constexpr int kPatchW = 4 * kTileW + 7;       // 63 input columns
constexpr int kWarpgroups = 4;
constexpr int kTilesPerGroup = 2;             // m64 tiles per warpgroup: 8 x 64 = 512 rows
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kAtomBytes = 64 * wgmma::kRowBytes;  // 64 rows x 64 K of bf16
constexpr int kABytes = kWarpgroups * 2 * kAtomBytes;  // two A tiles per warpgroup

__host__ __device__ __forceinline__ int k_padded(int c) { return (49 * c + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int atoms(int c) { return (k_padded(c) + 63) / 64; }

int smem_bytes(int c) {
  const int staged = atoms(c) * kAtomBytes + kABytes + kPatchH * kPatchW * c * 2;
  const int conv = kPos * kOut * 2;
  return (staged > conv ? staged : conv) + 1024;  // + the 1024-byte alignment
}

constexpr int kLoadBatch = 8;  // patch elements each thread loads before it stores any

// kC: the channel count as a compile-time constant (1, 3 and 10, the
// stems' inputs, fold every division by it), or 0 to read it from c_arg.
template <typename In, int kC>
__global__ void __launch_bounds__(kThreads, 1)
stem_mma_kernel(const In* __restrict__ x, const bf16* __restrict__ packed,
                const float* __restrict__ bias, const float* __restrict__ scale,
                const float* __restrict__ offset, bf16* __restrict__ out, int c_arg, int h,
                int w, int tiles_w) {
  const int c = kC ? kC : c_arg;
  extern __shared__ uint8_t stem_smem_raw[];
  uint8_t* smem = wgmma::align_1024(stem_smem_raw);
  const int n_atoms = atoms(c);
  const int k_pad = k_padded(c);
  const int k_real = 49 * c;
  uint8_t* wsm = smem;                                   // [atom][64 rows] swizzled
  uint8_t* abuf = wsm + n_atoms * kAtomBytes;            // [warpgroup][2] swizzled A tiles
  bf16* patch = reinterpret_cast<bf16*>(abuf + kABytes); // [row][col][c]
  const uint16_t* patch_bits = reinterpret_cast<const uint16_t*>(patch);
  bf16* conv = reinterpret_cast<bf16*>(smem);            // [pos][64], after the products

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;

  // 1. the packed weights, swizzled by K atom; chunks past K are zero
  const int chunks = n_atoms * 8;
  for (int i = threadIdx.x; i < kOut * chunks; i += kThreads) {
    const int n = i / chunks, cc = i % chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (cc * 8 < k_pad) v = *reinterpret_cast<const uint4*>(packed + (int64_t)n * k_pad + cc * 8);
    *reinterpret_cast<uint4*>(wsm + (cc / 8) * kAtomBytes + wgmma::swizzled_offset(n, cc % 8)) = v;
  }
  // 2. the normalized, zero-padded input patch, rounded once to bf16; a
  //    patch row is kPatchW * c contiguous input elements, and each thread
  //    issues kLoadBatch loads before it waits for the first
  const In* xb = x + static_cast<int64_t>(b) * h * w * c;
  const int patch_size = kPatchH * kPatchW * c;
  for (int i0 = threadIdx.x; i0 < patch_size; i0 += kThreads * kLoadBatch) {
    float raw[kLoadBatch];
    unsigned inside = 0u;  // bit u: element u lies in the image (else the conv's zero padding)
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int row = i / (c * kPatchW), col = (i / c) % kPatchW;
      const int iy = iy0 + row, ix = ix0 + col;
      raw[u] = 0.0f;
      if (i < patch_size && iy >= 0 && iy < h && ix >= 0 && ix < w) {
        raw[u] = load_input(xb + (static_cast<int64_t>(iy) * w + ix0) * c + i % (c * kPatchW));
        inside |= 1u << u;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= patch_size) break;
      const int ci = i % c;
      const float v = (inside >> u) & 1u ? __fadd_rn(__fmul_rn(raw[u], scale[ci]), offset[ci])
                                         : 0.0f;
      patch[i] = __float2bfloat16(v);
    }
  }
  wgmma::proxy_fence();
  __syncthreads();

  // 3. the products. Thread t of warpgroup g gathers chunk t % 8 (8 values
  //    of K) of rows t / 8 + 16 j (j < 4) of each A tile of its m64 tiles.
  const int g = threadIdx.x / 128, t = threadIdx.x % 128;
  const int chunk = t % 8;
  int base[kTilesPerGroup][4];  // patch offset of each gathered row's conv position
#pragma unroll
  for (int i = 0; i < kTilesPerGroup; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = min((g * kTilesPerGroup + i) * 64 + t / 8 + 16 * j, kPos - 1);
      base[i][j] = (2 * (p / kConvW) * kPatchW + 2 * (p % kConvW)) * c;
    }
  }
  float acc[kTilesPerGroup][32];
#pragma unroll
  for (int i = 0; i < kTilesPerGroup; ++i) {
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[i][r] = 0.0f;
  }
  const int steps = k_pad / 16;
  for (int atom = 0; atom < n_atoms; ++atom) {
    int koff[8];  // patch offset of the 8 K values of this thread's chunk, -1 past 49 C
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = atom * 64 + chunk * 8 + e;
      const int ky = k / (7 * c);
      koff[e] = k < k_real ? ky * kPatchW * c + (k - ky * 7 * c) : -1;
    }
    const int atom_steps = min(4, steps - 4 * atom);
    const uint8_t* wtile = wsm + atom * kAtomBytes;
#pragma unroll
    for (int i = 0; i < kTilesPerGroup; ++i) {
      uint8_t* tile = abuf + (g * 2 + i) * kAtomBytes;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word[4];  // 8 bf16 of K, as bits; +0.0 is 0
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo = koff[2 * e] >= 0 ? patch_bits[base[i][j] + koff[2 * e]] : 0u;
          const uint32_t hi =
              koff[2 * e + 1] >= 0 ? patch_bits[base[i][j] + koff[2 * e + 1]] : 0u;
          word[e] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(tile + wgmma::swizzled_offset(t / 8 + 16 * j, chunk)) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
      wgmma::proxy_fence();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");  // the warpgroup's tile is whole
      wgmma::fence_accumulators(acc[i]);
      wgmma::fence();
      for (int s = 0; s < atom_steps; ++s) {
        wgmma::mma_m64n64k16(acc[i], wgmma::swizzled_descriptor(tile, s),
                             wgmma::swizzled_descriptor(wtile, s));
      }
      wgmma::commit();
      // the other A tile's products have retired: it may be gathered anew
      wgmma::wait<1>();
      wgmma::fence_accumulators(acc[i]);
    }
  }
  wgmma::wait<0>();
#pragma unroll
  for (int i = 0; i < kTilesPerGroup; ++i) wgmma::fence_accumulators(acc[i]);
  __syncthreads();  // every warpgroup is done with the staged operands

  // 4. bias + ReLU, rounded once to bf16, into the conv tile
#pragma unroll
  for (int i = 0; i < kTilesPerGroup; ++i) {
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int p = (g * kTilesPerGroup + i) * 64 + wgmma::accumulator_row(r, t);
      const int o = wgmma::accumulator_col(r, t);
      if (p < kPos) {
        *reinterpret_cast<__nv_bfloat162*>(conv + p * kOut + o) = __floats2bfloat162_rn(
            fmaxf(acc[i][r] + bias[o], 0.0f), fmaxf(acc[i][r + 1] + bias[o + 1], 0.0f));
      }
    }
  }
  __syncthreads();

  // 5. the 3x3 / 2 ceil pool, 8 channels (16 bytes) per thread and step
  const int out_h = h / 4, out_w = w / 4;
  const int rows_left = h / 2 - 2 * oy0, cols_left = w / 2 - 2 * ox0;
  for (int i = threadIdx.x; i < kTileH * kTileW * 8; i += kThreads) {
    const int o8 = (i % 8) * 8, q = i / 8;
    const int qy = q / kTileW, qx = q % kTileW;
    const int oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= out_h || ox >= out_w) continue;
    const int r0 = 2 * qy, c0 = 2 * qx;
    const int r1 = min(r0 + 3, rows_left), c1 = min(c0 + 3, cols_left);
    __nv_bfloat162 m[4];
    const __nv_bfloat162 lowest = __floats2bfloat162_rn(-INFINITY, -INFINITY);
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = lowest;
    for (int r = r0; r < r1; ++r) {
      for (int cc = c0; cc < c1; ++cc) {
        const uint4 v = *reinterpret_cast<const uint4*>(conv + (r * kConvW + cc) * kOut + o8);
        const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e] = __hmax2(m[e], pv[e]);
      }
    }
    *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * out_h + oy) * out_w + ox) * kOut +
                              o8) = *reinterpret_cast<const uint4*>(m);
  }
}

template <typename In, int kC>
int launch(const void* x, const void* packed, const float* bias, const float* scale,
           const float* offset, void* out, int batch, int c, int h, int w,
           cudaStream_t stream) {
  const int bytes = smem_bytes(c);
  auto kernel = stem_mma_kernel<In, kC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (h / 4 + kTileH - 1) / kTileH;
  const int tiles_w = (w / 4 + kTileW - 1) / kTileW;
  const dim3 grid(tiles_h * tiles_w, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const In*>(x),
                                            static_cast<const bf16*>(packed), bias, scale,
                                            offset, static_cast<bf16*>(out), c, h, w, tiles_w);
  return last_launch_error();
}

template <typename In>
int launch(const void* x, const void* packed, const float* bias, const float* scale,
           const float* offset, void* out, int batch, int c, int h, int w,
           cudaStream_t stream) {
  switch (c) {
    case 1: return launch<In, 1>(x, packed, bias, scale, offset, out, batch, c, h, w, stream);
    case 3: return launch<In, 3>(x, packed, bias, scale, offset, out, batch, c, h, w, stream);
    case 10: return launch<In, 10>(x, packed, bias, scale, offset, out, batch, c, h, w, stream);
    default: return launch<In, 0>(x, packed, bias, scale, offset, out, batch, c, h, w, stream);
  }
}

}  // namespace mma

template <typename In>
int launch(const void* x, const void* weight, const float* bias, const float* scale,
           const float* offset, void* out, int batch, int c, int h, int w,
           cudaStream_t stream) {
  const int bytes = smem_bytes(c);
  auto kernel = fused_stem_kernel<In>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (h / 4 + kTileH - 1) / kTileH;
  const int tiles_w = (w / 4 + kTileW - 1) / kTileW;
  const dim3 grid(tiles_h * tiles_w, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const In*>(x), static_cast<const float*>(weight), bias, scale, offset,
      static_cast<float*>(out), c, h, w, tiles_w);
  return last_launch_error();
}

// The route of compute dtype `dtype` for an input of type In.
template <typename In>
int launch_route(int dtype, const void* x, const void* weight, const float* bias,
                 const float* scale, const float* offset, void* out, int batch, int c, int h,
                 int w, cudaStream_t stream) {
  if (dtype == kBFloat16) {
    return mma::launch<In>(x, weight, bias, scale, offset, out, batch, c, h, w, stream);
  }
  return launch<In>(x, weight, bias, scale, offset, out, batch, c, h, w, stream);
}

int launch_for_input(int input_code, int dtype, const void* x, const void* weight,
                     const float* bias, const float* scale, const float* offset, void* out,
                     int batch, int c, int h, int w, cudaStream_t stream) {
  switch (input_code) {
    case kInUInt8:
      return launch_route<uint8_t>(dtype, x, weight, bias, scale, offset, out, batch, c, h, w,
                                   stream);
    case kInBFloat16:
      return launch_route<__nv_bfloat16>(dtype, x, weight, bias, scale, offset, out, batch, c,
                                         h, w, stream);
    case kInFloat32:
      return launch_route<float>(dtype, x, weight, bias, scale, offset, out, batch, c, h, w,
                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x (batch, h, w, c) NHWC of type input_code; out (batch, h/4, w/4, 64) of
// type dtype; weight (64, c, 7, 7) float32 at dtype 0, packed (64, K) bf16
// at dtype 1 (see the header); bias (64,), scale and offset (c,) float32.
// h and w multiples of 4, batch <= 65535 (checked by the caller). Returns 0
// or a cudaError_t code.
int fused_stem_forward(int input_code, int dtype, int device, const void* x, const void* weight,
                       const void* bias, const void* scale, const void* offset, void* out,
                       int batch, int c, int h, int w, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_for_input(input_code, dtype, x, weight, static_cast<const float*>(bias),
                          static_cast<const float*>(scale), static_cast<const float*>(offset),
                          out, batch, c, h, w, static_cast<cudaStream_t>(stream));
}

const char* fused_stem_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
