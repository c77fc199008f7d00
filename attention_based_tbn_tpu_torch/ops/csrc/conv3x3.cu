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
// bf16 routes, two, chosen by C_in (conv3x3_route): the packed weight of
// one 64-wide N tile either fits in shared memory beside four input halos
// (resident route, C_in <= 96: the probe's 96, BN-Inception's 64) or not
// (streaming route, e.g. inception_5a_3x3's 192). Both run on the bf16
// tensor cores through wgmma (wgmma.cuh).
//
// Resident route (conv3x3_resident_kernel). A block owns one 64-wide N tile
// and is persistent: it loads that tile's packed weight into shared memory
// once (9 C_in x 64 x 2 bytes, 112 KB at C_in = 96 as k_pad / 64 swizzled
// 64 x 64 tiles). Its four warpgroups then work independently, synchronised
// only among their own 128 threads, so one warpgroup's copies and stores
// overlap the others' products. A warpgroup owns an even share of the
// spatial tiles of 2 output rows x 32 columns of one image (64 positions,
// masked at the image's edge; at W = 28 the last 4 columns are masked,
// 12.5% of the products), taken down a column strip of an image, so its
// next tile is most often the one below. Its input halo, (2 + 2) x (32 +
// 2) pixels x C_in, staged by cp.async and zero outside the image, is a
// ring of 4 rows: the tile below shares 2 rows with this one, and its other
// 2 are copied into the slots of this halo's first two rows as soon as the
// products no longer read them (after the taps with ky = 0, then ky = 1),
// so they land while this tile's products run; a new strip's halo is
// copied whole after the products. Each input element then crosses L2 ->
// shared memory about (2 x 34) / (2 x 32) = 1.06 times per N tile, not 9.
// Each pixel is C_in / 8 16-byte units and a zero unit, made odd, so the 8
// rows of an ldmatrix (8 neighbouring pixels) hit 8 distinct bank groups.
// Each k16 step's A fragment comes from the halo by ldmatrix.x4 at per-lane
// row addresses shifted by the tap ((ky, kx, c) of each 8-channel chunk,
// from four tables made once per block, one for each ring position and
// output row; K padding reads the lane's own pixel's zero unit), and the
// product is wgmma's register-A form against the resident B. K runs eight
// k16 steps a commit group, each group retired (wait<0>) before the next
// group's ldmatrix: ptxas serializes every product of the register-A form
// when a fragment is reloaded with a group in flight (its C7513 report), so
// the overlap comes from the other warpgroups instead. The epilogue adds
// the fp32 bias, applies ReLU, rounds once to bf16, and a 4-lane transpose
// by shuffles gives each lane 8 neighbouring channels of a position: one
// 16-byte store each, masked to the image and to C_out. Grid: (SMs / N
// tiles) x N tiles blocks of 512 threads, one a SM (225 KB of shared
// memory at C_in = 96).
//
// Streaming route (conv3x3_mma_kernel), where the weight does not fit: an
// implicit GEMM with M = the B H W output positions in NHWC order, so a
// tile may cross image rows and images: each row decodes its own (y, x).
// N = C_out in 64-wide wgmma tiles, two per block where C_out rounded up to
// 64 is a multiple of 128. K = 9 C_in in (ky, kx, c) order, 64 deep per
// stage. A block of two warpgroups owns 128 positions; the stage's A tile
// is 128 rows x 64 K, and each 16-byte chunk of a row (8 channels of one
// tap: C_in is a multiple of 8) is one cp.async straight from x into the
// 128-byte-swizzled K-major layout, with src-size 0 where the tap falls
// outside the image (the conv's zero padding), past 9 C_in (K padding: zero
// on both operands, since 0 x NaN is NaN) or past the last position. The
// mainloop is pe_block.cu's: a 3-stage cp.async ring, the products of one
// stage retired before its slot is refilled. The epilogue adds the fp32
// bias, applies ReLU, rounds once to bf16 into a tile in shared memory
// (reusing the ring), and writes it in 16-byte stores, masked to C_out (a
// multiple of 8).
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

// --------------------------------------------------- bf16 streaming route

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

__host__ __device__ constexpr int k_padded(int c_in) { return (9 * c_in + kK - 1) / kK * kK; }
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

int launch_streaming(const bf16* x, const bf16* packed, const float* bias, bf16* out,
                     int positions, int h, int wd, int c_in, int c_out, cudaStream_t stream) {
  if (cols_padded(c_out) % 128 == 0) {
    return launch_tiles<2>(x, packed, bias, out, positions, h, wd, c_in, c_out, stream);
  }
  return launch_tiles<1>(x, packed, bias, out, positions, h, wd, c_in, c_out, stream);
}

}  // namespace mma

// ------------------------------------------------- bf16 resident route

namespace resident {

constexpr int kTH = 2;                            // output rows of a warpgroup's tile
constexpr int kTW = 32;                           // output columns of a tile
constexpr int kWarpgroups = 4;                    // each on its own tiles
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStageGroups = 2;                   // B tiles (4 k16 steps each) a commit
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
static_assert(kHaloH == 4, "the halo's rows are a ring indexed with & (kHaloH - 1)");
constexpr int kGroupSteps = 4;                    // k16 steps of one B tile
constexpr int kMaxSmem = 232448;                  // a block's shared memory on the H100
constexpr int kBTileBytes = 64 * wgmma::kRowBytes;  // 64 rows of N x 64 of K

// 16-byte units per halo pixel: the C_in / 8 chunks and at least one zero
// unit (the A operand of K past 9 C_in), made odd, so the eight rows of an
// ldmatrix phase (eight neighbouring pixels) fall on distinct banks.
__host__ __device__ constexpr int pixel_units(int c_in) { return (c_in / 8 + 1) | 1; }
__host__ __device__ constexpr int halo_bytes(int c_in) {
  return kHaloH * kHaloW * pixel_units(c_in) * 16;
}
// K tables: one for each first halo slot (0 or 2) and output row (0 or 1).
constexpr int kTables = 4;

// Shared memory of a block: 1024 (alignment) + the N tile's weight + a halo
// a warpgroup + the K tables.
__host__ __device__ constexpr int smem_bytes(int c_in) {
  const int k_pad = mma::k_padded(c_in);
  return 1024 + 64 * k_pad * 2 + kWarpgroups * halo_bytes(c_in) + kTables * k_pad / 8 * 4;
}

// Barrier of the 128 threads of warpgroup wg (named barrier 1 + wg; 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The 16-byte chunks of a halo row a thread copies: a halo row is kHaloW
// pixels x C_in / 8 chunks (at most 34 x 12 = 408 for the route's C_in <=
// 96), and the warpgroup's thread wt takes chunks wt, wt + 128, ... of
// every row, the same in every row and tile: their pixel column, their
// offset in a row of x (elements) and in a halo row (bytes), made once.
constexpr int kRowChunks = 4;  // ceil(408 / 128)

// The largest C_in the route takes (a multiple of 8): to here a block's
// shared memory fits the H100's and a halo row fits kRowChunks chunks a
// thread. ops/kernels.CONV3X3_RESIDENT_MAX_C_IN states the same number, so
// a route is named without a card; the smoke compares the two.
constexpr int kMaxCin = 96;
static_assert(smem_bytes(kMaxCin) <= kMaxSmem && smem_bytes(kMaxCin + 8) > kMaxSmem,
              "kMaxCin is the largest C_in whose block fits the shared memory");
static_assert(kHaloW * (kMaxCin / 8) <= 128 * kRowChunks, "a halo row fits kRowChunks a thread");

struct HaloColumns {
  int hx[kRowChunks];   // pixel column in the halo; kHaloW when unused
  int src[kRowChunks];  // elements from the row's first pixel in x
  int dst[kRowChunks];  // bytes from the halo row's start
};

__device__ __forceinline__ HaloColumns halo_columns(int wt, int c_in) {
  HaloColumns cols;
  const int chunks = c_in / 8, units = pixel_units(c_in);
#pragma unroll
  for (int k = 0; k < kRowChunks; ++k) {
    const int q = wt + 128 * k;
    const int hx = q < kHaloW * chunks ? q / chunks : kHaloW, ch = q % chunks;
    cols.hx[k] = hx;
    cols.src[k] = hx * c_in + ch * 8;
    cols.dst[k] = (hx * units + ch) * 16;
  }
  return cols;
}

// Halo rows hy_begin .. hy_end - 1 of a tile of image img whose halo starts
// at image row iy0 and column x0, this thread's chunks of each, zero
// outside the image. The halo's 4 rows are a ring: row hy lies in slot
// (slot0 + hy) % 4 of `buf`.
__device__ __forceinline__ void load_halo_rows(const bf16* __restrict__ x, int img, int iy0,
                                               int x0, int hy_begin, int hy_end, int slot0,
                                               int h, int wd, int c_in, const HaloColumns& cols,
                                               uint32_t buf) {
  const int row_bytes = kHaloW * pixel_units(c_in) * 16;
  bool col_ok[kRowChunks];
#pragma unroll
  for (int k = 0; k < kRowChunks; ++k) {
    col_ok[k] = cols.hx[k] < kHaloW && x0 + cols.hx[k] >= 0 && x0 + cols.hx[k] < wd;
  }
  for (int hy = hy_begin; hy < hy_end; ++hy) {
    const int iy = iy0 + hy;
    const bool row_ok = iy >= 0 && iy < h;
    // the row's pixel x0 in x (may lie before the row: read only where ok)
    const bf16* row = x + ((static_cast<int64_t>(img) * h + iy) * wd + x0) * c_in;
    const uint32_t dst = buf + ((slot0 + hy) & (kHaloH - 1)) * row_bytes;
#pragma unroll
    for (int k = 0; k < kRowChunks; ++k) {
      if (cols.hx[k] < kHaloW) {
        const bool ok = row_ok && col_ok[k];
        cp_async16(dst + cols.dst[k], ok ? row + cols.src[k] : x, ok);
      }
    }
  }
}

// Where tile `tile` lies: tiles run down a column strip of an image (ty
// fastest), so a warpgroup's next tile is most often the one below.
struct TilePos {
  int img, ty, x0;
};

__device__ __forceinline__ TilePos tile_pos(int tile, int tiles_y, int tiles_x) {
  const int strip = tile / tiles_y;
  return TilePos{strip / tiles_x, tile - strip * tiles_y, (strip % tiles_x) * kTW};
}

// A 4 x 4 transpose among the four lanes of a quad (lanes 4 g .. 4 g + 3):
// lane t gives a[k], meant for lane k, and gets lane s's a[t] as element s.
// Two butterfly stages of two shuffles each (xor 1, then xor 2), then the
// four values put in lane order.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&a)[4], int lane) {
  const bool t0 = lane & 1, t1 = lane & 2;
  // stage 1: keep columns t0 and t0 + 2, send the other two to lane t ^ 1
  const uint32_t keep_lo = t0 ? a[1] : a[0], keep_hi = t0 ? a[3] : a[2];
  const uint32_t got_lo = __shfl_xor_sync(0xffffffffu, t0 ? a[0] : a[1], 1);
  const uint32_t got_hi = __shfl_xor_sync(0xffffffffu, t0 ? a[2] : a[3], 1);
  // stage 2: keep column t (rows t, t ^ 1), send column t ^ 2 to lane t ^ 2
  const uint32_t own = t1 ? keep_hi : keep_lo, own1 = t1 ? got_hi : got_lo;
  const uint32_t far = __shfl_xor_sync(0xffffffffu, t1 ? keep_lo : keep_hi, 2);
  const uint32_t far1 = __shfl_xor_sync(0xffffffffu, t1 ? got_lo : got_hi, 2);
  // rows t, t ^ 1, t ^ 2, t ^ 3 -> rows 0, 1, 2, 3
  const uint32_t r0 = t0 ? own1 : own, r1 = t0 ? own : own1;
  const uint32_t r2 = t0 ? far1 : far, r3 = t0 ? far : far1;
  return t1 ? make_uint4(r2, r3, r0, r1) : make_uint4(r0, r1, r2, r3);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments of k16 steps 4 g .. 4 g + 3 by ldmatrix from the halo (past
// 9 C_in, from the lane's own pixel's zero unit).
__device__ __forceinline__ void load_group(uint32_t (&frag)[kGroupSteps][4], const int* table,
                                           int g, int half, uint32_t a_base) {
#pragma unroll
  for (int s = 0; s < kGroupSteps; ++s) {
    wgmma::ldmatrix_x4(frag[s], a_base + table[(g * kGroupSteps + s) * 2 + half]);
  }
}

// The products of those steps against the resident weight's tile g; w_desc
// is the descriptor of the weight's first k16 step (the address field, in
// 16-byte units, advances with the step).
__device__ __forceinline__ void mma_group(float (&acc)[32], uint32_t (&frag)[kGroupSteps][4],
                                          int g, uint64_t w_desc) {
#pragma unroll
  for (int s = 0; s < kGroupSteps; ++s) {
    wgmma::mma_m64n64k16_rs(acc, frag[s],
                            w_desc + ((g * kBTileBytes + s * wgmma::kStepBytes) >> 4));
  }
}

// grid: (blocks per N tile) x n_tiles, block i on N tile i % n_tiles; its
// warpgroup wg on tiles (i / n_tiles) * 4 + wg, then every 4 (grid / n_tiles).
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_resident_kernel(const bf16* __restrict__ x, const bf16* __restrict__ packed,
                        const float* __restrict__ bias, bf16* __restrict__ out, int batch, int h,
                        int wd, int c_in, int c_out, int n_tiles) {
  extern __shared__ uint8_t conv3x3_resident_raw[];
  uint8_t* w_s = wgmma::align_1024(conv3x3_resident_raw);
  const int k_pad = mma::k_padded(c_in);
  const int hbytes = halo_bytes(c_in);
  int* table = reinterpret_cast<int*>(w_s + 64 * k_pad * 2 + kWarpgroups * hbytes);

  const int t = threadIdx.x;
  const int wg = t / 128, wt = t % 128, lane = t % 32;
  // this warpgroup's halo: 4 rows of (32 + 2) pixels, a ring
  const uint32_t halo = smem_u32(w_s + 64 * k_pad * 2 + wg * hbytes);
  const int n0 = (blockIdx.x % n_tiles) * 64;
  const int tiles_x = (wd + kTW - 1) / kTW, tiles_y = (h + kTH - 1) / kTH;
  const int tiles = batch * tiles_x * tiles_y;
  // this warpgroup's run of tiles: an even share of the N tile's
  const int runs = kWarpgroups * (gridDim.x / n_tiles);
  const int run = (blockIdx.x / n_tiles) * kWarpgroups + wg;
  int tile = static_cast<int>(static_cast<int64_t>(tiles) * run / runs);
  const int last = static_cast<int>(static_cast<int64_t>(tiles) * (run + 1) / runs);

  // the N tile's packed weight, once: k_pad / 64 swizzled 64 x 64 tiles
  const int row_chunks = k_pad / 8;
  for (int idx = t; idx < 64 * row_chunks; idx += kThreads) {
    const int row = idx / row_chunks, kc = idx - row * row_chunks;
    cp_async16(smem_u32(w_s) + (kc / 8) * kBTileBytes + wgmma::swizzled_offset(row, kc % 8),
               packed + static_cast<int64_t>(n0 + row) * k_pad + kc * 8, true);
  }
  const HaloColumns cols = halo_columns(wt, c_in);
  if (tile < last) {
    const TilePos p = tile_pos(tile, tiles_y, tiles_x);
    load_halo_rows(x, p.img, kTH * p.ty - 1, p.x0 - 1, 0, kHaloH, (kTH * p.ty) & (kHaloH - 1),
                   h, wd, c_in, cols, halo);
  }
  cp_async_commit();
  // K tables: for each first slot s0 (0 or 2) and output row oy (0 or 1),
  // the byte offset from a lane's pixel column of each 8-channel K chunk's
  // tap (ky, kx) and channels: slot (s0 + oy + ky) % 4, column + kx; past 9
  // C_in, the zero unit of the lane's own pixel. And the zero units of every
  // pixel of every halo (the copies never write them).
  const int units = pixel_units(c_in), chunks = c_in / 8;
  for (int idx = t; idx < kTables * row_chunks; idx += kThreads) {
    const int which = idx / row_chunks, j = idx - which * row_chunks;
    const int s0 = 2 * (which / 2), oy = which % 2;
    const int tap = 8 * j / c_in, c = 8 * j - tap * c_in;
    const int ky = tap < 9 ? tap / 3 : 0, kx = tap < 9 ? tap % 3 : 0;
    const int pixel = ((s0 + oy + ky) & (kHaloH - 1)) * kHaloW + kx;
    table[idx] = tap < 9 ? pixel * units * 16 + c * 2 : pixel * units * 16 + chunks * 16;
  }
  uint8_t* halos = w_s + 64 * k_pad * 2;
  for (int p = t; p < kWarpgroups * kHaloH * kHaloW; p += kThreads) {
    *reinterpret_cast<uint4*>(halos + (p * units + chunks) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait<0>();
  wgmma::proxy_fence();
  __syncthreads();  // the weight, the tables and the first halos are in place

  // this lane's A row: output row oy, column ox of the tile; its K chunk in
  // a k16 step
  const int m = (wt / 32) * 16 + lane % 16;
  const int oy = m / kTW;
  const uint32_t lane_base = halo + (m % kTW) * units * 16;
  const int half = lane / 16;
  const uint64_t w_desc = wgmma::swizzled_descriptor(w_s, 0);
  const int groups = k_pad / 64;

  for (; tile < last; ++tile) {
    const TilePos p = tile_pos(tile, tiles_y, tiles_x);
    const int slot0 = (kTH * p.ty) & (kHaloH - 1);  // 0 or 2
    // the next tile is the one below: its halo shares 2 rows with this
    // one's, and its other 2 go into the slots of this halo's rows 0 and 1
    // as soon as the products no longer read them (after ky = 0 and 1)
    const bool below = tile + 1 < last && p.ty + 1 < tiles_y;
    cp_async_wait<0>();  // this thread's copies of this tile's halo landed
    warpgroup_sync(wg);  // the warpgroup's copies landed
    const int* tbl = table + ((slot0 / 2) * 2 + oy) * row_chunks;
    int refilled = 0;  // rows of the next tile's halo issued
    const auto refill = [&](int k_done) {
      while (below && refilled < 2 && k_done >= 3 * c_in * (refilled + 1)) {
        warpgroup_sync(wg);  // every lane's reads of that row are done
        load_halo_rows(x, p.img, kTH * p.ty + 1, p.x0 - 1, 2 + refilled, 3 + refilled,
                       (slot0 + 2) & (kHaloH - 1), h, wd, c_in, cols, halo);
        cp_async_commit();
        ++refilled;
      }
    };

    float acc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = 0.f;
    wgmma::fence_accumulators(acc);
    // eight k16 steps a commit group, retired before the next group's A
    // registers are loaded: ptxas serializes every product of the register-A
    // form when a fragment is reloaded with a group in flight
    uint32_t frag[kStageGroups][kGroupSteps][4];
    int g = 0;
    for (; g + kStageGroups <= groups; g += kStageGroups) {
#pragma unroll
      for (int q = 0; q < kStageGroups; ++q) load_group(frag[q], tbl, g + q, half, lane_base);
      wgmma::fence();
#pragma unroll
      for (int q = 0; q < kStageGroups; ++q) mma_group(acc, frag[q], g + q, w_desc);
      wgmma::commit();
      wgmma::wait<0>();
      refill(64 * (g + kStageGroups));
    }
    for (; g < groups; ++g) {
      load_group(frag[0], tbl, g, half, lane_base);
      wgmma::fence();
      mma_group(acc, frag[0], g, w_desc);
      wgmma::commit();
      wgmma::wait<0>();
    }
    wgmma::fence_accumulators(acc);
    refill(k_pad);
    warpgroup_sync(wg);  // every read of this halo is done
    if (!below && tile + 1 < last) {  // a new strip: the next tile's whole halo
      const TilePos q = tile_pos(tile + 1, tiles_y, tiles_x);
      load_halo_rows(x, q.img, kTH * q.ty - 1, q.x0 - 1, 0, kHaloH,
                     (kTH * q.ty) & (kHaloH - 1), h, wd, c_in, cols, halo);
      cp_async_commit();
    }

    // bias + ReLU in fp32, rounded once to bf16, stored from the registers:
    // the four lanes of a quad hold 2 channels of each 8 of a row; one
    // transpose among them gives each lane 8 neighbouring channels, one
    // 16-byte store, masked to the image and to C_out (a multiple of 8)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = wgmma::accumulator_row(2 * rh, wt);
      const int iy = kTH * p.ty + row / kTW, ix = p.x0 + row % kTW;
      bf16* dst = out + ((static_cast<int64_t>(p.img) * h + iy) * wd + ix) * c_out + n0;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        uint32_t pairs[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = 4 * (4 * hq + k) + 2 * rh;
          const int n = n0 + wgmma::accumulator_col(r, wt);  // even
          const float2 bn = n < c_out ? *reinterpret_cast<const float2*>(bias + n)
                                      : make_float2(0.f, 0.f);
          pairs[k] = bf16_pair(relu(acc[r] + bn.x), relu(acc[r + 1] + bn.y));
        }
        const uint4 v = quad_transpose(pairs, lane);
        const int c8 = 8 * (4 * hq + (lane & 3));
        if (iy < h && ix < wd && n0 + c8 < c_out) *reinterpret_cast<uint4*>(dst + c8) = v;
      }
    }
  }
  cp_async_wait<0>();
}

int launch(const bf16* x, const bf16* packed, const float* bias, bf16* out, int batch, int h,
           int wd, int c_in, int c_out, int device, cudaStream_t stream) {
  // Set once, at the first launch: never inside a CUDA graph's capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = mma::cols_padded(c_out) / 64;
  const int tiles = batch * ((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW);
  const int blocks = (tiles + kWarpgroups - 1) / kWarpgroups;  // per N tile, at most
  const int per_tile = sms / n_tiles < 1 ? 1 : (sms / n_tiles < blocks ? sms / n_tiles : blocks);
  conv3x3_resident_kernel<<<per_tile * n_tiles, kThreads, smem_bytes(c_in), stream>>>(
      x, packed, bias, out, batch, h, wd, c_in, c_out, n_tiles);
  return last_launch_error();
}

}  // namespace resident

// The route of a shape (dtype 0 fp32, 1 bf16): 0 the fp32 FMA route, 1 the
// bf16 streaming route, 2 the bf16 resident route; -1 none (bf16 channel
// counts not multiples of 8).
int route_of(int dtype, int c_in, int c_out) {
  if (dtype == kFloat32) return 0;
  if (c_in % mma::kChannelMultiple || c_out % mma::kChannelMultiple) return -1;
  return c_in <= resident::kMaxCin ? 2 : 1;
}

// ------------------------------------------------------- wgmma RS probe

// c (64 x 64, fp32) = a (64 x 64) @ b (64 x 64)^T through four k16 products
// of the register-A form: A by ldmatrix_x4 from rows 144 bytes apart (as a
// halo's padded pixels), B in the 128-byte-swizzled layout.
__global__ void __launch_bounds__(128) wgmma_rs_probe_kernel(const bf16* a, const bf16* b,
                                                             float* c) {
  constexpr int kAStride = 144;
  __shared__ __align__(1024) uint8_t raw[8192 + 64 * kAStride];
  uint8_t* sb = raw;
  uint8_t* sa = raw + 8192;
  for (int i = threadIdx.x; i < 64 * 64; i += 128) {
    const int r = i / 64, k = i % 64;
    *reinterpret_cast<bf16*>(sa + r * kAStride + k * 2) = a[i];
    *reinterpret_cast<bf16*>(sb + wgmma::swizzled_offset(r, k / 8) + (k % 8) * 2) = b[i];
  }
  wgmma::proxy_fence();
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32) * 16 + lane % 16;
  uint32_t frag[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wgmma::ldmatrix_x4(frag[s], smem_u32(sa + row * kAStride + s * 32 + (lane / 16) * 16));
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma::fence_accumulators(acc);
  wgmma::fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wgmma::mma_m64n64k16_rs(acc, frag[s], wgmma::swizzled_descriptor(sb, s));
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
    const auto xb = static_cast<const bf16*>(x);
    const auto wb = static_cast<const bf16*>(weight);
    const auto ob = static_cast<bf16*>(out);
    switch (route_of(dtype, c_in, c_out)) {
      case 2:
        return resident::launch(xb, wb, bias, ob, batch, h, w, c_in, c_out, device, s);
      case 1:
        return mma::launch_streaming(xb, wb, bias, ob, positions, h, w, c_in, c_out, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
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

// The route conv3x3_forward takes for (dtype, C_in, C_out): *route 0 the
// fp32 FMA route, 1 the bf16 streaming route, 2 the bf16 resident route.
// ops/kernels.conv3x3_route states the same rule; the smoke compares the
// two. Returns 0, or cudaErrorInvalidValue where no route takes the shape.
int conv3x3_route(int dtype, int c_in, int c_out, int* route) {
  if ((dtype != kFloat32 && dtype != kBFloat16) || c_in < 1 || c_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *route = route_of(dtype, c_in, c_out);
  return *route < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// The largest C_in of the bf16 resident route (beyond it, the streaming
// route).
int conv3x3_resident_max_c_in() { return resident::kMaxCin; }

// c (64, 64) fp32 = a (64, 64) @ b (64, 64)^T, bf16 a and b, through the
// register-A wgmma (wgmma_rs_probe_kernel). Returns 0 or a cudaError_t code.
int conv3x3_wgmma_rs_probe(int device, const void* a, const void* b, void* c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_rs_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(c));
  return last_launch_error();
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
