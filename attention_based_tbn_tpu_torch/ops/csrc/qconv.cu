// The int8 compute path of BN-Inception's towers at inference
// (tpu.quantize=int8): two kernels.
//
// Replaces XLA's s8 x s8 -> s32 convolution of the JAX package's
// models/layers.py:conv2d_apply_q (:54; routed by route_qconv, :102). That
// is not a pallas_call: the TPU path is XLA's own int8 convolution with the
// quantize before it and the dequantize after it as separate passes (XLA
// fused no epilogue into the s8 convolution, layers.py:71-76). torch has no
// CUDA int8 convolution, so both halves are written here.
//
// quantize: a float32 or bf16 (B, C, H, W) activation -> int8 NHWC
// (channels contiguous), q = clamp(rint(x / x_scale), -127, 127) with IEEE
// division and round half to even, as jnp.round. x_scale is read from a
// device scalar: the calibrated amax never leaves the card. Bound: bytes
// (one read of x, one int8 write). Three routes, by x's memory (the wrapper
// picks one: kernels.quantize_route), each with any batch stride (a channel
// slice of a wider activation):
//   channels: channels contiguous at a pixel stride of 16 bytes' multiple
//     from a 16-byte aligned start (the towers' channels-last blocks):
//     one elementwise pass, 16 channels a thread (16-byte loads, one
//     16-byte store), a grid-stride loop of a few blocks a SM;
//   channels_narrow: channels contiguous otherwise (4-element aligned), four
//     channels a thread into one 32-bit store;
//   planes: NCHW memory (the Flow stem's pool1 output), transposed through
//     shared memory in tiles of 64 positions x 32 channels so that the reads
//     (positions) and the writes (channels) are both coalesced.
//
// qconv: implicit-GEMM convolution of the int8 NHWC input with the int8
// (C_out, KH, KW, C_in) weight, C_in a multiple of 32. GEMM rows are output
// positions, columns output channels, K = (tap, channel). Products: wgmma's
// s8 form (m64nNk32, s32 accumulators, both operands K-major in 64-byte-
// swizzled shared memory; wgmma.cuh), exact. N is a multiple of 32 from 64
// to 256, chosen by C_out (kernels.qconv_plan: 544 -> 3 x 192).
//
// Walk. Persistent: one block a SM keeps one N tile and walks M boxes of up
// to 64 output positions. Its two consumer warpgroups take alternate boxes,
// each fed by its own ring of 5 stages and its own producer warp, and their
// mainloops take turns (an mbarrier each), so one's epilogue runs under the
// other's products. A stage is signalled by mbarriers (full: TMA's bytes
// landed; empty: the warpgroup retired its products), and one commit group
// stays in flight (wait<1>). K runs (tap, 64-channel chunk). Where the N
// tile's whole weight fits in shared memory (kernels.QCONV_RESIDENT_B_BYTES:
// the big early sites) it is loaded once a block and a stage holds two
// chunks' input boxes (4 k32 products); otherwise a stage holds one chunk's
// input box and weight tile. K is padded to whole stages with boxes out of
// bounds (TMA's zeros), and every chunk issues both its k32 products: a
// conditional wgmma serialized the products (the mainloop 2.7x slower on
// an H100 at the largest 1x1 site). The products wasted on zeros: the
// padding step of an odd step count, and half of each tap's last chunk
// where C_in is 32 past a multiple of 64 (96, 160, 224: 25%, 17%, 12.5% of
// those sites' products).
//
// Operand loads by TMA, tiled tensor maps made per call on the host
// (cuTensorMapEncodeTiled, reached in libcuda by dlsym), passed as
// __grid_constant__ parameters. The input map is 4-D over the NHWC tensor
// (C, W, H, B); a box is box_w x box_h output positions of box_i images,
// and each tap shifts the box's input corner by (kx - pad, ky - pad): TMA's
// out-of-bounds zero fill gives the convolution's zero padding and the
// ragged edges, and element strides of 2 on W and H give the stride-2 sites
// (3c and 4e). A 1x1 / stride-1 site is a plain GEMM: the "flat" plan maps
// the B H W positions as one row of an image (box 64 x 1 x 1). The weight
// map is 3-D (C_in, taps, C_out), box (64, 1, N). Chosen over the im2col
// tensor map: the tiled map is the same code for every site, and its boxes
// are the tile geometry the epilogue decodes. Rows of a box past the tile's
// positions (box_w box_h box_i < 64, an image's edge) are masked in the
// epilogue. 64-byte rows, not 128: a tap's 64 channels (C_in 64 at the
// largest sites) fill them.
//
// Epilogue. The dequantize in registers: acc * scale[o] + bias[o] as a
// separate fp32 multiply and add (__fmul_rn / __fadd_rn, never contracted
// to an FMA), bit-equal to the plain version's two rounded operations;
// ReLU on the output channels from relu_from on (the merged 1x1's
// pool-proj columns, first, take none); one rounding to the compute type.
// Each warp then stages its 16 rows, 32 columns at a time, through a slab
// in shared memory and writes them channels-last, 16 channels a lane
// (16-byte stores), into up to four column segments that the caller
// passes, each on a 32-channel boundary, with any pixel stride: a float
// segment in the compute type (a channel slice of the block's output
// buffer, or a scratch tensor), or an int8 segment quantized for the next
// site, q = clamp(rint(v / x_scale), -127, 127) with __fdiv_rn, v the value
// after its rounding to the compute type (what the JAX package quantizes)
// and x_scale that site's calibrated scale read from the card. So a tensor
// that only the next int8 site reads is never written in float. Bound:
// bytes at the 1x1 sites and at the 3x3 ones (their float output);
// operations (2 M N K int8 at 1979 TOP/s) come close only at wide 3x3
// sites.
#include <dlfcn.h>

#include <cstdio>

#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// --------------------------------------------------------------- quantize

constexpr int kQPix = 64;    // planes tile: positions
constexpr int kQCh = 32;     // planes tile: channels
constexpr int kQPitch = 36;  // its shared row in bytes (4-byte aligned)
constexpr int kQThreads = 256;
constexpr int kQVec = 16;       // channels a thread on the channels route
constexpr int kQBlocksPerSm = 8;  // the channels route's grid-stride loop

enum QuantizeRoute : int { kPlanes = 0, kChannels = 1, kChannelsNarrow = 2 };

// clamp(rint(v / s), -127, 127) as a byte of a packed word (IEEE division).
// A zero (half a ReLU's output) is 0 without dividing: the division's
// range check sends a zero dividend down its slow path.
__device__ __forceinline__ uint32_t quantize_byte(float v, float s, int shift) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v == 0.f ? s : v, s)), -127.f), 127.f);
  return v == 0.f ? 0u : (static_cast<uint32_t>(__float2int_rn(q)) & 0xffu) << shift;
}

__device__ __forceinline__ uint32_t quantize_word(const float* v, float s) {
  return quantize_byte(v[0], s, 0) | quantize_byte(v[1], s, 8) | quantize_byte(v[2], s, 16) |
         quantize_byte(v[3], s, 24);
}

// 16 consecutive values from a 16-byte aligned p, widened to fp32.
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ uint4 quantize16(const float (&v)[16], float s) {
  return make_uint4(quantize_word(v, s), quantize_word(v + 4, s), quantize_word(v + 8, s),
                    quantize_word(v + 12, s));
}

template <typename In>
__global__ void __launch_bounds__(kQThreads) quantize_kernel(
    const In* __restrict__ x, const float* __restrict__ x_scale, int8_t* __restrict__ out,
    int c, int hw, long long batch_stride) {
  __shared__ __align__(16) int8_t tile[kQPix * kQPitch];
  const int p0 = blockIdx.x * kQPix;
  const int c0 = blockIdx.y * kQCh;
  const long long img = blockIdx.z;
  const float s = *x_scale;
  const In* src = x + img * batch_stride + static_cast<long long>(c0) * hw;
  for (int i = threadIdx.x; i < kQPix * kQCh; i += kQThreads) {
    const int ch = i / kQPix, p = i - ch * kQPix;
    uint32_t q = 0;
    if (p0 + p < hw) {
      q = quantize_byte(to_float(src[static_cast<long long>(ch) * hw + p0 + p]), s, 0);
    }
    tile[p * kQPitch + ch] = static_cast<int8_t>(q);
  }
  __syncthreads();
  int8_t* dst = out + (img * hw + p0) * c + c0;
  for (int i = threadIdx.x; i < kQPix * (kQCh / 4); i += kQThreads) {
    const int p = i / (kQCh / 4), word = i - p * (kQCh / 4);
    if (p0 + p < hw) {
      *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(p) * c + word * 4) =
          *reinterpret_cast<const uint32_t*>(tile + p * kQPitch + word * 4);
    }
  }
}

template <typename In>
__global__ void __launch_bounds__(kQThreads) quantize_vec_kernel(
    const In* __restrict__ x, const float* __restrict__ x_scale, int8_t* __restrict__ out,
    int c, long long hw, long long pixel_stride, long long batch_stride, long long units) {
  const float s = *x_scale;
  const int per_pixel = c / kQVec;
  for (long long i = static_cast<long long>(blockIdx.x) * kQThreads + threadIdx.x; i < units;
       i += static_cast<long long>(gridDim.x) * kQThreads) {
    const long long pixel = i / per_pixel;
    const int unit = static_cast<int>(i - pixel * per_pixel);
    const long long img = pixel / hw;
    float v[16];
    load16(x + img * batch_stride + (pixel - img * hw) * pixel_stride + unit * kQVec, v);
    *reinterpret_cast<uint4*>(out + pixel * c + unit * kQVec) = quantize16(v, s);
  }
}

template <typename In>
__global__ void __launch_bounds__(kQThreads) quantize_nhwc_kernel(
    const In* __restrict__ x, const float* __restrict__ x_scale, int8_t* __restrict__ out,
    int c, long long hw, long long pixel_stride, long long batch_stride, long long words) {
  const long long i = static_cast<long long>(blockIdx.x) * kQThreads + threadIdx.x;
  if (i >= words) return;
  const int per_pixel = c / 4;
  const long long pixel = i / per_pixel;
  const int word = static_cast<int>(i - pixel * per_pixel);
  const long long img = pixel / hw;
  const In* src = x + img * batch_stride + (pixel - img * hw) * pixel_stride + word * 4;
  const float v[4] = {to_float(src[0]), to_float(src[1]), to_float(src[2]), to_float(src[3])};
  *reinterpret_cast<uint32_t*>(out + pixel * c + word * 4) = quantize_word(v, *x_scale);
}

int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (!counts[device]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      return 132;
    }
    counts[device] = n;
  }
  return counts[device];
}

template <typename In>
int launch_quantize(const In* x, const float* x_scale, int8_t* out, int batch, int c, int hw,
                    int route, long long pixel_stride, long long batch_stride, int device,
                    cudaStream_t s) {
  if (route == kChannels) {
    const long long units = static_cast<long long>(batch) * hw * (c / kQVec);
    const long long needed = (units + kQThreads - 1) / kQThreads;
    const long long blocks =
        needed < static_cast<long long>(sm_count(device)) * kQBlocksPerSm
            ? needed : static_cast<long long>(sm_count(device)) * kQBlocksPerSm;
    quantize_vec_kernel<In><<<static_cast<unsigned>(blocks), kQThreads, 0, s>>>(
        x, x_scale, out, c, hw, pixel_stride, batch_stride, units);
  } else if (route == kChannelsNarrow) {
    const long long words = static_cast<long long>(batch) * hw * (c / 4);
    const long long blocks = (words + kQThreads - 1) / kQThreads;
    quantize_nhwc_kernel<In><<<static_cast<unsigned>(blocks), kQThreads, 0, s>>>(
        x, x_scale, out, c, hw, pixel_stride, batch_stride, words);
  } else {
    const dim3 grid((hw + kQPix - 1) / kQPix, c / kQCh, batch);
    quantize_kernel<In><<<grid, kQThreads, 0, s>>>(x, x_scale, out, c, hw, batch_stride);
  }
  return last_launch_error();
}

// ------------------------------------------------------------------ qconv

constexpr int kRows = 64;                     // output positions a box: one warpgroup's tile
constexpr int kKBytes = wgmma::kRow64Bytes;   // K bytes a step: 64 channels of one tap
constexpr int kRings = 2;                     // consumer warpgroups, each on its own boxes
constexpr int kConsumers = 128 * kRings;
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup (a warp a ring)
constexpr int kATileBytes = kRows * kKBytes;  // 4 KB
constexpr int kStages = 5;                    // a ring's depth
constexpr int kMaxN = 256;
constexpr int kMaxSegments = 4;
constexpr int kUnit = 16;                     // output channels a store: 16-byte stores
constexpr int kSegmentBoundary = 32;          // segments start on 32-channel boundaries
// The epilogue's slab per consumer warp: its 16 rows x 32 columns in fp32,
// rows 8 floats apart in banks (the accumulators' float2 writes of 4 rows
// fall on distinct banks).
constexpr int kSlabRows = 16;
constexpr int kSlabPitch = 32 + 8;
constexpr int kSlabFloats = kSlabRows * kSlabPitch;
constexpr int kSlabBytes = (kConsumers / 32) * kSlabFloats * 4;
constexpr int kParamBytes = 2 * kMaxN * 4;    // the N tile's scale and bias
constexpr int kSmemLimit = 232448 - 1024;     // a block's dynamic shared memory, with margin

// Error codes past cudaError_t's range (qconv_error_string).
constexpr int kNoEncoder = 1 << 20;
constexpr int kEncodeFailed = (1 << 20) + 1024;  // + the CUresult

// The tile walk of one launch.
struct Geometry {
  int images, ho, wo;         // the output grid the boxes cover (flat: 1 x 1 x B H W)
  int box_w, box_h, box_i;    // a block's box of output positions
  int tiles_w, tiles_h;       // boxes along W and H
  int n_tiles;                // N tiles along C_out
  int m_tiles;                // M boxes
  int kw, taps, c_chunks;     // K: taps x 64-channel chunks
  int c_in, c_out, stride, pad, relu_from, bf16_out;
};

// The output's column segments, in column order: [end[k - 1], end[k]).
struct Segments {
  int count;
  int end[kMaxSegments];
  int int8[kMaxSegments];           // 1: quantized for the next site
  long long stride[kMaxSegments];   // elements from one position to the next
  void* out[kMaxSegments];          // the segment's element (0, 0, 0, 0)
  const float* x_scale[kMaxSegments];
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Until the phase of parity `parity` of the barrier has completed. A wait
// that outlasts kMaxPolls polls (seconds; a ring step takes microseconds)
// traps, so a fault in the transaction counts fails the launch instead of
// hanging the card.
constexpr long long kMaxPolls = 1LL << 28;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  long long polls = 0;
  do {
    if (++polls > kMaxPolls) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// The consumer warpgroups' own barrier (the producer never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Shared memory: two rings (one a consumer warpgroup) of kStages x [A box
// (+ B tile, streamed)], the consumer warps' slabs, the N tile's scale and
// bias, then (resident) every K step's B tile of the block's N tile, iters
// x N x 64 bytes, loaded once.
template <int BN, bool kResident>
struct QTile {
  // K steps a stage: two 64-channel chunks (4 k32 products) with B resident,
  // one with B streamed beside them. In flight, a ring holds kStages x
  // kChunks input boxes of 4 KB: the loads are latency-bound, so deep.
  static constexpr int kChunks = kResident ? 2 : 1;
  static constexpr int kBTileBytes = BN * kKBytes;
  static constexpr int kStageBytes = kChunks * kATileBytes + (kResident ? 0 : kBTileBytes);
  static constexpr int kSlabOffset = kRings * kStages * kStageBytes;
  static constexpr int kParamOffset = kSlabOffset + kSlabBytes;
  static constexpr int kResidentOffset = kParamOffset + kParamBytes;
  static constexpr int kFixedSmem = kResidentOffset + 1024;  // + the 1024-byte alignment
  static_assert(BN % kSegmentBoundary == 0 && BN >= 64 && BN <= kMaxN, "N: 64 ... 256 by 32");
  static_assert(kStageBytes % 1024 == 0 && kSlabBytes % 1024 == 0 && kParamBytes % 1024 == 0,
                "tiles on 1024 bytes");
  static_assert(kFixedSmem <= kSmemLimit, "a block's shared memory on the H100");
};

// The origin of M box m.
struct Origin {
  int ox0, oy0, img0;
};

__device__ __forceinline__ Origin box_origin(const Geometry& g, int m) {
  Origin o;
  o.ox0 = m % g.tiles_w * g.box_w;
  o.oy0 = m / g.tiles_w % g.tiles_h * g.box_h;
  o.img0 = m / (g.tiles_w * g.tiles_h) * g.box_i;
  return o;
}

// The output position of row r of a tile's box, -1 past the box or the output.
__device__ __forceinline__ long long row_position(const Geometry& g, const Origin& o, int r) {
  const int plane = g.box_w * g.box_h;
  if (r >= plane * g.box_i) return -1;
  const int bi = r / plane;
  const int y = (r - bi * plane) / g.box_w;
  const int x = r - bi * plane - y * g.box_w;
  const int img = o.img0 + bi, oy = o.oy0 + y, ox = o.ox0 + x;
  if (img >= g.images || oy >= g.ho || ox >= g.wo) return -1;
  return (static_cast<long long>(img) * g.ho + oy) * g.wo + ox;
}

// 16 channels from column n on of output position p into their segment.
__device__ __forceinline__ void store_unit(const Segments& segs, int bf16_out, long long p,
                                           int n, const float (&v)[16]) {
  int k = 0;
  while (k + 1 < segs.count && n >= segs.end[k]) ++k;
  const long long at = p * segs.stride[k] + (n - (k ? segs.end[k - 1] : 0));
  if (segs.int8[k]) {
    *reinterpret_cast<uint4*>(static_cast<int8_t*>(segs.out[k]) + at) =
        quantize16(v, *segs.x_scale[k]);
  } else if (bf16_out) {
    uint4 packed[2];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    uint4* dst = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(segs.out[k]) + at);
    dst[0] = packed[0];
    dst[1] = packed[1];
  } else {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(segs.out[k]) + at);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  }
}

// Persistent: a block keeps one N tile (blockIdx.x % n_tiles) and walks
// the M boxes blockIdx.x / n_tiles, + per_n, ...; its two consumer
// warpgroups take alternate boxes, each fed by its own ring and producer
// warp, so one's epilogue overlaps the other's products, and the producers
// run ahead into the next boxes.
template <int BN, bool kResident>
__global__ void __launch_bounds__(kThreads, 1) qconv_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ scale, const float* __restrict__ bias, const Geometry g,
    const Segments segs) {
  using T = QTile<BN, kResident>;
  extern __shared__ uint8_t qconv_smem_raw[];
  __shared__ __align__(8) uint64_t full[kRings][kStages];
  __shared__ __align__(8) uint64_t empty[kRings][kStages];
  __shared__ __align__(8) uint64_t b_full;
  __shared__ __align__(8) uint64_t turn[kRings];  // whose mainloop is next
  uint8_t* smem = wgmma::align_1024(qconv_smem_raw);
  uint8_t* b_resident = smem + T::kResidentOffset;
  // K steps, padded to whole stages: a step past the last reads a box out of
  // bounds (TMA's zeros), so every stage issues the same products, without a
  // branch around them (a conditional wgmma serializes the products)
  const int iters = g.taps * g.c_chunks;
  const int padded = (iters + T::kChunks - 1) / T::kChunks * T::kChunks;
  const int per_n = gridDim.x / g.n_tiles;
  const int n0 = (blockIdx.x % g.n_tiles) * BN;
  const int first = blockIdx.x / g.n_tiles;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < kRings; ++r) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[r][s], 1);
        mbar_init(&empty[r][s], 128);
      }
    }
    mbar_init(&b_full, 1);
#pragma unroll
    for (int r = 0; r < kRings; ++r) mbar_init(&turn[r], 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producers: lane 0 of warp r keeps ring r's TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ring = (threadIdx.x - kConsumers) / 32;
    if (ring < kRings && threadIdx.x % 32 == 0) {
      if (kResident && ring == 0) {  // the N tile's whole B, once
        mbar_expect_tx(&b_full, static_cast<uint32_t>(padded) * T::kBTileBytes);
        for (int k = 0; k < padded; ++k) {
          const int tap = k < iters ? k / g.c_chunks : 0;
          const int c0 = k < iters ? (k - tap * g.c_chunks) * kKBytes : g.c_chunks * kKBytes;
          tma_load_3d(b_resident + k * T::kBTileBytes, &w_map, &b_full, c0, tap, n0);
        }
      }
      const uint32_t box_bytes = kKBytes * g.box_w * g.box_h * g.box_i;
      uint8_t* ring_base = smem + ring * kStages * T::kStageBytes;
      int it = 0;
      for (int m = first + ring * per_n; m < g.m_tiles; m += kRings * per_n) {
        const Origin o = box_origin(g, m);
        for (int k0 = 0; k0 < padded; k0 += T::kChunks, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[ring][s], ((it / kStages) & 1) ^ 1);
          uint8_t* stage = ring_base + s * T::kStageBytes;
          mbar_expect_tx(&full[ring][s],
                         T::kChunks * box_bytes + (kResident ? 0 : T::kBTileBytes));
          for (int j = 0; j < T::kChunks; ++j) {
            const int k = k0 + j;
            const int tap = k < iters ? k / g.c_chunks : 0;
            const int c0 = k < iters ? (k - tap * g.c_chunks) * kKBytes : g.c_chunks * kKBytes;
            const int ky = tap / g.kw, kx = tap - ky * g.kw;
            tma_load_4d(stage + j * kATileBytes, &x_map, &full[ring][s], c0,
                        o.ox0 * g.stride - g.pad + kx, o.oy0 * g.stride - g.pad + ky, o.img0);
            if (!kResident) {
              tma_load_3d(stage + kATileBytes, &w_map, &full[ring][s], c0, tap, n0);
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int ring = threadIdx.x / 128;  // this warpgroup's ring and boxes
    const int warp = t / 32, lane = t % 32;
    float* slab = reinterpret_cast<float*>(smem + T::kSlabOffset) + (ring * 4 + warp) * kSlabFloats;
    float* n_scale = reinterpret_cast<float*>(smem + T::kParamOffset);
    float* n_bias = n_scale + kMaxN;
    for (int c = threadIdx.x; c < BN; c += kConsumers) {
      n_scale[c] = n0 + c < g.c_out ? scale[n0 + c] : 0.f;
      n_bias[c] = n0 + c < g.c_out ? bias[n0 + c] : 0.f;
    }
    consumers_sync();
    const uint8_t* ring_base = smem + ring * kStages * T::kStageBytes;
    if (kResident) mbar_wait(&b_full, 0);
    int it = 0, box = 0;
    for (int m = first + ring * per_n; m < g.m_tiles; m += kRings * per_n, ++box) {
      const Origin o = box_origin(g, m);
      // The warpgroups' mainloops take turns (ring 0 first), so one's
      // epilogue runs under the other's products.
      mbar_wait(&turn[ring], (box & 1) ^ (ring == 0));
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      // one commit group in flight: a stage is released once the group
      // after it has been issued and its own has retired
      int held = -1;
      for (int k0 = 0; k0 < padded; k0 += T::kChunks, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[ring][s], (it / kStages) & 1);
        const uint8_t* stage = ring_base + s * T::kStageBytes;
        wgmma::fence_accumulators(acc);
        wgmma::fence();
#pragma unroll
        for (int j = 0; j < T::kChunks; ++j) {
          const uint8_t* a = stage + j * kATileBytes;
          const uint8_t* b =
              kResident ? b_resident + (k0 + j) * T::kBTileBytes : stage + kATileBytes;
#pragma unroll
          for (int step = 0; step < kKBytes / 32; ++step) {
            wgmma::mma_s8<BN>(acc, wgmma::swizzled64_descriptor(a, step),
                              wgmma::swizzled64_descriptor(b, step));
          }
        }
        wgmma::commit();
        wgmma::wait<1>();
        wgmma::fence_accumulators(acc);
        if (held >= 0) mbar_arrive(&empty[ring][held]);
        held = s;
      }
      mbar_arrive(&turn[(ring + 1) % kRings]);
      wgmma::wait<0>();
      wgmma::fence_accumulators(acc);
      mbar_arrive(&empty[ring][held]);

      // Epilogue: dequantize + bias, ReLU, one rounding to the compute type
      // in registers; then per warp (its 16 rows), in chunks of 32 columns
      // through its slab, each lane writes 16 channels of one row into their
      // segment.
      float v[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int col = wgmma::accumulator_col(i, lane);
        const float2 sc = *reinterpret_cast<const float2*>(n_scale + col);
        const float2 bi = *reinterpret_cast<const float2*>(n_bias + col);
        v[i] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), sc.x), bi.x);
        v[i + 1] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i + 1]), sc.y), bi.y);
        if (n0 + col >= g.relu_from) v[i] = fmaxf(v[i], 0.f);
        if (n0 + col + 1 >= g.relu_from) v[i + 1] = fmaxf(v[i + 1], 0.f);
      }
      if (g.bf16_out) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) v[i] = round_to<__nv_bfloat16>(v[i]);
      }
      const long long row_p = lane < kSlabRows ? row_position(g, o, warp * kSlabRows + lane)
                                               : -1;
      const long long p = __shfl_sync(0xffffffffu, row_p, lane / 2);
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
#pragma unroll
        for (int i = 16 * q; i < 16 * q + 16; i += 2) {
          const int r = wgmma::accumulator_row(i, lane);  // the warp's rows: 0 ... 15
          const int col = wgmma::accumulator_col(i, lane) - 32 * q;
          *reinterpret_cast<float2*>(slab + r * kSlabPitch + col) = make_float2(v[i], v[i + 1]);
        }
        __syncwarp();
        const int n = n0 + 32 * q + kUnit * (lane % 2);
        if (p >= 0 && n < g.c_out) {
          float u[16];
          load16(slab + (lane / 2) * kSlabPitch + kUnit * (lane % 2), u);
          store_unit(segs, g.bf16_out, p, n, u);
        }
        __syncwarp();
      }
    }
  }
}

template <int BN, bool kResident>
int launch_qconv(const CUtensorMap& x_map, const CUtensorMap& w_map, const float* scale,
                 const float* bias, const Geometry& g, const Segments& segs, int smem,
                 int blocks, cudaStream_t s) {
  // Set once, at the first launch: never inside a CUDA graph's capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      qconv_kernel<BN, kResident>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  qconv_kernel<BN, kResident><<<blocks, kThreads, smem, s>>>(x_map, w_map, scale, bias, g,
                                                             segs);
  return last_launch_error();
}

template <int BN>
int launch_qconv(bool resident, const CUtensorMap& x_map, const CUtensorMap& w_map,
                 const float* scale, const float* bias, const Geometry& g, const Segments& segs,
                 int blocks, cudaStream_t s) {
  const int iters = g.taps * g.c_chunks;
  if (resident) {
    const int padded = (iters + QTile<BN, true>::kChunks - 1) / QTile<BN, true>::kChunks *
                       QTile<BN, true>::kChunks;
    const int smem = QTile<BN, true>::kFixedSmem + padded * QTile<BN, true>::kBTileBytes;
    if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    return launch_qconv<BN, true>(x_map, w_map, scale, bias, g, segs, smem, blocks, s);
  }
  return launch_qconv<BN, false>(x_map, w_map, scale, bias, g, segs,
                                 QTile<BN, false>::kFixedSmem, blocks, s);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda the process has loaded (no link
// against libcuda, whatever the toolkit's version).
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// An int8 tiled map with the 64-byte swizzle; dims and boxes innermost
// first, strides in bytes from dimension 1 on.
int encode_map(CUtensorMap* map, cuuint32_t rank, const void* base, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box, const cuuint32_t* elements) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kNoEncoder;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base),
                            dims, strides, box, elements, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// ---------------------------------------------------- the s8 product probe

// c (64 x N, s32) = a (64 x 128) @ b (N x 128)^T, int8 row-major: each
// staged by thread stores as two 64-byte-swizzled K tiles (the kernel's
// layout), two k32 steps each.
template <int N>
__global__ void __launch_bounds__(128) s8_probe_kernel(const int8_t* __restrict__ a,
                                                      const int8_t* __restrict__ b,
                                                      int* __restrict__ c) {
  extern __shared__ uint8_t probe_smem_raw[];
  uint8_t* sa = wgmma::align_1024(probe_smem_raw);  // K tiles of A: 64 x 64 bytes each
  uint8_t* sb = sa + 2 * 64 * kKBytes;              // K tiles of B: N x 64 bytes each
  for (int i = threadIdx.x; i < (64 + N) * 8; i += 128) {
    const int row = i / 8, chunk = i % 8;  // a row's 16-byte chunk: K tile chunk / 4
    const bool in_a = row < 64;
    const int r = in_a ? row : row - 64;
    const uint4 v = reinterpret_cast<const uint4*>(in_a ? a : b)[r * 8 + chunk];
    uint8_t* tile = in_a ? sa + (chunk / 4) * 64 * kKBytes : sb + (chunk / 4) * N * kKBytes;
    *reinterpret_cast<uint4*>(tile + wgmma::swizzled64_offset(r, chunk % 4)) = v;
  }
  wgmma::proxy_fence();
  __syncthreads();
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  wgmma::fence_accumulators(acc);
  wgmma::fence();
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      wgmma::mma_s8<N>(acc, wgmma::swizzled64_descriptor(sa + kt * 64 * kKBytes, step),
                       wgmma::swizzled64_descriptor(sb + kt * N * kKBytes, step));
    }
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_accumulators(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    c[wgmma::accumulator_row(i, threadIdx.x) * N + wgmma::accumulator_col(i, threadIdx.x)] =
        acc[i];
  }
}

template <int N>
int launch_probe(const int8_t* a, const int8_t* b, int* c, cudaStream_t s) {
  s8_probe_kernel<N><<<1, 128, 2 * (64 + N) * kKBytes + 1024, s>>>(a, b, c);
  return last_launch_error();
}

}  // namespace

extern "C" {

// x: (batch, c, h, w), fp32 (dtype 0) or bf16 (1), batch stride
// `batch_stride` elements; route 0 (planes): each (n, c) plane contiguous;
// 1 (channels) and 2 (channels_narrow): channels contiguous, `pixel_stride`
// elements from one position to the next (route 1: x and the pixel stride
// on 16 bytes). x_scale: one fp32 on the card; out: (batch, h, w, c) int8.
// c a multiple of 32, batch <= 65535 (checked by the caller). Returns 0 or
// a cudaError_t code.
int quantize_forward(int dtype, int device, const void* x, const float* x_scale, void* out,
                     int batch, int c, int hw, int route, long long pixel_stride,
                     long long batch_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c % kQCh || batch < 1 || hw < 1 || route < kPlanes || route > kChannelsNarrow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<int8_t*>(out);
  if (dtype == kFloat32) {
    return launch_quantize(static_cast<const float*>(x), x_scale, q, batch, c, hw, route,
                           pixel_stride, batch_stride, device, s);
  }
  if (dtype == kBFloat16) {
    return launch_quantize(static_cast<const __nv_bfloat16*>(x), x_scale, q, batch, c, hw, route,
                           pixel_stride, batch_stride, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (batch, h, w, c) int8 NHWC contiguous; weight: (c_out, k, k, c) int8
// contiguous; scale, bias: (c_out,) fp32; the output in fp32 (dtype 0) or
// bf16 (1). plan: {N tile, box_w, box_h, box_i, flat, resident}
// (kernels.qconv_plan; flat: a 1x1 / stride-1 / pad-0 site walked as one
// row of B H W positions; resident: the N tile's whole B kept in shared
// memory, iters x N x 64 bytes at most qconv_resident_b_limit()).
// segments: n_segments x {end column, int8 flag, pointer, pixel stride in
// elements, x_scale pointer (int8 segments)}, in column order, each a
// multiple of 32 columns, the last ending at c_out; the pointers and pixel
// strides on 16 bytes (checked by the caller, with the shapes). Returns 0
// or an error code (qconv_error_string).
int qconv_forward(int device, const void* x, const void* weight, const float* scale,
                  const float* bias, int batch, int h, int w, int c, int c_out, int k,
                  int stride, int pad, int ho, int wo, int relu_from, int dtype, const int* plan,
                  int n_segments, const long long* segments, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bn = plan[0], box_w = plan[1], box_h = plan[2], box_i = plan[3], flat = plan[4];
  const bool resident = plan[5] != 0;
  const int rows = box_w * box_h * box_i;
  if (c % kSegmentBoundary || c_out < 1 || batch < 1 || k < 1 || stride < 1 || stride > 2 ||
      n_segments < 1 || n_segments > kMaxSegments || rows < 1 || rows > kRows ||
      box_w * stride > 256 || box_h * stride > 256 || box_i > 256 ||
      (dtype != kFloat32 && dtype != kBFloat16) ||
      (flat && (k != 1 || stride != 1 || pad != 0 || box_h != 1 || box_i != 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.images = flat ? 1 : batch;
  g.ho = flat ? 1 : ho;
  g.wo = flat ? batch * ho * wo : wo;
  g.box_w = box_w;
  g.box_h = box_h;
  g.box_i = box_i;
  g.tiles_w = (g.wo + box_w - 1) / box_w;
  g.tiles_h = (g.ho + box_h - 1) / box_h;
  g.n_tiles = (c_out + bn - 1) / bn;
  g.kw = k;
  g.taps = k * k;
  g.c_chunks = (c + kKBytes - 1) / kKBytes;
  g.c_in = c;
  g.c_out = c_out;
  g.stride = stride;
  g.pad = pad;
  g.relu_from = relu_from;
  g.bf16_out = dtype == kBFloat16;
  const long long m_tiles =
      static_cast<long long>(g.tiles_w) * g.tiles_h * ((g.images + box_i - 1) / box_i);
  if (m_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  g.m_tiles = static_cast<int>(m_tiles);
  // persistent: per_n blocks on each N tile (a box for each ring at
  // least), one block a SM
  const int per_n_sms = sm_count(device) / g.n_tiles > 1 ? sm_count(device) / g.n_tiles : 1;
  const int per_n_boxes = (g.m_tiles + kRings - 1) / kRings;
  const int per_n = per_n_boxes < per_n_sms ? per_n_boxes : per_n_sms;
  const int blocks = per_n * g.n_tiles;

  Segments segs;
  segs.count = n_segments;
  for (int i = 0; i < n_segments; ++i) {
    const long long* seg = segments + 5 * i;
    segs.end[i] = static_cast<int>(seg[0]);
    segs.int8[i] = static_cast<int>(seg[1]);
    segs.out[i] = reinterpret_cast<void*>(seg[2]);
    segs.stride[i] = seg[3];
    segs.x_scale[i] = reinterpret_cast<const float*>(seg[4]);
    if (segs.end[i] % kSegmentBoundary || (i && segs.end[i] <= segs.end[i - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (segs.end[n_segments - 1] != c_out) return static_cast<int>(cudaErrorInvalidValue);

  // input: (C, W, H, B) with the box of one block at each tap; the flat
  // walk sees the B H W positions as one image row
  const cuuint64_t in_w = flat ? static_cast<cuuint64_t>(batch) * h * w : w;
  const cuuint64_t in_h = flat ? 1 : h, in_b = flat ? 1 : batch;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(c), in_w, in_h, in_b};
  const cuuint64_t x_strides[3] = {static_cast<cuuint64_t>(c), in_w * c, in_h * in_w * c};
  const cuuint32_t x_box[4] = {kKBytes, static_cast<cuuint32_t>(box_w * stride),
                               static_cast<cuuint32_t>(box_h * stride),
                               static_cast<cuuint32_t>(box_i)};
  const cuuint32_t x_elements[4] = {1, static_cast<cuuint32_t>(stride),
                                    static_cast<cuuint32_t>(stride), 1};
  CUtensorMap x_map, w_map;
  int status = encode_map(&x_map, 4, x, x_dims, x_strides, x_box, x_elements);
  if (status) return status;
  // weight: (C_in, taps, C_out), box (64, 1, N)
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(k * k),
                                static_cast<cuuint64_t>(c_out)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(c),
                                   static_cast<cuuint64_t>(k) * k * c};
  const cuuint32_t w_box[3] = {kKBytes, 1, static_cast<cuuint32_t>(bn)};
  const cuuint32_t w_elements[3] = {1, 1, 1};
  status = encode_map(&w_map, 3, weight, w_dims, w_strides, w_box, w_elements);
  if (status) return status;

  const auto s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return launch_qconv<64>(resident, x_map, w_map, scale, bias, g, segs, blocks, s);
    case 96: return launch_qconv<96>(resident, x_map, w_map, scale, bias, g, segs, blocks, s);
    case 128: return launch_qconv<128>(resident, x_map, w_map, scale, bias, g, segs, blocks, s);
    case 160: return launch_qconv<160>(resident, x_map, w_map, scale, bias, g, segs, blocks, s);
    case 192: return launch_qconv<192>(resident, x_map, w_map, scale, bias, g, segs, blocks, s);
    case 224: return launch_qconv<224>(resident, x_map, w_map, scale, bias, g, segs, blocks, s);
    case 256: return launch_qconv<256>(resident, x_map, w_map, scale, bias, g, segs, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a: (64, 128), b: (n, 128) int8 contiguous on the card; c: (64, n) int32,
// a @ b^T by four m64nNk32 products from 64-byte-swizzled K tiles; n in
// 64, 96, ..., 256.
int qconv_wgmma_probe(int device, int n, const void* a, const void* b, void* c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto pa = static_cast<const int8_t*>(a);
  const auto pb = static_cast<const int8_t*>(b);
  const auto pc = static_cast<int*>(c);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 64: return launch_probe<64>(pa, pb, pc, s);
    case 96: return launch_probe<96>(pa, pb, pc, s);
    case 128: return launch_probe<128>(pa, pb, pc, s);
    case 160: return launch_probe<160>(pa, pb, pc, s);
    case 192: return launch_probe<192>(pa, pb, pc, s);
    case 224: return launch_probe<224>(pa, pb, pc, s);
    case 256: return launch_probe<256>(pa, pb, pc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bytes of B the resident plan may keep in shared memory (the budget
// beside the ring and the slabs; kernels.QCONV_RESIDENT_B_BYTES).
int qconv_resident_b_limit() { return kSmemLimit - QTile<64, true>::kFixedSmem; }

const char* qconv_error_string(int err) {
  static thread_local char message[96];
  if (err == kNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err >= kEncodeFailed) {
    snprintf(message, sizeof message, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - kEncodeFailed);
    return message;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
