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
// device scalar: the calibrated amax never leaves the card. Two input
// layouts, each with any batch stride (a channel slice of a wider
// activation): planes (NCHW memory), transposed through shared memory in
// tiles of 64 positions x 32 channels so that the reads (positions) and the
// writes (channels) are both coalesced; or channels contiguous (NHWC
// memory, any pixel stride: cuDNN's channels-last outputs on the card),
// four channels a thread into one 32-bit store. Bound: bytes (one read of
// x, one int8 write).
//
// qconv: implicit-GEMM convolution of the int8 NHWC input with the int8
// (C_out, KH, KW, C_in) weight (K = (ky * KW + kx) * C_in + c contiguous
// per output channel), 1x1 or 3x3, stride 1 or 2, padding 0 or 1, C_in a
// multiple of 32 (every BN-Inception site: 64 ... 1056). GEMM rows are
// output positions, columns output channels. Products run on the int8
// tensor cores by mma.sync.m16n8k32 (s8 x s8 -> s32, exact). A block owns
// 64 positions x 64 channels with four warps of 32 x 32 each; K advances 32
// bytes (one tap's 32 channels) a step through a 3-stage cp.async ring, in
// which zero-filled copies give the convolution's zero padding and the
// ragged edges. Shared rows are padded to 48 bytes, so the fragments'
// 32-bit loads hit 32 distinct banks. The epilogue dequantizes in
// registers: acc * scale[o] + bias[o] as a separate fp32 multiply and add
// (__fmul_rn / __fadd_rn, never contracted to an FMA), so it is bit-equal
// to the plain version's two rounded operations; then ReLU on the output
// channels from relu_from on (the merged 1x1's pool-proj columns, first,
// take none), and one rounding to the compute type, stored NCHW. Bound:
// operations (2 M N K int8 at 1979 TOP/s) at the 3x3 sites, bytes at the
// narrow 1x1 ones. Not yet: wgmma's s8 form, TMA, quantize-on-load.
#include "common.cuh"

namespace {

constexpr int kBM = 64;        // output positions a block
constexpr int kBN = 64;        // output channels a block
constexpr int kBK = 32;        // K bytes a step: one tap's 32 channels
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kRowBytes = 48;  // a 32-byte K row padded against bank conflicts
constexpr int kThreads = 128;

constexpr int kQPix = 64;   // quantize tile: positions
constexpr int kQCh = 32;    // quantize tile: channels
constexpr int kQPitch = 36; // its shared row in bytes (4-byte aligned)
constexpr int kQThreads = 256;

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A (16 x 32, row) * B (32 x 8, col) + D in int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// clamp(rint(v / s), -127, 127) as a byte of a packed word (IEEE division)
__device__ __forceinline__ uint32_t quantize_byte(float v, float s, int shift) {
  v = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return (static_cast<uint32_t>(__float2int_rn(v)) & 0xffu) << shift;
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
  const float s = *x_scale;
  const uint32_t packed = quantize_byte(to_float(src[0]), s, 0) |
                          quantize_byte(to_float(src[1]), s, 8) |
                          quantize_byte(to_float(src[2]), s, 16) |
                          quantize_byte(to_float(src[3]), s, 24);
  *reinterpret_cast<uint32_t*>(out + pixel * c + word * 4) = packed;
}

template <typename Out>
__global__ void __launch_bounds__(kThreads) qconv_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, Out* __restrict__ out, int h, int wd, int c, int c_out,
    int kh, int kw, int stride, int pad, int ho, int wo, long long positions, int relu_from) {
  __shared__ __align__(16) int8_t sa[kStages][kBM * kRowBytes];
  __shared__ __align__(16) int8_t sb[kStages][kBN * kRowBytes];
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int hw_out = ho * wo;

  // this thread's copy slot in every stage: one 16-byte half of one row
  // of the A tile (an output position) and of the B tile (an output channel)
  const int row = tid >> 1, half = tid & 1;
  const long long m = m0 + row;
  const bool m_ok = m < positions;
  int img = 0, oy = 0, ox = 0;
  if (m_ok) {
    img = static_cast<int>(m / hw_out);
    const int p = static_cast<int>(m - static_cast<long long>(img) * hw_out);
    oy = p / wo;
    ox = p - oy * wo;
  }
  const int iy0 = oy * stride - pad, ix0 = ox * stride - pad;
  const int8_t* x_img = x + static_cast<long long>(img) * h * wd * c + half * 16;
  const int o = n0 + row;
  const bool o_ok = o < c_out;
  const int c_steps = c / kBK;
  const int8_t* w_row = w + static_cast<long long>(o_ok ? o : 0) * kh * kw * c + half * 16;
  const int steps = kh * kw * c_steps;

  auto load = [&](int stage, int step) {
    const int tap = step / c_steps;
    const int c0 = (step - tap * c_steps) * kBK;
    const int ky = tap / kw, kx = tap - ky * kw;
    const int iy = iy0 + ky, ix = ix0 + kx;
    const bool a_ok = m_ok && iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const int8_t* a_src = a_ok ? x_img + (static_cast<long long>(iy) * wd + ix) * c + c0 : x;
    cp_async16(smem_u32(&sa[stage][row * kRowBytes + half * 16]), a_src, a_ok);
    const int8_t* b_src = o_ok ? w_row + tap * c + c0 : w;
    cp_async16(smem_u32(&sb[stage][row * kRowBytes + half * 16]), b_src, o_ok);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int stage = step % kStages;
    const int8_t* a_tile = sa[stage];
    const int8_t* b_tile = sb[stage];
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* r = a_tile + (wm * 32 + mt * 16 + g) * kRowBytes + t * 4;
      af[mt][0] = ld_s32(r);
      af[mt][1] = ld_s32(r + 8 * kRowBytes);
      af[mt][2] = ld_s32(r + 16);
      af[mt][3] = ld_s32(r + 8 * kRowBytes + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int8_t* r = b_tile + (wn * 32 + nt * 8 + g) * kRowBytes + t * 4;
      bfr[nt][0] = ld_s32(r);
      bfr[nt][1] = ld_s32(r + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bfr[nt]);
    // the stage computed one step ago: every thread is past it (the barrier above)
    const int next = step + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // accumulator (mt, nt, i): row g (i < 2) or g + 8, column 2 t + (i & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const long long mm = m0 + wm * 32 + mt * 16 + g + hi * 8;
      if (mm >= positions) continue;
      const int im = static_cast<int>(mm / hw_out);
      const int p = static_cast<int>(mm - static_cast<long long>(im) * hw_out);
      Out* dst = out + static_cast<long long>(im) * c_out * hw_out + p;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int oc = n0 + wn * 32 + nt * 8 + t * 2 + j;
          if (oc >= c_out) continue;
          float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][hi * 2 + j]), scale[oc]),
                              bias[oc]);
          if (oc >= relu_from) v = fmaxf(v, 0.f);
          dst[static_cast<long long>(oc) * hw_out] = from_float<Out>(v);
        }
      }
    }
  }
}

template <typename In>
int launch_quantize(const In* x, const float* x_scale, int8_t* out, int batch, int c, int hw,
                    int channels_last, long long pixel_stride, long long batch_stride,
                    cudaStream_t s) {
  if (channels_last) {
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

}  // namespace

extern "C" {

// x: (batch, c, h, w), fp32 (dtype 0) or bf16 (1), batch stride
// `batch_stride` elements; channels_last 0: each (n, c) plane contiguous;
// 1: channels contiguous, `pixel_stride` elements from one position to the
// next. x_scale: one fp32 on the card; out: (batch, h, w, c) int8. c a
// multiple of 32, batch <= 65535 (checked by the caller). Returns 0 or a
// cudaError_t code.
int quantize_forward(int dtype, int device, const void* x, const float* x_scale, void* out,
                     int batch, int c, int hw, int channels_last, long long pixel_stride,
                     long long batch_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c % kQCh || batch < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<int8_t*>(out);
  if (dtype == kFloat32) {
    return launch_quantize(static_cast<const float*>(x), x_scale, q, batch, c, hw, channels_last,
                           pixel_stride, batch_stride, s);
  }
  if (dtype == kBFloat16) {
    return launch_quantize(static_cast<const __nv_bfloat16*>(x), x_scale, q, batch, c, hw,
                           channels_last, pixel_stride, batch_stride, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (batch, h, w, c) int8 NHWC; weight: (c_out, kh, kw, c) int8; scale,
// bias: (c_out,) fp32; out: (batch, c_out, ho, wo) NCHW in fp32 (dtype 0)
// or bf16 (1). c a multiple of 32, kh = kw in {1, 3} (checked by the
// caller). Returns 0 or a cudaError_t code.
int qconv_forward(int dtype, int device, const void* x, const void* weight, const float* scale,
                  const float* bias, void* out, int batch, int h, int w, int c, int c_out, int kh,
                  int kw, int stride, int pad, int ho, int wo, int relu_from, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c % kBK || c_out < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long positions = static_cast<long long>(batch) * ho * wo;
  const long long tiles = (positions + kBM - 1) / kBM;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), (c_out + kBN - 1) / kBN);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xq = static_cast<const int8_t*>(x);
  const auto wq = static_cast<const int8_t*>(weight);
  if (dtype == kFloat32) {
    qconv_kernel<float><<<grid, kThreads, 0, s>>>(xq, wq, scale, bias, static_cast<float*>(out),
                                                  h, w, c, c_out, kh, kw, stride, pad, ho, wo,
                                                  positions, relu_from);
  } else if (dtype == kBFloat16) {
    qconv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        xq, wq, scale, bias, static_cast<__nv_bfloat16*>(out), h, w, c, c_out, kh, kw, stride,
        pad, ho, wo, positions, relu_from);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return last_launch_error();
}

const char* qconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
