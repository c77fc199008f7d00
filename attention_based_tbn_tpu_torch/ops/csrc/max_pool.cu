// MaxPool2d(kernel 3, stride 2, padding 0, ceil_mode=True) on NCHW or
// channels-last (NHWC in memory) input, fp32 or bf16, and its gradient; the
// output, the tap codes and the gradient keep the input's memory format.
//
// Replaces the JAX package's ops/pallas_pool.py:ceil_max_pool2d_pallas
// (pallas_call at :88, kernel _pool_kernel at :39): the towers' stride-2
// ceil-mode max pools (stem pool1 and pool2, the passthrough branch of
// inception 3c and 4e). The JAX kernel's VJP is XLA's reduce-window
// gradient (:140-147); here the backward is a kernel too, so a training
// step never runs a second pool to find the winners again.
//
// Bound: pure data movement. Forward: each input element read once, each
// output written once (plus one tap byte per output under autograd);
// backward: the gradient and the taps read once, dx written once. A few
// comparisons per element are nothing against the card's rate, so the bound
// is bytes / HBM bandwidth.
//
// Forward. Ceil mode only shortens the last window of a row or column (2
// taps instead of 3 at even H or W); torch guarantees no window starts past
// the input. Every window keeps its running maximum and its tap (0-8, row-
// major in the 3x3 window) by torch's comparison, v > m || isnan(v): the
// first strict maximum wins and a later NaN replaces it. Taking each input
// row's 3-tap maximum first and then the rows in order gives the same
// winner as scanning the nine taps in order, so both routes combine rows.
// * NCHW: a block owns a band of output rows of one plane, or several whole
//   planes when a plane is small; the input rows it needs are one contiguous
//   run of memory, staged into shared memory with 16-byte cp.async copies
//   (the run's unaligned head and tail element by element); a thread then
//   walks kStrip output rows of two neighbouring columns there, carrying
//   the shared row and reading the shared column once.
// * Channels-last: a thread owns one output column and one 16-byte channel
//   vector (8 bf16 or 4 fp32; one channel when C or the pointers do not
//   allow it) for kBandRows output rows (one row where that would leave
//   fewer than half the threads the card holds), and carries the row that two
//   windows share in registers, so each input row is loaded once per strip
//   and six 16-byte loads are in flight per output row.
// Backward (gather form, no zero-fill pass): each input element (or channel
// vector) sums, in fp32, the gradient of the at most 2 x 2 windows whose tap
// points at it, by output row then output column ascending, and rounds
// once: torch's CUDA backward in the same order, so dx is bit-equal to it.
// Index math is 32-bit; the wrapper refuses tensors of 2^31 elements or
// more. The TPU kernel's whole-image block, even-start selection matmul and
// row loop were Mosaic workarounds and have no counterpart here.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;         // NCHW blocks and the NCHW backward
constexpr int kVecThreads = 128;      // channels-last blocks
constexpr int kTargetBytes = 4096;    // NCHW: outputs per block times their size
constexpr int kStrip = 4;             // NCHW: output rows per thread
constexpr int kBandRows = 4;          // channels-last: output rows per thread
constexpr int kMinThreads = 132 * 2048;  // channels-last: the card's resident threads
constexpr int kMaxGridZ = 65535;
constexpr int kBwdPlanes = 4;         // NCHW backward: planes per thread
constexpr int kMaxSmem = 48 * 1024;   // NCHW staging: the default dynamic limit

__device__ __forceinline__ void take(float v, int tap, float& m, int& t) {
  if (v > m || isnan(v)) {
    m = v;
    t = tap;
  }
}

// The 3-tap (or, at the ceil edge, 2-tap) maxima of one staged row for two
// neighbouring windows (the second only when `two`), which share a column:
// columns 0-2 and 2-4 of p, nx of them in the input.
template <typename T>
__device__ __forceinline__ void shared_row_max(const T* p, int nx, bool two, float (&m)[2],
                                               int (&t)[2]) {
  const float c2 = nx > 2 ? to_float(p[2]) : 0.f;
  m[0] = to_float(p[0]);
  t[0] = 0;
  take(to_float(p[1]), 1, m[0], t[0]);
  if (nx > 2) take(c2, 2, m[0], t[0]);
  m[1] = c2;
  t[1] = 0;
  if (two) {
    take(to_float(p[3]), 1, m[1], t[1]);
    if (nx > 4) take(to_float(p[4]), 2, m[1], t[1]);
  }
}

// One block: `per_block` whole planes (bands == 1), or output rows
// [band * b, band * b + band) of one plane (bands > 1).
template <typename T, bool kTaps>
__global__ void __launch_bounds__(kThreads) ceil_pool_forward_nchw(
    const T* __restrict__ x, T* __restrict__ out, uint8_t* __restrict__ taps, int planes,
    int h, int w, int oh, int ow, int per_block, int bands, int band) {
  extern __shared__ __align__(16) uint8_t pool_smem[];
  int plane0, np, oy0, rows, y0, in_rows;
  if (bands == 1) {
    plane0 = blockIdx.x * per_block;
    np = min(per_block, planes - plane0);
    oy0 = 0;
    rows = oh;
    y0 = 0;
    in_rows = h;
  } else {
    plane0 = blockIdx.x / bands;
    np = 1;
    oy0 = (blockIdx.x % bands) * band;
    rows = min(band, oh - oy0);
    y0 = 2 * oy0;
    in_rows = min(2 * (oy0 + rows - 1) + 3, h) - y0;
  }

  // Stage the run [start, start + count) with the same 16-byte phase in
  // shared memory as in device memory, so the aligned middle moves in
  // 16-byte copies.
  const T* src = x + plane0 * h * w + y0 * w;
  const int count = np * in_rows * w;
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  T* s = reinterpret_cast<T*>(pool_smem + phase);
  const int bytes = count * static_cast<int>(sizeof(T));
  const int head = min(bytes, (16 - phase) & 15);
  const int chunks = (bytes - head) / 16;
  const uint32_t dst = smem_u32(pool_smem + phase + head);
  const uint8_t* from = reinterpret_cast<const uint8_t*>(src) + head;
  for (int i = threadIdx.x; i < chunks; i += kThreads) cp_async16(dst + 16 * i, from + 16 * i, true);
  cp_async_commit();
  const int head_elems = head / static_cast<int>(sizeof(T));
  if (threadIdx.x < head_elems) s[threadIdx.x] = src[threadIdx.x];
  for (int e = (head + 16 * chunks) / static_cast<int>(sizeof(T)) + threadIdx.x; e < count;
       e += kThreads) {
    s[e] = src[e];
  }
  cp_async_wait<0>();
  __syncthreads();

  // Each thread owns two neighbouring output columns of one plane for kStrip
  // output rows and carries the input row that two windows share, as the
  // channels-last kernel does: five shared-memory reads per input row for
  // two outputs.
  const int strips = (rows + kStrip - 1) / kStrip;
  const int pairs = (ow + 1) / 2;
  for (int u = threadIdx.x; u < np * strips * pairs; u += kThreads) {
    const int ox = 2 * (u % pairs);
    const int strip = (u / pairs) % strips;
    const int p = u / (pairs * strips);
    const int r1 = min(strip * kStrip + kStrip, rows);
    const int nx = min(5, w - 2 * ox);  // input columns of the two windows
    const bool two = ox + 1 < ow;
    const T* col = s + p * in_rows * w + 2 * ox;  // input row y at col + (y - y0) * w
    T* dst = out + (plane0 + p) * oh * ow + ox;
    uint8_t* tap_dst = kTaps ? taps + (plane0 + p) * oh * ow + ox : nullptr;
    float carry[2];
    int carry_t[2];
    shared_row_max(col + (2 * (oy0 + strip * kStrip) - y0) * w, nx, two, carry, carry_t);
    for (int oy = oy0 + strip * kStrip; oy < oy0 + r1; ++oy) {
      const int y = 2 * oy;
      float m[2] = {carry[0], carry[1]};
      int t[2] = {carry_t[0], carry_t[1]};
      if (y + 1 < h) {
        float v[2];
        int vt[2];
        shared_row_max(col + (y + 1 - y0) * w, nx, two, v, vt);
#pragma unroll
        for (int k = 0; k < 2; ++k) take(v[k], 3 + vt[k], m[k], t[k]);
      }
      if (y + 2 < h) {
        shared_row_max(col + (y + 2 - y0) * w, nx, two, carry, carry_t);
#pragma unroll
        for (int k = 0; k < 2; ++k) take(carry[k], 6 + carry_t[k], m[k], t[k]);
      }
      dst[oy * ow] = from_float<T>(m[0]);
      if (kTaps) tap_dst[oy * ow] = static_cast<uint8_t>(t[0]);
      if (two) {
        dst[oy * ow + 1] = from_float<T>(m[1]);
        if (kTaps) tap_dst[oy * ow + 1] = static_cast<uint8_t>(t[1]);
      }
    }
  }
}

// VEC consecutive channels of one pixel as one access (16 bytes for T, VEC
// bytes of taps).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int VEC>
struct alignas(VEC) TapPack {
  uint8_t v[VEC];
};

// The 3-tap (or, at the ceil edge, 2-tap) maximum of one input row.
template <typename T, int VEC>
__device__ __forceinline__ void row_max(const T* __restrict__ p, int c, int nx, float (&m)[VEC],
                                        int (&t)[VEC]) {
  const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(p);
  const Pack<T, VEC> b = *reinterpret_cast<const Pack<T, VEC>*>(p + c);
  Pack<T, VEC> d = b;
  if (nx > 2) d = *reinterpret_cast<const Pack<T, VEC>*>(p + 2 * c);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    m[k] = to_float(a.v[k]);
    t[k] = 0;
    take(to_float(b.v[k]), 1, m[k], t[k]);
    if (nx > 2) take(to_float(d.v[k]), 2, m[k], t[k]);
  }
}

// grid (column-vector blocks, bands of `band` output rows, batch rows).
template <typename T, int VEC, bool kTaps>
__global__ void __launch_bounds__(kVecThreads) ceil_pool_forward_nhwc(
    const T* __restrict__ x, T* __restrict__ out, uint8_t* __restrict__ taps, int c, int h,
    int w, int oh, int ow, int band) {
  const int cv = c / VEC;
  const int j = blockIdx.x * kVecThreads + threadIdx.x;
  if (j >= ow * cv) return;
  const int vec = j % cv, ox = j / cv;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * band;
  const int oy1 = min(oy0 + band, oh);
  const int nx = min(3, w - 2 * ox);
  const int row_stride = w * c;
  const T* col = x + (b * h * w + 2 * ox) * c + vec * VEC;

  float carry[VEC];  // row 2 oy: the last row of the previous window
  int carry_t[VEC];
  row_max<T, VEC>(col + 2 * oy0 * row_stride, c, nx, carry, carry_t);
  for (int oy = oy0; oy < oy1; ++oy) {
    const int y = 2 * oy;
    float m[VEC], r1[VEC], r2[VEC];
    int t[VEC], t1[VEC], t2[VEC];
    const bool has1 = y + 1 < h, has2 = y + 2 < h;
    if (has1) row_max<T, VEC>(col + (y + 1) * row_stride, c, nx, r1, t1);
    if (has2) row_max<T, VEC>(col + (y + 2) * row_stride, c, nx, r2, t2);
    Pack<T, VEC> o;
    TapPack<VEC> ot;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      m[k] = carry[k];
      t[k] = carry_t[k];
      if (has1) take(r1[k], 3 + t1[k], m[k], t[k]);
      if (has2) {
        take(r2[k], 6 + t2[k], m[k], t[k]);
        carry[k] = r2[k];
        carry_t[k] = t2[k];
      }
      o.v[k] = from_float<T>(m[k]);
      ot.v[k] = static_cast<uint8_t>(t[k]);
    }
    const int offset = ((b * oh + oy) * ow + ox) * c + vec * VEC;
    *reinterpret_cast<Pack<T, VEC>*>(out + offset) = o;
    if (kTaps) *reinterpret_cast<TapPack<VEC>*>(taps + offset) = ot;
  }
}

// Output rows [lo, hi] and columns whose window holds input row / column v.
__device__ __forceinline__ int first_window(int v) { return v >= 1 ? (v - 1) / 2 : 0; }

// block (32, 8): 32 columns x 8 rows; a thread owns its (y, x) in
// kBwdPlanes planes, and grid z walks the planes (no index division). For
// each plane it loads the tap and the gradient of each of the at most
// 2 x 2 windows that hold (y, x), skipping the window positions that fall
// outside the output; the loops are unrolled, so the loads of all its
// planes (up to 32) can be in flight together.
template <typename T>
__global__ void __launch_bounds__(256) ceil_pool_backward_nchw(
    const T* __restrict__ grad, const uint8_t* __restrict__ taps, T* __restrict__ dx, int planes,
    int h, int w, int oh, int ow) {
  const int xx = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * 8 + threadIdx.y;
  if (xx >= w || y >= h) return;
  const int oy0 = first_window(y), oy1 = min(y / 2, oh - 1);
  const int ox0 = first_window(xx), ox1 = min(xx / 2, ow - 1);
  for (int plane0 = blockIdx.z * kBwdPlanes; plane0 < planes;
       plane0 += gridDim.z * kBwdPlanes) {
    float acc[kBwdPlanes];
#pragma unroll
    for (int k = 0; k < kBwdPlanes; ++k) {
      acc[k] = 0.f;
      if (plane0 + k >= planes) continue;
      const int base = (plane0 + k) * oh * ow;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int oy = oy0 + a, ox = ox0 + b;
          if (oy <= oy1 && ox <= ox1) {
            const int o = base + oy * ow + ox;
            const float g = to_float(grad[o]);
            if (taps[o] == (y - 2 * oy) * 3 + (xx - 2 * ox)) acc[k] += g;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBwdPlanes; ++k) {
      if (plane0 + k < planes) dx[((plane0 + k) * h + y) * w + xx] = from_float<T>(acc[k]);
    }
  }
}

// grid (column-vector blocks, input rows, batch rows).
template <typename T, int VEC>
__global__ void __launch_bounds__(kVecThreads) ceil_pool_backward_nhwc(
    const T* __restrict__ grad, const uint8_t* __restrict__ taps, T* __restrict__ dx, int c,
    int h, int w, int oh, int ow) {
  const int cv = c / VEC;
  const int j = blockIdx.x * kVecThreads + threadIdx.x;
  if (j >= w * cv) return;
  const int vec = j % cv, xx = j / cv;
  const int y = blockIdx.y, b = blockIdx.z;
  const int oy1 = min(y / 2, oh - 1), ox1 = min(xx / 2, ow - 1);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int oy = first_window(y); oy <= oy1; ++oy) {
    for (int ox = first_window(xx); ox <= ox1; ++ox) {
      const int offset = ((b * oh + oy) * ow + ox) * c + vec * VEC;
      const TapPack<VEC> t = *reinterpret_cast<const TapPack<VEC>*>(taps + offset);
      const Pack<T, VEC> g = *reinterpret_cast<const Pack<T, VEC>*>(grad + offset);
      const int want = (y - 2 * oy) * 3 + (xx - 2 * ox);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (t.v[k] == want) acc[k] += to_float(g.v[k]);
      }
    }
  }
  Pack<T, VEC> r;
#pragma unroll
  for (int k = 0; k < VEC; ++k) r.v[k] = from_float<T>(acc[k]);
  *reinterpret_cast<Pack<T, VEC>*>(dx + ((b * h + y) * w + xx) * c + vec * VEC) = r;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, bool kTaps>
int forward_nchw(const T* x, T* out, uint8_t* taps, int planes, int h, int w, int oh, int ow,
                 cudaStream_t stream) {
  constexpr int kTargetOutputs = kTargetBytes / sizeof(T);
  const int per_plane = oh * ow;
  int blocks, per_block = 1, bands = 1, band = oh;
  size_t smem;
  if (per_plane <= kTargetOutputs) {  // whole planes per block
    per_block = kTargetOutputs / per_plane;
    blocks = cdiv(planes, per_block);
    smem = static_cast<size_t>(per_block) * h * w * sizeof(T) + 16;
  } else {  // bands of output rows
    bands = cdiv(oh, max(1, kTargetOutputs / ow));
    band = cdiv(oh, bands);
    bands = cdiv(oh, band);
    blocks = planes * bands;
    smem = static_cast<size_t>(2 * band + 1) * w * sizeof(T) + 16;
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  ceil_pool_forward_nchw<T, kTaps><<<blocks, kThreads, smem, stream>>>(
      x, out, taps, planes, h, w, oh, ow, per_block, bands, band);
  return last_launch_error();
}

template <typename T, int VEC, bool kTaps>
int forward_nhwc(const T* x, T* out, uint8_t* taps, int n, int c, int h, int w, int oh, int ow,
                 cudaStream_t stream) {
  // kBandRows output rows per thread, or one where the strips would number
  // fewer than half the card's resident threads (the small late pools)
  const long long vectors = static_cast<long long>(n) * oh * ow * (c / VEC);
  const int band = vectors / kBandRows >= kMinThreads / 2 ? kBandRows : 1;
  const dim3 grid(cdiv(ow * (c / VEC), kVecThreads), cdiv(oh, band), n);
  ceil_pool_forward_nhwc<T, VEC, kTaps><<<grid, kVecThreads, 0, stream>>>(x, out, taps, c, h, w,
                                                                          oh, ow, band);
  return last_launch_error();
}

template <typename T, bool kTaps>
int forward(const T* x, T* out, uint8_t* taps, int n, int c, int h, int w, int oh, int ow,
            bool channels_last, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!channels_last) return forward_nchw<T, kTaps>(x, out, taps, n * c, h, w, oh, ow, stream);
  if (c % kVec == 0 && aligned16(x) && aligned16(out))
    return forward_nhwc<T, kVec, kTaps>(x, out, taps, n, c, h, w, oh, ow, stream);
  return forward_nhwc<T, 1, kTaps>(x, out, taps, n, c, h, w, oh, ow, stream);
}

template <typename T>
int launch_forward(const void* x, void* out, void* taps, int n, int c, int h, int w, int oh,
                   int ow, bool channels_last, cudaStream_t stream) {
  const T* src = static_cast<const T*>(x);
  T* dst = static_cast<T*>(out);
  uint8_t* t = static_cast<uint8_t*>(taps);
  if (t != nullptr) return forward<T, true>(src, dst, t, n, c, h, w, oh, ow, channels_last, stream);
  return forward<T, false>(src, dst, t, n, c, h, w, oh, ow, channels_last, stream);
}

template <typename T>
int launch_backward(const void* grad, const void* taps, void* dx, int n, int c, int h, int w,
                    int oh, int ow, bool channels_last, cudaStream_t stream) {
  const T* g = static_cast<const T*>(grad);
  const uint8_t* t = static_cast<const uint8_t*>(taps);
  T* d = static_cast<T*>(dx);
  constexpr int kVec = 16 / sizeof(T);
  if (!channels_last) {
    const dim3 grid(cdiv(w, 32), cdiv(h, 8), min(cdiv(n * c, kBwdPlanes), kMaxGridZ));
    ceil_pool_backward_nchw<T><<<grid, dim3(32, 8), 0, stream>>>(g, t, d, n * c, h, w, oh, ow);
  } else if (c % kVec == 0 && aligned16(grad) && aligned16(dx)) {
    const dim3 grid(cdiv(w * (c / kVec), kVecThreads), h, n);
    ceil_pool_backward_nhwc<T, kVec><<<grid, kVecThreads, 0, stream>>>(g, t, d, c, h, w, oh, ow);
  } else {
    const dim3 grid(cdiv(w * c, kVecThreads), h, n);
    ceil_pool_backward_nhwc<T, 1><<<grid, kVecThreads, 0, stream>>>(g, t, d, c, h, w, oh, ow);
  }
  return last_launch_error();
}

}  // namespace

extern "C" {

// x (n, c, h, w) in NCHW or, with channels_last, NHWC memory order; out
// (n, c, oh, ow) and, unless taps is null, taps (n, c, oh, ow) uint8 (the
// winning tap 0-8 of each window) in the same order. Returns 0 or a
// cudaError_t code.
int max_pool_forward(int dtype, int device, const void* x, void* out, void* taps, int n, int c,
                     int h, int w, int oh, int ow, int channels_last, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_forward<__nv_bfloat16>(x, out, taps, n, c, h, w, oh, ow, channels_last, s);
  if (dtype == kFloat32)
    return launch_forward<float>(x, out, taps, n, c, h, w, oh, ow, channels_last, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx (n, c, h, w) from grad and taps (n, c, oh, ow), all in one memory
// order; every element of dx is written. Returns 0 or a cudaError_t code.
int max_pool_backward(int dtype, int device, const void* grad, const void* taps, void* dx, int n,
                      int c, int h, int w, int oh, int ow, int channels_last, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_backward<__nv_bfloat16>(grad, taps, dx, n, c, h, w, oh, ow, channels_last, s);
  if (dtype == kFloat32)
    return launch_backward<float>(grad, taps, dx, n, c, h, w, oh, ow, channels_last, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* max_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
