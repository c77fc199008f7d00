// Segment consensus fused with the classifier heads: per clip, the float32
// mean of (N, F) features over N, then each head's logits
// pooled @ W_h^T + b_h, all heads in one launch.
//
// Replaces the JAX package's ops/pallas_kernels.py:consensus_heads_pallas
// (pallas_call at :299; reference consensus_heads_reference at :264).
//
// Input: features (B, N, F) float32 or bfloat16 (the Fusion output, B clips
// of N segment rows, or N = 10 x segments under 10-crop); per head a
// (C_h, F) weight in torch layout and a (C_h,) bias, in the features' type.
// Output: one float32 buffer holding each head's (B, C_h) logits in turn
// (head h from B * (C_0 + .. + C_{h-1})). At bfloat16 the numerics are the
// JAX model's fast_consensus (models/tbn.py:430-440) with TorchLinear heads
// (models/layers.py:624-625): the fp32 mean rounded to bf16, products of
// bf16 operands accumulated in fp32, the product rounded to bf16, the sum
// with the bias rounded again, returned as float32. At float32 every step
// is float32 and nothing is rounded.
//
// Bound: bytes. Each feature is read once and each weight once per clip,
// 2 * (F + C) operations per feature row: far below the card's ridge point,
// and at the evaluation's shapes ((2, 250, 512) features, 477 classes) 0.3
// microseconds of traffic, so the launch and the cluster barriers are the
// floor; one launch for all heads is the design's point.
//
// Design: one launch, one thread-block cluster of kCluster = 8 blocks (the
// portable size) per clip: grid (8, B), cluster (8, 1, 1), launched by
// cudaLaunchKernelEx (capturable in a CUDA graph).
// 1. Block r of the cluster sums rows [r N / 8, (r + 1) N / 8) of its clip
//    (none when N < 8 leaves it without a row): 16-byte loads of 8 bf16 or
//    4 fp32 features a thread, neighbouring threads on neighbouring
//    features, 256 / (F / 8) rows in flight (4 at F = 512 bf16), then the
//    row slots summed in slot order into the block's partial sum, which it
//    writes into slot r of every block's shared memory through distributed
//    shared memory (stores: nothing waits on them). A block may touch
//    another's shared memory only once that block is known to have started:
//    every block arrives at a cluster barrier on entry (relaxed) and waits
//    on it just before these stores, so step 1's loads overlap the start-up.
// 2. A second cluster barrier (arrive with release, wait with acquire):
//    every block then holds all 8 partial sums, adds them in rank order, so
//    each forms the same fp32 sum, divides by N and rounds the mean to the
//    features' type. No block touches another's memory after the barrier,
//    so none has to wait for the others before it exits.
// 3. Block r takes classes [r C / 8, (r + 1) C / 8) of the heads' C
//    concatenated classes: a warp kBatch = 8 class rows at a time (the
//    first batch's biases and first two 16-byte chunks a lane, all of a
//    512-wide bf16 row, loaded before step 1 so that the loads overlap
//    steps 1 and 2), lanes on 16-byte chunks of the rows with every row's
//    load in flight together, fp32 FMAs against the mean, shuffle
//    reductions; lane q adds row q's bias with the two roundings and
//    writes the logit. The choice of 16-byte loads is a template
//    parameter: behind a run-time branch each load waited for the one
//    before.
// Every feature is read once from device memory, each weight row once per
// clip. A 16-byte load needs F a multiple of 8 (bf16) or 4 (fp32) and
// 16-byte aligned features and weights; otherwise the same loop reads one
// element at a time. The TPU kernel's batch tiles and _pad_batch were
// Mosaic constraints and have no counterpart here.
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFeatures = 4096;  // 144 KB of shared memory at most
constexpr int kMaxHeads = 4;
constexpr int kCluster = 8;  // blocks per clip: the portable cluster size
constexpr int kBatch = 8;    // class rows a warp reads at a time

// The cluster barrier in two halves (barrier.cluster): arrive releases this
// thread's writes to shared memory (the relaxed form orders nothing: the
// start-up barrier, which only says that every block of the cluster runs);
// wait returns once every thread of the cluster arrived, and acquires their
// writes.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
struct Heads {
  const T* weight[kMaxHeads];
  const T* bias[kMaxHeads];
  int classes[kMaxHeads];
  int total;  // classes of all heads
};

// Elements of T in 16 bytes: 8 bf16 or 4 fp32.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// v = elements [j kVec, (j + 1) kVec) of a row of f, widened to fp32: one
// 16-byte load when kVecLoads (f a multiple of kVec, the row 16-byte
// aligned), else one element at a time, zero past f. A compile-time choice:
// behind a run-time branch, each load would wait for the one before.
template <typename T, bool kVecLoads>
__device__ __forceinline__ void load_vec(const T* __restrict__ row, int j, int f,
                                         float (&v)[kVec<T>]) {
  if constexpr (kVecLoads) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + j);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec<T>; ++i) v[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec<T>; ++i) {
      const int k = j * kVec<T> + i;
      v[i] = k < f ? to_float(row[k]) : 0.f;
    }
  }
}

// Classes base .. base + kBatch - 1 of the heads' concatenation: each one's
// weight row, its bias (widened) and its logit's place in out, -1 (and row
// 0 of the first head) past c1. The heads' fields are read at fixed
// indices, so the parameter struct is not copied to local memory.
template <typename T>
__device__ __forceinline__ void decode_batch(const Heads<T>& heads, int base, int c1, int f,
                                             int b, const T* (&rows)[kBatch],
                                             float (&bias)[kBatch], int (&index)[kBatch]) {
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const bool valid = base + q < c1;
    int c = valid ? base + q : 0, before = 0, classes = heads.classes[0];
    const T* weight = heads.weight[0];
    const T* bias_h = heads.bias[0];
#pragma unroll
    for (int k = 1; k < kMaxHeads; ++k) {
      if (c >= classes) {
        c -= classes;
        before += classes;
        classes = heads.classes[k];
        weight = heads.weight[k];
        bias_h = heads.bias[k];
      }
    }
    rows[q] = weight + static_cast<int64_t>(c) * f;
    bias[q] = valid ? to_float(bias_h[c]) : 0.f;
    index[q] = valid ? static_cast<int>(gridDim.y) * before + b * classes + c : -1;
  }
}

// kN (a multiple of 4) floats of shared memory at p (16-byte aligned) in
// float4 reads: a lane's 8 floats are 32 bytes apart from its neighbour's,
// so one float read at a time would hit each bank 8 times.
template <int kN>
__device__ __forceinline__ void read4(const float* p, float (&v)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

template <int kN>
__device__ __forceinline__ void write4(float* p, const float (&v)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// Shared memory of a block, in floats: every block's partial sum, then the
// row slots' sums (at most kThreads x 8 floats: slots x F <= kThreads x
// kVec), later the mean.
__host__ __device__ __forceinline__ int smem_floats(int f) {
  return kCluster * f + (f > kThreads * 8 ? f : kThreads * 8);
}

template <typename T, bool kVecLoads>
__global__ void __launch_bounds__(kThreads)
consensus_heads_kernel(const T* __restrict__ x, Heads<T> heads, float* __restrict__ out, int n,
                       int f) {
  constexpr int kN = kVec<T>;
  extern __shared__ __align__(16) float consensus_smem[];
  float* gathered = consensus_smem;               // [kCluster][f]: the blocks' partial sums
  float* pooled = consensus_smem + kCluster * f;  // the row slots' sums, then the mean
  cluster_arrive_relaxed();  // this block runs: waited on before any remote store
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int t = threadIdx.x;

  // this warp's first kBatch classes: their rows, biases (loaded now, while
  // the rows are summed) and places in out
  const int warp = t / 32, lane = t % 32;
  const int c1 = (rank + 1) * heads.total / kCluster;
  int base = rank * heads.total / kCluster + warp * kBatch;
  const T* rows[kBatch];
  float bias[kBatch];
  int index[kBatch];  // the logit's place in out, -1 past this block's classes
  decode_batch(heads, base, c1, f, b, rows, bias, index);
  // and their first two 16-byte chunks a lane (all of a 512-wide bf16
  // row), loaded now, so that the loads overlap steps 1 and 2
  uint4 early[kBatch][2];
  if constexpr (kVecLoads) {
    const int vecs = (f + kN - 1) / kN;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        early[q][e] = j < vecs ? __ldg(reinterpret_cast<const uint4*>(rows[q]) + j)
                               : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // 1. this block's share of the rows: slot s sums rows row0 + s, + slots, ...
  const T* xb = x + static_cast<int64_t>(b) * n * f;
  const int vecs = (f + kN - 1) / kN;  // per row
  const int slots = vecs < kThreads ? kThreads / vecs : 1;
  const int slot = t / vecs;
  const int row0 = rank * n / kCluster, row1 = (rank + 1) * n / kCluster;
  if (slot < slots) {
    for (int j = t % vecs; j < vecs; j += kThreads) {
      float sum[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) sum[i] = 0.f;
#pragma unroll 8
      for (int row = row0 + slot; row < row1; row += slots) {
        float v[kN];
        load_vec<T, kVecLoads>(xb + static_cast<int64_t>(row) * f, j, f, v);
#pragma unroll
        for (int i = 0; i < kN; ++i) sum[i] += v[i];
      }
      if constexpr (kVecLoads) {
        write4(pooled + slot * f + j * kN, sum);
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          if (j * kN + i < f) pooled[slot * f + j * kN + i] = sum[i];
        }
      }
    }
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster runs: its shared memory may be written
  // the slots' sums in slot order: this block's partial sum, written into
  // every block's gathered[rank] through distributed shared memory
  for (int i = t; i < f; i += kThreads) {
    float sum = 0.f;
    for (int s = 0; s < slots; ++s) sum += pooled[s * f + i];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) cluster.map_shared_rank(gathered, r)[rank * f + i] = sum;
  }
  cluster_arrive();  // this block's writes are released...
  cluster_wait();    // ...and every block's have landed here; none follow

  // 2. the partial sums in rank order: the same mean in every block
  for (int i = t; i < f; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) sum += gathered[r * f + i];
    pooled[i] = round_to<T>(sum / static_cast<float>(n));
  }
  __syncthreads();

  // 3. this block's share of the classes (the first batch's rows already
  // on their way): each warp kBatch classes at a time
  bool first = true;
  for (; base < c1; base += kWarps * kBatch, first = false) {
    float dot[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) dot[q] = 0.f;
    int j0 = lane;
    if (kVecLoads && first) {  // the chunks loaded early
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (lane + 32 * e < vecs) {
#pragma unroll
          float p[kN];
          read4(pooled + (lane + 32 * e) * kN, p);
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            const T* w = reinterpret_cast<const T*>(&early[q][e]);
#pragma unroll
            for (int i = 0; i < kN; ++i) dot[q] = fmaf(p[i], to_float(w[i]), dot[q]);
          }
        }
      }
      j0 = lane + 64;
    }
#pragma unroll 2
    for (int j = j0; j < vecs; j += 32) {
      float v[kBatch][kN];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) load_vec<T, kVecLoads>(rows[q], j, f, v[q]);
      float p[kN];
      if constexpr (kVecLoads) {
        read4(pooled + j * kN, p);
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i) p[i] = j * kN + i < f ? pooled[j * kN + i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) {
#pragma unroll
        for (int q = 0; q < kBatch; ++q) dot[q] = fmaf(p[i], v[q][i], dot[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
#pragma unroll
      for (int delta = 16; delta > 0; delta >>= 1) {
        dot[q] += __shfl_xor_sync(0xffffffffu, dot[q], delta);
      }
    }
    if (lane < kBatch) {
      float logit = 0.f;
      int at = -1;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (q == lane) {
          logit = round_to<T>(round_to<T>(dot[q]) + bias[q]);
          at = index[q];
        }
      }
      if (at >= 0) out[at] = logit;
    }
    decode_batch(heads, base + kWarps * kBatch, c1, f, b, rows, bias, index);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool kVecLoads>
int launch_cluster(const T* x, const Heads<T>& heads, float* out, int batch, int n, int f,
                   cudaStream_t stream) {
  // Set once, at the first launch: never inside a CUDA graph's capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      consensus_heads_kernel<T, kVecLoads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(kMaxFeatures) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, batch, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem_floats(f) * sizeof(float);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = kCluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, consensus_heads_kernel<T, kVecLoads>, x, heads, out, n, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return last_launch_error();
}

template <typename T>
int launch(const void* x, const void* const* weights, const void* const* biases, void* out,
           const int* classes, int count, int batch, int n, int f, cudaStream_t stream) {
  Heads<T> heads{};
  bool vec = f % kVec<T> == 0 && aligned16(x);
  for (int h = 0; h < count; ++h) {
    heads.weight[h] = static_cast<const T*>(weights[h]);
    heads.bias[h] = static_cast<const T*>(biases[h]);
    heads.classes[h] = classes[h];
    heads.total += classes[h];
    vec = vec && aligned16(weights[h]);
  }
  const auto xt = static_cast<const T*>(x);
  const auto o = static_cast<float*>(out);
  return vec ? launch_cluster<T, true>(xt, heads, o, batch, n, f, stream)
             : launch_cluster<T, false>(xt, heads, o, batch, n, f, stream);
}

}  // namespace

extern "C" {

// x (batch, n, f), weights[h] (classes[h], f) and biases[h] (classes[h],)
// of type dtype, h < count; out (sum of batch * classes[h]) float32, head h's
// (batch, classes[h]) logits after the earlier heads'. 1 <= f <=
// consensus_heads_max_features(), 1 <= count <= consensus_heads_max_heads(),
// n >= 1, batch <= 65535 (checked by the caller). Returns 0 or a
// cudaError_t code.
int consensus_heads_forward(int dtype, int device, const void* x, const void* const* weights,
                            const void* const* biases, void* out, const int* classes, int count,
                            int batch, int n, int f, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 1 || count > kMaxHeads || f < 1 || f > kMaxFeatures || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(x, weights, biases, out, classes, count, batch, n, f, s);
  }
  if (dtype == kFloat32) {
    return launch<float>(x, weights, biases, out, classes, count, batch, n, f, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int consensus_heads_max_features() { return kMaxFeatures; }

int consensus_heads_max_heads() { return kMaxHeads; }

int consensus_heads_cluster() { return kCluster; }

const char* consensus_heads_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
