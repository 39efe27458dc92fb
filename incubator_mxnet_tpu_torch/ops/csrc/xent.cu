// Fused softmax cross-entropy, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of incubator_mxnet_tpu/ops/pallas_kernels.py:
//   xent_fwd_kernel <- _xent_fwd / _xent_fwd_kernel: per row of the (N, V)
//                      logits, lse = logsumexp(row) and
//                      loss = lse - row[label]; lse is saved for the
//                      backward;
//   xent_bwd_kernel <- _xent_bwd_call / _xent_bwd_kernel:
//                      dlogits = (exp(row - lse) - onehot(label)) * dloss,
//                      the softmax recomputed from the saved lse.
// Neither writes the (N, V) softmax: the forward leaves two floats a row,
// the backward writes only dlogits.
//
// What bounds them on an H100: bytes. The forward reads each logit once
// (4096 x 32000 float32 in the train step: 524 MB, 156 us at 3.35 TB/s)
// for about 1.25 exponentials and a few adds per element; the backward
// reads the logits and writes dlogits once (twice the bytes) for one
// exponential per element. Both are far below the card's ratio of
// operations to bytes.
//
// Design. The TPU kernel holds a whole (8, V) tile in VMEM; that block
// structure is not carried over. The forward gives each row one block of
// 256 threads. Each thread walks the row with a stride of the block,
// kLoads 16-byte loads in flight, and keeps its own online (max, sum of
// exp) pair: a group of values first takes its own max, then joins the
// running pair with one rescale. The pairs merge by warp shuffles, then
// across the 8 warps through shared memory; thread 0 writes lse and reads
// logits[row, label] itself. The backward is elementwise over a 2-D grid
// (rows x chunks of V), so the 4096 x 8 blocks of the train step fill the
// 132 SMs; each thread owns kLoads 16-byte groups of its chunk. All math
// is float32 for float32 and bfloat16 logits alike; dlogits is stored in
// the logits' type (bfloat16 rounded to nearest even).
//
// A label outside [0, V) matches no column, as `iota == label` does in the
// TPU kernel: its loss is lse and its dlogits carry no one-hot term.
// 16-byte loads are used only when every row starts 16-byte aligned
// (V and the row stride multiples of 4 floats or 8 bfloat16, the base
// address aligned); otherwise each thread reads one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // loads in flight per thread
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&x)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Online softmax state: running max m and sum s of exp(x - m). The empty
// state is (-FLT_MAX, 0), finite so that merging two empty states gives no
// NaN and a -inf logit adds exp(-inf) = 0.
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <int W>
__device__ __forceinline__ void accumulate(float& m, float& s,
                                           const float (&x)[W]) {
  float cm = x[0];
#pragma unroll
  for (int i = 1; i < W; ++i) cm = fmaxf(cm, x[i]);
  const float mn = fmaxf(m, cm);
  float add = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) add += expf(x[i] - mn);
  s = s * expf(m - mn) + add;
  m = mn;
}

// Merges every thread's (m, s) into thread 0's.
__device__ __forceinline__ void block_merge(float& m, float& s) {
  __shared__ float warp_m[kWarps], warp_s[kWarps];
#pragma unroll
  for (int off = 16; off; off >>= 1)
    merge(m, s, __shfl_xor_sync(kFullMask, m, off),
          __shfl_xor_sync(kFullMask, s, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_m[warp] = m;
    warp_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_m[lane] : -FLT_MAX;
    s = lane < kWarps ? warp_s[lane] : 0.f;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      merge(m, s, __shfl_xor_sync(kFullMask, m, off),
            __shfl_xor_sync(kFullMask, s, off));
  }
}

// One block per row. kVec: 16-byte loads (V % Vec<T>::n == 0 and aligned
// rows), else one element per load.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ logits, int64_t row_stride,
                    const int* __restrict__ labels, float* __restrict__ loss,
                    float* __restrict__ lse, int vocab) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * row_stride;
  float m = -FLT_MAX, s = 0.f;
  constexpr int W = kVec ? Vec<T>::n : 1;
  const int groups = vocab / W;  // vocab % W == 0 when kVec
  for (int base = threadIdx.x; base < groups; base += kThreads * kLoads) {
    float v[kLoads][W];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * kThreads;
      if (i < groups) {
        if constexpr (kVec)
          load_vec(x + int64_t(i) * W, v[u]);
        else
          v[u][0] = to_f32(x[i]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (base + u * kThreads < groups) accumulate<W>(m, s, v[u]);
  }
  block_merge(m, s);
  if (threadIdx.x == 0) {
    const float l = m + logf(s);
    const int label = labels[row];
    const float picked =
        (label >= 0 && label < vocab) ? to_f32(x[label]) : 0.f;
    loss[row] = l - picked;
    lse[row] = l;
  }
}

// blockIdx.x: row; blockIdx.y: chunk of kThreads * kLoads groups of the
// row. dlogits is contiguous (N, V).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ logits, int64_t row_stride,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ dloss, T* __restrict__ dlogits,
                    int vocab) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * row_stride;
  T* g = dlogits + row * int64_t(vocab);
  const float l = lse[row], d = dloss[row];
  const int label = labels[row];
  constexpr int W = kVec ? Vec<T>::n : 1;
  const int groups = vocab / W;
  const int first = blockIdx.y * (kThreads * kLoads) + threadIdx.x;
  float v[kLoads][W];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = first + u * kThreads;
    if (i < groups) {
      if constexpr (kVec)
        load_vec(x + int64_t(i) * W, v[u]);
      else
        v[u][0] = to_f32(x[i]);
    }
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = first + u * kThreads;
    if (i >= groups) continue;
#pragma unroll
    for (int e = 0; e < W; ++e)
      v[u][e] = (expf(v[u][e] - l) - (i * W + e == label ? 1.f : 0.f)) * d;
    if constexpr (kVec)
      store_vec(g + int64_t(i) * W, v[u]);
    else
      store(g + i, v[u][0]);
  }
}

// True when every row of `logits` starts on a 16-byte boundary.
template <typename T>
bool vector_rows(const void* logits, int64_t row_stride, int vocab) {
  constexpr int W = Vec<T>::n;
  return vocab % W == 0 && row_stride % W == 0 &&
         reinterpret_cast<uintptr_t>(logits) % 16 == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* logits, int64_t row_stride,
                       const void* labels, void* loss, void* lse, int rows,
                       int vocab, cudaStream_t s) {
  const auto* x = static_cast<const T*>(logits);
  const auto* lab = static_cast<const int*>(labels);
  auto* out = static_cast<float*>(loss);
  auto* l = static_cast<float*>(lse);
  if (vector_rows<T>(logits, row_stride, vocab))
    xent_fwd_kernel<T, true><<<rows, kThreads, 0, s>>>(x, row_stride, lab,
                                                       out, l, vocab);
  else
    xent_fwd_kernel<T, false><<<rows, kThreads, 0, s>>>(x, row_stride, lab,
                                                        out, l, vocab);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* logits, int64_t row_stride,
                       const void* labels, const void* lse,
                       const void* dloss, void* dlogits, int rows, int vocab,
                       cudaStream_t s) {
  const auto* x = static_cast<const T*>(logits);
  const auto* lab = static_cast<const int*>(labels);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(dloss);
  auto* g = static_cast<T*>(dlogits);
  const bool vec = vector_rows<T>(logits, row_stride, vocab) &&
                   reinterpret_cast<uintptr_t>(dlogits) % 16 == 0;
  const int groups = vec ? vocab / Vec<T>::n : vocab;
  constexpr int kChunk = kThreads * kLoads;  // groups a block covers
  const dim3 grid(rows, (groups + kChunk - 1) / kChunk);
  if (vec)
    xent_bwd_kernel<T, true><<<grid, kThreads, 0, s>>>(x, row_stride, lab, l,
                                                       d, g, vocab);
  else
    xent_bwd_kernel<T, false><<<grid, kThreads, 0, s>>>(x, row_stride, lab,
                                                        l, d, g, vocab);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the logits' element type). logits is
// (rows, vocab) with unit column stride and `row_stride` elements between
// rows; labels is (rows,) int32; loss and lse are (rows,) float32. Every
// pointer is device memory; nothing is allocated and nothing
// synchronises. Returns the launch's cudaError_t (0 on success).
extern "C" int mxtpu_softmax_xent_fwd(int dtype, const void* logits,
                                      int64_t row_stride, const void* labels,
                                      void* loss, void* lse, int rows,
                                      int vocab, void* stream) {
  if (rows < 0 || vocab < 1 || row_stride < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(logits, row_stride, labels, loss, lse, rows,
                             vocab, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(logits, row_stride, labels, loss, lse,
                                     rows, vocab, s);
  return cudaErrorInvalidValue;
}

// logits and labels as for mxtpu_softmax_xent_fwd; lse and dloss are
// (rows,) float32; dlogits is a contiguous (rows, vocab) tensor of the
// logits' type.
extern "C" int mxtpu_softmax_xent_bwd(int dtype, const void* logits,
                                      int64_t row_stride, const void* labels,
                                      const void* lse, const void* dloss,
                                      void* dlogits, int rows, int vocab,
                                      void* stream) {
  if (rows < 0 || vocab < 1 || row_stride < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(logits, row_stride, labels, lse, dloss, dlogits,
                             rows, vocab, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(logits, row_stride, labels, lse, dloss,
                                     dlogits, rows, vocab, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
