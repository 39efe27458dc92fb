// FlashAttention-2, forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces three TPU kernels of incubator_mxnet_tpu/ops/pallas_kernels.py:
//   flash_fwd_kernel <- _flash_fwd / _fwd_kernel: o and the row logsumexp
//                       by an online softmax over key tiles;
//   flash_dq_kernel  <- _flash_bwd's first call / _dq_kernel:
//                       dq = sum_k ds * K, with p recomputed from lse;
//   flash_dkv_kernel <- _flash_bwd's second call / _dkv_kernel:
//                       dv = sum_q p^T * dO and dk = sum_q ds^T * Q.
// with s = q.k * scale (masked with -1e30 after the scale when causal),
// p = exp(s - lse), dp = dO.v and ds = p * (dp - delta) * scale, where
// delta = rowsum(dO * O) is computed outside the kernels, as in JAX.
//
// What bounds them on an H100: operations. Per causal (query row, key)
// pair the forward does 4 * D operations (q.k and p * v), dQ 6 * D and
// dK/dV 8 * D, while the bytes are a few D-wide rows per row of the
// sequence. At the training shape (B 8, H 8, T 512, D 64, float32) the
// forward does about 64 operations per byte it must move, the backward
// more, all above the card's float32 ratio of 20 (67 TFLOP/s over
// 3.35 TB/s).
//
// Design. One block of 256 threads per (batch * head, tile of 64 rows):
// query rows for the forward and dQ, key rows for dK/dV. Each kernel is a
// chain of small matrix products over tiles staged in shared memory as
// float32, the way a SIMT GEMM is written: the block's 64 x 64 score tile
// (and the 64 x D output tile) is split into a 16 x 16 grid of threads,
// each owning 4 rows x 4 scores (4 x D/16 outputs) in registers, so every
// float4 read from shared memory feeds 4 to 16 FMAs. A product that sums
// over D reads both operands transposed ([D][64], staged once per tile);
// one that sums over the walked rows reads p or ds (written to shared
// memory transposed by the threads that computed them) and a row-major
// tile. The row max and the row sum of the online softmax are 16-lane
// shuffle reductions (the 16 threads of a row are half a warp); each
// thread keeps its own partial row sum until the end.
//
// Causal walks stop at the diagonal: the forward and dQ walk key tiles up
// to the block's last query row, and dK/dV walks query tiles from the
// block's first key row on. Longest walks are scheduled first. There are
// no atomics: each output row is written by the one block that owns it, so
// results are deterministic, as in the TPU design.
//
// Ragged ends: any T runs the kernels. Keys at or past T are masked, rows
// at or past T are staged as zeros, give p = 0 and are never written, so
// the port needs neither the JAX adapter's padding nor its dense fallback.
//
// Types: q, k, v, dO and the outputs are all float32 or all bfloat16; the
// math is float32. As in JAX, p is rounded to v's type before P.V, ds to
// k's before the dQ product, and p and ds to dO's and q's before the dV and
// dK products. lse is a plain (B * H, T) float32 array (the TPU kernel's
// lane replication was a Mosaic tiling artefact). Each (B, H, T, D) operand
// is read through its batch, head and row strides (its D stride is 1), so
// the model's (B, T, H, D) tensors are read in place, without a transposed
// copy. Head dims 16, 32 and 64 are built (dK/dV at D 128 would need more
// shared memory than a block has).
//
// Known limits, left to later work: float32 stays on the SIMT cores
// (tensor cores via wgmma, TMA staging and a pipelined tile ring would
// come with a bfloat16 path); the staging loads are plain and synchronous;
// the diagonal tile of a causal walk computes its masked half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kBlock = 64;    // rows a block owns, and rows per staged tile
constexpr int kThreads = 256;  // 16 x 16, a 4 x 4 score tile each
constexpr int kPS = kBlock + 4;  // row stride of the p / ds tiles
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// Strides, in elements, of one (B, H, T, D) operand whose D stride is 1.
struct Layout {
  int64_t b, h, t;
};

template <int D>
struct Dims {
  static_assert(D % 16 == 0 && D <= 64, "head dim must be 16, 32 or 64");
  static constexpr int DC = D / 16;  // output columns per thread
  static constexpr int NS = D + 4;   // row stride of a row-major tile
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T and back (the `.astype(dtype)` before a product in JAX).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16(x));
  }
}

// Sum and max over the 16 threads of a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

// Rows [t0, t0 + 64) of one (b, h) slice as float32, into `nat` (row-major,
// [64][D + 4]) and/or `tr` (transposed, [D][64]), whichever is not null;
// rows at or past `seq` become zeros. Consecutive threads take consecutive
// rows, so the transposed stores, and the row-major ones at the padded
// stride D + 4, do not conflict in shared memory.
template <int D, int NS = Dims<D>::NS, typename T>
__device__ __forceinline__ void stage(float* nat, float* tr, const T* src,
                                      int64_t stride_t, int t0, int seq) {
  for (int i = threadIdx.x; i < kBlock * D / 4; i += kThreads) {
    const int r = i % kBlock, c = 4 * (i / kBlock);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < seq) x = load4(src + (t0 + r) * stride_t + c);
    if (nat) *reinterpret_cast<float4*>(nat + r * NS + c) = x;
    if (tr) {
      tr[c * kBlock + r] = x.x;
      tr[(c + 1) * kBlock + r] = x.y;
      tr[(c + 2) * kBlock + r] = x.z;
      tr[(c + 3) * kBlock + r] = x.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&y)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 v = load4(p + c);
      y[c] = v.x;
      y[c + 1] = v.y;
      y[c + 2] = v.z;
      y[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) y[c] = p[c];
  }
}

// acc[i][j] += sum_{k < depth} a[k * sa + i] * b[k * sb + j]: the thread's
// 4 x N block of a product whose operands are k-major in shared memory
// (a and b already offset to the thread's rows and columns).
template <int N>
__device__ __forceinline__ void gemm(float (&acc)[4][N], const float* a,
                                     int sa, const float* b, int sb,
                                     int depth) {
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float4 x = load4(a + k * sa);
    float y[N];
    load_vec<N>(b + k * sb, y);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      acc[0][j] = fmaf(x.x, y[j], acc[0][j]);
      acc[1][j] = fmaf(x.y, y[j], acc[1][j]);
      acc[2][j] = fmaf(x.z, y[j], acc[2][j]);
      acc[3][j] = fmaf(x.w, y[j], acc[3][j]);
    }
  }
}

// Column j of the thread's 4 x 4 tile v, rounded to T, into the transposed
// tile dst (row stride PS) at row (tx * 4 + j), columns ty * 4 ... + 3.
template <typename T, int PS = kPS>
__device__ __forceinline__ void put_transposed(float* dst,
                                               const float (&v)[4][4],
                                               int tx, int ty) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (tx * 4 + j) * PS + ty * 4) =
        make_float4(round_to<T>(v[0][j]), round_to<T>(v[1][j]),
                    round_to<T>(v[2][j]), round_to<T>(v[3][j]));
}

// Rows (ty * 4 + i) of a (b, h) slice, columns tx * DC ..., from acc * mul.
template <int D, typename T>
__device__ __forceinline__ void put_rows(T* dst, int64_t stride_t, int r0,
                                         int seq, int tx, int ty,
                                         const float (&acc)[4][Dims<D>::DC],
                                         const float (&mul)[4]) {
  constexpr int DC = Dims<D>::DC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + ty * 4 + i;
    if (t >= seq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store1(dst + t * stride_t + tx * DC + c, acc[i][c] * mul[i]);
  }
}

// The tile index a query-row block works on: with a causal mask the last
// tiles walk the most keys, so they are handed out first.
__device__ __forceinline__ int query_tile(int causal) {
  return causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         (2 * D * kBlock + kBlock * Dims<D>::NS + kBlock * kPS);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (4 * D * kBlock + kBlock * Dims<D>::NS + kBlock * kPS);
}
// dK/dV keeps its shared memory under half an SM's (two blocks per SM):
// unpadded row-major tiles and one tile for p, then ds.
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * D * kBlock + 2 * kBlock * D + kBlock * kBlock);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Layout lq, Layout lk,
                     Layout lv, Layout lo, int heads, int seq, float scale,
                     int causal) {
  constexpr int DC = Dims<D>::DC, NS = Dims<D>::NS;
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                 // [D][64]
  float* k_t = q_t + D * kBlock;     // [D][64]
  float* v_n = k_t + D * kBlock;     // [64][NS]
  float* p_t = v_n + kBlock * NS;    // [64 keys][kPS]
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = query_tile(causal) * kBlock;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  stage<D>(nullptr, q_t, q + b * lq.b + h * lq.h, lq.t, q0, seq);

  float acc[4][DC] = {}, m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.f;
  const int k_end = causal ? min(q0 + kBlock, seq) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // the previous tile is read
    stage<D>(nullptr, k_t, kb, lk.t, k0, seq);
    stage<D>(v_n, nullptr, vb, lv.t, k0, seq);
    __syncthreads();
    float s[4][4] = {};
    gemm<4>(s, q_t + ty * 4, kBlock, k_t + tx * 4, kBlock, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const bool live = kj < seq && (!causal || kj <= qi);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);  // p
        l[i] += s[i][j];
      }
      m[i] = m_new;
    }
    put_transposed<T>(p_t, s, tx, ty);
    __syncthreads();
    gemm<DC>(acc, p_t + ty * 4, kPS, v_n + tx * DC, NS,
             min(kBlock, k_end - k0));
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(row_sum(l[i]), 1e-30f);
    inv[i] = 1.f / li;
    const int qi = q0 + ty * 4 + i;
    if (tx == 0 && qi < seq) lse[int64_t(bh) * seq + qi] = m[i] + logf(li);
  }
  put_rows<D>(o + b * lo.b + h * lo.h, lo.t, q0, seq, tx, ty, acc, inv);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldq,
                    int heads, int seq, float scale, int causal) {
  constexpr int DC = Dims<D>::DC, NS = Dims<D>::NS;
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                  // [D][64]
  float* do_t = q_t + D * kBlock;     // [D][64]
  float* k_t = do_t + D * kBlock;     // [D][64]
  float* v_t = k_t + D * kBlock;      // [D][64]
  float* k_n = v_t + D * kBlock;      // [64][NS]
  float* ds_t = k_n + kBlock * NS;    // [64 keys][kPS]
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = query_tile(causal) * kBlock;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  stage<D>(nullptr, q_t, q + b * lq.b + h * lq.h, lq.t, q0, seq);
  stage<D>(nullptr, do_t, dout + b * ldo.b + h * ldo.h, ldo.t, q0, seq);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    row_lse[i] = qi < seq ? lse[int64_t(bh) * seq + qi] : 0.f;
    row_delta[i] = qi < seq ? delta[int64_t(bh) * seq + qi] : 0.f;
  }

  float acc[4][DC] = {};
  const int k_end = causal ? min(q0 + kBlock, seq) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();
    stage<D>(k_n, k_t, kb, lk.t, k0, seq);
    stage<D>(nullptr, v_t, vb, lv.t, k0, seq);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm<4>(s, q_t + ty * 4, kBlock, k_t + tx * 4, kBlock, D);
    gemm<4>(dp, do_t + ty * 4, kBlock, v_t + tx * 4, kBlock, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const bool live = kj < seq && (!causal || kj <= qi);
        const float p = live ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - row_delta[i]) * scale;  // ds
      }
    }
    put_transposed<T>(ds_t, s, tx, ty);
    __syncthreads();
    gemm<DC>(acc, ds_t + ty * 4, kPS, k_n + tx * DC, NS,
             min(kBlock, k_end - k0));
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  put_rows<D>(dq + b * ldq.b + h * ldq.h, ldq.t, q0, seq, tx, ty, acc, one);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                     Layout ldo, Layout ldk, Layout ldv, int heads, int seq,
                     float scale, int causal) {
  constexpr int DC = Dims<D>::DC;
  extern __shared__ __align__(16) float smem[];
  float* k_t = smem;                  // [D][64], this block's keys
  float* v_t = k_t + D * kBlock;      // [D][64]
  float* q_t = v_t + D * kBlock;      // [D][64], the walked query tile
  float* do_t = q_t + D * kBlock;     // [D][64]
  float* q_n = do_t + D * kBlock;     // [64][D]
  float* do_n = q_n + kBlock * D;     // [64][D]
  float* pds = do_n + kBlock * D;     // [64 queries][64]: p, then ds
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kBlock;  // the first key tiles walk the most
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + b * lq.b + h * lq.h;
  const T* dob = dout + b * ldo.b + h * ldo.h;
  const float* lse_b = lse + int64_t(bh) * seq;
  const float* delta_b = delta + int64_t(bh) * seq;
  stage<D>(nullptr, k_t, k + b * lk.b + h * lk.h, lk.t, k0, seq);
  stage<D>(nullptr, v_t, v + b * lv.b + h * lv.h, lv.t, k0, seq);

  float dk_acc[4][DC] = {}, dv_acc[4][DC] = {};
  // query rows before k0 see none of this block's keys
  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kBlock) {
    __syncthreads();
    stage<D, D>(q_n, q_t, qb, lq.t, q0, seq);
    stage<D, D>(do_n, do_t, dob, ldo.t, q0, seq);
    float col_lse[4], col_delta[4];  // of this thread's 4 query columns
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = q0 + tx * 4 + j;
      col_lse[j] = qi < seq ? lse_b[qi] : 0.f;
      col_delta[j] = qi < seq ? delta_b[qi] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this block's keys, columns the queries
    float s[4][4] = {}, dp[4][4] = {};
    gemm<4>(s, k_t + ty * 4, kBlock, q_t + tx * 4, kBlock, D);
    gemm<4>(dp, v_t + ty * 4, kBlock, do_t + tx * 4, kBlock, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + tx * 4 + j;
        const bool live = qi < seq && (!causal || kj <= qi);
        s[i][j] = live ? expf(s[i][j] * scale - col_lse[j]) : 0.f;  // p
        dp[i][j] = s[i][j] * (dp[i][j] - col_delta[j]) * scale;     // ds
      }
    }
    const int n = min(kBlock, seq - q0);
    put_transposed<T, kBlock>(pds, s, tx, ty);
    __syncthreads();
    gemm<DC>(dv_acc, pds + ty * 4, kBlock, do_n + tx * DC, D, n);
    __syncthreads();
    put_transposed<T, kBlock>(pds, dp, tx, ty);
    __syncthreads();
    gemm<DC>(dk_acc, pds + ty * 4, kBlock, q_n + tx * DC, D, n);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  put_rows<D>(dk + b * ldk.b + h * ldk.h, ldk.t, k0, seq, tx, ty, dk_acc,
              one);
  put_rows<D>(dv + b * ldv.b + h * ldv.h, ldv.t, k0, seq, tx, ty, dv_acc,
              one);
}

// Calls f(T(), integral_constant<int, D>()) for the element type and head
// dim the kernels were compiled for; anything else is refused.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F&& f) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
#define MXTPU_FLASH_CASE(D)                                             \
  case D:                                                               \
    return dtype ? f(__nv_bfloat16(), std::integral_constant<int, D>()) \
                 : f(float(), std::integral_constant<int, D>());
  switch (head_dim) {
    MXTPU_FLASH_CASE(16)
    MXTPU_FLASH_CASE(32)
    MXTPU_FLASH_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_FLASH_CASE
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

Layout layout_at(const int64_t* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

dim3 grid_for(int batch, int heads, int seq) {
  return dim3((seq + kBlock - 1) / kBlock, batch * heads);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every (B, H, T, D) operand. Each
// operand's batch, head and row strides (in elements) come in `strides`,
// three per operand in argument order; its D stride must be 1, its strides
// multiples of 4 and its address 16-byte aligned (8 for bfloat16). lse and
// delta are contiguous (B * H, T) float32. Every pointer is device memory;
// nothing is allocated and nothing synchronises. Returns the launch's
// cudaError_t (0 on success).
extern "C" int mxtpu_flash_attention_fwd(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* o, void* lse,
                                         const int64_t* strides, int batch,
                                         int heads, int seq, int head_dim,
                                         int causal, float scale,
                                         void* stream) {
  if (batch < 0 || heads < 0 || seq < 0) return cudaErrorInvalidValue;
  return dispatch(dtype, head_dim, [&](auto tag, auto dim) -> cudaError_t {
    using T = decltype(tag);
    constexpr int D = decltype(dim)::value;
    if (batch == 0 || heads == 0 || seq == 0) return cudaSuccess;
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = allow_smem(kernel, fwd_smem<D>());
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq), kThreads, fwd_smem<D>(),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), layout_at(strides, 0),
        layout_at(strides, 1), layout_at(strides, 2), layout_at(strides, 3),
        heads, seq, scale, causal);
    return cudaGetLastError();
  });
}

extern "C" int mxtpu_flash_attention_dq(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dq,
                                        const int64_t* strides, int batch,
                                        int heads, int seq, int head_dim,
                                        int causal, float scale,
                                        void* stream) {
  if (batch < 0 || heads < 0 || seq < 0) return cudaErrorInvalidValue;
  return dispatch(dtype, head_dim, [&](auto tag, auto dim) -> cudaError_t {
    using T = decltype(tag);
    constexpr int D = decltype(dim)::value;
    if (batch == 0 || heads == 0 || seq == 0) return cudaSuccess;
    auto kernel = flash_dq_kernel<T, D>;
    cudaError_t err = allow_smem(kernel, dq_smem<D>());
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq), kThreads, dq_smem<D>(),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), layout_at(strides, 0), layout_at(strides, 1),
        layout_at(strides, 2), layout_at(strides, 3), layout_at(strides, 4),
        heads, seq, scale, causal);
    return cudaGetLastError();
  });
}

extern "C" int mxtpu_flash_attention_dkv(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, void* dk,
                                         void* dv, const int64_t* strides,
                                         int batch, int heads, int seq,
                                         int head_dim, int causal,
                                         float scale, void* stream) {
  if (batch < 0 || heads < 0 || seq < 0) return cudaErrorInvalidValue;
  return dispatch(dtype, head_dim, [&](auto tag, auto dim) -> cudaError_t {
    using T = decltype(tag);
    constexpr int D = decltype(dim)::value;
    if (batch == 0 || heads == 0 || seq == 0) return cudaSuccess;
    auto kernel = flash_dkv_kernel<T, D>;
    cudaError_t err = allow_smem(kernel, dkv_smem<D>());
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq), kThreads, dkv_smem<D>(),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), layout_at(strides, 0),
        layout_at(strides, 1), layout_at(strides, 2), layout_at(strides, 3),
        layout_at(strides, 4), layout_at(strides, 5), heads, seq, scale,
        causal);
    return cudaGetLastError();
  });
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
