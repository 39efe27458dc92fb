// Decode attention, hand-written for Hopper (sm_90a).
//
// Replaces three TPU kernels of incubator_mxnet_tpu/ops/pallas_kernels.py:
//   paged_decode_kernel  <- paged_decode_attention / _paged_decode_kernel
//                           (attention of one query per decode slot over a
//                           global KV page pool, walking the slot's page
//                           table);
//   flash_decode_kernel  <- flash_decode / _decode_kernel (the same over a
//                           dense (B, T, H, D) cache);
//   paged_decode_wide_kernel <- paged_decode_attention_wide /
//                           _paged_decode_wide_kernel (Q consecutive query
//                           rows per slot over the page pool, causal inside
//                           the call; see its own note below).
//
// What bounds them on an H100: bytes. A decode query reads each live key
// and value row once: sum_b n_valid[b] * H * D * 2 * sizeof(elem), plus the
// query and the output, at 3.35 TB/s. The arithmetic is 4 * D operations
// per key row (0.5 operations per byte in float32), far below the card's
// ratio of operations to bytes.
//
// Design. One thread block per (slot, head). Its kWarps warps take keys in
// turn, kUnroll consecutive keys per warp per iteration, so each warp has
// kUnroll independent row loads in flight. A key's score is a warp-shuffle
// dot product over D: lane i holds elements i, i + 32, ... of the query,
// key and value rows. Each warp keeps its own online softmax (running max
// m, sum l and output o) in registers; the warps' states are combined in
// shared memory at the end. Scores and sums are float32 for float32 and
// bfloat16 caches alike; the query and the output are float32.
//
// The paged kernel stages the slot's live page-table entries in shared
// memory (Hopper has no scalar prefetch) and walks only
// ceil(n_valid / page_size) pages; a page id outside the pool reads the
// null page 0. The dense kernel reads the (B, T, H, D) cache in place
// through its strides, so no transposed copy is made, and takes any T: the
// walk stops at min(n_valid, T). n_valid == 0 writes zeros, as the TPU
// kernel does (o = 0, l floored at 1e-30).
//
// Known limits, left to later work: at full width the grid is S * H = 64
// blocks on 132 SMs (split the key walk across blocks and combine in a
// second pass), and rows are read with plain loads (cp.async or TMA staging
// would keep more bytes in flight).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kMaxLanesPerRow = 8;  // head_dim <= 256
constexpr int kWideUnroll = 8;  // keys per round of a wide-kernel row
constexpr int kStage = 8;       // K and V loads in flight per thread
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row offsets (in elements) of key t for the block's (slot, head).
struct DenseRows {  // cache (B, T, H, D), contiguous
  int64_t row0;     // offset of (b, 0, h, 0)
  int64_t stride_t;  // H * D
  __device__ __forceinline__ int64_t operator()(int t) const {
    return row0 + t * stride_t;
  }
};

struct PagedRows {  // pool (P, page_size, H, D), contiguous
  const int* pages;  // the slot's page ids, staged in shared memory
  int page_size;
  int64_t head_off;  // h * D
  int64_t stride_row;  // H * D
  __device__ __forceinline__ int64_t operator()(int t) const {
    const int64_t row =
        int64_t(pages[t / page_size]) * page_size + t % page_size;
    return row * stride_row + head_off;
  }
};

// Online-softmax attention of one query row over keys [0, nv); every
// thread of the block calls it. `scratch` holds 2 * kWarps + kWarps * R * 32
// floats of shared memory.
template <typename T, int R, typename Rows>
__device__ __forceinline__ void attend(const float* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       float* __restrict__ out, int nv,
                                       int head_dim, float scale,
                                       const Rows& rows, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float qr[R], o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = lane + 32 * r;
    qr[r] = d < head_dim ? q[d] : 0.f;
    o[r] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  for (int base = warp * kUnroll; base < nv; base += kWarps * kUnroll) {
    float kr[kUnroll][R], vr[kUnroll][R];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = base + u < nv;
      const int64_t off = live ? rows(base + u) : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d = lane + 32 * r;
        const bool ok = live && d < head_dim;
        kr[u][r] = ok ? to_f32(k[off + d]) : 0.f;
        vr[u][r] = ok ? to_f32(v[off + d]) : 0.f;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) acc = fmaf(qr[r], kr[u][r], acc);
      s[u] = acc;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        s[u] += __shfl_xor_sync(kFullMask, s[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = base + u < nv ? s[u] * scale : kNegInf;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    float p[kUnroll], psum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = expf(s[u] - m_new);
      psum += p[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = o[r] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = fmaf(p[u], vr[u][r], acc);
      o[r] = acc;
    }
    m = m_new;
  }

  float* sm_m = scratch;
  float* sm_l = scratch + kWarps;
  float* sm_o = scratch + 2 * kWarps;  // [kWarps][R * 32]
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) sm_o[warp * R * 32 + lane + 32 * r] = o[r];
  __syncthreads();
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - mx);
      lsum = fmaf(sm_l[w], c, lsum);
      acc = fmaf(sm_o[w * R * 32 + d], c, acc);
    }
    out[d] = acc / fmaxf(lsum, 1e-30f);
  }
}

template <int R>
__host__ __device__ constexpr int scratch_floats() {
  return 2 * kWarps + kWarps * R * 32;
}

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const float* __restrict__ q,
                        const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ n_valid,
                        float* __restrict__ out, int heads, int head_dim,
                        int page_size, int num_pages, int table_width,
                        float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nv = max(0, min(n_valid[b], table_width * page_size));
  const int n_pages = (nv + page_size - 1) / page_size;
  int* pages = reinterpret_cast<int*>(smem + scratch_floats<R>());
  for (int j = threadIdx.x; j < n_pages; j += blockDim.x) {
    const int p = page_table[int64_t(b) * table_width + j];
    pages[j] = (p >= 0 && p < num_pages) ? p : 0;
  }
  __syncthreads();
  const PagedRows rows{pages, page_size, int64_t(h) * head_dim,
                       int64_t(heads) * head_dim};
  const int64_t qo = (int64_t(b) * heads + h) * head_dim;
  attend<T, R>(q + qo, k_pages, v_pages, out + qo, nv, head_dim, scale, rows,
               smem);
}

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
    flash_decode_kernel(const float* __restrict__ q,
                        const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache,
                        const int32_t* __restrict__ n_valid,
                        float* __restrict__ out, int cache_len, int heads,
                        int head_dim, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nv = max(0, min(n_valid[b], cache_len));
  const int64_t stride_t = int64_t(heads) * head_dim;
  const DenseRows rows{int64_t(b) * cache_len * stride_t +
                           int64_t(h) * head_dim,
                       stride_t};
  const int64_t qo = (int64_t(b) * heads + h) * head_dim;
  attend<T, R>(q + qo, k_cache, v_cache, out + qo, nv, head_dim, scale, rows,
               smem);
}

template <typename T, int R>
cudaError_t launch_paged(const void* q, const void* k, const void* v,
                         const void* table, const void* nv, void* out,
                         int slots, int heads, int head_dim, int page_size,
                         int num_pages, int table_width, float scale,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * scratch_floats<R>() + sizeof(int) * table_width;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(heads, slots);
  paged_decode_kernel<T, R><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(nv), static_cast<float*>(out), heads,
      head_dim, page_size, num_pages, table_width, scale);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         const void* nv, void* out, int batch, int cache_len,
                         int heads, int head_dim, float scale,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * scratch_floats<R>();
  const dim3 grid(heads, batch);
  flash_decode_kernel<T, R><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(nv),
      static_cast<float*>(out), cache_len, heads, head_dim, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_paged(int lanes, const void* q, const void* k,
                           const void* v, const void* table, const void* nv,
                           void* out, int slots, int heads, int head_dim,
                           int page_size, int num_pages, int table_width,
                           float scale, cudaStream_t s) {
#define MXTPU_PAGED_CASE(R)                                               \
  case R:                                                                 \
    return launch_paged<T, R>(q, k, v, table, nv, out, slots, heads,      \
                              head_dim, page_size, num_pages, table_width, \
                              scale, s);
  switch (lanes) {
    MXTPU_PAGED_CASE(1)
    MXTPU_PAGED_CASE(2)
    MXTPU_PAGED_CASE(3)
    MXTPU_PAGED_CASE(4)
    MXTPU_PAGED_CASE(5)
    MXTPU_PAGED_CASE(6)
    MXTPU_PAGED_CASE(7)
    MXTPU_PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_PAGED_CASE
}

template <typename T>
cudaError_t dispatch_flash(int lanes, const void* q, const void* k,
                           const void* v, const void* nv, void* out,
                           int batch, int cache_len, int heads, int head_dim,
                           float scale, cudaStream_t s) {
#define MXTPU_FLASH_CASE(R)                                                  \
  case R:                                                                    \
    return launch_flash<T, R>(q, k, v, nv, out, batch, cache_len, heads,     \
                              head_dim, scale, s);
  switch (lanes) {
    MXTPU_FLASH_CASE(1)
    MXTPU_FLASH_CASE(2)
    MXTPU_FLASH_CASE(3)
    MXTPU_FLASH_CASE(4)
    MXTPU_FLASH_CASE(5)
    MXTPU_FLASH_CASE(6)
    MXTPU_FLASH_CASE(7)
    MXTPU_FLASH_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_FLASH_CASE
}

// ---------------------------------------------------------------------------
// Wide paged decode: Q query rows per slot.
//
// Row i of slot b sits at position n_base[b] + i and attends keys
// idx < min(n_base[b] + i + 1, table_width * page_size): the paged prefix
// written by earlier calls plus causal masking among this call's own rows
// (their K/V are already in the pool), with the walk clamped to the table
// so a speculative row past a slot's last owned page reads no table entry
// outside the row. One kernel serves chunked prefill (Q = chunk), the
// prefix cache's tail prefill (Q = 32) and speculative verification
// (Q = lookahead + 1).
//
// What bounds it on an H100: bytes for small Q (every live K/V row of the
// (slot, head) read once, as in the single-query kernel), operations as Q
// grows: 4 * D float32 operations per (row, live key) pair, so at Q = 64
// the arithmetic can outweigh the bytes.
//
// Design (correctness first). One thread block per (head, slot, row group)
// of up to kWarps rows; warp w owns row group * kWarps + w and keeps its
// own online softmax (m, l, o) in registers, lanes splitting D, with a
// warp-shuffle reduction for each score, kWideUnroll keys per round. All
// rows of a block read the same keys, so the block stages a tile of
// tile_keys K and V rows in shared memory (converted to float32) once and
// every warp reads it there; each thread issues kStage loads of each
// tensor before its first store, so the staging is not a chain of
// dependent trips to device memory. The
// block walks only as far as its deepest row needs; a row stops at its own
// causal limit. The block's page ids are staged in shared memory first, as
// in the single-query kernel; an id outside the pool reads the null page 0.
// Left to later work: tensor cores for the Q x K tile, cp.async/TMA
// staging, and splitting long walks across blocks.
// ---------------------------------------------------------------------------

template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_wide_kernel(const float* __restrict__ q,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int32_t* __restrict__ page_table,
                             const int32_t* __restrict__ n_base,
                             float* __restrict__ out, int n_q, int heads,
                             int head_dim, int page_size, int num_pages,
                             int table_width, int tile_keys, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * kWarps;
  const int rows_here = min(kWarps, n_q - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = table_width * page_size;
  const int nb = max(0, n_base[b]);
  // the deepest row of the block, row0 + rows_here - 1, attends this many
  const int n_keys = min(nb + row0 + rows_here, cap);
  const int n_pages = (n_keys + page_size - 1) / page_size;

  int* pages = reinterpret_cast<int*>(smem);
  float* ks = smem + table_width;
  float* vs = ks + tile_keys * head_dim;
  for (int j = threadIdx.x; j < n_pages; j += blockDim.x) {
    const int p = page_table[int64_t(b) * table_width + j];
    pages[j] = (p >= 0 && p < num_pages) ? p : 0;
  }

  const bool active = warp < rows_here;
  const int row = row0 + warp;
  const int limit = active ? min(nb + row + 1, cap) : 0;
  const int64_t qo = ((int64_t(b) * n_q + row) * heads + h) * head_dim;
  float qr[R], o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = lane + 32 * r;
    qr[r] = active && d < head_dim ? q[qo + d] : 0.f;
    o[r] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int64_t stride_row = int64_t(heads) * head_dim;
  const int64_t head_off = int64_t(h) * head_dim;
  __syncthreads();  // the page ids are staged

  for (int t0 = 0; t0 < n_keys; t0 += tile_keys) {
    const int nt = min(tile_keys, n_keys - t0);
    const int n_el = nt * head_dim;
    // kStage elements of K and of V in flight per thread: every load of a
    // batch is issued before the first store
    for (int i0 = threadIdx.x; i0 < n_el; i0 += kStage * blockDim.x) {
      float kb[kStage], vb[kStage];
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int i = i0 + j * blockDim.x;
        kb[j] = vb[j] = 0.f;
        if (i < n_el) {
          const int t = i / head_dim;
          const int key = t0 + t;
          const int64_t src = (int64_t(pages[key / page_size]) * page_size +
                               key % page_size) *
                                  stride_row +
                              head_off + (i - t * head_dim);
          kb[j] = to_f32(k_pages[src]);
          vb[j] = to_f32(v_pages[src]);
        }
      }
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < n_el) {
          ks[i] = kb[j];
          vs[i] = vb[j];
        }
      }
    }
    __syncthreads();
    const int kend = min(nt, limit - t0);  // this row's live keys here
    for (int base = 0; base < kend; base += kWideUnroll) {
      float s[kWideUnroll];
#pragma unroll
      for (int u = 0; u < kWideUnroll; ++u) {
        const int t = min(base + u, nt - 1);
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int d = lane + 32 * r;
          if (d < head_dim) acc = fmaf(qr[r], ks[t * head_dim + d], acc);
        }
        s[u] = acc;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kWideUnroll; ++u)
          s[u] += __shfl_xor_sync(kFullMask, s[u], off);
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kWideUnroll; ++u) {
        s[u] = base + u < kend ? s[u] * scale : kNegInf;
        m_new = fmaxf(m_new, s[u]);
      }
      const float alpha = expf(m - m_new);
      float p[kWideUnroll], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kWideUnroll; ++u) {
        p[u] = base + u < kend ? expf(s[u] - m_new) : 0.f;
        psum += p[u];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d = lane + 32 * r;
        float acc = o[r] * alpha;
        if (d < head_dim) {
#pragma unroll
          for (int u = 0; u < kWideUnroll; ++u) {
            const int t = min(base + u, nt - 1);
            acc = fmaf(p[u], vs[t * head_dim + d], acc);
          }
        }
        o[r] = acc;
      }
      m = m_new;
    }
    __syncthreads();  // every warp is done with the tile
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = lane + 32 * r;
      if (d < head_dim) out[qo + d] = o[r] * inv;
    }
  }
}

// Keys staged per tile: 2 * tile_keys * head_dim floats of K and V, 32 KB.
int wide_tile_keys(int head_dim) {
  return head_dim >= 4096 ? 1 : 4096 / head_dim;
}

template <typename T, int R>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* table, const void* nb, void* out,
                        int slots, int n_q, int heads, int head_dim,
                        int page_size, int num_pages, int table_width,
                        float scale, cudaStream_t stream) {
  const int tile = wide_tile_keys(head_dim);
  const size_t smem = sizeof(int) * table_width +
                      sizeof(float) * 2 * size_t(tile) * head_dim;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(heads, slots, (n_q + kWarps - 1) / kWarps);
  paged_decode_wide_kernel<T, R><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(nb), static_cast<float*>(out), n_q, heads,
      head_dim, page_size, num_pages, table_width, tile, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_wide(int lanes, const void* q, const void* k,
                          const void* v, const void* table, const void* nb,
                          void* out, int slots, int n_q, int heads,
                          int head_dim, int page_size, int num_pages,
                          int table_width, float scale, cudaStream_t s) {
#define MXTPU_WIDE_CASE(R)                                                   \
  case R:                                                                    \
    return launch_wide<T, R>(q, k, v, table, nb, out, slots, n_q, heads,     \
                             head_dim, page_size, num_pages, table_width,    \
                             scale, s);
  switch (lanes) {
    MXTPU_WIDE_CASE(1)
    MXTPU_WIDE_CASE(2)
    MXTPU_WIDE_CASE(3)
    MXTPU_WIDE_CASE(4)
    MXTPU_WIDE_CASE(5)
    MXTPU_WIDE_CASE(6)
    MXTPU_WIDE_CASE(7)
    MXTPU_WIDE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_WIDE_CASE
}

int lanes_for(int head_dim) {
  if (head_dim < 1 || head_dim > 32 * kMaxLanesPerRow) return 0;
  return (head_dim + 31) / 32;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the key/value element type). q and out
// are float32. Every pointer is device memory; nothing is allocated and
// nothing synchronises. Returns the launch's cudaError_t (0 on success).
extern "C" int mxtpu_paged_decode_attention(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* n_valid, void* out, int slots,
    int heads, int head_dim, int page_size, int num_pages, int table_width,
    float scale, void* stream) {
  const int lanes = lanes_for(head_dim);
  if (!lanes || page_size < 1 || table_width < 1)
    return cudaErrorInvalidValue;
  if (slots == 0 || heads == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_paged<float>(lanes, q, k_pages, v_pages, page_table,
                                 n_valid, out, slots, heads, head_dim,
                                 page_size, num_pages, table_width, scale, s);
  if (dtype == 1)
    return dispatch_paged<__nv_bfloat16>(lanes, q, k_pages, v_pages,
                                         page_table, n_valid, out, slots,
                                         heads, head_dim, page_size,
                                         num_pages, table_width, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int mxtpu_flash_decode(int dtype, const void* q,
                                  const void* k_cache, const void* v_cache,
                                  const void* n_valid, void* out, int batch,
                                  int cache_len, int heads, int head_dim,
                                  float scale, void* stream) {
  const int lanes = lanes_for(head_dim);
  if (!lanes || cache_len < 0) return cudaErrorInvalidValue;
  if (batch == 0 || heads == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_flash<float>(lanes, q, k_cache, v_cache, n_valid, out,
                                 batch, cache_len, heads, head_dim, scale, s);
  if (dtype == 1)
    return dispatch_flash<__nv_bfloat16>(lanes, q, k_cache, v_cache, n_valid,
                                         out, batch, cache_len, heads,
                                         head_dim, scale, s);
  return cudaErrorInvalidValue;
}

// q and out are (slots, n_q, heads, head_dim) float32; n_base is (slots,)
// int32; the rest as for mxtpu_paged_decode_attention.
extern "C" int mxtpu_paged_decode_attention_wide(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* n_base, void* out, int slots,
    int n_q, int heads, int head_dim, int page_size, int num_pages,
    int table_width, float scale, void* stream) {
  const int lanes = lanes_for(head_dim);
  if (!lanes || page_size < 1 || table_width < 1 || n_q < 0)
    return cudaErrorInvalidValue;
  if (slots == 0 || heads == 0 || n_q == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_wide<float>(lanes, q, k_pages, v_pages, page_table,
                                n_base, out, slots, n_q, heads, head_dim,
                                page_size, num_pages, table_width, scale, s);
  if (dtype == 1)
    return dispatch_wide<__nv_bfloat16>(lanes, q, k_pages, v_pages,
                                        page_table, n_base, out, slots, n_q,
                                        heads, head_dim, page_size, num_pages,
                                        table_width, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
