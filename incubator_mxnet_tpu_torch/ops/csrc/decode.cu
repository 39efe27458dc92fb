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
// Known limits of the two single-query kernels, left to later work: at
// full width their grid is S * H = 64 blocks on 132 SMs (the wide kernel's
// split key walk and combine pass below would spread it), and they read
// rows with plain loads (the wide kernel stages with cp.async).

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kMaxLanesPerRow = 8;  // head_dim <= 256
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

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
        kr[u][r] = ok ? to_float(k[off + d]) : 0.f;
        vr[u][r] = ok ? to_float(v[off + d]) : 0.f;
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
// What bounds it on an H100: bytes. Every live K/V row of a (slot, head)
// is read once (2 * D * elem bytes) for all Q rows; the arithmetic, 4 * D
// operations per (row, live key) pair, stays below the bytes' time up to
// Q 64 even at the SIMT float32 rate, and the products run on the tensor
// cores.
//
// Design: a split key walk with a combine pass.
//   paged_decode_wide_kernel: one block of four warps per (head, slot, key
// split, group of 64 rows); every Q <= 64 is one group, so each live K/V
// row of a (slot, head) is read from device memory once per split for all
// Q rows. A split is Wide::BN consecutive keys (64 up to
// D_p 64, 32 at 128, 16 at 256): whole pages where the page size divides
// it. Splits come from table_width and page_size alone: the host never
// reads n_base (a blocking copy), and a split past the group's deepest
// causal limit writes empty partials (m = -1e30, l = 0) and stops. The
// block issues q's cp.async copies, stages the split's pool row of each
// key in shared memory (page ids read once; an id outside the pool reads
// the null page 0), then copies K and V rows with cp.async, K before V, so
// that the scores start while V is in flight. The four warps share the
// staging; each 16 query rows (Q padded to 16-row mma tiles) are one
// warp's, so no warp combines another's sums: S = q.K^T and P.V are
// mma.sync TF32 products from tf32_mma.cuh. q is float32, so it splits
// into hi and lo: 3 x TF32 against a float32 pool, 2 passes (hi.k + lo.k)
// against a bfloat16 pool, whose values are exact in TF32; p is rounded to
// the pool's type before P.V, as in JAX (exact in TF32 for bfloat16). Each
// warp writes float32 partials for its rows: the split's max m (base 2),
// sum l and unnormalised output o.
//   wide_combine_kernel: one warp per output row merges the row's splits
// in a fixed order by the log-sum-exp rule, skipping empty partials; a row
// whose every split is empty gives zeros (l floored at 1e-30, as the TPU
// kernel does). No atomics: results are bit-equal across launches.
//   The partials' workspace is the caller's (the wrapper takes it from
// PyTorch's caching allocator on the call's stream), so a CUDA graph can
// capture the call.
//   What limits it now (chip_smoke.py phase 5, tools/kernel_variants.py;
// PERF.md, PR 7): latency, not bytes. At Q 5 the split kernel is a chain
// of dependent waits (the page table, then K, the products, V) in blocks
// that each move 32 KB, and the combine is a second launch; at Q 64 the
// 3 x TF32 products weigh more. Splits of 32 or 16 keys measured slower
// (the combine grows more than the split kernel shrinks), and so did a
// programmatic dependent launch of the combine at Q 64 (faster at Q 5).
// ---------------------------------------------------------------------------

constexpr int kWideRows = 64;  // query rows of a block: four 16-row tiles

// 16-row tiles of a row group (all groups are sized as the first): one
// warp each; a block runs four warps all the same, which share the
// staging.
__host__ __device__ __forceinline__ int wide_tiles(int n_q) {
  return min(4, (n_q + 15) / 16);
}

// Tile shape at padded head dim D: BN keys a split, row strides of the
// staged q (float32) and K/V (T) tiles, 16 bytes of padding each, which
// makes the fragment reads conflict-free in shared memory.
template <typename T, int D>
struct Wide {
  static_assert(D % 16 == 0 && D <= 256, "padded head dim 16 ... 256");
  static constexpr int BN = D <= 64 ? 64 : 4096 / D;  // at most 128 threads
  static constexpr int NT = BN / 8;
  static constexpr int LSQ = D + 4;
  static constexpr int LS = D + 16 / int(sizeof(T));
  static size_t smem(int tiles) {
    return sizeof(float) * 16 * tiles * LSQ + sizeof(T) * 2 * BN * LS +
           sizeof(int) * BN;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(128)
    paged_decode_wide_kernel(const float* __restrict__ q,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int32_t* __restrict__ page_table,
                             const int32_t* __restrict__ n_base,
                             float* __restrict__ part_o,
                             float* __restrict__ part_ml, int n_q, int heads,
                             int head_dim, int page_size, int num_pages,
                             int table_width, int n_split, float scale,
                             int width, int q_width) {
  using P = Wide<T, D>;
  constexpr int BN = P::BN, NT = P::NT, LSQ = P::LSQ, LS = P::LS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles = wide_tiles(n_q);
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [16 tiles][LSQ]
  T* k_s = reinterpret_cast<T*>(q_s + 16 * tiles * LSQ);  // [BN][LS]
  T* v_s = k_s + BN * LS;                                 // [BN][LS]
  int* rows_s = reinterpret_cast<int*>(v_s + BN * LS);   // [BN] pool rows
  const int h = blockIdx.x, b = blockIdx.y;
  const int split = blockIdx.z % n_split, row0 = blockIdx.z / n_split *
                                                 kWideRows;
  const int rows_here = min(kWideRows, n_q - row0);
  const int cap = table_width * page_size;
  const int k_lo = split * BN;
  // thread r < BN reads key k_lo + r's page id before n_base, so the two
  // trips to device memory overlap
  int page = 0;
  if (threadIdx.x < BN && k_lo + int(threadIdx.x) < cap)
    page = page_table[int64_t(b) * table_width +
                      (k_lo + int(threadIdx.x)) / page_size];
  const int nb = max(0, n_base[b]);
  const int n_keys = min(nb + row0 + rows_here, cap);  // the deepest row's
  // partial (m, l) of row i at part_ml[2 * at(i)], its o at part_o[at(i) * D]
  const int64_t at0 = (int64_t(b) * n_split + split) * n_q * heads + h;
  if (k_lo >= n_keys) {  // no row of the group sees a key of this split
    for (int r = threadIdx.x; r < rows_here; r += blockDim.x) {
      part_ml[2 * (at0 + int64_t(row0 + r) * heads)] = kNegInf;
      part_ml[2 * (at0 + int64_t(row0 + r) * heads) + 1] = 0.f;
    }
    return;
  }
  if (head_dim < D) {
    zero_tiles(q_s, 16 * tiles * LSQ);
    zero_tiles(k_s, 2 * BN * LS);
    __syncthreads();
  }
  stage_tile<float, LSQ>(
      q_s,
      [&](int r) -> const float* {
        const int i = row0 + r;
        return i < n_q ? q + ((int64_t(b) * n_q + i) * heads + h) * head_dim
                       : nullptr;
      },
      q, 16 * tiles, head_dim, q_width);
  if (threadIdx.x < BN) {
    const int key = k_lo + threadIdx.x;
    rows_s[threadIdx.x] =
        key < n_keys ? (page >= 0 && page < num_pages ? page : 0) * page_size +
                           key % page_size
                     : -1;
  }
  __syncthreads();
  const int64_t stride_row = int64_t(heads) * head_dim;
  const int64_t head_off = int64_t(h) * head_dim;
  stage_tile<T, LS>(
      k_s,
      [&](int r) -> const T* {
        return rows_s[r] >= 0 ? k_pages + rows_s[r] * stride_row + head_off
                              : nullptr;
      },
      k_pages, BN, head_dim, width);
  cp_commit();
  stage_tile<T, LS>(
      v_s,
      [&](int r) -> const T* {
        return rows_s[r] >= 0 ? v_pages + rows_s[r] * stride_row + head_off
                              : nullptr;
      },
      v_pages, BN, head_dim, width);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4,
            t = lane % 4;
  const int w0 = row0 + 16 * warp;  // the warp's first row
  // the warp computes if it has rows and its deepest row sees the split
  const bool live_warp = w0 < n_q && k_lo < min(nb + w0 + 16, cap);
  const float scale2 = scale * kLog2e;  // scores in base 2
  float s[1][NT][4] = {}, m[2] = {kNegInf, kNegInf}, l[2] = {};
  cp_wait<1>();  // q and K
  __syncthreads();
  if (live_warp) {
    sum_over_d<float, T, D, 1, NT, LSQ, LS>(s, q_s + 16 * warp * LSQ, k_s,
                                             g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = w0 + g + 8 * (e >> 1);
        const int key = k_lo + nt * 8 + 2 * t + (e & 1);
        const bool live = key < min(nb + row + 1, cap);
        s[0][nt][e] = live ? s[0][nt][e] * scale2 : kNegInf;
        m[e >> 1] = fmaxf(m[e >> 1], s[0][nt][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]);
    // masked keys give p = 0, so a row with no live key here has l = 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[0][nt][e];
        const float p = x > kNegInf ? exp2f(x - m[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[0][nt][e] = round_to<T>(p);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  }
  cp_wait<0>();  // V
  __syncthreads();
  float acc[1][D / 8][4] = {};
  if (live_warp) sum_over_rows<T, D, 1, NT, LS>(acc, s, v_s, g, t);
  if (warp >= tiles) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + g + 8 * i;
    if (row >= n_q) continue;
    const int64_t at = at0 + int64_t(row) * heads;
    if (t == 0) {
      part_ml[2 * at] = m[i];
      part_ml[2 * at + 1] = l[i];
    }
    if (!live_warp) continue;  // no key of the split: l = 0, o not read
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + 2 * t + e;
        if (col < head_dim) part_o[at * head_dim + col] = acc[0][dn][2 * i + e];
      }
  }
}

// One warp per output row (slot, row, head): the row's n_split partials
// merged in split order, empty ones (l = 0) skipped. The lanes read the
// splits' (m, l) side by side (lane j: splits j, j + 32, ...), so the loads
// do not queue one behind another; the sums then run in split order, each
// split's weight handed round by a shuffle. Lanes split D: lane i holds
// output elements i, i + 32, ... (R of them).
template <int R>
__global__ void __launch_bounds__(128)
    wide_combine_kernel(const float* __restrict__ part_o,
                        const float* __restrict__ part_ml,
                        float* __restrict__ out, int n_rows, int n_q,
                        int heads, int head_dim, int n_split) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int per_slot = n_q * heads;  // rows of one slot, (row, head) order
  const int b = row / per_slot, rest = row - b * per_slot;
  const int64_t at0 = int64_t(b) * n_split * per_slot + rest;
  float mx = kNegInf;
  for (int j = lane; j < n_split; j += 32) {
    const int64_t at = at0 + int64_t(j) * per_slot;
    if (part_ml[2 * at + 1] > 0.f) mx = fmaxf(mx, part_ml[2 * at]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
  float o[R] = {}, lsum = 0.f;
  for (int j0 = 0; j0 < n_split; j0 += 32) {
    float c = 0.f, lj = 0.f;  // split j0 + lane's sum and weight
    if (j0 + lane < n_split) {
      const int64_t at = at0 + int64_t(j0 + lane) * per_slot;
      lj = part_ml[2 * at + 1];
      if (lj > 0.f) c = exp2f(part_ml[2 * at] - mx);
    }
    const int n = min(32, n_split - j0);
#pragma unroll 8
    for (int u = 0; u < n; ++u) {
      const float cu = __shfl_sync(kFullMask, c, u);
      lsum = fmaf(__shfl_sync(kFullMask, lj, u), cu, lsum);
      const float* src = part_o + (at0 + int64_t(j0 + u) * per_slot) *
                                      head_dim;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int d = lane + 32 * r;
        // an empty split's o is never written: not read either
        const float x = cu > 0.f && d < head_dim ? src[d] : 0.f;
        o[r] = fmaf(x, cu, o[r]);
      }
    }
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = lane + 32 * r;
    if (d < head_dim) out[int64_t(row) * head_dim + d] = o[r] * inv;
  }
}

// The padded head dim of the wide kernel: the smallest of 16, 32, 64, 128
// and 256 at or above d.
int wide_padded_dim(int d) {
  int p = 16;
  while (p < d) p *= 2;
  return p;
}

// Keys of one split of the wide kernel at head dim d (Wide<T, D_p>::BN).
int wide_split_keys(int d) {
  const int p = wide_padded_dim(d);
  return p <= 64 ? 64 : 4096 / p;
}

// Bytes each staging copy moves: 16 or 4 where the base address and the
// row's bytes allow (rows start at multiples of the row's bytes), else one
// element.
int wide_copy_width(const void* base, int row_bytes, int elem) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (a % 16 == 0 && row_bytes % 16 == 0) return 16;
  if (a % 4 == 0 && row_bytes % 4 == 0) return 4;
  return elem;
}

template <typename T, int D>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* table, const void* nb, void* part_o,
                        void* part_ml, int slots, int n_q, int heads,
                        int head_dim, int page_size, int num_pages,
                        int table_width, int n_split, float scale,
                        cudaStream_t stream) {
  using P = Wide<T, D>;
  const size_t smem = P::smem(wide_tiles(n_q));
  auto kernel = paged_decode_wide_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err) return err;
  }
  const int elem = sizeof(T), row_bytes = head_dim * elem;
  const int width = min(wide_copy_width(k, row_bytes, elem),
                        wide_copy_width(v, row_bytes, elem));
  const int groups = (n_q + kWideRows - 1) / kWideRows;
  kernel<<<dim3(heads, slots, n_split * groups), 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(nb), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), n_q, heads, head_dim, page_size,
      num_pages, table_width, n_split, scale, width,
      wide_copy_width(q, head_dim * 4, 4));
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_combine(const void* part_o, const void* part_ml,
                           void* out, int slots, int n_q, int heads,
                           int head_dim, int n_split, cudaStream_t stream) {
  const int n_rows = slots * n_q * heads;
  wide_combine_kernel<R><<<(n_rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<float*>(out), n_rows, n_q, heads, head_dim, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_wide(const void* q, const void* k, const void* v,
                          const void* table, const void* nb, void* part_o,
                          void* part_ml, int slots, int n_q, int heads,
                          int head_dim, int page_size, int num_pages,
                          int table_width, int n_split, float scale,
                          cudaStream_t s) {
#define MXTPU_WIDE_CASE(D)                                                  \
  case D:                                                                   \
    return launch_wide<T, D>(q, k, v, table, nb, part_o, part_ml, slots,    \
                             n_q, heads, head_dim, page_size, num_pages,    \
                             table_width, n_split, scale, s);
  switch (wide_padded_dim(head_dim)) {
    MXTPU_WIDE_CASE(16)
    MXTPU_WIDE_CASE(32)
    MXTPU_WIDE_CASE(64)
    MXTPU_WIDE_CASE(128)
    MXTPU_WIDE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_WIDE_CASE
}

cudaError_t dispatch_combine(int lanes, const void* part_o,
                             const void* part_ml, void* out, int slots,
                             int n_q, int heads, int head_dim, int n_split,
                             cudaStream_t s) {
#define MXTPU_COMBINE_CASE(R)                                              \
  case R:                                                                  \
    return launch_combine<R>(part_o, part_ml, out, slots, n_q, heads,      \
                             head_dim, n_split, s);
  switch (lanes) {
    MXTPU_COMBINE_CASE(1)
    MXTPU_COMBINE_CASE(2)
    MXTPU_COMBINE_CASE(3)
    MXTPU_COMBINE_CASE(4)
    MXTPU_COMBINE_CASE(5)
    MXTPU_COMBINE_CASE(6)
    MXTPU_COMBINE_CASE(7)
    MXTPU_COMBINE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_COMBINE_CASE
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
// int32; the rest as for mxtpu_paged_decode_attention. `work` is float32
// device memory for the partials: slots * n_split * n_q * heads *
// (head_dim + 2) floats, where n_split = ceil(table_width * page_size /
// keys), keys = 64 for a head_dim up to 64 and 4096 / D_p above (D_p the
// power of two at or above it, up to 256); the caller passes n_split and
// the call checks it. Launches the split kernel, then the combine kernel.
extern "C" int mxtpu_paged_decode_attention_wide(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* n_base, void* work, void* out,
    int slots, int n_q, int heads, int head_dim, int page_size,
    int num_pages, int table_width, int n_split, float scale, void* stream) {
  const int lanes = lanes_for(head_dim);
  if (!lanes || page_size < 1 || table_width < 1 || n_q < 0)
    return cudaErrorInvalidValue;
  const int keys = wide_split_keys(head_dim);
  if (n_split != (table_width * page_size + keys - 1) / keys)
    return cudaErrorInvalidValue;
  if (slots == 0 || heads == 0 || n_q == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_o = static_cast<float*>(work);
  float* part_ml =
      part_o + int64_t(slots) * n_split * n_q * heads * head_dim;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_wide<float>(q, k_pages, v_pages, page_table, n_base,
                               part_o, part_ml, slots, n_q, heads, head_dim,
                               page_size, num_pages, table_width, n_split,
                               scale, s);
  else if (dtype == 1)
    err = dispatch_wide<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                       n_base, part_o, part_ml, slots, n_q,
                                       heads, head_dim, page_size, num_pages,
                                       table_width, n_split, scale, s);
  else
    return cudaErrorInvalidValue;
  if (err) return err;
  return dispatch_combine(lanes, part_o, part_ml, out, slots, n_q, heads,
                          head_dim, n_split, s);
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
