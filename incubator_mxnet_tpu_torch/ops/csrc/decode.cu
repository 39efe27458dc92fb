// Decode attention, hand-written for Hopper (sm_90a).
//
// Replaces three TPU kernels of incubator_mxnet_tpu/ops/pallas_kernels.py:
//   decode_split_kernel<PagedRows> <- paged_decode_attention /
//                           _paged_decode_kernel (attention of one query
//                           per decode slot over a global KV page pool,
//                           walking the slot's page table);
//   decode_split_kernel<DenseRows> <- flash_decode / _decode_kernel (the
//                           same over a dense (B, T, H, D) cache);
//   each a split key walk that merges its splits in the same launch;
//   paged_decode_wide_kernel <- paged_decode_attention_wide /
//                           _paged_decode_wide_kernel (Q consecutive query
//                           rows per slot over the page pool, causal inside
//                           the call; see its own note below).
//
// What bounds them on an H100: bytes. A decode query reads each live key
// and value row once: sum_b n_valid[b] * H * D * 2 * sizeof(elem), plus the
// query and the output, at 3.35 TB/s. The arithmetic is 4 * D operations
// per key row (0.5 operations per byte in float32), far below the card's
// ratio of operations to bytes. At the serving shapes the bytes take 0.3-2
// us, so what a call costs is latency: the chain of dependent trips to
// device memory, and how many SMs pull bytes at once.
//
// Design of the single-query kernels: a split key walk, then a merge.
//   decode_split_kernel: one block of four warps per (head, slot, split of
// kDecodeKeys consecutive keys). The number of splits comes from what the
// host knows without reading the device: the cache length T (dense) or
// table_width * page_size (paged), never n_valid. At generate()'s shape
// (B 1, H 8, T 512) that is 128 blocks on 132 SMs, where one block per
// (slot, head) gave 8; at the serving shape (S 8, H 8, table 32 x 16)
// 1024. A split at or past the slot's n_valid stops at once. Thread r <
// kDecodeKeys reads key r's page id (one division per key, once) before
// n_valid, so the two trips overlap; an id outside the pool reads the null
// page 0. The split's K rows, then its V rows, go to shared memory by
// cp.async, 16 bytes a copy where the base address and the row's bytes
// allow (wide_copy_width), so the scores start while V is in flight; rows
// at or past min(n_valid, cap) are masked and not read. The products stay
// on the CUDA cores: a single query does 4 * D operations a key, which
// would leave a 16-row tensor-core tile 15/16 idle. Each warp scores its
// keys (lane i holds elements i, i + 32, ... of q and of the key row; a
// shuffle sum over the warp), the scores meet in shared memory, and every
// thread takes the split's max and sums for itself, then P.V for its
// columns of the output. Scores and sums are float32; p is rounded to the
// pool's type before P.V, as in JAX. Each live split writes float32
// partials to the workspace: its max m (base 2), sum l and unnormalised
// output o.
//   The merge, in the same launch: each live block, its partials written
// and fenced, adds one to its (slot, head)'s arrival counter; the block
// that arrives last (the slot's live splits are ceil(n_valid / 32), so
// every block knows how many arrive) reads the partials from L2, merges
// them in split order by the log-sum-exp rule, writes the output row and
// sets the counter back to zero, so the next call, or a CUDA graph's
// replay, finds it clean. A slot with no live key gives zeros, as the TPU
// kernel does. No atomics on data: results are bit-equal across launches.
// The counters (one per (slot, head)) are the caller's: the wrapper keeps
// one zeroed array per stream, and a call captured in a CUDA graph gets
// its own, so calls that overlap never share one.
// Measured (tools/kernel_variants.py; PERF.md): this one launch is 2-3 us
// faster at both serving shapes than empty partials for dead splits and
// wide_combine_kernel at n_q = 1 in a second launch (the tool builds that
// variant by text substitution), and 32-key splits beat 16 and 64 at
// generate()'s shape and come within 0.5 us of 64 at the serving one; a
// merge through a thread block cluster's distributed shared memory was
// correct but no faster.
//   q and the output are float32 or bfloat16 (the same type), K and V
// float32 or bfloat16, D from 1 to 256. The partials' workspace is the
// caller's (the wrapper takes it from PyTorch's caching allocator on the
// call's stream), nothing synchronises and the host reads nothing, so a
// CUDA graph can capture a call and replay it with other n_valid and
// page tables. flash_decode's n_valid may be one value for every sequence,
// passed by value (generate() passes a python int), which saves a fill.
//   What bounds it now: latency. Each live split is a chain of dependent
// trips (page ids, K, V, its partials, the fence and the counter), and the
// merging block adds another (the partials from L2); at the serving shapes
// the kernel runs 5-10 us against bytes that need 0.3-2 us.

#include "tf32_mma.cuh"

namespace {

constexpr int kDecodeKeys = 32;     // keys a split of the single-query walk
constexpr int kDecodeThreads = 128;  // four warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

// Where key `key` of slot b lives: fetch() is issued first (a page id, or
// nothing), row() then gives the key's row in the (rows, H, D) cache.
struct DenseRows {  // cache (B, T, H, D), contiguous
  int cap;          // T
  __device__ __forceinline__ int fetch(int, int) const { return 0; }
  __device__ __forceinline__ int64_t row(int b, int key, int) const {
    return int64_t(b) * cap + key;
  }
};

struct PagedRows {  // pool (P, page_size, H, D), contiguous
  const int32_t* table;  // (slots, width) page ids
  int width, page_size, num_pages, cap;  // cap = width * page_size
  __device__ __forceinline__ int fetch(int b, int key) const {
    return table[int64_t(b) * width + key / page_size];
  }
  __device__ __forceinline__ int64_t row(int, int key, int page) const {
    return int64_t(page >= 0 && page < num_pages ? page : 0) * page_size +
           key % page_size;
  }
};

// In the block that arrives last: the (slot, head)'s partials merged, in
// split order, into its output row `out`. Splits 0 ... n_live - 1 (split
// j's partials at at0 + j * heads) are the live ones, each with l >= 1;
// the rest are empty and not read. The partials are read from L2 (__ldcg:
// the other blocks wrote them); each thread reads every split's (m, l).
// The loops unroll by 8, so 8 splits' loads are in flight at once.
template <typename TO, int C>
__device__ void merge_splits(const float* part_o, const float* part_ml,
                             TO* out, int64_t at0, int heads, int head_dim,
                             int n_live) {
  float mx = kNegInf;
#pragma unroll 8
  for (int j = 0; j < n_live; ++j)
    mx = fmaxf(mx, __ldcg(part_ml + 2 * (at0 + int64_t(j) * heads)));
  float lsum = 0.f, o[C] = {};
#pragma unroll 8
  for (int j = 0; j < n_live; ++j) {
    const int64_t at = at0 + int64_t(j) * heads;
    const float c = exp2f(__ldcg(part_ml + 2 * at) - mx);
    lsum = fmaf(__ldcg(part_ml + 2 * at + 1), c, lsum);
    const float* src = part_o + at * head_dim;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int d = threadIdx.x + kDecodeThreads * i;
      if (d < head_dim) o[i] = fmaf(__ldcg(src + d), c, o[i]);
    }
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int d = threadIdx.x + kDecodeThreads * i;
    if (d < head_dim) out[d] = from_float<TO>(o[i] * inv);
  }
}

// One split of one (slot, head): keys [k_lo, k_lo + keys) of the slot,
// keys >= 1, staged by the whole block (after its __syncthreads) through
// the smem tiles `sm`; returns the split's max m (base 2) and sum l in
// every thread, and its unnormalised P.V for columns tid, tid + 128, ...
// in o. q_r: the lane's elements of q (lane + 32 r). Every thread calls
// it.
template <typename T, int R>
struct SplitSmem {
  static constexpr int K = kDecodeKeys, LS = 32 * R;
  T* k_s;           // [K][LS]
  T* v_s;           // [K][LS]
  int64_t* rows_s;  // [K] element offsets of the rows (-1: masked)
  float* s_s;       // [K] scores, base 2
  __device__ explicit SplitSmem(unsigned char* raw)
      : k_s(reinterpret_cast<T*>(raw)),
        v_s(k_s + K * LS),
        rows_s(reinterpret_cast<int64_t*>(v_s + K * LS)),
        s_s(reinterpret_cast<float*>(rows_s + K)) {}
  __host__ __device__ static constexpr size_t bytes() {
    return sizeof(T) * 2 * K * LS + (sizeof(int64_t) + sizeof(float)) * K;
  }
};

template <typename T, int R, int C, typename Rows>
__device__ __forceinline__ void attend_split(
    const SplitSmem<T, R>& sm, const T* __restrict__ k,
    const T* __restrict__ v, const Rows& rows, const float (&q_r)[R], int b,
    int h, int heads, int head_dim, int k_lo, int keys, int fetched,
    float scale2, int width, float& m, float& l, float (&o)[C]) {
  constexpr int K = kDecodeKeys, LS = 32 * R, W = kDecodeThreads / 32;
  constexpr int KW = K / W;  // keys a warp scores
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid < K)
    sm.rows_s[tid] =
        tid < keys ? rows.row(b, k_lo + tid, fetched) * heads * head_dim +
                         int64_t(h) * head_dim
                   : -1;
  __syncthreads();
  stage_tile<T, LS>(
      sm.k_s,
      [&](int r) -> const T* { return sm.rows_s[r] >= 0 ? k + sm.rows_s[r]
                                                         : nullptr; },
      k, K, head_dim, width);
  cp_commit();
  stage_tile<T, LS>(
      sm.v_s,
      [&](int r) -> const T* { return sm.rows_s[r] >= 0 ? v + sm.rows_s[r]
                                                         : nullptr; },
      v, K, head_dim, width);
  cp_commit();
  cp_wait<1>();  // K
  __syncthreads();
  // scores: warp w takes keys w, w + W, ...
  float s[KW];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    const T* kr = sm.k_s + (warp + W * i) * LS;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = lane + 32 * r;
      // columns past head_dim are not staged: not read either
      if (d < head_dim) acc = fmaf(q_r[r], to_float(kr[d]), acc);
    }
    s[i] = acc;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < KW; ++i) s[i] += __shfl_xor_sync(kFullMask, s[i], off);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < KW; ++i) sm.s_s[warp + W * i] = s[i] * scale2;
  }
  cp_wait<0>();  // V
  __syncthreads();
  // every thread: the split's max and sum, and P.V for its columns
  m = kNegInf;
  for (int kk = 0; kk < keys; ++kk) m = fmaxf(m, sm.s_s[kk]);
  l = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < keys; ++kk) {
    const float p = exp2f(sm.s_s[kk] - m);
    l += p;
    const float pr = round_to<T>(p);  // p.astype(v.dtype), as in JAX
    const T* vr = sm.v_s + kk * LS;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tid + kDecodeThreads * c;
      if (d < head_dim) o[c] = fmaf(pr, to_float(vr[d]), o[c]);
    }
  }
  __syncthreads();  // the tiles are read before anyone stages again
}

// The lane's elements of q (lane + 32 r; zeros past head_dim), as float.
template <typename TQ, int R>
__device__ __forceinline__ void load_q(const TQ* qb, int head_dim,
                                       float (&q_r)[R]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = lane + 32 * r;
    q_r[r] = d < head_dim ? to_float(qb[d]) : 0.f;
  }
}

// One split of one (slot, head) a block, float32 partials to device
// memory: see the design note above. R: lanes of a row (32 R >= head_dim).
template <typename T, typename TQ, int R, typename Rows>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_split_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, Rows rows,
                        const int32_t* __restrict__ n_valid, int n_valid_all,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml,
                        unsigned int* __restrict__ counters,
                        TQ* __restrict__ out,
                        int heads, int head_dim, int n_split, float scale,
                        int width) {
  constexpr int K = kDecodeKeys, C = (32 * R + kDecodeThreads - 1) /
                                     kDecodeThreads;  // columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SplitSmem<T, R> sm(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, k_lo = split * K;
  int fetched = 0;  // issued before n_valid: the two trips overlap
  if (tid < K && k_lo + tid < rows.cap) fetched = rows.fetch(b, k_lo + tid);
  const int nv = max(0, min(n_valid ? n_valid[b] : n_valid_all, rows.cap));
  const int64_t at0 = int64_t(b) * n_split * heads + h;  // split 0's
  const int64_t at = at0 + int64_t(split) * heads;
  const int n_live = (nv + K - 1) / K;  // splits with a live key
  if (split >= n_live) {  // no live key in this split
    // only live splits arrive and merge; with none, split 0 writes zeros
    if (n_live == 0 && split == 0)
      for (int d = tid; d < head_dim; d += kDecodeThreads)
        out[(int64_t(b) * heads + h) * head_dim + d] = from_float<TQ>(0.f);
    return;
  }
  float q_r[R], m, l, o[C];
  load_q<TQ, R>(q + (int64_t(b) * heads + h) * head_dim, head_dim, q_r);
  attend_split<T, R, C>(sm, k, v, rows, q_r, b, h, heads, head_dim, k_lo,
                        min(K, nv - k_lo), fetched, scale * kLog2e, width, m,
                        l, o);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = tid + kDecodeThreads * c;
    if (d < head_dim) part_o[at * head_dim + d] = o[c];
  }
  if (tid == 0) {
    part_ml[2 * at] = m;
    part_ml[2 * at + 1] = l;
  }
  __shared__ bool last;
  __syncthreads();  // every thread's partials are written
  if (tid == 0) {
    // the block's partials visible to the device before its arrival (a
    // fence after the barrier covers the writes of the whole block)
    __threadfence();
    unsigned int* count = counters + int64_t(b) * heads + h;
    last = atomicAdd(count, 1u) == unsigned(n_live - 1);
    if (last) *count = 0u;  // clean for the next call (or graph replay)
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other blocks' partials after their arrivals
  merge_splits<TQ, C>(part_o, part_ml,
                      out + (int64_t(b) * heads + h) * head_dim, at0, heads,
                      head_dim, n_live);
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
    if (d < head_dim)
      out[int64_t(row) * head_dim + d] = o[r] * inv;
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

// Lanes of a row (32 per lane-row) at head dim d: ceil(d / 32); 0 for a
// d outside 1 ... 256.
int lanes_for(int head_dim) {
  if (head_dim < 1 || head_dim > 256) return 0;
  return (head_dim + 31) / 32;
}

// Calls f(T(), TQ(), integral_constant<int, R>()) for the K/V type, the
// query type and the split kernel's lanes (1, 2, 4 or 8, the power of two
// at or above lanes_for(head_dim)); anything else is refused.
template <typename F>
cudaError_t dispatch_decode(int kv_dtype, int q_dtype, int head_dim, F&& f) {
  const int lanes = lanes_for(head_dim);
  auto with_lanes = [&](auto tk, auto tq) -> cudaError_t {
    if (lanes == 1) return f(tk, tq, std::integral_constant<int, 1>());
    if (lanes == 2) return f(tk, tq, std::integral_constant<int, 2>());
    if (lanes >= 3 && lanes <= 4)
      return f(tk, tq, std::integral_constant<int, 4>());
    if (lanes >= 5 && lanes <= 8)
      return f(tk, tq, std::integral_constant<int, 8>());
    return cudaErrorInvalidValue;
  };
  using bf16 = __nv_bfloat16;
  if (kv_dtype == 0 && q_dtype == 0) return with_lanes(float(), float());
  if (kv_dtype == 0 && q_dtype == 1) return with_lanes(float(), bf16());
  if (kv_dtype == 1 && q_dtype == 0) return with_lanes(bf16(), float());
  if (kv_dtype == 1 && q_dtype == 1) return with_lanes(bf16(), bf16());
  return cudaErrorInvalidValue;
}

// The split kernel over `rows`, on n_split = ceil(rows.cap / kDecodeKeys)
// splits. work: the partials, slots * n_split * heads * (head_dim + 2)
// floats; counters: slots * heads zeroed arrival counters.
template <typename T, typename TQ, int R, typename Rows>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const Rows& rows, const void* n_valid,
                          int n_valid_all, void* work, void* counters,
                          void* out, int slots, int heads, int head_dim,
                          int n_split, float scale, cudaStream_t stream) {
  if (n_split != (rows.cap + kDecodeKeys - 1) / kDecodeKeys)
    return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(work);
  float* part_ml = part_o + int64_t(slots) * n_split * heads * head_dim;
  constexpr size_t smem = SplitSmem<T, R>::bytes();
  auto kernel = decode_split_kernel<T, TQ, R, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err) return err;
  }
  const int elem = sizeof(T), row_bytes = head_dim * elem;
  const int width = min(wide_copy_width(k, row_bytes, elem),
                        wide_copy_width(v, row_bytes, elem));
  // a cache of no rows still runs one block a (slot, head): it writes the
  // zeros
  kernel<<<dim3(heads, slots, max(n_split, 1)), kDecodeThreads, smem,
           stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), rows, static_cast<const int32_t*>(n_valid),
      n_valid_all, part_o, part_ml, static_cast<unsigned int*>(counters),
      static_cast<TQ*>(out), heads, head_dim, n_split, scale, width);
  return cudaGetLastError();
}

}  // namespace

// kv_dtype, q_dtype: 0 = float32, 1 = bfloat16, the type of the pools
// and that of q and out. q and out are (slots, heads, head_dim); the pools
// (num_pages, page_size, heads, head_dim); page_table (slots, table_width)
// and n_valid (slots,) int32. `work` is float32 device memory for the
// partials: slots * n_split * heads * (head_dim + 2) floats, where n_split
// = ceil(table_width * page_size / 32), which the caller passes and the
// call checks. `counters` is slots * heads unsigned ints, zero before the
// call and left zero by it, which no call running at the same time may
// share. Every pointer is device memory; nothing is allocated and nothing
// synchronises. One launch (the split kernel, whose last blocks merge);
// returns its cudaError_t (0 on success).
extern "C" int mxtpu_paged_decode_attention(
    int kv_dtype, int q_dtype, const void* q, const void* k_pages,
    const void* v_pages, const void* page_table, const void* n_valid,
    void* work, void* counters, void* out, int slots, int heads,
    int head_dim, int page_size, int num_pages, int table_width, int n_split,
    float scale, void* stream) {
  if (!lanes_for(head_dim) || page_size < 1 || table_width < 1 ||
      !n_valid || !counters)
    return cudaErrorInvalidValue;
  if (slots == 0 || heads == 0) return cudaSuccess;
  const PagedRows rows{static_cast<const int32_t*>(page_table), table_width,
                       page_size, num_pages, table_width * page_size};
  return dispatch_decode(
      kv_dtype, q_dtype, head_dim, [&](auto tk, auto tq, auto lanes) {
        using T = decltype(tk);
        using TQ = decltype(tq);
        return launch_decode<T, TQ, decltype(lanes)::value>(
            q, k_pages, v_pages, rows, n_valid, 0, work, counters, out,
            slots, heads, head_dim, n_split, scale,
            static_cast<cudaStream_t>(stream));
      });
}

// The same over dense caches (batch, cache_len, heads, head_dim), with
// n_split = ceil(cache_len / 32). n_valid is (batch,) int32, or null: then
// every sequence has n_valid_all live positions.
extern "C" int mxtpu_flash_decode(int kv_dtype, int q_dtype, const void* q,
                                  const void* k_cache, const void* v_cache,
                                  const void* n_valid, int n_valid_all,
                                  void* work, void* counters, void* out,
                                  int batch, int cache_len, int heads,
                                  int head_dim, int n_split, float scale,
                                  void* stream) {
  if (!lanes_for(head_dim) || cache_len < 0 || !counters)
    return cudaErrorInvalidValue;
  if (batch == 0 || heads == 0) return cudaSuccess;
  const DenseRows rows{cache_len};
  return dispatch_decode(
      kv_dtype, q_dtype, head_dim, [&](auto tk, auto tq, auto lanes) {
        using T = decltype(tk);
        using TQ = decltype(tq);
        return launch_decode<T, TQ, decltype(lanes)::value>(
            q, k_cache, v_cache, rows, n_valid, n_valid_all, work, counters,
            out, batch, heads, head_dim, n_split, scale,
            static_cast<cudaStream_t>(stream));
      });
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
