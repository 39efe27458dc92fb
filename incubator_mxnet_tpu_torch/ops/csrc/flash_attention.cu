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
// sequence. At the training shape (B 8, H 8, T 512, D 64, causal,
// float32: 8.4 M pairs) the forward needs 32.1 us at the SIMT float32
// rate (67 TFLOP/s). The backward runs on the tensor cores at three
// TF32 products per float32 product (below): at 495 TFLOP/s that is
// 19.6 us of tensor work for dQ and 26.1 us for dK/dV, while their bytes
// (each operand read or written once) need 12.6 and 15.1 us at
// 3.35 TB/s, so both are still bound by operations.
//
// Head dims: any D from 1 to 128. Each kernel is built for a padded
// D_p of 16, 32, 64 or 128, the smallest at or above D; columns D ...
// D_p - 1 are staged as zeros, which leaves every dot product exact, the
// scale is the caller's (1 / sqrt(D) of the true D), and only the first D
// columns of o, dq, dk and dv are written.
//
// Forward design (SIMT). One block of 256 threads per (batch * head, 64
// query rows). The 64 x 64 score tile (and the 64 x D_p output tile) is
// split into a 16 x 16 grid of threads, each owning 4 rows x 4 scores
// (4 x D_p/16 outputs) in registers, over float32 tiles staged in shared
// memory (transposed where the product sums over D, so every float4 read
// feeds 4 to 32 FMAs). The row max and sum are 16-lane shuffle reductions.
// With a causal mask the last query tiles walk the most keys and are
// handed out first.
//
// Backward design (tensor cores). Both kernels run four warps over the
// block's 64 owned rows (query rows for dQ, key rows for dK/dV), and
// every product is mma.sync.m16n8k8 in TF32 with float32 accumulators in
// registers. float32 keeps float32 accuracy by error compensation: each
// operand splits in registers into hi (x rounded to TF32) and lo = x - hi,
// and each product is hi.hi + hi.lo + lo.hi (3xTF32, about 1e-6
// relative, inside the 2e-4 gradient gates where one TF32 pass, about
// 1e-3, is not). bfloat16 operands, and p and ds rounded to bfloat16 at
// JAX's rounding points, are exact in TF32: one pass.
//   Why mma.sync and not wgmma: wgmma takes TF32 operands from shared
// memory only K-major, with no transpose flag. The products that sum over
// the walked rows (dQ += dS.K, dV += P^T.dO, dK += dS^T.Q) would need K,
// Q and dO staged a second time in the other layout, each as a hi and a
// lo copy: four copies of Q and of dO a stage in dK/dV, 128 KB at D 64,
// and no room for a second stage. mma.sync reads its fragments from one
// row-major copy with plain shared loads and splits them in registers.
// The k index of the products over the walked rows is permuted (mma slot
// t <-> walked row 2t, slot t + 4 <-> row 2t + 1), so the accumulators of
// S and dP are the A fragments of the next product as they stand: p and
// ds never leave registers. dK/dV computes S^T and dP^T (keys as rows),
// so the same holds there.
//   Warp tiles: up to D_p 64 the four warps sit 2 x 2, each owning 32 rows
// (two 16-row mma tiles) and half of every walked tile, so each walked
// fragment it loads and splits feeds two products; the two warps of a
// row add their partial sums in a fixed order at the end. At D_p 128
// (registers) they sit 4 x 1, 16 rows each. The walked tile is 64 rows
// for dQ up to D_p 64 and 32 otherwise.
//   Staging is asynchronous: cp.async into a ring of two stages, so the
// next K/V tile (dQ) or Q/dO/lse/delta tile (dK/dV) loads while the
// current one is multiplied. The copy width is chosen by shape at run
// time: 16 bytes where every operand's address, strides and D allow it,
// else 4 bytes (any float32 operand; bfloat16 with even strides), else
// one bfloat16 element at a time with plain loads (an odd D such as 6 in
// the model's layout). Rows at or past T are zero-filled by the copy.
//   Causal balance: a causal walk's length grows (dQ) or shrinks (dK/dV)
// with the row tile, so block i owns tiles i and n - 1 - i, one after the
// other: every block walks the same length. Without it the longest walk
// sets the kernel's time (tools/flash_bwd_variants.py times both).
//   What bounds them now: at the training shape dQ runs its 3 x TF32
// work at about a third of the rate mma.sync reaches on an H100 in a bare
// loop (tools/tensor_core_rate.py; PERF.md, PR 6): the kernels issue the
// fragment loads, the splits and the softmax beside each product.
// Splitting each walked tile once in shared memory, separate accumulators
// for the correction terms, and wgmma for dQ with the products of a tile
// waited for before its softmax, measured no faster by more than a few
// percent; wgmma pays only once the softmax overlaps the products.
//   Registers (ptxas -v, sm_90a, float32 / bfloat16; chip_smoke.py phase
// 1 prints them for every build) at D_p 16, 32, 64, 128: dQ 165 / 119,
// 180 / 159, 255 / 226, 168 / 165; dK/dV 118 / 125, 161 / 159,
// 237 / 252, 255 / 245. Spills: 4 bytes in float32 dQ at D_p 128, none
// elsewhere. Shared memory at D_p 64 (float32 / bfloat16): dQ 102 / 54
// KB, dK/dV 69 / 37 KB; at D_p 128 both 132 / 68 KB. So at the
// training shape dQ holds two blocks an SM (registers and shared memory)
// and dK/dV two (registers).
//
// Causal walks stop at the diagonal: the forward and dQ walk key tiles up
// to the block's last query row, dK/dV walks query tiles from the block's
// first key row on; a warp skips a walked tile masked for all its rows,
// and only a tile that crosses the diagonal or the end of the sequence
// evaluates the mask. There are no atomics: each output row is written by
// the one block that owns it, in a fixed order, so results are
// deterministic, as in the TPU design.
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
// the model's (B, T, H, D) tensors are read in place, without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kBlock = 64;       // rows a block owns
constexpr int kThreads = 256;    // forward: 16 x 16, a 4 x 4 score tile each
constexpr int kBwdThreads = 128;  // backward: four warps of 16 owned rows
constexpr int kPS = kBlock + 4;  // row stride of the forward's p tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

// Strides, in elements, of one (B, H, T, D) operand whose D stride is 1.
struct Layout {
  int64_t b, h, t;
};

template <typename T>
constexpr bool kIsFloat = std::is_same<T, float>::value;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (kIsFloat<T>) {
    return x;
  } else {
    return __float2bfloat16(x);
  }
}

// x rounded to T and back (the `.astype(dtype)` before a product in JAX).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// -- forward (SIMT) ----------------------------------------------------------

template <int D>
struct Dims {
  static_assert(D % 16 == 0 && D <= 128, "padded head dim 16 ... 128");
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

// Rows [t0, t0 + 64), columns [0, d) of one (b, h) slice as float32, into
// `nat` (row-major, [64][D + 4]) or `tr` (transposed, [D][64]), whichever
// is not null; rows at or past `seq` and columns d ... D - 1 become zeros.
// `vec`: 4-element loads (d is then a multiple of 4 and every row
// aligned), else one element at a time. Consecutive threads take
// consecutive rows, so the transposed stores, and the row-major ones at
// the padded stride D + 4, do not conflict in shared memory.
template <int D, typename T>
__device__ __forceinline__ void stage(float* nat, float* tr, const T* src,
                                      int64_t stride_t, int t0, int seq,
                                      int d, bool vec) {
  constexpr int NS = Dims<D>::NS;
  for (int i = threadIdx.x; i < kBlock * D / 4; i += kThreads) {
    const int r = i % kBlock, c = 4 * (i / kBlock);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < seq && c < d) {
      const T* p = src + (t0 + r) * stride_t + c;
      if (vec) {
        x = load4(p);
      } else {
        x.x = to_float(p[0]);
        if (c + 1 < d) x.y = to_float(p[1]);
        if (c + 2 < d) x.z = to_float(p[2]);
        if (c + 3 < d) x.w = to_float(p[3]);
      }
    }
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

// The tile index a query-row block works on: with a causal mask the last
// tiles walk the most keys, so they are handed out first.
__device__ __forceinline__ int query_tile(int causal) {
  return causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// The 64-row tile a backward block owns in its pass 0 or 1, or -1. With a
// causal mask a tile's walk grows (dQ) or shrinks (dK/dV) with its index,
// so block i takes tiles i and n - 1 - i: every block walks the same
// length, and the longest walk no longer sets the kernel's time.
__device__ __forceinline__ int row_tile(int pass, int seq, int causal) {
  const int n = (seq + kBlock - 1) / kBlock, i = blockIdx.x;
  if (pass == 0) return i;
  return causal && n - 1 - i > i ? n - 1 - i : -1;
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         (2 * D * kBlock + kBlock * Dims<D>::NS + kBlock * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Layout lq, Layout lk,
                     Layout lv, Layout lo, int heads, int seq, int head_dim,
                     float scale, int causal, int vec) {
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
  stage<D>(nullptr, q_t, q + b * lq.b + h * lq.h, lq.t, q0, seq, head_dim,
           vec);

  float acc[4][DC] = {}, m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.f;
  const int k_end = causal ? min(q0 + kBlock, seq) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // the previous tile is read
    stage<D>(nullptr, k_t, kb, lk.t, k0, seq, head_dim, vec);
    stage<D>(v_n, nullptr, vb, lv.t, k0, seq, head_dim, vec);
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
    // p, rounded to v's type, transposed into p_t
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (tx * 4 + j) * kPS + ty * 4) =
          make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]),
                      round_to<T>(s[2][j]), round_to<T>(s[3][j]));
    __syncthreads();
    gemm<DC>(acc, p_t + ty * 4, kPS, v_n + tx * DC, NS,
             min(kBlock, k_end - k0));
  }
  T* ob = o + b * lo.b + h * lo.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(row_sum(l[i]), 1e-30f), inv = 1.f / li;
    const int qi = q0 + ty * 4 + i;
    if (qi >= seq) continue;
    if (tx == 0) lse[int64_t(bh) * seq + qi] = m[i] + logf(li);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (tx * DC + c < head_dim)
        ob[qi * lo.t + tx * DC + c] = from_float<T>(acc[i][c] * inv);
  }
}

// -- backward (tensor cores) -------------------------------------------------

// Tile shape of a backward kernel at padded head dim D. A block owns 64
// rows, and its four warps sit (64 / (16 WM)) x WC over them: each warp
// owns WM 16-row mma tiles and multiplies the BN / WC walked rows of its
// column, so each walked-tile fragment it loads and splits feeds WM
// products. With WC 2 the two warps of a row hold partial sums of the
// same output rows, which are added in a fixed order at the end.
template <typename T, int D, bool kDkv>
struct Bwd {
  static_assert(D % 16 == 0 && D <= 128, "padded head dim 16 ... 128");
  static constexpr int WM = D <= 64 ? 2 : 1;  // 16-row mma tiles a warp owns
  static constexpr int WC = WM;  // warps side by side over the walked rows
  static constexpr int BN = D <= 64 && !kDkv ? 64 : 32;  // walked tile rows
  static constexpr int WB = BN / WC;  // walked rows a warp multiplies
  static constexpr int NT = WB / 8;   // their 8-row mma tiles
  // row stride of a staged tile, in elements: 16 bytes of padding, which
  // makes both fragment reads below conflict-free in shared memory
  static constexpr int LS = D + 16 / int(sizeof(T));
  // floats a lane holds in one 16 WM x D accumulator
  static constexpr int ACC = WM * D / 8 * 4;
  static constexpr size_t smem = sizeof(T) * (2 * kBlock + 4 * BN) * LS +
                                 (kDkv ? sizeof(float) * 4 * BN : 0);
  static_assert(WC == 1 || 2 * 32 * ACC * sizeof(float) <= smem,
                "the partial sums fit in the staged tiles' space");
};

// x = hi + lo for TF32 products: hi is x rounded to TF32 (add half of
// the 13 dropped mantissa bits, clear them), lo = x - hi (exact in
// float32, at most 2^-12 of x), passed as it stands: the tensor cores
// read a TF32 operand's top 19 bits, so lo is truncated there, an error
// of at most 2^-11 of lo, 2^-23 of x. A
// bfloat16 value (and a float rounded to one) is exact in TF32: hi = x,
// and lo is 0 and never multiplied.
template <typename T>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kIsFloat<T>) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// c += a * b on one 16 x 8 x 8 TF32 tile, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (ah + al) * (bh + bl) as ah.bh + ah.bl + al.bh (3xTF32) for float32,
// ah.bh alone for bfloat16. The small terms go first.
template <typename T>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  if constexpr (kIsFloat<T>) {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

// c[m][nt] += A_m . B_nt^T for the warp's WM 16-row tiles m of A and
// every 8-row tile nt of B: a product that sums over D. A is the warp's
// rows of a staged tile, B its rows of the walked tile (both [rows][LS]).
// mma fragments (lane = 4 g + t): A (g | g + 8, t | t + 4), B (k t |
// t + 4, n g), C (g | g + 8, 2t | 2t + 1). No branch inside: the loads,
// splits and products of all tiles interleave.
template <typename T, int D, int WM, int NT, int LS>
__device__ __forceinline__ void sum_over_d(float (&c)[WM][NT][4],
                                           const T* a, const T* b, int g,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[WM][4], al[WM][4];
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      const T* ar = a + (16 * m + g) * LS + kk * 8 + t;
      split<T>(to_float(ar[0]), ah[m][0], al[m][0]);
      split<T>(to_float(ar[8 * LS]), ah[m][1], al[m][1]);
      split<T>(to_float(ar[4]), ah[m][2], al[m][2]);
      split<T>(to_float(ar[8 * LS + 4]), ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* br = b + (nt * 8 + g) * LS + kk * 8 + t;
      uint32_t bh0, bl0, bh1, bl1;
      split<T>(to_float(br[0]), bh0, bl0);
      split<T>(to_float(br[4]), bh1, bl1);
#pragma unroll
      for (int m = 0; m < WM; ++m)
        mma3<T>(c[m][nt], ah[m], al[m], bh0, bh1, bl0, bl1);
    }
  }
}

// acc[m][dn] += P_m . B over the walked rows: P holds, per 16-row tile m,
// 16 rows x 8 walked rows per ks in the C layout of sum_over_d, B is the
// warp's rows of the walked tile ([rows][LS]). The k index is permuted
// (mma slot t <-> walked row 2t, slot t + 4 <-> row 2t + 1), which makes
// P's registers the A fragment as they stand: (c0, c2, c1, c3).
template <typename T, int D, int WM, int NT, int LS>
__device__ __forceinline__ void sum_over_rows(float (&acc)[WM][D / 8][4],
                                              const float (&p)[WM][NT][4],
                                              const T* b, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    uint32_t ah[WM][4], al[WM][4];
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      split<T>(p[m][ks][0], ah[m][0], al[m][0]);
      split<T>(p[m][ks][2], ah[m][1], al[m][1]);
      split<T>(p[m][ks][1], ah[m][2], al[m][2]);
      split<T>(p[m][ks][3], ah[m][3], al[m][3]);
    }
    const T* br = b + (ks * 8 + 2 * t) * LS + g;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      uint32_t bh0, bl0, bh1, bl1;
      split<T>(to_float(br[dn * 8]), bh0, bl0);
      split<T>(to_float(br[LS + dn * 8]), bh1, bl1);
#pragma unroll
      for (int m = 0; m < WM; ++m)
        mma3<T>(acc[m][dn], ah[m], al[m], bh0, bh1, bl0, bl1);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `bytes` (16 or 4) from global to shared memory, asynchronously; only
// the first `valid` of them are read, the rest are zero-filled.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  if constexpr (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most one group (the tile in flight) is pending
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Rows [t0, t0 + rows), columns [0, d) of one (b, h) slice into dst
// ([rows][LS]); rows at or past seq become zeros (columns d ... D_p - 1
// are zeroed once, up front). `width`: bytes a copy moves, 16 or 4
// (cp.async), else one bfloat16 element (plain loads and stores).
template <typename T, int LS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           int64_t stride_t, int t0,
                                           int rows, int seq, int d,
                                           int width) {
  const int per = width / int(sizeof(T));  // elements a copy moves
  const int chunks = d / per;              // copies a row
  for (int i = threadIdx.x; i < rows * chunks; i += kBwdThreads) {
    const int r = i / chunks, c = (i - r * chunks) * per;
    const bool in = t0 + r < seq;
    const T* s = in ? src + (t0 + r) * stride_t + c : src;
    T* o = dst + r * LS + c;
    if (width == 16) {
      cp_async<16>(o, s, in ? 16 : 0);
    } else if (width == 4) {
      cp_async<4>(o, s, in ? 4 : 0);
    } else {
      *o = in ? *s : from_float<T>(0.f);
    }
  }
}

// (B * H, T) float32 statistics [t0, t0 + n) into dst; zeros past seq.
__device__ __forceinline__ void stage_stat(float* dst, const float* src,
                                           int t0, int n, int seq) {
  for (int i = threadIdx.x; i < n; i += kBwdThreads) {
    const bool in = t0 + i < seq;
    cp_async<4>(dst + i, in ? src + t0 + i : src, in ? 4 : 0);
  }
}

// Zeros over n elements of staged tiles (n * sizeof(T) a multiple of 16).
template <typename T>
__device__ __forceinline__ void zero_tiles(T* p, int n) {
  float4* p4 = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < n * int(sizeof(T)) / 16; i += kBwdThreads)
    p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The warp's 16 WM rows (r0 + 16 m + g, ... + 8) of its accumulator into
// dst, columns below d, rows below seq.
template <typename T, int D, int WM>
__device__ __forceinline__ void put_rows(T* dst, int64_t stride_t, int r0,
                                         int seq, int d, int g, int t,
                                         const float (&acc)[WM][D / 8][4]) {
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * m + g + 8 * i;
      if (row >= seq) continue;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = dn * 8 + 2 * t + e;
          if (col < d)
            dst[row * stride_t + col] =
                from_float<T>(acc[m][dn][2 * i + e]);
        }
    }
}

// With two warps over the walked rows: the warp of column 1 hands its
// partial sums to the warp of column 0 through `scratch` (each lane's
// registers, lane-major, per warp row), and that warp adds them. A fixed
// order, so the result stays deterministic. Every thread calls it.
template <int WM, int D>
__device__ __forceinline__ void add_partner(float (&acc)[WM][D / 8][4],
                                            float* scratch, int wr, int wc,
                                            int lane) {
  constexpr int N = WM * D / 8 * 4;
  float* mine = scratch + wr * N * 32 + lane;
  if (wc == 1) {
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[((m * (D / 8) + dn) * 4 + e) * 32] = acc[m][dn][e];
  }
  __syncthreads();
  if (wc == 0) {
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][dn][e] += mine[((m * (D / 8) + dn) * 4 + e) * 32];
  }
  __syncthreads();
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldq,
                    int heads, int seq, int head_dim, float scale,
                    int causal, int width) {
  using P = Bwd<T, D, false>;
  constexpr int WM = P::WM, WC = P::WC, BN = P::BN, WB = P::WB,
                NT = P::NT, LS = P::LS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [64][LS], the owned rows
  T* do_s = q_s + kBlock * LS;              // [64][LS]
  T* k_s = do_s + kBlock * LS;              // [2][BN][LS], the key ring
  T* v_s = k_s + 2 * BN * LS;               // [2][BN][LS]
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, wr = warp / WC, wc = warp % WC,
            lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  for (int pass = 0; pass < 2; ++pass) {
    const int tile = row_tile(pass, seq, causal);
    if (tile < 0) break;
    const int q0 = tile * kBlock;
    if (head_dim < D) {
      zero_tiles(q_s, (2 * kBlock + 4 * BN) * LS);
      __syncthreads();
    }
    stage_rows<T, LS>(q_s, q + b * lq.b + h * lq.h, lq.t, q0, kBlock, seq,
                      head_dim, width);
    stage_rows<T, LS>(do_s, dout + b * ldo.b + h * ldo.h, ldo.t, q0, kBlock,
                      seq, head_dim, width);
    stage_rows<T, LS>(k_s, kb, lk.t, 0, BN, seq, head_dim, width);
    stage_rows<T, LS>(v_s, vb, lv.t, 0, BN, seq, head_dim, width);
    cp_commit();

    const int w0 = q0 + 16 * WM * wr;  // the warp's first query row
    // p = exp2(s * scale * log2(e) - lse * log2(e)): one FFMA and one EX2
    const float scale2 = scale * kLog2e;
    float row_lse[WM][2], row_delta[WM][2];  // lse in base 2
  #pragma unroll
    for (int m = 0; m < WM; ++m)
  #pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = w0 + 16 * m + g + 8 * i;
        row_lse[m][i] = r < seq ? lse[int64_t(bh) * seq + r] * kLog2e : 0.f;
        row_delta[m][i] = r < seq ? delta[int64_t(bh) * seq + r] : 0.f;
      }
    const int k_end = causal ? min(q0 + kBlock, seq) : seq;
    const int w_end = causal ? w0 + 16 * WM : seq;  // keys its rows see
    const int tiles = (k_end + BN - 1) / BN;
    float acc[WM][D / 8][4] = {};
    for (int j = 0; j < tiles; ++j) {
      const int k0 = j * BN;
      if (j + 1 < tiles) {
        const int slot = (j + 1) & 1;
        stage_rows<T, LS>(k_s + slot * BN * LS, kb, lk.t, k0 + BN, BN, seq,
                          head_dim, width);
        stage_rows<T, LS>(v_s + slot * BN * LS, vb, lv.t, k0 + BN, BN, seq,
                          head_dim, width);
      }
      cp_commit();
      cp_wait_one();
      __syncthreads();
      const int kc = k0 + wc * WB;  // the warp's first key of the tile
      const T* kt = k_s + ((j & 1) * BN + wc * WB) * LS;
      const T* vt = v_s + ((j & 1) * BN + wc * WB) * LS;
      if (kc < w_end) {  // else the warp's keys are masked for all its rows
        float s[WM][NT][4] = {}, dp[WM][NT][4] = {};
        sum_over_d<T, D, WM, NT, LS>(s, q_s + (w0 - q0) * LS, kt, g, t);
        sum_over_d<T, D, WM, NT, LS>(dp, do_s + (w0 - q0) * LS, vt, g, t);
        const bool edge = (causal && kc + WB - 1 > w0) || kc + WB > seq;
  #pragma unroll
        for (int m = 0; m < WM; ++m)
  #pragma unroll
          for (int nt = 0; nt < NT; ++nt)
  #pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = w0 + 16 * m + g + 8 * (e >> 1);
              const int key = kc + nt * 8 + 2 * t + (e & 1);
              const bool live =
                  !edge || (key < seq && (!causal || key <= row));
              const float p =
                  live ? exp2f(s[m][nt][e] * scale2 - row_lse[m][e >> 1])
                       : 0.f;
              s[m][nt][e] = round_to<T>(
                  p * (dp[m][nt][e] - row_delta[m][e >> 1]) * scale);
            }
        sum_over_rows<T, D, WM, NT, LS>(acc, s, kt, g, t);
      }
      __syncthreads();  // the slot is read before the next tile refills it
    }
    if constexpr (WC == 2)
      add_partner<WM, D>(acc, reinterpret_cast<float*>(smem_raw), wr, wc,
                         lane);
    if (wc == 0)
      put_rows<T, D, WM>(dq + b * ldq.b + h * ldq.h, ldq.t, w0, seq, head_dim,
                         g, t, acc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                     Layout ldo, Layout ldk, Layout ldv, int heads, int seq,
                     int head_dim, float scale, int causal, int width) {
  using P = Bwd<T, D, true>;
  constexpr int WM = P::WM, WC = P::WC, BN = P::BN, WB = P::WB,
                NT = P::NT, LS = P::LS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [64][LS], the owned keys
  T* v_s = k_s + kBlock * LS;               // [64][LS]
  T* q_s = v_s + kBlock * LS;               // [2][BN][LS], the query ring
  T* do_s = q_s + 2 * BN * LS;              // [2][BN][LS]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BN * LS);  // [2][BN]
  float* delta_s = lse_s + 2 * BN;                              // [2][BN]
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, wr = warp / WC, wc = warp % WC,
            lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* qb = q + b * lq.b + h * lq.h;
  const T* dob = dout + b * ldo.b + h * ldo.h;
  const float* lse_b = lse + int64_t(bh) * seq;
  const float* delta_b = delta + int64_t(bh) * seq;
  for (int pass = 0; pass < 2; ++pass) {
    const int tile = row_tile(pass, seq, causal);
    if (tile < 0) break;
    const int k0 = tile * kBlock;
    if (head_dim < D) {
      zero_tiles(k_s, (2 * kBlock + 4 * BN) * LS);
      __syncthreads();
    }
    // query rows before k0 see none of this block's keys
    const int q_start = causal ? k0 : 0;
    const int tiles = (seq - q_start + BN - 1) / BN;
    stage_rows<T, LS>(k_s, k + b * lk.b + h * lk.h, lk.t, k0, kBlock, seq,
                      head_dim, width);
    stage_rows<T, LS>(v_s, v + b * lv.b + h * lv.h, lv.t, k0, kBlock, seq,
                      head_dim, width);
    stage_rows<T, LS>(q_s, qb, lq.t, q_start, BN, seq, head_dim, width);
    stage_rows<T, LS>(do_s, dob, ldo.t, q_start, BN, seq, head_dim, width);
    stage_stat(lse_s, lse_b, q_start, BN, seq);
    stage_stat(delta_s, delta_b, q_start, BN, seq);
    cp_commit();

    const int w0 = k0 + 16 * WM * wr;  // the warp's first key row
    const float scale2 = scale * kLog2e;  // p = exp2(s * scale2 - lse * log2e)
    float dk_acc[WM][D / 8][4] = {}, dv_acc[WM][D / 8][4] = {};
    for (int j = 0; j < tiles; ++j) {
      const int qs = q_start + j * BN;
      if (j + 1 < tiles) {
        const int slot = (j + 1) & 1;
        stage_rows<T, LS>(q_s + slot * BN * LS, qb, lq.t, qs + BN, BN, seq,
                          head_dim, width);
        stage_rows<T, LS>(do_s + slot * BN * LS, dob, ldo.t, qs + BN, BN, seq,
                          head_dim, width);
        stage_stat(lse_s + slot * BN, lse_b, qs + BN, BN, seq);
        stage_stat(delta_s + slot * BN, delta_b, qs + BN, BN, seq);
      }
      cp_commit();
      cp_wait_one();
      __syncthreads();
      const int qc = qs + wc * WB;  // the warp's first query of the tile
      const T* qt = q_s + ((j & 1) * BN + wc * WB) * LS;
      const T* dot = do_s + ((j & 1) * BN + wc * WB) * LS;
      const float* lse_t = lse_s + (j & 1) * BN + wc * WB;
      const float* delta_t = delta_s + (j & 1) * BN + wc * WB;
      // else the warp's queries all precede its keys: all masked
      if (!causal || qc + WB > w0) {
        // transposed scores: rows are the warp's keys, columns the queries
        float s[WM][NT][4] = {}, dp[WM][NT][4] = {};
        sum_over_d<T, D, WM, NT, LS>(s, k_s + (w0 - k0) * LS, qt, g, t);
        sum_over_d<T, D, WM, NT, LS>(dp, v_s + (w0 - k0) * LS, dot, g, t);
        const bool edge =
            (causal && qc < w0 + 16 * WM - 1) || qc + WB > seq;
  #pragma unroll
        for (int m = 0; m < WM; ++m)
  #pragma unroll
          for (int nt = 0; nt < NT; ++nt)
  #pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = w0 + 16 * m + g + 8 * (e >> 1);
              const int col = nt * 8 + 2 * t + (e & 1), query = qc + col;
              const bool live =
                  !edge || (query < seq && (!causal || key <= query));
              const float p =
                  live ? exp2f(s[m][nt][e] * scale2 - lse_t[col] * kLog2e)
                       : 0.f;
              dp[m][nt][e] =
                  round_to<T>(p * (dp[m][nt][e] - delta_t[col]) * scale);
              s[m][nt][e] = round_to<T>(p);
            }
        sum_over_rows<T, D, WM, NT, LS>(dv_acc, s, dot, g, t);
        sum_over_rows<T, D, WM, NT, LS>(dk_acc, dp, qt, g, t);
      }
      __syncthreads();  // the slot is read before the next tile refills it
    }
    if constexpr (WC == 2) {
      float* scratch = reinterpret_cast<float*>(smem_raw);
      add_partner<WM, D>(dk_acc, scratch, wr, wc, lane);
      add_partner<WM, D>(dv_acc, scratch, wr, wc, lane);
    }
    if (wc == 0) {
      put_rows<T, D, WM>(dk + b * ldk.b + h * ldk.h, ldk.t, w0, seq, head_dim,
                         g, t, dk_acc);
      put_rows<T, D, WM>(dv + b * ldv.b + h * ldv.h, ldv.t, w0, seq, head_dim,
                         g, t, dv_acc);
    }
  }
}

// -- host side ---------------------------------------------------------------

// The padded head dim the kernels are built for: the smallest of 16, 32,
// 64 and 128 at or above d; 0 for a d outside 1 ... 128.
int padded_dim(int d) {
  if (d < 1 || d > 128) return 0;
  int p = 16;
  while (p < d) p *= 2;
  return p;
}

// Calls f(T(), integral_constant<int, D_p>()) for the element type and the
// padded head dim of head_dim; anything else is refused.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F&& f) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
#define MXTPU_FLASH_CASE(D)                                             \
  case D:                                                               \
    return dtype ? f(__nv_bfloat16(), std::integral_constant<int, D>()) \
                 : f(float(), std::integral_constant<int, D>());
  switch (padded_dim(head_dim)) {
    MXTPU_FLASH_CASE(16)
    MXTPU_FLASH_CASE(32)
    MXTPU_FLASH_CASE(64)
    MXTPU_FLASH_CASE(128)
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

// One block per 64-row tile (per pair of tiles for the causal backward,
// see row_tile) and (batch, head).
dim3 grid_for(int batch, int heads, int seq, bool pairs = false) {
  const int n = (seq + kBlock - 1) / kBlock;
  return dim3(pairs ? (n + 1) / 2 : n, batch * heads);
}

// Whether copies of `bytes` bytes of the first n operands stay aligned and
// inside a row: every address, every batch, head and row stride (in
// bytes) and the row's D elements are multiples of `bytes`.
bool aligned_to(int bytes, int elem, int head_dim, const void* const* ptrs,
                int n, const int64_t* strides) {
  if (int64_t(head_dim) * elem % bytes) return false;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % bytes) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] * elem % bytes) return false;
  }
  return true;
}

// Bytes each staging copy of the backward kernels moves (16 or 4 with
// cp.async, else one element), for the operands q, k, v, dO.
int copy_width(int elem, int head_dim, const void* const* ptrs,
               const int64_t* strides) {
  if (aligned_to(16, elem, head_dim, ptrs, 4, strides)) return 16;
  if (aligned_to(4, elem, head_dim, ptrs, 4, strides)) return 4;
  return elem;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every (B, H, T, D) operand, D
// from 1 to 128. Each operand's batch, head and row strides (in elements)
// come in `strides`, three per operand in argument order; its D stride
// must be 1, and its address aligned to its element. Any other stride
// runs: the kernels pick their widest copy that every input's address and
// strides allow (16 bytes, 4, or one element). lse and delta are
// contiguous (B * H, T) float32. Every pointer is device memory; nothing
// is allocated and nothing synchronises. Returns the launch's cudaError_t
// (0 on success).
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
    const void* in[] = {q, k, v};
    const int elem = sizeof(T);
    const int vec = aligned_to(4 * elem, elem, head_dim, in, 3, strides);
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = allow_smem(kernel, fwd_smem<D>());
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq), kThreads, fwd_smem<D>(),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), layout_at(strides, 0),
        layout_at(strides, 1), layout_at(strides, 2), layout_at(strides, 3),
        heads, seq, head_dim, scale, causal, vec);
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
    const void* in[] = {q, k, v, dout};
    const int width = copy_width(sizeof(T), head_dim, in, strides);
    auto kernel = flash_dq_kernel<T, D>;
    constexpr size_t smem = Bwd<T, D, false>::smem;
    cudaError_t err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq, causal), kBwdThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), layout_at(strides, 0), layout_at(strides, 1),
        layout_at(strides, 2), layout_at(strides, 3), layout_at(strides, 4),
        heads, seq, head_dim, scale, causal, width);
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
    const void* in[] = {q, k, v, dout};
    const int width = copy_width(sizeof(T), head_dim, in, strides);
    auto kernel = flash_dkv_kernel<T, D>;
    constexpr size_t smem = Bwd<T, D, true>::smem;
    cudaError_t err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq, causal), kBwdThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), layout_at(strides, 0),
        layout_at(strides, 1), layout_at(strides, 2), layout_at(strides, 3),
        layout_at(strides, 4), layout_at(strides, 5), heads, seq, head_dim,
        scale, causal, width);
    return cudaGetLastError();
  });
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
