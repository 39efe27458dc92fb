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
// sequence. All three run on the tensor cores at three TF32 products per
// float32 product (below). At the training shape (B 8, H 8, T 512, D 64,
// causal, float32: 8.4 M pairs) and 495 TFLOP/s that is 13.0 us of tensor
// work for the forward, 19.6 us for dQ and 26.1 us for dK/dV, while their
// bytes (each operand read or written once) need 10.0, 12.6 and 15.1 us
// at 3.35 TB/s, so all three are still bound by operations.
//
// Head dims: any D from 1 to 256. Each kernel is built for a padded
// D_p of 16, 32, 64, 128 or 256, the smallest at or above D; columns D ...
// D_p - 1 are staged as zeros, which leaves every dot product exact, the
// scale is the caller's (1 / sqrt(D) of the true D), and only the first D
// columns of o, dq, dk and dv are written.
//
// D_p 256 has a tile of its own: a 16 x 256 accumulator takes 128
// registers a lane (two of them in dK/dV), so a block runs eight warps,
// two over each 16-row tile, each owning half of the D columns of the
// output (o, dq, dk and dv). Both warps of a row tile compute the tile's
// S (and dP), which sum over all of D: the scores are recomputed rather
// than passed through shared memory, so the two warps never wait on each
// other. Walked tiles shrink to 16 rows, which keeps two stages of the
// ring in shared memory (float32: forward 133 KB, backward 200 KB); one
// block an SM.
//
// Forward design (tensor cores). One block of four warps per (batch *
// head, 64 query rows), each warp owning 16 whole query rows: it
// multiplies every key of each key tile, so no warp combines another's
// sums. S = Q.K^T and O += P.V are mma.sync products built from the
// backward's parts (tf32_mma.cuh): the permuted k index makes the S
// accumulators P.V's A fragments, so p, the running max and sum and the O
// accumulators stay in registers, and a row's max and sum reduce over the
// 4 lanes of a quad. float32 runs 3 x TF32 (the lse it writes is what dQ
// and dK/dV recompute p from); bfloat16 one pass, p rounded to v's type
// before P.V as in JAX. Key and value tiles (64 keys up to D_p 64, 32 at
// D_p 128, for registers) stream through a cp.async ring of two stages,
// the next tile in flight while the current one is multiplied, with the
// copy width chosen by shape as below. With a causal mask block i owns
// query tiles i and n - 1 - i, so every block walks the same number of
// key tiles.
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
// sets the kernel's time (tools/kernel_variants.py times both).
//   What bounds them now: at the training shape dQ runs its 3 x TF32
// work at about a third of the rate mma.sync reaches on an H100 in a bare
// loop (tools/tensor_core_rate.py; PERF.md, PR 6): the kernels issue the
// fragment loads, the splits and the softmax beside each product.
// Splitting each walked tile once in shared memory, separate accumulators
// for the correction terms, and wgmma for dQ with the products of a tile
// waited for before its softmax, measured no faster by more than a few
// percent; wgmma pays only once the softmax overlaps the products.
//   Registers (ptxas -v, sm_90a, float32 / bfloat16; chip_smoke.py phase
// 1 prints them for every build) at D_p 16, 32, 64, 128: forward 89 / 88,
// 101 / 93, 131 / 128, 133 / 124; dQ 165 / 120, 166 / 159, 255 / 222,
// 166 / 168; dK/dV 102 / 96, 161 / 164, 237 / 253, 255 / 247. Spills: 4
// bytes in float32 dK/dV at D_p 128, none elsewhere. Shared memory at D_p
// 64 (float32 / bfloat16): forward 87 / 46 KB, dQ 102 / 54 KB, dK/dV 69 /
// 37 KB; at D_p 128 the forward 101 / 52 KB, the backward 132 / 68 KB. So
// at the training shape every kernel holds two blocks an SM.
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

#include "tf32_mma.cuh"

namespace {

constexpr int kBlock = 64;  // rows a block owns
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Strides, in elements, of one (B, H, T, D) operand whose D stride is 1.
struct Layout {
  int64_t b, h, t;
};

// The 64-row tile a block owns in its pass 0 or 1, or -1. With a causal
// mask a tile's walk grows (forward, dQ) or shrinks (dK/dV) with its index,
// so block i takes tiles i and n - 1 - i: every block walks the same
// length, and the longest walk no longer sets the kernel's time.
__device__ __forceinline__ int row_tile(int pass, int seq, int causal) {
  const int n = (seq + kBlock - 1) / kBlock, i = blockIdx.x;
  if (pass == 0) return i;
  return causal && n - 1 - i > i ? n - 1 - i : -1;
}

// Rows [t0, t0 + rows), columns [0, d) of one (b, h) slice into dst
// ([rows][LS]); rows at or past seq become zeros (columns d ... D_p - 1
// are zeroed once, up front). `width` as for stage_tile.
template <typename T, int LS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           int64_t stride_t, int t0,
                                           int rows, int seq, int d,
                                           int width) {
  stage_tile<T, LS>(
      dst,
      [&](int r) -> const T* {
        return t0 + r < seq ? src + (t0 + r) * stride_t : nullptr;
      },
      src, rows, d, width);
}

// (B * H, T) float32 statistics [t0, t0 + n) into dst; zeros past seq.
__device__ __forceinline__ void stage_stat(float* dst, const float* src,
                                           int t0, int n, int seq) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = t0 + i < seq;
    cp_async<4>(dst + i, in ? src + t0 + i : src, in ? 4 : 0);
  }
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

// -- forward (tensor cores) --------------------------------------------------

// Warps over the D columns of an output at padded head dim D: two at
// D_p 256, where each owns 128 columns (see the head-dim note above).
template <int D>
struct Cols {
  static constexpr int WD = D > 128 ? 2 : 1;  // warps over the columns
  static constexpr int DW = D / WD;           // columns a warp owns
  static constexpr int kThreads = 128 * WD;   // four warps per column part
};

// Tile shape of the forward at padded head dim D: four warps of 16 query
// rows (times Cols::WD), each over every key of a BN-row key tile (64 keys
// up to D 64; 32 at D 128, where the 16 x 128 output accumulator takes 64
// registers a lane; 16 at D 256).
template <typename T, int D>
struct Fwd : Cols<D> {
  static_assert(D % 16 == 0 && D <= 256, "padded head dim 16 ... 256");
  static constexpr int BN = D <= 64 ? 64 : D <= 128 ? 32 : 16;  // key tile
  static constexpr int NT = BN / 8;  // its 8-key mma tiles
  static constexpr int LS = D + 16 / int(sizeof(T));  // as Bwd::LS
  static constexpr size_t smem = sizeof(T) * (kBlock + 4 * BN) * LS;
};

template <typename T, int D>
__global__ void __launch_bounds__(Cols<D>::kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Layout lq, Layout lk,
                     Layout lv, Layout lo, int heads, int seq, int head_dim,
                     float scale, int causal, int width) {
  using P = Fwd<T, D>;
  constexpr int BN = P::BN, NT = P::NT, LS = P::LS, DW = P::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [64][LS], the owned rows
  T* k_s = q_s + kBlock * LS;               // [2][BN][LS], the key ring
  T* v_s = k_s + 2 * BN * LS;               // [2][BN][LS]
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  // warp: the 16-row tile; wd: the part of the D columns the warp owns
  const int warp = threadIdx.x / 32 % 4, wd = threadIdx.x / 128,
            lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  // scores in base 2, p = exp2(s * scale * log2(e) - m): one FFMA, one EX2
  const float scale2 = scale * kLog2e;
  for (int pass = 0; pass < 2; ++pass) {
    const int tile = row_tile(pass, seq, causal);
    if (tile < 0) break;
    const int q0 = tile * kBlock;
    if (head_dim < D) {
      zero_tiles(q_s, (kBlock + 4 * BN) * LS);
      __syncthreads();
    }
    stage_rows<T, LS>(q_s, q + b * lq.b + h * lq.h, lq.t, q0, kBlock, seq,
                      head_dim, width);
    stage_rows<T, LS>(k_s, kb, lk.t, 0, BN, seq, head_dim, width);
    stage_rows<T, LS>(v_s, vb, lv.t, 0, BN, seq, head_dim, width);
    cp_commit();

    const int w0 = q0 + 16 * warp;  // the warp's first query row
    const int k_end = causal ? min(q0 + kBlock, seq) : seq;
    // the warp computes while it has rows below seq and keys its rows see
    const int w_end = w0 >= seq ? 0 : causal ? w0 + 16 : seq;
    const int tiles = (k_end + BN - 1) / BN;
    // per lane: rows g and g + 8 of the warp, their running max (base 2)
    // and this lane's share of their sums
    float acc[1][DW / 8][4] = {}, m[2] = {kNegInf, kNegInf}, l[2] = {};
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
      cp_wait<1>();
      __syncthreads();
      if (k0 < w_end) {  // else the tile is masked for all the warp's rows
        const T* kt = k_s + (j & 1) * BN * LS;
        float s[1][NT][4] = {};
        sum_over_d<T, T, D, 1, NT, LS, LS>(s, q_s + 16 * warp * LS, kt, g,
                                           t);
        const bool edge = (causal && k0 + BN - 1 > w0) || k0 + BN > seq;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = w0 + g + 8 * (e >> 1);
            const int key = k0 + nt * 8 + 2 * t + (e & 1);
            const bool live =
                !edge || (key < seq && (!causal || key <= row));
            s[0][nt][e] = live ? s[0][nt][e] * scale2 : kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[0][nt][e]);
          }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], quad_max(mx[i]));
          alpha[i] = exp2f(m[i] - m_new);
          l[i] *= alpha[i];
          m[i] = m_new;
        }
#pragma unroll
        for (int dn = 0; dn < DW / 8; ++dn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][dn][e] *= alpha[e >> 1];
        // p, summed as it stands and rounded to v's type for P.V
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[0][nt][e] - m[e >> 1]);
            l[e >> 1] += p;
            s[0][nt][e] = round_to<T>(p);
          }
        sum_over_rows<T, DW, 1, NT, LS>(
            acc, s, v_s + (j & 1) * BN * LS + wd * DW, g, t);
      }
      __syncthreads();  // the slot is read before the next tile refills it
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = fmaxf(quad_sum(l[i]), 1e-30f), inv = 1.f / li;
      const int row = w0 + g + 8 * i;
      if (t == 0 && wd == 0 && row < seq)
        lse[int64_t(bh) * seq + row] = m[i] * kLn2 + logf(li);
#pragma unroll
      for (int dn = 0; dn < DW / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[0][dn][2 * i + e] *= inv;
    }
    put_rows<T, DW, 1>(o + b * lo.b + h * lo.h + wd * DW, lo.t, w0, seq,
                       head_dim - wd * DW, g, t, acc);
  }
}

// -- backward (tensor cores) -------------------------------------------------

// Tile shape of a backward kernel at padded head dim D. A block owns 64
// rows, and its four warps sit (64 / (16 WM)) x WC over them: each warp
// owns WM 16-row mma tiles and multiplies the BN / WC walked rows of its
// column, so each walked-tile fragment it loads and splits feeds WM
// products. With WC 2 the two warps of a row hold partial sums of the
// same output rows, which are added in a fixed order at the end. At D_p
// 256 each of them is two warps (Cols::WD), one per half of the columns.
template <typename T, int D, bool kDkv>
struct Bwd : Cols<D> {
  static_assert(D % 16 == 0 && D <= 256, "padded head dim 16 ... 256");
  static constexpr int WM = D <= 64 ? 2 : 1;  // 16-row mma tiles a warp owns
  static constexpr int WC = WM;  // warps side by side over the walked rows
  static constexpr int BN =  // walked tile rows
      D <= 64 && !kDkv ? 64 : D <= 128 ? 32 : 16;
  static constexpr int WB = BN / WC;  // walked rows a warp multiplies
  static constexpr int NT = WB / 8;   // their 8-row mma tiles
  // row stride of a staged tile, in elements: 16 bytes of padding, which
  // makes both fragment reads below conflict-free in shared memory
  static constexpr int LS = D + 16 / int(sizeof(T));
  // floats a lane holds in one 16 WM x DW accumulator
  static constexpr int ACC = WM * Cols<D>::DW / 8 * 4;
  static constexpr size_t smem = sizeof(T) * (2 * kBlock + 4 * BN) * LS +
                                 (kDkv ? sizeof(float) * 4 * BN : 0);
  static_assert(WC == 1 || 2 * 32 * ACC * sizeof(float) <= smem,
                "the partial sums fit in the staged tiles' space");
};

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
__global__ void __launch_bounds__(Cols<D>::kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldq,
                    int heads, int seq, int head_dim, float scale,
                    int causal, int width) {
  using P = Bwd<T, D, false>;
  constexpr int WM = P::WM, WC = P::WC, BN = P::BN, WB = P::WB,
                NT = P::NT, LS = P::LS, DW = P::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [64][LS], the owned rows
  T* do_s = q_s + kBlock * LS;              // [64][LS]
  T* k_s = do_s + kBlock * LS;              // [2][BN][LS], the key ring
  T* v_s = k_s + 2 * BN * LS;               // [2][BN][LS]
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  // wd: the part of the D columns of the output the warp owns
  const int warp = threadIdx.x / 32 % 4, wr = warp / WC, wc = warp % WC,
            wd = threadIdx.x / 128, lane = threadIdx.x % 32, g = lane / 4,
            t = lane % 4;
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
    float acc[WM][DW / 8][4] = {};
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
      cp_wait<1>();
      __syncthreads();
      const int kc = k0 + wc * WB;  // the warp's first key of the tile
      const T* kt = k_s + ((j & 1) * BN + wc * WB) * LS;
      const T* vt = v_s + ((j & 1) * BN + wc * WB) * LS;
      if (kc < w_end) {  // else the warp's keys are masked for all its rows
        float s[WM][NT][4] = {}, dp[WM][NT][4] = {};
        sum_over_d<T, T, D, WM, NT, LS, LS>(s, q_s + (w0 - q0) * LS, kt, g, t);
        sum_over_d<T, T, D, WM, NT, LS, LS>(dp, do_s + (w0 - q0) * LS, vt, g, t);
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
        sum_over_rows<T, DW, WM, NT, LS>(acc, s, kt + wd * DW, g, t);
      }
      __syncthreads();  // the slot is read before the next tile refills it
    }
    if constexpr (WC == 2)
      add_partner<WM, DW>(acc, reinterpret_cast<float*>(smem_raw), wr, wc,
                          lane);
    if (wc == 0)
      put_rows<T, DW, WM>(dq + b * ldq.b + h * ldq.h + wd * DW, ldq.t, w0,
                          seq, head_dim - wd * DW, g, t, acc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cols<D>::kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                     Layout ldo, Layout ldk, Layout ldv, int heads, int seq,
                     int head_dim, float scale, int causal, int width) {
  using P = Bwd<T, D, true>;
  constexpr int WM = P::WM, WC = P::WC, BN = P::BN, WB = P::WB,
                NT = P::NT, LS = P::LS, DW = P::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [64][LS], the owned keys
  T* v_s = k_s + kBlock * LS;               // [64][LS]
  T* q_s = v_s + kBlock * LS;               // [2][BN][LS], the query ring
  T* do_s = q_s + 2 * BN * LS;              // [2][BN][LS]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BN * LS);  // [2][BN]
  float* delta_s = lse_s + 2 * BN;                              // [2][BN]
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  // wd: the part of the D columns of the output the warp owns
  const int warp = threadIdx.x / 32 % 4, wr = warp / WC, wc = warp % WC,
            wd = threadIdx.x / 128, lane = threadIdx.x % 32, g = lane / 4,
            t = lane % 4;
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
    float dk_acc[WM][DW / 8][4] = {}, dv_acc[WM][DW / 8][4] = {};
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
      cp_wait<1>();
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
        sum_over_d<T, T, D, WM, NT, LS, LS>(s, k_s + (w0 - k0) * LS, qt, g, t);
        sum_over_d<T, T, D, WM, NT, LS, LS>(dp, v_s + (w0 - k0) * LS, dot, g, t);
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
        sum_over_rows<T, DW, WM, NT, LS>(dv_acc, s, dot + wd * DW, g, t);
        sum_over_rows<T, DW, WM, NT, LS>(dk_acc, dp, qt + wd * DW, g, t);
      }
      __syncthreads();  // the slot is read before the next tile refills it
    }
    if constexpr (WC == 2) {
      float* scratch = reinterpret_cast<float*>(smem_raw);
      add_partner<WM, DW>(dk_acc, scratch, wr, wc, lane);
      add_partner<WM, DW>(dv_acc, scratch, wr, wc, lane);
    }
    if (wc == 0) {
      put_rows<T, DW, WM>(dk + b * ldk.b + h * ldk.h + wd * DW, ldk.t, w0,
                          seq, head_dim - wd * DW, g, t, dk_acc);
      put_rows<T, DW, WM>(dv + b * ldv.b + h * ldv.h + wd * DW, ldv.t, w0,
                          seq, head_dim - wd * DW, g, t, dv_acc);
    }
  }
}

// -- host side ---------------------------------------------------------------

// The padded head dim the kernels are built for: the smallest of 16, 32,
// 64, 128 and 256 at or above d; 0 for a d outside 1 ... 256.
int padded_dim(int d) {
  if (d < 1 || d > 256) return 0;
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
    MXTPU_FLASH_CASE(256)
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

// One block per 64-row tile (per pair of tiles when causal, see row_tile)
// and (batch, head).
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

// Bytes each staging copy moves (16 or 4 with cp.async, else one
// element), for the kernel's n input operands (q, k, v, and dO).
int copy_width(int elem, int head_dim, const void* const* ptrs, int n,
               const int64_t* strides) {
  if (aligned_to(16, elem, head_dim, ptrs, n, strides)) return 16;
  if (aligned_to(4, elem, head_dim, ptrs, n, strides)) return 4;
  return elem;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every (B, H, T, D) operand, D
// from 1 to 256. Each operand's batch, head and row strides (in elements)
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
    const int width = copy_width(sizeof(T), head_dim, in, 3, strides);
    auto kernel = flash_fwd_kernel<T, D>;
    constexpr size_t smem = Fwd<T, D>::smem;
    cudaError_t err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq, causal), Cols<D>::kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), layout_at(strides, 0),
        layout_at(strides, 1), layout_at(strides, 2), layout_at(strides, 3),
        heads, seq, head_dim, scale, causal, width);
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
    const int width = copy_width(sizeof(T), head_dim, in, 4, strides);
    auto kernel = flash_dq_kernel<T, D>;
    constexpr size_t smem = Bwd<T, D, false>::smem;
    cudaError_t err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq, causal), Cols<D>::kThreads, smem,
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
    const int width = copy_width(sizeof(T), head_dim, in, 4, strides);
    auto kernel = flash_dkv_kernel<T, D>;
    constexpr size_t smem = Bwd<T, D, true>::smem;
    cudaError_t err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid_for(batch, heads, seq, causal), Cols<D>::kThreads, smem,
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
