// Tensor-core building blocks shared by the port's attention kernels
// (flash_attention.cu: the flash forward, dQ and dK/dV; decode.cu: the wide
// paged decode): TF32 mma.sync products at float32 accuracy, with fragments
// read from row-major tiles in shared memory, and cp.async staging of rows.
//
// mma.sync.m16n8k8 fragments (lane = 4 g + t): A (rows g | g + 8, k t |
// t + 4), B (k t | t + 4, n g), C (rows g | g + 8, columns 2t | 2t + 1).
//
// float32 keeps float32 accuracy by error compensation: each operand splits
// in registers into hi (x rounded to TF32) and lo = x - hi, and each product
// is hi.hi + hi.lo + lo.hi (3 x TF32, about 1e-6 relative). A bfloat16
// value, and a float rounded to one, is exact in TF32: hi = x, lo = 0, and
// the products with lo are not issued.
//
// Included by one translation unit each: everything is internal to it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// c += (ah + al) * (bh + bl) for an A operand of type TA and a B operand of
// type TB: ah.bh, plus al.bh where A is float32 and ah.bl where B is (3 x
// TF32 for two float32 operands, 2 for float32 by bfloat16, 1 for two
// bfloat16). The small terms go first.
template <typename TA, typename TB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  if constexpr (kIsFloat<TA>) mma_tf32(c, al, bh0, bh1);
  if constexpr (kIsFloat<TB>) mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// c[m][nt] += A_m . B_nt^T for the warp's WM 16-row tiles m of A and
// every 8-row tile nt of B: a product that sums over D. A is the warp's
// rows of a staged tile ([rows][LSA] of TA), B its rows of the walked tile
// ([rows][LSB] of TB). No branch inside: the loads, splits and products of
// all tiles interleave.
template <typename TA, typename TB, int D, int WM, int NT, int LSA, int LSB>
__device__ __forceinline__ void sum_over_d(float (&c)[WM][NT][4],
                                           const TA* a, const TB* b, int g,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[WM][4], al[WM][4];
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      const TA* ar = a + (16 * m + g) * LSA + kk * 8 + t;
      split<TA>(to_float(ar[0]), ah[m][0], al[m][0]);
      split<TA>(to_float(ar[8 * LSA]), ah[m][1], al[m][1]);
      split<TA>(to_float(ar[4]), ah[m][2], al[m][2]);
      split<TA>(to_float(ar[8 * LSA + 4]), ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const TB* br = b + (nt * 8 + g) * LSB + kk * 8 + t;
      uint32_t bh0, bl0, bh1, bl1;
      split<TB>(to_float(br[0]), bh0, bl0);
      split<TB>(to_float(br[4]), bh1, bl1);
#pragma unroll
      for (int m = 0; m < WM; ++m)
        mma3<TA, TB>(c[m][nt], ah[m], al[m], bh0, bh1, bl0, bl1);
    }
  }
}

// acc[m][dn] += P_m . B over the walked rows: P holds, per 16-row tile m,
// 16 rows x 8 walked rows per ks in the C layout of sum_over_d (already
// rounded to T), B is the warp's rows of the walked tile ([rows][LS]).
// The k index is permuted (mma slot t <-> walked row 2t, slot t + 4 <->
// row 2t + 1), which makes P's registers the A fragment as they stand:
// (c0, c2, c1, c3).
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
        mma3<T, T>(acc[m][dn], ah[m], al[m], bh0, bh1, bl0, bl1);
    }
  }
}

// Max and sum over the 4 lanes of a quad: the lanes that hold one row of
// a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
// wait until at most `n` groups (those still in flight) are pending
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// Rows [0, rows) of a tile into dst ([rows][LS]): the first d elements of
// row r from src_row(r), or zeros where src_row(r) is null (`any` is a
// valid address the zero-filling copies name). `width`: bytes a copy
// moves, 16 or 4 (cp.async), else one bfloat16 element (plain loads and
// stores). Columns d ... LS - 1 are left as they are.
template <typename T, int LS, typename Row>
__device__ __forceinline__ void stage_tile(T* dst, Row src_row, const T* any,
                                           int rows, int d, int width) {
  const int per = width / int(sizeof(T));  // elements a copy moves
  const int chunks = d / per;              // copies a row
  // copy i = threadIdx.x + k * blockDim.x is (row r, chunk c); both step
  // without a division per copy
  const int dr = blockDim.x / chunks, dc = blockDim.x % chunks;
  int r = threadIdx.x / chunks, c = threadIdx.x % chunks;
  while (r < rows) {
    const T* row = src_row(r);
    const bool in = row != nullptr;
    const T* s = in ? row + c * per : any;
    T* o = dst + r * LS + c * per;
    if (width == 16) {
      cp_async<16>(o, s, in ? 16 : 0);
    } else if (width == 4) {
      cp_async<4>(o, s, in ? 4 : 0);
    } else {
      *o = in ? *s : from_float<T>(0.f);
    }
    r += dr;
    c += dc;
    if (c >= chunks) c -= chunks, ++r;
  }
}

// Zeros over n elements of staged tiles (n * sizeof(T) a multiple of 16).
template <typename T>
__device__ __forceinline__ void zero_tiles(T* p, int n) {
  float4* p4 = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < n * int(sizeof(T)) / 16; i += blockDim.x)
    p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace
