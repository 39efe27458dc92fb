// Tensor-core rates of one card: independent mma.sync products (TF32
// m16n8k8, bfloat16 m16n8k16; eight accumulators a warp) and wgmma
// products (TF32 m64n64k8, A from shared memory or registers, B from
// shared memory; two accumulators a warpgroup) in a loop on operands that
// stay in registers or shared memory, so nothing but the products is
// timed. The values are meaningless; only the rate is read. Built and run
// by tools/tensor_core_rate.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kBf16>
__global__ void mma_kernel(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x * 5u, b1 = 11u;
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kBf16) {
        mma_bf16(c[j], a, b0, b1);
      } else {
        mma_tf32(c[j], a, b0, b1);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// A shared-memory matrix descriptor without swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
}

#define MXTPU_ACC32(x)                                                      \
  "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3]), "+f"(x[4]), "+f"(x[5]),   \
      "+f"(x[6]), "+f"(x[7]), "+f"(x[8]), "+f"(x[9]), "+f"(x[10]),          \
      "+f"(x[11]), "+f"(x[12]), "+f"(x[13]), "+f"(x[14]), "+f"(x[15]),      \
      "+f"(x[16]), "+f"(x[17]), "+f"(x[18]), "+f"(x[19]), "+f"(x[20]),      \
      "+f"(x[21]), "+f"(x[22]), "+f"(x[23]), "+f"(x[24]), "+f"(x[25]),      \
      "+f"(x[26]), "+f"(x[27]), "+f"(x[28]), "+f"(x[29]), "+f"(x[30]),      \
      "+f"(x[31])
#define MXTPU_D32                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MXTPU_D32
      "%32, %33, p, 1, 1;\n}\n"
      : MXTPU_ACC32(d)
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MXTPU_D32
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : MXTPU_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <bool kRegA>
__global__ void wgmma_kernel(float* out, int iters) {
  __shared__ __align__(128) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  float d0[32] = {}, d1[32] = {};
  const uint32_t a[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kRegA) {
        wgmma_rs(d0, a, desc(base + 8192));
        wgmma_rs(d1, a, desc(base + 16384));
      } else {
        wgmma_ss(d0, desc(base), desc(base + 8192));
        wgmma_ss(d1, desc(base + 4096), desc(base + 16384));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }
  float s = 0.f;
  for (int j = 0; j < 32; ++j) s += d0[j] + d1[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// kind: 0 mma.sync TF32, 1 mma.sync bfloat16 (threads a block: 32 x warps),
// 2 wgmma TF32 A from shared memory, 3 wgmma TF32 A from registers (128
// threads a block). Returns the launch's cudaError_t.
extern "C" int mxtpu_tensor_core_rate(int kind, float* out, int blocks,
                                      int threads, int iters) {
  switch (kind) {
    case 0: mma_kernel<false><<<blocks, threads>>>(out, iters); break;
    case 1: mma_kernel<true><<<blocks, threads>>>(out, iters); break;
    case 2: wgmma_kernel<false><<<blocks, 128>>>(out, iters); break;
    case 3: wgmma_kernel<true><<<blocks, 128>>>(out, iters); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
