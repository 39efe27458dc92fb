// Fused BatchNorm -> ReLU (-> residual add) epilogue, hand-written for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of incubator_mxnet_tpu/ops/pallas_kernels.py:
//   epilogue_fwd_kernel    <- _epilogue_fwd_call (_epilogue_fwd_kernel,
//                             _epilogue_res_fwd_kernel):
//                             y = relu(x * scale + shift [+ r]) over a
//                             channels-last (R, C) activation, float32
//                             math, y in x's type (float32, bfloat16 or
//                             float16);
//   epilogue_bwd_kernel +  <- _epilogue_bwd_call (_epilogue_bwd_kernel):
//   epilogue_reduce_kernel    mask = y > 0, dx = dy * mask * scale,
//                             dres = dy * mask (residual variant),
//                             dscale = sum over rows of dy * mask * x,
//                             dshift = sum over rows of dy * mask.
//
// What bounds them on an H100: bytes. The forward reads x (and r) and
// writes y once for two or three float operations an element; the
// backward reads x, y and dy and writes dx (and dres) once for about six.
// At ResNet-50's batch 128 the largest calls move 0.8-2.1 GB (245-613 us
// at 3.35 TB/s); the card's ratio of operations to bytes is far above
// theirs.
//
// Design. Each thread owns one fixed group of channels (W consecutive
// channels, W = 4 float32 or 8 bfloat16 / float16 for one 16-byte load
// where C and every pointer allow, else W = 1), so it loads its scale
// and shift once and walks rows with a grid stride: a block of 256
// threads covers `cols` = min(C / W, 256) channel groups by 256 / cols
// rows per pass, and a second grid dimension covers the channel groups
// beyond 256.
// Neighbouring threads read neighbouring addresses (rows are contiguous,
// C elements apart), and each thread keeps kUnroll rows of loads in
// flight.
//
// The TPU backward carries the channel sums in one (1, C) output block
// that its sequential grid revisits (:535-541). Blocks on this card run
// in no order, so the carry becomes two passes with no atomics: each
// block sums its own rows per thread, combines its threads in shared
// memory in a fixed order and writes one row of an (n_blocks, 2C) float32
// buffer of partial sums; epilogue_reduce_kernel then sums those rows
// per channel, again in a fixed order. The result is deterministic for a
// given card and shape.
//
// Masking: a row is live where y > 0 (no pre-activation tensor is kept);
// x is masked as well as dy, as in the TPU kernel (:525-530), so that a
// NaN in a dead element cannot reach the sums through 0 * NaN. Products
// and sums are rounded one operation at a time (__fmul_rn, __fadd_rn):
// the forward equals its plain PyTorch version bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;            // rows in flight per thread
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kMinRowsPerThread = 16;  // backward: rows before a partial
constexpr int kReduceCols = 32;        // reduce: channels per block
constexpr int kReduceLanes = 16;       // reduce: partial rows in parallel

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
template <>
struct Vec<__half> {
  static constexpr int n = 8;
};

template <int W>
__device__ __forceinline__ void load(const float* p, float (&o)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x;
      o[i + 1] = v.y;
      o[i + 2] = v.z;
      o[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) o[i] = p[i];
  }
}

template <int W>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&o)[W]) {
  if constexpr (W == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) o[i] = __bfloat162float(p[i]);
  }
}

template <int W>
__device__ __forceinline__ void load(const __half* p, float (&o)[W]) {
  if constexpr (W == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) o[i] = __half2float(p[i]);
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float (&x)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = x[i];
  }
}

template <int W>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[W]) {
  if constexpr (W == 8) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = __float2bfloat16(x[i]);
  }
}

template <int W>
__device__ __forceinline__ void store(__half* p, const float (&x)[W]) {
  if constexpr (W == 8) {
    uint4 v;
    __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2half2_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = __float2half_rn(x[i]);
  }
}

// The thread's place: channel group `group` (of `groups` per row) and row
// `row` of the block's first pass; `active` is false for the threads left
// over when `cols` does not divide 256 or the last column chunk is short.
struct Place {
  int group, row, rows_per_pass;
  bool active;
};

__device__ __forceinline__ Place place(int groups, int cols) {
  Place p;
  p.rows_per_pass = kThreads / cols;
  const int lane_col = threadIdx.x % cols, lane_row = threadIdx.x / cols;
  p.group = blockIdx.y * cols + lane_col;
  p.row = blockIdx.x * p.rows_per_pass + lane_row;
  p.active = lane_row < p.rows_per_pass && p.group < groups;
  return p;
}

template <typename T, int W, bool kRes>
__global__ void __launch_bounds__(kThreads)
    epilogue_fwd_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const T* __restrict__ res, T* __restrict__ y,
                        int64_t rows, int groups, int cols) {
  const Place p = place(groups, cols);
  if (!p.active) return;
  const int64_t C = int64_t(groups) * W;
  const int64_t col = int64_t(p.group) * W;
  float sc[W], sh[W];
  load<W>(scale + col, sc);
  load<W>(shift + col, sh);
  const int64_t step = int64_t(gridDim.x) * p.rows_per_pass;
  for (int64_t r0 = p.row; r0 < rows; r0 += step * kUnroll) {
    float v[kUnroll][W], rv[kUnroll][W];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      if (r < rows) {
        load<W>(x + r * C + col, v[u]);
        if constexpr (kRes) load<W>(res + r * C + col, rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + u * step;
      if (r >= rows) continue;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float t = __fadd_rn(__fmul_rn(v[u][e], sc[e]), sh[e]);
        if constexpr (kRes) t = __fadd_rn(t, rv[u][e]);
        v[u][e] = fmaxf(t, 0.f);
      }
      store<W>(y + r * C + col, v[u]);
    }
  }
}

// partial: (gridDim.x, 2C) float32; row b holds block column b's sums of
// dy * mask * x (first C) and of dy * mask (last C) for the channels its
// blockIdx.y covers.
template <typename T, int W, bool kRes>
__global__ void __launch_bounds__(kThreads)
    epilogue_bwd_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const T* __restrict__ y, const T* __restrict__ dy,
                        T* __restrict__ dx, T* __restrict__ dres,
                        float* __restrict__ partial, int64_t rows,
                        int groups, int cols) {
  __shared__ float red_scale[kThreads * W], red_shift[kThreads * W];
  const Place p = place(groups, cols);
  const int64_t C = int64_t(groups) * W;
  const int64_t col = int64_t(p.group) * W;
  float acc_scale[W], acc_shift[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc_scale[e] = acc_shift[e] = 0.f;
  if (p.active) {
    float sc[W];
    load<W>(scale + col, sc);
    const int64_t step = int64_t(gridDim.x) * p.rows_per_pass;
    for (int64_t r0 = p.row; r0 < rows; r0 += step * kUnroll) {
      float xv[kUnroll][W], yv[kUnroll][W], gv[kUnroll][W];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + u * step;
        if (r < rows) {
          load<W>(x + r * C + col, xv[u]);
          load<W>(y + r * C + col, yv[u]);
          load<W>(dy + r * C + col, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + u * step;
        if (r >= rows) continue;
        float out[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const bool live = yv[u][e] > 0.f;
          const float g = live ? gv[u][e] : 0.f;
          const float xm = live ? xv[u][e] : 0.f;
          acc_scale[e] = __fadd_rn(acc_scale[e], __fmul_rn(g, xm));
          acc_shift[e] = __fadd_rn(acc_shift[e], g);
          out[e] = __fmul_rn(g, sc[e]);
          gv[u][e] = g;
        }
        store<W>(dx + r * C + col, out);
        if constexpr (kRes) store<W>(dres + r * C + col, gv[u]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < W; ++e) {
    red_scale[threadIdx.x * W + e] = acc_scale[e];
    red_shift[threadIdx.x * W + e] = acc_shift[e];
  }
  __syncthreads();
  // the threads of the first row combine each channel group's rows in
  // order and write the block's partial sums
  if (p.active && threadIdx.x < cols) {
    float* out = partial + int64_t(blockIdx.x) * 2 * C + col;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      float s = 0.f, b = 0.f;
      for (int rr = 0; rr < p.rows_per_pass; ++rr) {
        const int i = (rr * cols + threadIdx.x) * W + e;
        s = __fadd_rn(s, red_scale[i]);
        b = __fadd_rn(b, red_shift[i]);
      }
      out[e] = s;
      out[C + e] = b;
    }
  }
}

// out[j] = sum over b of partial[b, j] for j < width (= 2C), b in order:
// lane ty sums rows ty, ty + kReduceLanes, ...; lane 0 sums the lanes.
__global__ void __launch_bounds__(kReduceCols* kReduceLanes)
    epilogue_reduce_kernel(const float* __restrict__ partial, int n_rows,
                           int64_t width, float* __restrict__ out) {
  __shared__ float lanes[kReduceLanes][kReduceCols];
  const int tx = threadIdx.x % kReduceCols, ty = threadIdx.x / kReduceCols;
  const int64_t j = int64_t(blockIdx.x) * kReduceCols + tx;
  float s = 0.f;
  if (j < width)
    for (int b = ty; b < n_rows; b += kReduceLanes)
      s = __fadd_rn(s, partial[int64_t(b) * width + j]);
  lanes[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < width) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < kReduceLanes; ++l) t = __fadd_rn(t, lanes[l][tx]);
    out[j] = t;
  }
}

struct Grid {
  dim3 grid;
  int groups, cols;
};

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

// rows_per_thread: the least rows each thread walks (fills the grid
// first, then lengthens the walk).
Grid make_grid(int64_t rows, int64_t channels, int w, int rows_per_thread,
               int max_blocks) {
  Grid g;
  g.groups = static_cast<int>(channels / w);
  g.cols = g.groups < kThreads ? g.groups : kThreads;
  const int rpp = kThreads / g.cols;
  const int gy = (g.groups + g.cols - 1) / g.cols;
  const int64_t per_block = int64_t(rpp) * rows_per_thread;
  int64_t gx = (rows + per_block - 1) / per_block;
  const int64_t cap = max_blocks / gy > 0 ? max_blocks / gy : 1;
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  g.grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  return g;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
bool use_vec(int64_t channels, const void* const* ptrs, int n) {
  if (channels % Vec<T>::n) return false;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] && !aligned(ptrs[i])) return false;
  return true;
}

template <typename T, int W>
cudaError_t fwd(const void* x, const void* scale, const void* shift,
                const void* res, void* y, int64_t rows, int64_t channels,
                cudaStream_t s) {
  const Grid g = make_grid(rows, channels, W, kUnroll,
                           4 * kBlocksPerSm * sm_count());
  const auto* xp = static_cast<const T*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* yp = static_cast<T*>(y);
  if (res)
    epilogue_fwd_kernel<T, W, true><<<g.grid, kThreads, 0, s>>>(
        xp, sc, sh, static_cast<const T*>(res), yp, rows, g.groups, g.cols);
  else
    epilogue_fwd_kernel<T, W, false><<<g.grid, kThreads, 0, s>>>(
        xp, sc, sh, nullptr, yp, rows, g.groups, g.cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_dispatch(const void* x, const void* scale,
                         const void* shift, const void* res, void* y,
                         int64_t rows, int64_t channels, cudaStream_t s) {
  const void* ptrs[] = {x, scale, shift, res, y};
  if (use_vec<T>(channels, ptrs, 5))
    return fwd<T, Vec<T>::n>(x, scale, shift, res, y, rows, channels, s);
  return fwd<T, 1>(x, scale, shift, res, y, rows, channels, s);
}

int bwd_blocks(int64_t rows, int64_t channels, int w) {
  return static_cast<int>(
      make_grid(rows, channels, w, kMinRowsPerThread,
                kBlocksPerSm * sm_count())
          .grid.x);
}

template <typename T, int W>
cudaError_t bwd(const void* x, const void* scale, const void* y,
                const void* dy, void* dx, void* dres, void* workspace,
                void* dscale_dshift, int64_t rows, int64_t channels,
                cudaStream_t s) {
  const Grid g = make_grid(rows, channels, W, kMinRowsPerThread,
                           kBlocksPerSm * sm_count());
  auto* partial = static_cast<float*>(workspace);
  const auto* xp = static_cast<const T*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* yp = static_cast<const T*>(y);
  const auto* dyp = static_cast<const T*>(dy);
  auto* dxp = static_cast<T*>(dx);
  if (dres)
    epilogue_bwd_kernel<T, W, true><<<g.grid, kThreads, 0, s>>>(
        xp, sc, yp, dyp, dxp, static_cast<T*>(dres), partial, rows,
        g.groups, g.cols);
  else
    epilogue_bwd_kernel<T, W, false><<<g.grid, kThreads, 0, s>>>(
        xp, sc, yp, dyp, dxp, nullptr, partial, rows, g.groups, g.cols);
  cudaError_t err = cudaGetLastError();
  if (err) return err;
  const int64_t width = 2 * channels;
  const unsigned blocks =
      static_cast<unsigned>((width + kReduceCols - 1) / kReduceCols);
  epilogue_reduce_kernel<<<blocks, kReduceCols * kReduceLanes, 0, s>>>(
      partial, static_cast<int>(g.grid.x), width,
      static_cast<float*>(dscale_dshift));
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dispatch(const void* x, const void* scale, const void* y,
                         const void* dy, void* dx, void* dres,
                         void* workspace, void* dscale_dshift, int64_t rows,
                         int64_t channels, cudaStream_t s) {
  const void* ptrs[] = {x, scale, y, dy, dx, dres};
  if (use_vec<T>(channels, ptrs, 6))
    return bwd<T, Vec<T>::n>(x, scale, y, dy, dx, dres, workspace,
                             dscale_dshift, rows, channels, s);
  return bwd<T, 1>(x, scale, y, dy, dx, dres, workspace, dscale_dshift,
                   rows, channels, s);
}

bool valid(int dtype, int64_t rows, int64_t channels) {
  return dtype >= 0 && dtype <= 2 && rows >= 0 && channels >= 1 &&
         channels <= (int64_t(1) << 30);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the type of x, r and
// y). x, r and y
// are contiguous (rows, channels); scale and shift are (channels,)
// float32; r is null for the plain variant. Every pointer is device
// memory; nothing is allocated and nothing synchronises. Returns the
// launch's cudaError_t (0 on success).
extern "C" int mxtpu_bn_act_epilogue_fwd(int dtype, const void* x,
                                         const void* scale,
                                         const void* shift, const void* res,
                                         void* y, int64_t rows,
                                         int64_t channels, void* stream) {
  if (!valid(dtype, rows, channels)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_dispatch<float>(x, scale, shift, res, y, rows, channels, s);
  if (dtype == 1)
    return fwd_dispatch<__nv_bfloat16>(x, scale, shift, res, y, rows,
                                       channels, s);
  return fwd_dispatch<__half>(x, scale, shift, res, y, rows, channels, s);
}

// Floats of workspace that mxtpu_bn_act_epilogue_bwd needs for these
// sizes on the current device: (blocks, 2 * channels) partial sums, for
// the larger of the two grids it may choose.
extern "C" int64_t mxtpu_bn_act_epilogue_bwd_workspace(int dtype,
                                                       int64_t rows,
                                                       int64_t channels) {
  if (!valid(dtype, rows, channels)) return -1;
  const int w = dtype == 0   ? Vec<float>::n
                : dtype == 1 ? Vec<__nv_bfloat16>::n
                             : Vec<__half>::n;
  int blocks = bwd_blocks(rows, channels, 1);
  if (channels % w == 0) {
    const int vec = bwd_blocks(rows, channels, w);
    if (vec > blocks) blocks = vec;
  }
  return int64_t(blocks) * 2 * channels;
}

// x, y, dy, dx and dres (null for the plain variant) are contiguous
// (rows, channels) of type `dtype`; scale is (channels,) float32;
// workspace holds mxtpu_bn_act_epilogue_bwd_workspace(...) floats;
// dscale_dshift is (2 * channels,) float32 and receives dscale, then
// dshift.
extern "C" int mxtpu_bn_act_epilogue_bwd(int dtype, const void* x,
                                         const void* scale, const void* y,
                                         const void* dy, void* dx,
                                         void* dres, void* workspace,
                                         void* dscale_dshift, int64_t rows,
                                         int64_t channels, void* stream) {
  if (!valid(dtype, rows, channels)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0)
    return cudaMemsetAsync(dscale_dshift, 0, 2 * channels * sizeof(float),
                           s);
  if (dtype == 0)
    return bwd_dispatch<float>(x, scale, y, dy, dx, dres, workspace,
                               dscale_dshift, rows, channels, s);
  if (dtype == 1)
    return bwd_dispatch<__nv_bfloat16>(x, scale, y, dy, dx, dres,
                                       workspace, dscale_dshift, rows,
                                       channels, s);
  return bwd_dispatch<__half>(x, scale, y, dy, dx, dres, workspace,
                              dscale_dshift, rows, channels, s);
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
