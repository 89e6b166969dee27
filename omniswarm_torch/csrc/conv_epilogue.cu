// The epilogue of SuperPoint's convolutions: bias, ReLU and 2 x 2 max-pool
// in one pass over the convolution's output.
//
// Replaces no TPU kernel: the JAX package (omniswarm_tpu/models/superpoint.py)
// leaves the bias add, the ReLU and the pool to XLA, which fuses them into
// the convolution. On the card the convolutions run in cuDNN, whose PyTorch
// route writes the output and then adds the bias in a kernel of its own;
// F.relu and F.max_pool2d were two more passes over HBM. For an NCHW f32
// conv output x (N, C, H, W) and the bias (C,):
//   v   = x[n, c, y, x] + bias[c]     one f32 rounding, as x + b
//   v   = max(v, 0)                   with the ReLU; NaN stays NaN (clamp_min)
//   out = max of v over the 2 x 2 window at (2 y', 2 x')   with the pool
// The pool has stride 2 and floors, as F.max_pool2d(x, 2, 2) does: an odd
// last row or column is dropped. Max is PTX max.NaN.f32 (sm_80+; built
// without --use_fast_math), so a NaN anywhere in a window gives NaN, as
// max_pool2d propagates it, and the result is bit-equal to the three
// PyTorch ops (+0 and -0 compare equal). The pool comes only with the ReLU.
//
// What bounds it on an H100: a few instructions an element against 8 bytes
// moved (4 read, 4 written), 5 with the pool (4 read, 1 written), so memory
// (3.35 TB/s). SuperPoint's 12 epilogues at 208 x 400 move 106.5 MB a view:
// 8.52 GB for a 10-drone keyframe step's 80 views, 2.54 ms.
//
// What the design does about it: every byte moves once, 16 bytes at a
// time. One CTA of 256 threads takes one balanced chunk of one (n, c)
// plane, so the channel's bias is one load a CTA, kept in a register.
// - Without the pool a plane is contiguous: an item is one float4 of it
//   (VEC when H*W % 4 == 0 and both pointers lie on 16 bytes), neighbouring
//   threads on neighbouring float4s. It may run in place (out == x).
// - With the pool an item is a float4 from each of two input rows, written
//   as one float2 (VEC when W % 4 == 0, x on 16 bytes and out on 8).
// - Else one element an item (with the pool: 2 x 2 scalar loads, one store).
// A thread issues the loads of its kItems items before any store. The
// chunks are at most kThreads * kItems items, so the smallest main-path
// shape, (80, 65, 26, 50), launches 5,200 CTAs (several waves over the 132
// SMs) and the largest, (80, 64, 208, 400), 107,520.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;        // items a thread

__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// K input columns of one row: one float4 or K scalars
template <int K>
__device__ __forceinline__ void load_row(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

template <int K>
__device__ __forceinline__ void store(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// K input columns an item a row: 4 (VEC), else 2 with the pool, 1 without
template <bool POOL, bool VEC>
__host__ __device__ constexpr int item_cols() {
  return VEC ? 4 : (POOL ? 2 : 1);
}

// x: (N, C, H, W); out: (N, C, H, W), or (N, C, H/2, W/2) with the pool.
// The grid is (N * C * chunks); a plane holds `items` items.
template <bool RELU, bool POOL, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const float* x, const float* __restrict__ bias,
                     float* out, int C, int H, int W, int items, int chunks) {
  constexpr int K = item_cols<POOL, VEC>();
  constexpr int KO = POOL ? K / 2 : K;           // output columns an item
  constexpr int ROWS = POOL ? 2 : 1;
  const int plane = blockIdx.x / chunks;           // n * C + c
  const int chunk = blockIdx.x - plane * chunks;
  const float b = __ldg(bias + plane % C);
  const int per = (items + chunks - 1) / chunks;
  const int begin = chunk * per + threadIdx.x;
  const int end = min((chunk + 1) * per, items);
  const int G = W / K;                             // items a pooled row
  const int Wo = W / 2;
  const size_t in_plane = static_cast<size_t>(plane) * H * W;
  const size_t out_plane = POOL ? static_cast<size_t>(plane) * (H / 2) * Wo
                                : in_plane;

  float v[kItems][ROWS][K];
  size_t dst[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = begin + i * kThreads;
    if (j >= end) break;
    size_t src;
    if constexpr (POOL) {
      const int yo = j / G;
      const int g = j - yo * G;
      src = in_plane + static_cast<size_t>(2 * yo) * W + g * K;
      dst[i] = out_plane + static_cast<size_t>(yo) * Wo + g * KO;
    } else {
      src = in_plane + static_cast<size_t>(j) * K;
      dst[i] = src;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) load_row<K>(x + src + r * W, v[i][r]);
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (begin + i * kThreads >= end) break;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float s = v[i][r][k] + b;
        v[i][r][k] = RELU ? nan_max(s, 0.0f) : s;
      }
    float o[KO];
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      if constexpr (POOL) {
        o[k] = nan_max(nan_max(v[i][0][2 * k], v[i][0][2 * k + 1]),
                       nan_max(v[i][1][2 * k], v[i][1][2 * k + 1]));
      } else {
        o[k] = v[i][0][k];
      }
    }
    store<KO>(out + dst[i], o);
  }
}

template <bool RELU, bool POOL, bool VEC>
int launch(const float* x, const float* bias, float* out, int N, int C,
           int H, int W, cudaStream_t stream) {
  constexpr int K = item_cols<POOL, VEC>();
  const long long items = POOL ? static_cast<long long>(H / 2) * (W / K)
                               : static_cast<long long>(H) * W / K;
  const long long cap = static_cast<long long>(kThreads) * kItems;
  const long long chunks = (items + cap - 1) / cap;
  const long long blocks = static_cast<long long>(N) * C * chunks;
  if (items < 1 || items > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  conv_epilogue_kernel<RELU, POOL, VEC>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, bias, out, C, H, W, static_cast<int>(items),
          static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Input columns a thread's item loads at once for these arguments: 4 (16-byte
// loads) when the float4s line up (see the top of this file), else 1.
extern "C" int conv_epilogue_vector_width(const float* x, const float* out,
                                          int H, int W, int pool) {
  const uintptr_t px = reinterpret_cast<uintptr_t>(x);
  const uintptr_t po = reinterpret_cast<uintptr_t>(out);
  if (pool) return (W % 4 == 0 && px % 16 == 0 && po % 8 == 0) ? 4 : 1;
  return (static_cast<long long>(H) * W % 4 == 0 && px % 16 == 0 &&
          po % 16 == 0) ? 4 : 1;
}

// x: (N, C, H, W) f32, contiguous; bias: (C,) f32; out: (N, C, H, W), which
// may be x, or (N, C, H/2, W/2) with the pool (then H, W >= 2 and not x);
// all on the current device. The pool needs the ReLU. Launches on `stream`,
// allocates nothing; returns the CUDA error code of the launch (0 on
// success).
extern "C" int conv_epilogue_launch(const float* x, const float* bias,
                                    float* out, int N, int C, int H, int W,
                                    int relu, int pool, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || (pool && !relu) ||
      (pool && (H < 2 || W < 2 || x == out)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = conv_epilogue_vector_width(x, out, H, W, pool) == 4;
  if (pool)
    return vec ? launch<true, true, true>(x, bias, out, N, C, H, W, s)
               : launch<true, true, false>(x, bias, out, N, C, H, W, s);
  if (relu)
    return vec ? launch<true, false, true>(x, bias, out, N, C, H, W, s)
               : launch<true, false, false>(x, bias, out, N, C, H, W, s);
  return vec ? launch<false, false, true>(x, bias, out, N, C, H, W, s)
             : launch<false, false, false>(x, bias, out, N, C, H, W, s);
}
