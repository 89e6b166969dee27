// Window-max non-maximum suppression of a batch of SuperPoint heat maps.
//
// Replaces the TPU kernel omniswarm_tpu/ops/pallas_kernels.py::
// grid_nms_pallas (body _nms_kernel with _shift_rows_max/_shift_cols_max).
// For each map b and pixel (y, x) of a (B, H, W) f32 batch:
//   winmax = max of heat[b] over the (2r+1)^2 window centred on (y, x),
//            cells outside the map counting as -inf (no wrap-around)
//   out    = heat if heat >= winmax else 0
// The window max is separable: a max over 2r+1 rows, then over 2r+1 columns
// of that. A max does no arithmetic, so the result is bit-exact against any
// evaluation order (+0 and -0 compare equal); plateau ties keep every equal
// cell. The max propagates NaN like jnp.maximum / torch.maximum, and a NaN
// compares false, so a NaN centre or a NaN in the window gives 0.
//
// What bounds it on an H100: each map is read once and written once,
// 8 bytes a pixel against about 4r+2 comparisons, so memory (3.35 TB/s)
// bounds it: (40, 208, 400) maps move 26.6 MB, about 8 us.
//
// What the design does about it: one CTA per (map, strip of kRows output
// rows, column tile); a tile is a whole map wide up to 504 columns. Each
// thread owns VEC adjacent columns (VEC = 4, one float4; VEC = 1 when
// W % 4 != 0 or a pointer is not on 16 bytes).
// 1. The thread loads its kRows + 2r rows of those columns straight from
//    global memory, coalesced 16-byte loads, rows outside the map as -inf,
//    and takes the vertical (2r+1) max in registers by van Herk /
//    Gil-Werman (about 3 max an output instead of 2r). It writes the kRows
//    row maxima to shared memory and keeps the centre rows in registers.
// 2. After one barrier it takes the horizontal max from its own and its
//    neighbours' shared float4s (ceil(r/VEC) column groups each side are the
//    tile's halo, -inf outside the map), compares and makes 16-byte stores.
// The vertical halo (2r of the kRows + 2r rows) is re-read by the next
// strip's CTA, from L2. The max is one PTX max.NaN.f32 (sm_80+; built
// without --use_fast_math). r = 4, the front-end's radius, is compiled
// statically; any 0 <= r <= 16 takes a run-time-r instantiation whose
// vertical pass reads the window's rows directly (through L1).
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;        // output rows a CTA
constexpr int kMaxRadius = 16;
constexpr int kPathRadius = 4;   // SuperPoint's nms_dist

template <int VEC>
constexpr int max_threads() { return VEC == 4 ? 128 : 512; }

template <int VEC>
struct Cols { float v[VEC]; };

__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int VEC>
__device__ __forceinline__ Cols<VEC> cols_max(const Cols<VEC>& a,
                                              const Cols<VEC>& b) {
  Cols<VEC> c;
#pragma unroll
  for (int k = 0; k < VEC; ++k) c.v[k] = nan_max(a.v[k], b.v[k]);
  return c;
}

template <int VEC>
__device__ __forceinline__ Cols<VEC> cols_fill(float x) {
  Cols<VEC> c;
#pragma unroll
  for (int k = 0; k < VEC; ++k) c.v[k] = x;
  return c;
}

// 16-byte (VEC = 4) or 4-byte loads and stores, global or shared
template <int VEC>
__device__ __forceinline__ Cols<VEC> cols_load(const float* p) {
  Cols<VEC> c;
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    c.v[0] = q.x; c.v[1] = q.y; c.v[2] = q.z; c.v[3] = q.w;
  } else {
    c.v[0] = *p;
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ Cols<VEC> cols_ldg(const float* p) {
  Cols<VEC> c;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    c.v[0] = q.x; c.v[1] = q.y; c.v[2] = q.z; c.v[3] = q.w;
  } else {
    c.v[0] = __ldg(p);
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ void cols_store(float* p, const Cols<VEC>& c) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(c.v[0], c.v[1], c.v[2],
                                                c.v[3]);
  } else {
    *p = c.v[0];
  }
}

// heat, out: (B, H, W); the grid is (strips * tiles, B), tiles column tiles
// of blockDim.x - 2 * halo groups each. RAD >= 0: the radius, compiled in;
// RAD < 0: the radius is r_arg.
template <int VEC, int RAD>
__global__ void __launch_bounds__(VEC == 4 ? 128 : 512, VEC == 4 ? 4 : 1)
grid_nms_kernel(const float* __restrict__ heat, float* __restrict__ out,
                int H, int W, int r_arg, int tiles) {
  constexpr bool kStatic = RAD >= 0;
  constexpr int kR = kStatic ? RAD : kMaxRadius;     // largest radius
  constexpr int kHalo = (kR + VEC - 1) / VEC;        // largest halo groups
  const int r = kStatic ? RAD : r_arg;
  const int halo = kStatic ? kHalo : (r + VEC - 1) / VEC;
  extern __shared__ __align__(16) float rowmax[];    // (kRows, NT * VEC)

  const int NT = blockDim.x;
  const int t = threadIdx.x;
  const int strip = blockIdx.x / tiles;
  const int tile = blockIdx.x - strip * tiles;
  const int y0 = strip * kRows;
  const int g = tile * (NT - 2 * halo) - halo + t;   // this column group
  const bool in_map = g >= 0 && g < W / VEC;
  const size_t base = static_cast<size_t>(blockIdx.y) * H * W
                      + (in_map ? static_cast<size_t>(g) * VEC : 0);
  const float* src = heat + base;
  const float NEG = -INFINITY;

  // 1. vertical (2r+1) max of this thread's columns, rows y0 .. y0+kRows-1
  Cols<VEC> centre[kRows];
  if constexpr (kStatic) {
    constexpr int N = kRows + 2 * RAD;
    constexpr int K = 2 * RAD + 1;
    Cols<VEC> x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int y = y0 - RAD + j;
      x[j] = (in_map && y >= 0 && y < H)
                 ? cols_ldg<VEC>(src + static_cast<size_t>(y) * W)
                 : cols_fill<VEC>(NEG);
    }
    // van Herk / Gil-Werman over blocks of K rows from row 0 of x:
    // suf[j] = max x[j .. end of j's block], pre[j] = max x[start .. j];
    // the window x[i .. i+K-1] is suf[i] (i a block start) or
    // max(suf[i], pre[i+K-1]) (the two blocks it straddles)
    Cols<VEC> suf[N], pre[N];
#pragma unroll
    for (int j = N - 1; j >= 0; --j)
      suf[j] = (j % K == K - 1 || j == N - 1)
                   ? x[j] : cols_max(x[j], suf[j + 1 < N ? j + 1 : j]);
#pragma unroll
    for (int j = 0; j < N; ++j)
      pre[j] = (j % K == 0) ? x[j] : cols_max(pre[j > 0 ? j - 1 : 0], x[j]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const Cols<VEC> m =
          (i % K == 0) ? suf[i] : cols_max(suf[i], pre[i + K - 1]);
      cols_store<VEC>(rowmax + (i * NT + t) * VEC, m);
      centre[i] = x[i + RAD];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int y = y0 + i;
      Cols<VEC> m = cols_fill<VEC>(NEG);
      centre[i] = m;
      if (in_map && y < H) {
        const int hi = min(y + r, H - 1);
        for (int yy = max(y - r, 0); yy <= hi; ++yy)
          m = cols_max(m, cols_ldg<VEC>(src + static_cast<size_t>(yy) * W));
        centre[i] = cols_ldg<VEC>(src + static_cast<size_t>(y) * W);
      }
      cols_store<VEC>(rowmax + (i * NT + t) * VEC, m);
    }
  }
  __syncthreads();

  // 2. horizontal (2r+1) max over the row maxima, compare, store
  if (!in_map || t < halo || t >= NT - halo) return;
  float* dst = out + base;
  constexpr int kSpan = (2 * kHalo + 1) * VEC;      // columns gathered
  constexpr int kMid = kHalo * VEC;                 // index of column 0
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (y0 + i >= H) break;
    float v[kSpan];
#pragma unroll
    for (int j = -kHalo; j <= kHalo; ++j) {
      const Cols<VEC> c = (kStatic || (j >= -halo && j <= halo))
                              ? cols_load<VEC>(rowmax + (i * NT + t + j) * VEC)
                              : cols_fill<VEC>(NEG);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[(j + kHalo) * VEC + k] = c.v[k];
    }
    Cols<VEC> o;
    if constexpr (kStatic && VEC > 1 && RAD >= VEC - 1) {
      // the windows of all VEC outputs share columns [VEC-1-RAD, RAD]
      float core = v[kMid + VEC - 1 - RAD];
#pragma unroll
      for (int k = VEC - RAD; k <= RAD; ++k) core = nan_max(core, v[kMid + k]);
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float m = core;
#pragma unroll
        for (int k = c - RAD; k < VEC - 1 - RAD; ++k) m = nan_max(m, v[kMid + k]);
#pragma unroll
        for (int k = RAD + 1; k <= c + RAD; ++k) m = nan_max(m, v[kMid + k]);
        const float h = centre[i].v[c];
        o.v[c] = (h >= m) ? h : 0.0f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float m = v[kMid + c];
#pragma unroll
        for (int d = 1; d <= kR; ++d)
          if (kStatic || d <= r)
            m = nan_max(m, nan_max(v[kMid + c - d], v[kMid + c + d]));
        const float h = centre[i].v[c];
        o.v[c] = (h >= m) ? h : 0.0f;
      }
    }
    cols_store<VEC>(dst + static_cast<size_t>(y0 + i) * W, o);
  }
}

template <int VEC, int RAD>
int launch(const float* heat, float* out, int B, int H, int W, int r,
           cudaStream_t stream) {
  const int groups = W / VEC;
  const int halo = (r + VEC - 1) / VEC;
  int nt = (groups + 2 * halo + 31) / 32 * 32;
  if (nt > max_threads<VEC>()) nt = max_threads<VEC>();
  const int per_tile = nt - 2 * halo;                  // >= 96
  const long long tiles = (groups + per_tile - 1) / per_tile;
  const long long blocks = tiles * ((H + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kRows * nt * VEC;   // <= 32 KB
  grid_nms_kernel<VEC, RAD>
      <<<dim3(static_cast<unsigned>(blocks), B), nt, smem, stream>>>(
          heat, out, H, W, r, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Column width of the launch the kernel takes for these arguments: 4 (16-byte
// loads and stores) when W % 4 == 0 and both pointers are on 16 bytes, else 1.
extern "C" int grid_nms_vector_width(const float* heat, const float* out,
                                     int W) {
  return (W % 4 == 0 && reinterpret_cast<uintptr_t>(heat) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 4 : 1;
}

// heat, out: (B, H, W) f32, contiguous, on the current device; 0 <= r <= 16,
// B <= 65535. Launches on `stream`; returns the CUDA error code of the
// launch (0 on success).
extern "C" int grid_nms_launch(const float* heat, float* out, int B, int H,
                               int W, int r, void* stream) {
  if (B < 1 || H < 1 || W < 1 || r < 0 || r > kMaxRadius || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = grid_nms_vector_width(heat, out, W) == 4;
  if (r == kPathRadius)
    return vec4 ? launch<4, kPathRadius>(heat, out, B, H, W, r, s)
                : launch<1, kPathRadius>(heat, out, B, H, W, r, s);
  return vec4 ? launch<4, -1>(heat, out, B, H, W, r, s)
              : launch<1, -1>(heat, out, B, H, W, r, s);
}
