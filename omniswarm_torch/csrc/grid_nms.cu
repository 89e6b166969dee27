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
// evaluation order; plateau ties keep every equal cell. The max propagates
// NaN like jnp.maximum / torch.maximum, and a NaN compares false.
//
// What bounds it on an H100: each map is read once and written once,
// 8 bytes a pixel against 4r+2 comparisons, so memory (3.35 TB/s) bounds it:
// (40, 208, 400) maps move 26.6 MB, about 8 us.
//
// What the design does about it: one CTA per 32x32 output tile of one map.
// The CTA stages the tile and its r-pixel halo in shared memory once (the
// only global reads; neighbouring threads read neighbouring addresses),
// takes the row-window max of the (32 + 2r)-wide strip into a second shared
// buffer, then the column-window max and the compare, and writes the tile.
// The halo is re-read by the neighbouring tiles (+56% reads at r = 4, from
// L2). 11.5 KB of shared memory at r = 4, so several CTAs share an SM.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kTile = 32;       // output tile is kTile x kTile
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kMaxRadius = 16;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
grid_nms_kernel(const float* __restrict__ heat, float* __restrict__ out,
                int H, int W, int r) {
  extern __shared__ float smem[];
  const int SW = kTile + 2 * r;             // staged strip width
  const int SH = kTile + 2 * r;             // staged strip height
  float* tile = smem;                       // (SH, SW): tile plus halo
  float* vmax = smem + SH * SW;             // (kTile, SW): max over rows

  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* src = heat + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;

  for (int i = tid; i < SH * SW; i += nthreads) {
    const int ty = i / SW, tx = i - ty * SW;
    const int gy = y0 - r + ty, gx = x0 - r + tx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? src[static_cast<size_t>(gy) * W + gx]
                  : -INFINITY;
  }
  __syncthreads();

  // max over the 2r+1 rows centred on each output row, for every staged column
  for (int i = tid; i < kTile * SW; i += nthreads) {
    const int ty = i / SW, tx = i - ty * SW;
    const float* col = tile + (ty + r) * SW + tx;
    float m = col[0];
    for (int d = 1; d <= r; ++d) {
      m = nan_max(m, col[-d * SW]);
      m = nan_max(m, col[d * SW]);
    }
    vmax[i] = m;
  }
  __syncthreads();

  // then over the 2r+1 columns, and the compare
  for (int i = tid; i < kTile * kTile; i += nthreads) {
    const int ty = i / kTile, tx = i - ty * kTile;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= H || gx >= W) continue;
    const float* row = vmax + ty * SW + tx + r;
    float m = row[0];
    for (int d = 1; d <= r; ++d) {
      m = nan_max(m, row[-d]);
      m = nan_max(m, row[d]);
    }
    const float h = tile[(ty + r) * SW + tx + r];
    dst[static_cast<size_t>(gy) * W + gx] = (h >= m) ? h : 0.0f;
  }
}

}  // namespace

// heat, out: (B, H, W) f32, contiguous, on the current device; 0 <= r <= 16.
// Launches on `stream`; returns the CUDA error code of the launch (0 on
// success).
extern "C" int grid_nms_launch(const float* heat, float* out, int B, int H,
                               int W, int r, void* stream) {
  if (B < 1 || H < 1 || W < 1 || r < 0 || r > kMaxRadius || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int s = kTile + 2 * r;
  const size_t smem = sizeof(float) * static_cast<size_t>(s * s + kTile * s);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const dim3 block(kThreadsX, kThreadsY);
  grid_nms_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      heat, out, H, W, r);
  return static_cast<int>(cudaGetLastError());
}
