// One warm cyclic-reduction level of the block-tridiagonal factorization.
//
// Replaces the TPU kernel omniswarm_tpu/solver/pallas_level.py::
// fused_reduction_level (body _level_kernel). For each block pair i < t it
// computes, on f32 (m, m) blocks (m <= 80):
//   s = rsqrt(max(diag A[2i+1], 1e-30)), An = S A[2i+1] S, X0n = X0 / max(s s^T, 1e-30)
//   M = An X0n; enorm = max row-sum |I - M|; rho = max row-sum |An|
//   if enorm > guard or enorm is not finite: X = I/rho, M = An/rho
//   X <- X (2I - M); X <- X (2I - An X); Ainv = X o s s^T
//   W_l = B[2i] Ainv, W_r = B[2i+1]^T Ainv, A_new = A[2i] - W_l B[2i]^T,
//   corr_l = W_r B[2i+1], B_new = -W_l B[2i+1], plus copies of B[2i], B[2i+1]
// That is 9 products of (m, m) blocks, 18 m^3 FLOPs per pair, reading 5
// blocks and writing 8.
//
// What bounds it on an H100: at the solver's shapes (m = 40 with t = 32..4
// pairs, m = 80 with t = 128..4) the work is a few MFLOP to 2 GFLOP per
// launch, so the level is bound by latency and, at m = 80, by the FP32 FMA
// rate of the few SMs that hold a pair each -- not by memory (5 MB to 84 MB
// per factor).
//
// What the design does about it: one CTA per pair keeps the whole
// dependent chain (9 products, 2 reductions, the guard branch) in shared
// memory, so a level is one launch and no intermediate touches device
// memory. Products are plain FP32 FMAs (no TF32, no tensor cores): the
// solver needs true f32. Five (m, m+1) shared buffers are reused across the
// schedule -- {An, X0n/X, M, X'} during Newton-Schulz, then
// {B_left, B_right, Ainv, W_l, W_r} -- with A[2i] read from global memory in
// the epilogue and outputs written from registers: 130 KB at m = 80, inside
// the 227 KB a block may opt into. The +1 padding keeps transposed reads
// free of bank conflicts. Compile without --use_fast_math: the guard's
// isfinite test must see NaN.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 80;

// NaN-propagating max (jnp.maximum / jnp.max semantics; fmaxf drops NaN).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// C = op(A) op(B) over ld-strided shared tiles; C may be shared or global
// (ldc), scaled by `sign`. Every thread owns outputs tid, tid + kThreads, ...
template <bool TA, bool TB>
__device__ void matmul(const float* A, const float* B, float* C, int m,
                       int ld, int ldc, float sign) {
  for (int idx = threadIdx.x; idx < m * m; idx += kThreads) {
    const int r = idx / m;
    const int c = idx - r * m;
    float acc = 0.f;
    for (int k = 0; k < m; ++k) {
      const float a = TA ? A[k * ld + r] : A[r * ld + k];
      const float b = TB ? B[c * ld + k] : B[k * ld + c];
      acc = fmaf(a, b, acc);
    }
    C[r * ldc + c] = sign * acc;
  }
}

// Per-row sums of |I - M| (into e) and |An| (into p), one warp per row.
__device__ void row_sums(const float* M, const float* An, float* e, float* p,
                         int m, int ld) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < m; r += kThreads / 32) {
    float se = 0.f, sp = 0.f;
    for (int c = lane; c < m; c += 32) {
      se += fabsf((r == c ? 1.f : 0.f) - M[r * ld + c]);
      sp += fabsf(An[r * ld + c]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      se += __shfl_down_sync(0xffffffffu, se, off);
      sp += __shfl_down_sync(0xffffffffu, sp, off);
    }
    if (lane == 0) {
      e[r] = se;
      p[r] = sp;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_level_kernel(const float* __restrict__ A, const float* __restrict__ Bp,
                   const float* __restrict__ X0, float* __restrict__ out,
                   int t, int m, float guard) {
  extern __shared__ float smem[];
  __shared__ int bad;
  __shared__ float rho;
  const int ld = m + 1;
  const int tile = m * ld;
  float* S0 = smem;
  float* S1 = S0 + tile;
  float* S2 = S1 + tile;
  float* S3 = S2 + tile;
  float* S4 = S3 + tile;
  float* sv = S4 + tile;  // Jacobi scale s (m)
  float* re = sv + m;     // row sums of |I - M| (m)
  float* rp = re + m;     // row sums of |An| (m)

  const int i = blockIdx.x;
  const int n = m * m;
  const size_t blk = static_cast<size_t>(n);
  const float* a_even = A + (2 * i) * blk;
  const float* a_odd = A + (2 * i + 1) * blk;
  const float* b_left = Bp + (2 * i) * blk;
  const float* b_right = Bp + (2 * i + 1) * blk;
  const float* x0 = X0 + i * blk;
  // outputs, each (t, m, m): Ainv, W_l, W_r, A_new, corr_l, B_new, B_left, B_right
  float* o_ainv = out + (0 * static_cast<size_t>(t) + i) * blk;
  float* o_wl = out + (1 * static_cast<size_t>(t) + i) * blk;
  float* o_wr = out + (2 * static_cast<size_t>(t) + i) * blk;
  float* o_anew = out + (3 * static_cast<size_t>(t) + i) * blk;
  float* o_corr = out + (4 * static_cast<size_t>(t) + i) * blk;
  float* o_bnew = out + (5 * static_cast<size_t>(t) + i) * blk;
  float* o_bl = out + (6 * static_cast<size_t>(t) + i) * blk;
  float* o_br = out + (7 * static_cast<size_t>(t) + i) * blk;

  // ---- Newton-Schulz: S0 = An, S1 = X0n, S2 = M -------------------------
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / m, c = idx - r * m;
    S0[r * ld + c] = a_odd[idx];
    S1[r * ld + c] = x0[idx];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += kThreads)
    sv[r] = 1.f / sqrtf(nan_max(S0[r * ld + r], 1e-30f));
  __syncthreads();
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / m, c = idx - r * m;
    const float ss = sv[r] * sv[c];
    S0[r * ld + c] *= ss;
    S1[r * ld + c] /= nan_max(ss, 1e-30f);
  }
  __syncthreads();
  matmul<false, false>(S0, S1, S2, m, ld, ld, 1.f);  // M = An X0n
  __syncthreads();
  row_sums(S2, S0, re, rp, m, ld);
  __syncthreads();
  if (threadIdx.x == 0) {
    float enorm = re[0], rh = rp[0];
    for (int r = 1; r < m; ++r) {
      enorm = nan_max(enorm, re[r]);
      rh = nan_max(rh, rp[r]);
    }
    bad = (enorm > guard) || !isfinite(enorm);
    rho = rh;
  }
  __syncthreads();
  if (bad) {  // block-uniform: Jacobi start I/rho, whose product is An/rho
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = idx / m, c = idx - r * m;
      S1[r * ld + c] = (r == c ? 1.f : 0.f) / rho;
      S2[r * ld + c] = S0[r * ld + c] / rho;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {  // S2 = 2I - M
    const int r = idx / m, c = idx - r * m;
    S2[r * ld + c] = (r == c ? 2.f : 0.f) - S2[r * ld + c];
  }
  __syncthreads();
  matmul<false, false>(S1, S2, S3, m, ld, ld, 1.f);  // X = X (2I - M)
  __syncthreads();
  matmul<false, false>(S0, S3, S1, m, ld, ld, 1.f);  // P = An X
  __syncthreads();
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {  // S1 = 2I - P
    const int r = idx / m, c = idx - r * m;
    S1[r * ld + c] = (r == c ? 2.f : 0.f) - S1[r * ld + c];
  }
  __syncthreads();
  matmul<false, false>(S3, S1, S2, m, ld, ld, 1.f);  // X = X (2I - An X)
  __syncthreads();

  // ---- Ainv (S2), B_left (S0), B_right (S1) -----------------------------
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / m, c = idx - r * m;
    const float ainv = S2[r * ld + c] * (sv[r] * sv[c]);
    S2[r * ld + c] = ainv;
    o_ainv[idx] = ainv;
    const float bl = b_left[idx], br = b_right[idx];
    S0[r * ld + c] = bl;
    S1[r * ld + c] = br;
    o_bl[idx] = bl;
    o_br[idx] = br;
  }
  __syncthreads();
  matmul<false, false>(S0, S2, S3, m, ld, ld, 1.f);  // W_l = B_left Ainv
  matmul<true, false>(S1, S2, S4, m, ld, ld, 1.f);   // W_r = B_right^T Ainv
  __syncthreads();
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / m, c = idx - r * m;
    o_wl[idx] = S3[r * ld + c];
    o_wr[idx] = S4[r * ld + c];
  }
  // A_new = A_even - W_l B_left^T, with A_even read from global memory
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / m, c = idx - r * m;
    float acc = 0.f;
    for (int k = 0; k < m; ++k) acc = fmaf(S3[r * ld + k], S0[c * ld + k], acc);
    o_anew[idx] = a_even[idx] - acc;
  }
  matmul<false, false>(S4, S1, o_corr, m, ld, m, 1.f);   // corr_l = W_r B_right
  matmul<false, false>(S3, S1, o_bnew, m, ld, m, -1.f);  // B_new = -W_l B_right
}

// Five (m, m+1) tiles plus three m-vectors.
size_t smem_bytes(int m) {
  return sizeof(float) * (5 * static_cast<size_t>(m) * (m + 1) + 3 * m);
}

}  // namespace

// A (2t, m, m), Bp (2t, m, m) with Bp[2t-1] = 0, X0 (t, m, m), out (8, t, m, m);
// all f32, contiguous, on the current device. Launches on `stream`; returns
// the CUDA error code of the attribute call or the launch (0 on success).
extern "C" int fused_level_launch(const float* A, const float* Bp,
                                  const float* X0, float* out, int t, int m,
                                  float guard, void* stream) {
  if (m < 1 || m > kMaxM || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      fused_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_level_kernel<<<t, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, Bp, X0, out, t, m, guard);
  return static_cast<int>(cudaGetLastError());
}
