// One warm cyclic-reduction level of the block-tridiagonal factorization.
//
// Replaces the TPU kernel omniswarm_tpu/solver/pallas_level.py::
// fused_reduction_level (body _level_kernel). For each block pair i < t it
// computes, on f32 (m, m) blocks (m <= 80):
//   s = rsqrt(max(diag A[2i+1], 1e-30)), An = S A[2i+1] S, X0n = X0 / max(s s^T, 1e-30)
//   M = An X0n; enorm = max row-sum |I - M|; rho = max row-sum |An|
//   if enorm > guard or enorm is not finite: X = I/rho, M = An/rho
//   X1 = X (2I - M); P = An X1; X2 = X1 (2I - P); Ainv = X2 o s s^T
//   W_l = B[2i] Ainv, W_r = B[2i+1]^T Ainv, A_new = A[2i] - W_l B[2i]^T,
//   corr_l = W_r B[2i+1], B_new = -W_l B[2i+1], plus copies of B[2i], B[2i+1]
// B holds 2t - 1 blocks: the last pair's B[2i+1] is zero. That is 9 products
// of (m, m) blocks, 18 m^3 FLOPs per pair, reading 5 blocks and writing 8.
//
// What bounds it on an H100: the solver launches m = 40 with t = 32..4
// pairs and m = 80 with t = 128..4. Every launch fits in one wave of the 132
// SMs, so a level takes as long as one pair's dependent chain (9 products, 2
// reductions, the guard) on the SMs that hold it. At t = 128, m = 80 that is
// the FP32 FMA rate of one SM per pair (0.52 MFLOP a product); at small t it
// is the chain's latency, which one SM per pair cannot bring below ~18 us at
// m = 80. Memory is not the bound (5 to 84 MB per factor).
//
// What the design does about it:
// - Register tiles. Each thread owns a T x T micro-tile (T = 1..5, chosen so
//   the panel's outputs fit 256 threads) of every product and keeps its sums
//   in registers: per k step it loads T values of each operand from shared
//   memory for T^2 FMAs (0.4 loads per FMA at T = 5, not 2), and at m = 40
//   and 80 an operand that runs along k is read as float4. Thread (tr, tc)
//   owns rows tr + TR i and columns tc + TC j, so a warp reads few distinct
//   left-operand rows (broadcasts) and consecutive right-operand columns.
//   Every output is summed by one thread with fmaf in k order, so results
//   are the same from run to run. True FP32: no TF32, no tensor cores (the
//   solver needs f32).
// - A cluster of C CTAs per pair (C in {1, 2, 4, 8}: the largest with at
//   most one CTA per SM and all resident, see fused_level_cluster_size). The
//   Newton-Schulz chain runs on column panels: M, X1, P and X2 each need only
//   the CTA's own columns of their right operand, and their left operands
//   (An, X0n) every CTA loads whole. Only X1 (the left operand of X2) and
//   Ainv (the right operand of W_l, W_r) cross CTAs: each CTA stores its
//   panel into every peer's shared memory (distributed shared memory, no
//   remote loads) before a cluster barrier. The guard's row sums of |I - M|
//   (one thread a row) are exchanged the same way and summed in rank order,
//   so every CTA takes the same branch, NaN included. The epilogue runs on
//   row panels, whose operands are all local. At t = 4 this puts 32 SMs on
//   the level, not 4.
// - Overlapped loads and stores. A[2i+1] and X0 are issued with cp.async
//   first, B[2i], B[2i+1] and the CTA's rows of A[2i] in a second group that
//   lands while the Newton-Schulz chain runs. Cluster barriers are split:
//   the product P and the Ainv output run between a barrier's arrive and its
//   wait. Products store only into the CTA's own shared memory; panels go to
//   the peers in a separate copy loop and every output goes to device memory
//   from shared memory in 16-byte stores: stores inside the product loops
//   slowed those loops several times over at t = 128.
// Seven (m, row_stride(m)) tiles are resident: 191 KB at m = 80, inside the
// 227 KB a block may opt into. Compile without --use_fast_math: the guard's
// isfinite test must see NaN.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <initializer_list>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 80;
constexpr int kMaxTile = 5;
constexpr int kMaxDevices = 16;
constexpr int kClusterSizes[] = {8, 4, 2};

// NaN-propagating max (jnp.maximum / jnp.max semantics; fmaxf drops NaN).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Row stride of a shared tile: m + 1 rounded up to a multiple of 4, so rows
// start on 16 bytes (cp.async and float4 loads) and, at m = 40 and 80, a
// warp's reads of up to 8 consecutive rows fall in distinct banks.
__host__ __device__ constexpr int row_stride(int m) { return (m + 4) & ~3; }

// Columns a CTA of a cluster of C takes: ceil(m / C), rounded up to a
// multiple of 4 when m is one, so panels start on 16 bytes (the last ranks
// may get fewer columns, or none).
__host__ __device__ constexpr int panel_width(int m, int C) {
  return m % 4 == 0 ? ((m + C - 1) / C + 3) & ~3 : (m + C - 1) / C;
}

// Rows [r0, r1) of a contiguous (m, m) block into an ld-strided tile.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int r1, int m, int ld) {
  if (m % 4 == 0) {
    const int q = m / 4, n = (r1 - r0) * q;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = r0 + idx / q, c = 4 * (idx % q);
      cp_async16(dst + r * ld + c, src + r * m + c);
    }
    return;
  }
  const int n = (r1 - r0) * m;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = r0 + idx / m, c = idx % m;
    cp_async4(dst + r * ld + c, src + r * m + c);
  }
}

// out(r, c) = sum_k L(r, k) R(k, c) over rows [r0, r0 + R) x columns
// [c0, c0 + W) of ld-strided shared tiles, handed to store(r, c, value).
// L(r, k) = Ls[r][k], or Ls[k][r] if LT; R(k, c) = Rs[k][c], or Rs[c][k] if
// RT. Thread (tr, tc) of the TR x TC grid owns rows r0 + tr + TR i and
// columns c0 + tc + TC j (i, j < T); threads past the grid and outputs past
// the region do no stores. With m a multiple of 4 known at compile time, an
// operand that runs along k in memory is read as float4 (4 k steps a load);
// the sum still runs over k in order. No barrier inside.
template <int T, int MCT, bool LT, bool RT, class FS>
__device__ __forceinline__ void tile_mm(int m_rt, const float* Ls,
                                        const float* Rs, int r0, int R,
                                        int c0, int W, FS store) {
  constexpr bool kVec = MCT > 0 && MCT % 4 == 0;
  const int m = MCT ? MCT : m_rt;
  const int ld = row_stride(m);
  if (R <= 0 || W <= 0) return;
  const int TC = (W + T - 1) / T, TR = (R + T - 1) / T;
  const int tr = threadIdx.x / TC, tc = threadIdx.x - tr * TC;
  if (tr >= TR) return;
  int rows[T], cols[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int rr = tr + TR * i, cc = tc + TC * i;
    rows[i] = r0 + (rr < R ? rr : 0);  // clamped: loads stay in the tile
    cols[i] = c0 + (cc < W ? cc : 0);
  }
  float acc[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = 0.f;
  if constexpr (kVec) {
#pragma unroll 2
    for (int k = 0; k < m; k += 4) {
      float av[T][4], bv[T][4];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        if constexpr (LT) {
#pragma unroll
          for (int u = 0; u < 4; ++u) av[i][u] = Ls[(k + u) * ld + rows[i]];
        } else {
          const float4 v =
              *reinterpret_cast<const float4*>(Ls + rows[i] * ld + k);
          av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if constexpr (RT) {
          const float4 v =
              *reinterpret_cast<const float4*>(Rs + cols[j] * ld + k);
          bv[j][0] = v.x; bv[j][1] = v.y; bv[j][2] = v.z; bv[j][3] = v.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) bv[j][u] = Rs[(k + u) * ld + cols[j]];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int j = 0; j < T; ++j)
            acc[i][j] = fmaf(av[i][u], bv[j][u], acc[i][j]);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      float av[T], bv[T];
#pragma unroll
      for (int i = 0; i < T; ++i)
        av[i] = LT ? Ls[k * ld + rows[i]] : Ls[rows[i] * ld + k];
#pragma unroll
      for (int j = 0; j < T; ++j)
        bv[j] = RT ? Rs[cols[j] * ld + k] : Rs[k * ld + cols[j]];
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (tr + TR * i >= R) continue;
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (tc + TC * j < W) store(rows[i], cols[j], acc[i][j]);
  }
}

// Rows [r0, r0 + nr) x columns [c0, c0 + nc) of an ld-strided tile into the
// same place of a contiguous (m, m) block; float4 stores when m is a multiple
// of 4 (then so are c0 and nc: whole rows or panels, see panel_width).
__device__ __forceinline__ void store_block(float* dst, const float* S,
                                            int r0, int nr, int c0, int nc,
                                            int m, int ld) {
  if (m % 4 == 0) {
    const int q = nc / 4;
    for (int idx = threadIdx.x; idx < nr * q; idx += kThreads) {
      const int r = r0 + idx / q, c = c0 + 4 * (idx % q);
      *reinterpret_cast<float4*>(dst + r * m + c) =
          *reinterpret_cast<const float4*>(S + r * ld + c);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < nr * nc; idx += kThreads) {
    const int r = r0 + idx / nc, c = c0 + idx % nc;
    dst[r * m + c] = S[r * ld + c];
  }
}

// This CTA's columns [p0, p0 + pw) of tile S into the same place of every
// peer's S (distributed shared memory stores).
__device__ __forceinline__ void push_cols(cg::cluster_group& cluster,
                                          float* S, int m, int ld, int p0,
                                          int pw) {
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (m % 4 == 0) {  // so are p0 and pw (panel_width)
    const int q = pw / 4;
    for (int idx = threadIdx.x; idx < m * q; idx += kThreads) {
      const int at = (idx / q) * ld + p0 + 4 * (idx % q);
      const float4 v = *reinterpret_cast<const float4*>(S + at);
      for (int p = 0; p < C; ++p)
        if (p != rank)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(S, p) + at) = v;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < m * pw; idx += kThreads) {
    const int at = (idx / pw) * ld + p0 + idx % pw;
    const float v = S[at];
    for (int p = 0; p < C; ++p)
      if (p != rank) cluster.map_shared_rank(S, p)[at] = v;
  }
}

// Grid: t clusters of C CTAs (cluster rank = blockIdx.x % C). T: micro-tile
// side; MCT: m at compile time (0: m_rt at run time). Peers exchange data by
// storing into each other's shared memory (no CTA reads a peer's); every
// exchange is followed by a cluster barrier (release/acquire) before use.
template <int T, int MCT>
__global__ void __launch_bounds__(kThreads, 1)
fused_level_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ X0, float* __restrict__ out,
                   int t, int m_rt, float guard) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int m = MCT ? MCT : m_rt;
  const int ld = row_stride(m);
  const int tile = m * ld;
  const int w = panel_width(m, C);
  const int p0 = min(m, rank * w);             // this CTA's panel [p0, p0 + pw)
  const int pw = min(m, p0 + w) - p0;

  extern __shared__ __align__(16) float smem[];
  __shared__ int bad;
  __shared__ float rho;
  float* An = smem;        // An; W_l rows in the epilogue
  float* X = An + tile;    // X0n or I/rho; Ainv (all columns); B_new rows
  float* Tm = X + tile;    // own columns of M, 2I - M, then 2I - P; W_r rows
  float* X1 = Tm + tile;   // X1 (all columns); corr_l rows
  float* Bl = X1 + tile;   // B[2i]
  float* Br = Bl + tile;   // B[2i+1], zero for the last pair
  float* Ae = Br + tile;   // own rows of A[2i], then of A_new
  float* sv = Ae + tile;   // Jacobi scale s (m)
  float* rp = sv + m;      // row sums of |An| (m)
  float* part = rp + m;    // row q: rank q's row sums of |I - M|, own columns

  const int i = blockIdx.x / C;
  const size_t blk = static_cast<size_t>(m) * m;
  const size_t plane = static_cast<size_t>(t) * blk;
  const bool has_right = i + 1 < t;
  // outputs, each (t, m, m): Ainv, W_l, W_r, A_new, corr_l, B_new, B_left, B_right
  float* o_ainv = out + i * blk;
  float* o_wl = o_ainv + plane;
  float* o_wr = o_wl + plane;
  float* o_anew = o_wr + plane;
  float* o_corr = o_anew + plane;
  float* o_bnew = o_corr + plane;
  float* o_bl = o_bnew + plane;
  float* o_br = o_bl + plane;

  // ---- loads: {A[2i+1], X0} now, {B[2i], B[2i+1], A[2i] rows} behind NS ---
  load_rows(An, A + (2 * i + 1) * blk, 0, m, m, ld);
  load_rows(X, X0 + i * blk, 0, m, m, ld);
  cp_async_commit();
  load_rows(Bl, B + (2 * i) * blk, 0, m, m, ld);
  if (has_right) {
    load_rows(Br, B + (2 * i + 1) * blk, 0, m, m, ld);
  } else {
    for (int idx = threadIdx.x; idx < m * m; idx += kThreads)
      Br[(idx / m) * ld + idx % m] = 0.f;
  }
  load_rows(Ae, A + (2 * i) * blk, p0, p0 + pw, m, ld);
  cp_async_commit();
  // peers' shared memory may be written only once every CTA has started
  if (C > 1) cluster_arrive();
  cp_async_wait<1>();
  __syncthreads();

  // ---- Jacobi scaling ----------------------------------------------------
  for (int r = threadIdx.x; r < m; r += kThreads)
    sv[r] = 1.f / sqrtf(nan_max(An[r * ld + r], 1e-30f));
  __syncthreads();
  for (int idx = threadIdx.x; idx < m * m; idx += kThreads) {
    const int r = idx / m, c = idx % m;
    const float ss = sv[r] * sv[c];
    An[r * ld + c] *= ss;
    X[r * ld + c] /= nan_max(ss, 1e-30f);
  }
  __syncthreads();

  auto to = [=](float* S) {
    return [=](int r, int c, float v) { S[r * ld + c] = v; };
  };

  // ---- M = An X0n (own columns), guard -----------------------------------
  tile_mm<T, MCT, false, false>(m, An, X, 0, m, p0, pw, to(Tm));
  __syncthreads();
  if (C > 1) cluster_wait();
  if (threadIdx.x < m) {  // row sums of |I - M| over own columns, to all
    const int r = threadIdx.x;
    float se = 0.f;
    for (int c = p0; c < p0 + pw; ++c)
      se += fabsf((r == c ? 1.f : 0.f) - Tm[r * ld + c]);
    part[rank * ld + r] = se;
    for (int q = 0; q < C; ++q)
      if (q != rank) cluster.map_shared_rank(part, q)[rank * ld + r] = se;
  } else if (threadIdx.x >= 128 && threadIdx.x < 128 + m) {
    const int r = threadIdx.x - 128;
    float sp = 0.f;
    for (int c = 0; c < m; ++c) sp += fabsf(An[r * ld + c]);
    rp[r] = sp;
  }
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // every CTA of the pair computes the same values
    float enorm = 0.f, rh = 0.f;
    for (int r = threadIdx.x; r < m; r += 32) {
      float e = 0.f;
      for (int q = 0; q < C; ++q) e += part[q * ld + r];
      enorm = nan_max(enorm, e);
      rh = nan_max(rh, rp[r]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      enorm = nan_max(enorm, __shfl_xor_sync(0xffffffffu, enorm, off));
      rh = nan_max(rh, __shfl_xor_sync(0xffffffffu, rh, off));
    }
    if (threadIdx.x == 0) {
      bad = (enorm > guard) || !isfinite(enorm);
      rho = rh;
    }
  }
  __syncthreads();

  // ---- fallback start, 2I - M --------------------------------------------
  const bool fallback = bad;
  const float rh = rho;
  for (int idx = threadIdx.x; idx < m * pw; idx += kThreads) {
    const int r = idx / pw, c = p0 + idx % pw;
    const float mv = fallback ? An[r * ld + c] / rh : Tm[r * ld + c];
    Tm[r * ld + c] = (r == c ? 2.f : 0.f) - mv;
  }
  if (fallback) {  // cluster-uniform: Jacobi start I/rho
    for (int idx = threadIdx.x; idx < m * m; idx += kThreads) {
      const int r = idx / m, c = idx % m;
      X[r * ld + c] = (r == c ? 1.f : 0.f) / rh;
    }
  }
  __syncthreads();

  // ---- X1 = X (2I - M) to every CTA; P = An X1, kept as 2I - P -----------
  tile_mm<T, MCT, false, false>(m, X, Tm, 0, m, p0, pw, to(X1));
  __syncthreads();
  if (C > 1) {
    push_cols(cluster, X1, m, ld, p0, pw);
    cluster_arrive();
  }
  tile_mm<T, MCT, false, false>(m, An, X1, 0, m, p0, pw,
                                [=](int r, int c, float v) {
                                  Tm[r * ld + c] = (r == c ? 2.f : 0.f) - v;
                                });
  if (C > 1) cluster_wait();
  __syncthreads();

  // ---- X2 = X1 (2I - P), Ainv = X2 o s s^T to every CTA ------------------
  tile_mm<T, MCT, false, false>(m, X1, Tm, 0, m, p0, pw,
                                [=](int r, int c, float v) {
                                  X[r * ld + c] = v * (sv[r] * sv[c]);
                                });
  cp_async_wait<0>();
  __syncthreads();
  if (C > 1) {
    push_cols(cluster, X, m, ld, p0, pw);
    cluster_arrive();
  }
  store_block(o_ainv, X, 0, m, p0, pw, m, ld);
  if (C > 1) cluster_wait();  // after this, no CTA touches a peer
  __syncthreads();

  // ---- epilogue on own rows: W_l (in An), W_r (in Tm) ---------------------
  tile_mm<T, MCT, false, false>(m, Bl, X, p0, pw, 0, m, to(An));
  tile_mm<T, MCT, true, false>(m, Br, X, p0, pw, 0, m, to(Tm));
  __syncthreads();

  // ---- A_new = A[2i] - W_l B_l^T (in Ae), corr_l = W_r B_r (in X1),
  //      B_new = -W_l B_r (in X) ---------------------------------------------
  tile_mm<T, MCT, false, true>(m, An, Bl, p0, pw, 0, m,
                               [=](int r, int c, float v) {
                                 Ae[r * ld + c] -= v;
                               });
  tile_mm<T, MCT, false, false>(m, Tm, Br, p0, pw, 0, m, to(X1));
  tile_mm<T, MCT, false, false>(m, An, Br, p0, pw, 0, m,
                                [=](int r, int c, float v) {
                                  X[r * ld + c] = -v;
                                });
  __syncthreads();
  store_block(o_wl, An, p0, pw, 0, m, m, ld);
  store_block(o_wr, Tm, p0, pw, 0, m, m, ld);
  store_block(o_anew, Ae, p0, pw, 0, m, m, ld);
  store_block(o_corr, X1, p0, pw, 0, m, m, ld);
  store_block(o_bnew, X, p0, pw, 0, m, m, ld);
  store_block(o_bl, Bl, p0, pw, 0, m, m, ld);
  store_block(o_br, Br, p0, pw, 0, m, m, ld);
}

using KernelFn = void (*)(const float*, const float*, const float*, float*,
                          int, int, float);

// Seven (m, row_stride(m)) tiles, two m-vectors and the (8, row_stride(m))
// row sums of the guard.
constexpr size_t smem_bytes(int m) {
  return sizeof(float) *
         ((7 * static_cast<size_t>(m) + 8) * row_stride(m) + 2 * m);
}

// The least micro-tile side whose grid over an (m, ceil(m/C)) panel fits
// the CTA's threads.
constexpr int tile_side(int m, int C) {
  const int w = panel_width(m, C);
  for (int T = 1; T < kMaxTile; ++T)
    if (((m + T - 1) / T) * ((w + T - 1) / T) <= kThreads) return T;
  return kMaxTile;
}

// The path's widths get m at compile time, instantiated only at the tile
// sides their cluster sizes reach (m = 40: 3, 2, 2, 2 and m = 80: 5, 4, 3, 2
// for C = 1, 2, 4, 8); any other m runs the same kernel with m at run time,
// at every tile side.
template <int M, int C>
KernelFn fixed_kernel() {
  return fused_level_kernel<tile_side(M, C), M>;
}

KernelFn runtime_kernel(int T) {
  switch (T) {
    case 1: return fused_level_kernel<1, 0>;
    case 2: return fused_level_kernel<2, 0>;
    case 3: return fused_level_kernel<3, 0>;
    case 4: return fused_level_kernel<4, 0>;
    default: return fused_level_kernel<5, 0>;
  }
}

template <int M>
KernelFn width_kernel(int C) {
  switch (C) {
    case 8: return fixed_kernel<M, 8>();
    case 4: return fixed_kernel<M, 4>();
    case 2: return fixed_kernel<M, 2>();
    default: return fixed_kernel<M, 1>();
  }
}

KernelFn pick_kernel(int m, int C) {
  if (m == 80) return width_kernel<80>(C);
  if (m == 40) return width_kernel<40>(C);
  return runtime_kernel(tile_side(m, C));
}

// Per-device state, filled on the device's first query or launch: its SM
// count, every instantiation opted into the shared memory of m = 80 (so one
// setting serves every m of the run-time instantiation), and the clusters
// of each (m, C) kernel the device holds at once (-1: not asked yet).
struct DeviceState {
  bool ready;
  int sms;
  int clusters[kMaxM + 1][3];  // C = 8, 4, 2, as kClusterSizes
};
DeviceState g_devices[kMaxDevices];

cudaError_t device_state(DeviceState** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& s = g_devices[dev];
  *out = &s;
  if (s.ready) return cudaSuccess;
  err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  KernelFn all[2 * 4 + kMaxTile];
  int n = 0;
  for (int C : {1, 2, 4, 8}) {
    all[n++] = width_kernel<40>(C);
    all[n++] = width_kernel<80>(C);
  }
  for (int T = 1; T <= kMaxTile; ++T) all[n++] = runtime_kernel(T);
  for (int k = 0; k < n && err == cudaSuccess; ++k)
    err = cudaFuncSetAttribute(all[k],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxM)));
  if (err != cudaSuccess) return err;
  for (auto& row : s.clusters)
    for (int& c : row) c = -1;
  s.ready = true;
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int m, int C, int t,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(t * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(m);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// CTAs per pair for t pairs of (m, m) blocks on the current device (see
// fused_level_cluster_size).
cudaError_t cluster_size(int m, int t, int* C_out) {
  DeviceState* s = nullptr;
  cudaError_t err = device_state(&s);
  if (err != cudaSuccess) return err;
  for (int slot = 0; slot < 3; ++slot) {
    const int C = kClusterSizes[slot];
    if (C > m || t * C > s->sms) continue;
    int& n = s->clusters[m][slot];
    if (n < 0) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(m, C, 1, &attr);
      int active = 0;
      err = cudaOccupancyMaxActiveClusters(&active, pick_kernel(m, C), &cfg);
      if (err != cudaSuccess) return err;
      n = active;
    }
    if (t <= n) {
      *C_out = C;
      return cudaSuccess;
    }
  }
  *C_out = 1;
  return cudaSuccess;
}

}  // namespace

// CTAs per block pair for a level of t pairs of (m, m) blocks on the current
// device: the largest C in {8, 4, 2} with C <= m, t C <= the SM count and all
// t clusters resident at once (one wave), else 1. Returns C, or minus a CUDA
// error code.
extern "C" int fused_level_cluster_size(int m, int t) {
  if (m < 1 || m > kMaxM || t < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  int C = 0;
  const cudaError_t err = cluster_size(m, t, &C);
  return err == cudaSuccess ? C : -static_cast<int>(err);
}

// A (2t, m, m), B (2t-1, m, m), X0 (t, m, m), out (8, t, m, m); all f32,
// contiguous, on the current device, and 16-byte aligned when m % 4 == 0.
// Launches t clusters of fused_level_cluster_size(m, t) CTAs on `stream`;
// returns the CUDA error code of the size query or the launch (0 on
// success). A refused cluster launch is returned, never retried with
// smaller clusters.
extern "C" int fused_level_launch(const float* A, const float* B,
                                  const float* X0, float* out, int t, int m,
                                  float guard, void* stream) {
  if (m < 1 || m > kMaxM || t < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int C = 0;
  cudaError_t err = cluster_size(m, t, &C);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(m, C, t, &attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, pick_kernel(m, C), A, B, X0, out, t, m,
                           guard);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
