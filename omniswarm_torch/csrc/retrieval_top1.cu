// Masked top-1 place retrieval: Q queries against an (N, D) descriptor DB.
//
// Replaces the TPU kernel omniswarm_tpu/ops/pallas_kernels.py::
// retrieval_top1_pallas (body _retrieval_kernel). For each query q < Q:
//   sims[n] = sum_k db[n, k] * query[q, k]   (f32 accumulation)
//   sims[n] = -inf where mask[q, n] is false
//   best[q] = the lowest n among the maxima of sims, sim[q] = sims[best[q]]
// The TPU kernel walks 256-row chunks in order, keeps the first maximum
// within a chunk and lets a later chunk win only when strictly greater;
// together that is "lowest index among equal maxima", which is what both
// passes here implement. When every row is masked the result is (0, -inf).
// Inputs are unit descriptors: the kernel assumes finite similarities.
//
// What bounds it on an H100: the DB is read once per launch (4096 x 4096 f32
// is 64 MB, about 20 us at 3.35 TB/s) against 2 Q N D FLOPs (168 MFLOP at
// Q = 5, 2.5 us at 67 TFLOP/s FP32), so memory bounds it.
//
// What the design does about it: pass 1 gives each warp one DB row at a
// time (grid-stride over rows); its lanes stream the row with 16-byte loads,
// neighbouring lanes on neighbouring addresses, and accumulate the dot
// products of up to 8 queries at once, so for Q <= 8 the DB is read exactly
// once. The queries (at most 8 x 16 KB) are read through the read-only
// cache. Each warp keeps a running (max, index) per query; the CTA reduces
// its warps' pairs in shared memory and writes one pair per query. Pass 2,
// one CTA per query, reduces the CTAs' pairs with the same tie-break.
#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kWarps = 8;            // warps per CTA in pass 1
constexpr int kThreads = 32 * kWarps;
constexpr int kQueries = 8;          // queries accumulated per DB read
constexpr int kMaxBlocks = 1024;     // pass-1 CTAs
constexpr int kReduceThreads = 256;  // pass-2 CTA size

// (s, i) beats (bs, bi): larger similarity, or equal and lower index.
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(kThreads)
retrieval_partial_kernel(const float* __restrict__ db,
                         const float* __restrict__ query,
                         const unsigned char* __restrict__ mask, int N, int D,
                         int Q, int vec4, float* __restrict__ part_sim,
                         int* __restrict__ part_idx) {
  __shared__ float s_sim[kWarps][kQueries];
  __shared__ int s_idx[kWarps][kQueries];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const int D4 = vec4 ? D / 4 : 0;

  for (int q0 = 0; q0 < Q; q0 += kQueries) {
    const int nq = min(kQueries, Q - q0);
    float best[kQueries];
    int best_i[kQueries];
#pragma unroll
    for (int j = 0; j < kQueries; ++j) {
      best[j] = -INFINITY;
      best_i[j] = INT_MAX;
    }
    for (int row = gwarp; row < N; row += nwarps) {
      const float* drow = db + static_cast<size_t>(row) * D;
      float acc[kQueries];
#pragma unroll
      for (int j = 0; j < kQueries; ++j) acc[j] = 0.f;
      const float4* drow4 = reinterpret_cast<const float4*>(drow);
      for (int k = lane; k < D4; k += 32) {
        const float4 d = drow4[k];
#pragma unroll
        for (int j = 0; j < kQueries; ++j) {
          if (j < nq) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(
                query + static_cast<size_t>(q0 + j) * D) + k);
            acc[j] += d.x * v.x + d.y * v.y + d.z * v.z + d.w * v.w;
          }
        }
      }
      for (int k = 4 * D4 + lane; k < D; k += 32) {
        const float d = drow[k];
#pragma unroll
        for (int j = 0; j < kQueries; ++j)
          if (j < nq)
            acc[j] += d * __ldg(query + static_cast<size_t>(q0 + j) * D + k);
      }
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
        float v = acc[j];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (j < nq) {
          const float s =
              mask[static_cast<size_t>(q0 + j) * N + row] ? v : -INFINITY;
          if (beats(s, row, best[j], best_i[j])) {
            best[j] = s;
            best_i[j] = row;
          }
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
        s_sim[warp][j] = best[j];
        s_idx[warp][j] = best_i[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < nq) {
      const int j = threadIdx.x;
      float bs = s_sim[0][j];
      int bi = s_idx[0][j];
      for (int w = 1; w < kWarps; ++w) {
        if (beats(s_sim[w][j], s_idx[w][j], bs, bi)) {
          bs = s_sim[w][j];
          bi = s_idx[w][j];
        }
      }
      part_sim[static_cast<size_t>(q0 + j) * gridDim.x + blockIdx.x] = bs;
      part_idx[static_cast<size_t>(q0 + j) * gridDim.x + blockIdx.x] = bi;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kReduceThreads)
retrieval_reduce_kernel(const float* __restrict__ part_sim,
                        const int* __restrict__ part_idx, int nparts,
                        long long* __restrict__ out_idx,
                        float* __restrict__ out_sim) {
  __shared__ float s_sim[kReduceThreads];
  __shared__ int s_idx[kReduceThreads];
  const int q = blockIdx.x;
  float bs = -INFINITY;
  int bi = INT_MAX;
  for (int p = threadIdx.x; p < nparts; p += kReduceThreads) {
    const float s = part_sim[static_cast<size_t>(q) * nparts + p];
    const int i = part_idx[static_cast<size_t>(q) * nparts + p];
    if (beats(s, i, bs, bi)) {
      bs = s;
      bi = i;
    }
  }
  s_sim[threadIdx.x] = bs;
  s_idx[threadIdx.x] = bi;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const float s = s_sim[threadIdx.x + stride];
      const int i = s_idx[threadIdx.x + stride];
      if (beats(s, i, s_sim[threadIdx.x], s_idx[threadIdx.x])) {
        s_sim[threadIdx.x] = s;
        s_idx[threadIdx.x] = i;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // INT_MAX only if no row was ever a candidate (N == 0 is refused)
    out_idx[q] = s_idx[0] == INT_MAX ? 0 : s_idx[0];
    out_sim[q] = s_sim[0];
  }
}

}  // namespace

// Number of pass-1 CTAs for an N-row DB: the length of each query's row of
// the partial buffers the caller allocates.
extern "C" int retrieval_top1_blocks(int N) {
  const int need = (N + kWarps - 1) / kWarps;
  return need < 1 ? 1 : (need > kMaxBlocks ? kMaxBlocks : need);
}

// db (N, D) f32, query (Q, D) f32, mask (Q, N) bool (one byte each), all
// contiguous on the current device; part_sim (Q, nb) f32 and part_idx (Q, nb)
// i32 scratch with nb = retrieval_top1_blocks(N); out_idx (Q,) i64, out_sim
// (Q,) f32. Launches both passes on `stream`; returns the CUDA error code of
// the launches (0 on success).
extern "C" int retrieval_top1_launch(const float* db, const float* query,
                                     const unsigned char* mask, int N, int D,
                                     int Q, float* part_sim, int* part_idx,
                                     long long* out_idx, float* out_sim,
                                     void* stream) {
  if (N < 1 || D < 1 || Q < 1 || Q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = retrieval_top1_blocks(N);
  const bool aligned =
      (reinterpret_cast<size_t>(db) % 16 == 0) &&
      (reinterpret_cast<size_t>(query) % 16 == 0);
  const int vec4 = (D % 4 == 0 && aligned) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  retrieval_partial_kernel<<<nb, kThreads, 0, s>>>(db, query, mask, N, D, Q,
                                                   vec4, part_sim, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  retrieval_reduce_kernel<<<Q, kReduceThreads, 0, s>>>(part_sim, part_idx, nb,
                                                       out_idx, out_sim);
  return static_cast<int>(cudaGetLastError());
}
