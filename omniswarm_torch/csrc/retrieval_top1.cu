// Masked top-1 place retrieval: Q queries against an (N, D) descriptor DB.
//
// Replaces the TPU kernel omniswarm_tpu/ops/pallas_kernels.py::
// retrieval_top1_pallas (body _retrieval_kernel). For each query q < Q:
//   sims[n] = sum_k db[n, k] * query[q, k]   (f32 accumulation, no TF32)
//   sims[n] = -inf where mask[q, n] is false
//   best[q] = the lowest n among the maxima of sims, sim[q] = sims[best[q]]
// The TPU kernel walks 256-row chunks in order, keeps the first maximum
// within a chunk and lets a later chunk win only when strictly greater;
// together that is "lowest index among equal maxima", which every reduction
// here implements by comparing (similarity, index) pairs (`beats`), never by
// the order in which CTAs finish. A masked row is (-inf, n), so a query
// whose every row is masked returns (0, -inf) with no special case.
// Inputs are unit descriptors: the kernel assumes finite similarities.
//
// What bounds it on an H100: the DB is read once per launch (4096 x 4096 f32
// is 64 MB, 20 us at 3.35 TB/s) against 2 Q N D FLOPs (168 MFLOP at Q = 5,
// 2.5 us at 67 TFLOP/s FP32), so device-memory bytes bound it; at N = 512 the
// 8 MB DB is a few microseconds of work and latency bounds it.
//
// What the design does about it (one launch, any N, D and Q):
// - Row tiles: a CTA takes kRows = 4 DB rows at a time (grid-stride over
//   tiles, at most kBlocksPerSM CTAs per SM) and all 8 warps split D: thread
//   t owns the 16-byte columns t, t + 256, t + 512, ... of every row, so a
//   512-row DB still spreads over 128 CTAs with every lane loading.
// - Loads in flight: each step a lane issues kRows x JU independent 16-byte
//   DB loads (__ldg) before it multiplies; JU is 4, 2 or 1 by the query
//   count, to stay within 128 registers.
// - Query reuse: a query float4 (__ldg, L1-resident) serves kRows DB float4s,
//   so a step issues kRows + KQ loads for kRows * KQ float4 products, where
//   the warp-per-row design issued Q query loads beside every DB load.
// - Same order for every row: the column split depends on D alone, each
//   lane accumulates its columns in increasing order with explicit fmaf,
//   the warp sums by one xor-shuffle tree and the CTA adds its 8 warps'
//   partials in warp order. Rows past N (a ragged last tile) reuse row N - 1
//   and are dropped afterwards, and queries past Q reuse query Q - 1, so no
//   row's dot depends on its position. Equal rows give bit-equal sims.
// - Fixed costs: the CTAs' per-query (sim, index) pairs are reduced by the
//   last CTA to finish (a ticket counter that it resets to 0), so one launch
//   does the whole search; the caller passes one scratch allocation.
// D % 4 != 0 or unaligned pointers take the same kernel with 4-byte units.
#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 256;     // 8 warps, splitting D
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;          // DB rows per tile
constexpr int kMaxQueries = 8;    // queries per pass over the DB
constexpr int kBlocksPerSM = 2;

// (s, i) beats (bs, bi): larger similarity, or equal and lower index.
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ float dot_acc(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float dot_acc(float a, float b, float acc) {
  return fmaf(a, b, acc);
}

// T is the load unit (float4, or float when D % 4 != 0 or a pointer is not
// 16-byte aligned); W = D / (units per T). KQ queries per pass over the DB.
template <typename T, int KQ>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
retrieval_kernel(const T* __restrict__ db, const T* __restrict__ query,
                 const unsigned char* __restrict__ mask, int N, int W, int Q,
                 float* __restrict__ part_sim, int* __restrict__ part_idx,
                 unsigned int* __restrict__ ticket,
                 long long* __restrict__ out_idx,
                 float* __restrict__ out_sim) {
  constexpr int JU = KQ <= 2 ? 4 : (KQ <= 5 ? 2 : 1);  // columns per step
  constexpr int kSlots = kRows * KQ;  // (row, query) pairs of a tile
  __shared__ float s_part[2][kWarps][kSlots];
  __shared__ float s_best[kSlots];
  __shared__ int s_best_i[kSlots];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ntiles = (N + kRows - 1) / kRows;
  // thread tid < kSlots reduces slot (row tid / KQ, query tid % KQ) of every
  // tile and keeps its running best
  const bool owner = tid < kSlots;
  const int own_r = tid / KQ;
  const int own_j = tid % KQ;

  for (int q0 = 0; q0 < Q; q0 += KQ) {
    float best = -INFINITY;
    int best_i = INT_MAX;
    int buf = 0;
    for (int tile = blockIdx.x; tile < ntiles;
         tile += gridDim.x, buf ^= 1) {
      const int row0 = tile * kRows;
      const int own_row = row0 + own_r;
      // the owner's mask byte, requested before the DB stream
      const bool keep = owner && own_row < N && q0 + own_j < Q &&
                        mask[static_cast<size_t>(q0 + own_j) * N + own_row];

      float acc[kRows][KQ];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < KQ; ++j) acc[r][j] = 0.f;

      for (int k0 = tid; k0 < W; k0 += kThreads * JU) {
        T d[JU][kRows];
        T v[JU][KQ];
#pragma unroll
        for (int u = 0; u < JU; ++u) {
          const int k = min(k0 + u * kThreads, W - 1);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            d[u][r] = __ldg(
                db + static_cast<size_t>(min(row0 + r, N - 1)) * W + k);
#pragma unroll
          for (int j = 0; j < KQ; ++j)
            v[u][j] = __ldg(
                query + static_cast<size_t>(min(q0 + j, Q - 1)) * W + k);
        }
#pragma unroll
        for (int u = 0; u < JU; ++u) {
          if (k0 + u * kThreads < W) {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int j = 0; j < KQ; ++j)
                acc[r][j] = dot_acc(d[u][r], v[u][j], acc[r][j]);
          }
        }
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < KQ; ++j) {
          float v = acc[r][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) s_part[buf][warp][r * KQ + j] = v;
        }
      }
      // One barrier a tile: the next tile writes the other buffer, and the
      // tile after it passes the next barrier only once this one is read.
      __syncthreads();
      if (owner && own_row < N) {
        float s = s_part[buf][0][tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += s_part[buf][w][tid];
        if (!keep) s = -INFINITY;
        if (beats(s, own_row, best, best_i)) {
          best = s;
          best_i = own_row;
        }
      }
    }

    if (owner) {
      s_best[tid] = best;
      s_best_i[tid] = best_i;
    }
    __syncthreads();
    if (tid < KQ && q0 + tid < Q) {
      float bs = s_best[tid];
      int bi = s_best_i[tid];
#pragma unroll
      for (int r = 1; r < kRows; ++r) {
        if (beats(s_best[r * KQ + tid], s_best_i[r * KQ + tid], bs, bi)) {
          bs = s_best[r * KQ + tid];
          bi = s_best_i[r * KQ + tid];
        }
      }
      part_sim[static_cast<size_t>(q0 + tid) * gridDim.x + blockIdx.x] = bs;
      part_idx[static_cast<size_t>(q0 + tid) * gridDim.x + blockIdx.x] = bi;
    }
    __syncthreads();
  }

  // Last CTA to finish reduces every CTA's pair per query, one warp a query.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int q = warp; q < Q; q += kWarps) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int p = lane; p < static_cast<int>(gridDim.x); p += 32) {
      const float s = __ldcg(part_sim + static_cast<size_t>(q) * gridDim.x + p);
      const int i = __ldcg(part_idx + static_cast<size_t>(q) * gridDim.x + p);
      if (beats(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, bs, off);
      const int i = __shfl_xor_sync(0xffffffffu, bi, off);
      if (beats(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
    if (lane == 0) {
      out_idx[q] = bi == INT_MAX ? 0 : bi;  // INT_MAX: no row (N >= 1)
      out_sim[q] = bs;
    }
  }
  if (tid == 0) *ticket = 0u;
}

template <typename T, int KQ>
cudaError_t launch(const void* db, const void* query,
                   const unsigned char* mask, int N, int W, int Q, int nb,
                   float* part_sim, int* part_idx, unsigned int* ticket,
                   long long* out_idx, float* out_sim, cudaStream_t s) {
  retrieval_kernel<T, KQ><<<nb, kThreads, 0, s>>>(
      static_cast<const T*>(db), static_cast<const T*>(query), mask, N, W, Q,
      part_sim, part_idx, ticket, out_idx, out_sim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_queries(const void* db, const void* query,
                           const unsigned char* mask, int N, int W, int Q,
                           int nb, float* part_sim, int* part_idx,
                           unsigned int* ticket, long long* out_idx,
                           float* out_sim, cudaStream_t s) {
  switch (Q < kMaxQueries ? Q : kMaxQueries) {
#define RETRIEVAL_CASE(KQ)                                                  \
  case KQ:                                                                  \
    return launch<T, KQ>(db, query, mask, N, W, Q, nb, part_sim, part_idx, \
                         ticket, out_idx, out_sim, s);
    RETRIEVAL_CASE(1)
    RETRIEVAL_CASE(2)
    RETRIEVAL_CASE(3)
    RETRIEVAL_CASE(4)
    RETRIEVAL_CASE(5)
    RETRIEVAL_CASE(6)
    RETRIEVAL_CASE(7)
    RETRIEVAL_CASE(8)
#undef RETRIEVAL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of CTAs for an N-row DB on the current device: the length of each
// query's row of the (sim, index) partials in the caller's scratch.
extern "C" int retrieval_top1_blocks(int N) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    sms = 1;
  const int tiles = (N + kRows - 1) / kRows;
  const int most = sms * kBlocksPerSM;
  return tiles < 1 ? 1 : (tiles > most ? most : tiles);
}

// db (N, D) f32, query (Q, D) f32, mask (Q, N) bool (one byte each), all
// contiguous on the current device. scratch: 8 * Q * nb bytes, 4-byte
// aligned, nb = retrieval_top1_blocks(N) (the CTAs' (sim, index) pairs).
// ticket: one u32 that is 0 before the launch; the kernel leaves it 0, so
// launches that share a ticket must be ordered (one stream). out_idx (Q,)
// i64, out_sim (Q,) f32. One launch on `stream`; returns the CUDA error
// code of the launch (0 on success).
extern "C" int retrieval_top1_launch(const float* db, const float* query,
                                     const unsigned char* mask, int N, int D,
                                     int Q, void* scratch, void* ticket,
                                     long long* out_idx, float* out_sim,
                                     void* stream) {
  if (N < 1 || D < 1 || Q < 1 || Q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = retrieval_top1_blocks(N);
  float* part_sim = static_cast<float*>(scratch);
  int* part_idx = reinterpret_cast<int*>(part_sim + static_cast<size_t>(Q) * nb);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<size_t>(db) % 16 == 0) &&
                       (reinterpret_cast<size_t>(query) % 16 == 0);
  const cudaError_t err =
      (D % 4 == 0 && aligned)
          ? launch_queries<float4>(db, query, mask, N, D / 4, Q, nb, part_sim,
                                   part_idx, tk, out_idx, out_sim, s)
          : launch_queries<float>(db, query, mask, N, D, Q, nb, part_sim,
                                  part_idx, tk, out_idx, out_sim, s);
  return static_cast<int>(err);
}
