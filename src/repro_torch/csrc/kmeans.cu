// Nearest-centroid assignment and the fused k-means step (universal
// clustering of interval signatures into archetypes).
//
// Replaces two TPU kernels of src/repro/kernels/kmeans_assign/kmeans.py:
//   _kmeans_kernel         (kmeans_assign_pallas, ops.py::kmeans_assign):
//       per row, argmin_k and min_k of d2 = x2 - 2 x.c_k + c2_k (int32, fp32;
//       ties go to the lowest k, as jnp.argmin);
//   _kmeans_update_kernel  (kmeans_update_pallas, ops.py::kmeans_update):
//       the same assignment fused with the valid-weighted per-cluster sums
//       (K, d), counts (K,) and inertia (sum of valid min d2), all fp32.
//
// What bounds them on the H100: at the main path's shapes (N = 32,768 store
// rows, d = 128, K = 14) a call reads 16.8 MB of signatures and does
// 0.12 GFLOP, so both are bound by bytes (3.35 TB/s), not by fp32
// operations (67 TFLOP/s). The design reads each row once:
//   * one warp per row: the row's d values sit in registers (d / 32 a lane),
//     and each of the K dot products is a warp butterfly sum; x2 likewise.
//     The (K, d) centroids (7 KB) and their squared norms are in shared
//     memory. The d2 form and the strict "<" keep the reference's ties.
//   * The update must be deterministic (a store that is compacted and built
//     again must cluster bit for bit alike), so it uses no float atomics.
//     Phase 1: each block takes kRowsPerBlock consecutive rows, assigns
//     them, and reduces them into shared memory: thread f owns feature
//     column f of every cluster's sum and adds the block's rows in row
//     order; thread 0 adds counts and inertia in row order. The block writes
//     its partials (K, d), (K,) and (1,) to scratch. Phase 2: a second
//     launch sums the partials in block order, one thread per output value.
//     Rows with valid == 0 (the store's padded tail, tombstones) add nothing.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Loads the centroids and their squared norms into shared memory.
__device__ void load_centroids(const float* __restrict__ c, int K, int d, float* sc,
                               float* sc2) {
  for (int i = threadIdx.x; i < K * d; i += blockDim.x) sc[i] = c[i];
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int kk = warp; kk < K; kk += kWarps) {
    float s = 0.f;
    for (int f = lane; f < d; f += 32) s = fmaf(sc[kk * d + f], sc[kk * d + f], s);
    s = rt::warp_sum(s);
    if (lane == 0) sc2[kk] = s;
  }
  __syncthreads();
}

// One warp: nearest centroid of row xr. VPL = values a lane holds (d <= 32 VPL).
template <int VPL>
__device__ __forceinline__ void nearest(const float* __restrict__ xr, const float* sc,
                                        const float* sc2, int d, int K, int lane, int& best_k,
                                        float& best_d2) {
  float xv[VPL];
  float x2 = 0.f;
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int f = lane + 32 * u;
    xv[u] = f < d ? xr[f] : 0.f;
    x2 = fmaf(xv[u], xv[u], x2);
  }
  x2 = rt::warp_sum(x2);
  best_k = 0;
  best_d2 = FLT_MAX;
  for (int kk = 0; kk < K; ++kk) {
    const float* cr = sc + kk * d;
    float xc = 0.f;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int f = lane + 32 * u;
      if (f < d) xc = fmaf(xv[u], cr[f], xc);
    }
    xc = rt::warp_sum(xc);
    const float d2 = x2 - 2.f * xc + sc2[kk];
    if (d2 < best_d2 || kk == 0) {
      best_d2 = d2;
      best_k = kk;
    }
  }
}

template <int VPL>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c, int N, int d,
                     int K, int* __restrict__ assign, float* __restrict__ dist2) {
  extern __shared__ float smem[];
  float* sc = smem;       // (K, d)
  float* sc2 = sc + K * d;  // (K,)
  load_centroids(c, K, d, sc, sc2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int row = blockIdx.x * kWarps + warp; row < N; row += gridDim.x * kWarps) {
    int best_k;
    float best_d2;
    nearest<VPL>(x + static_cast<size_t>(row) * d, sc, sc2, d, K, lane, best_k, best_d2);
    if (lane == 0) {
      assign[row] = best_k;
      dist2[row] = best_d2;
    }
  }
}

constexpr int kRowsPerBlock = 256;

template <int VPL>
__global__ void __launch_bounds__(kThreads)
kmeans_update_partial_kernel(const float* __restrict__ x, const float* __restrict__ c,
                             const float* __restrict__ valid, int N, int d, int K,
                             float* __restrict__ part_sums, float* __restrict__ part_counts,
                             float* __restrict__ part_inertia) {
  extern __shared__ float smem[];
  float* sc = smem;                   // (K, d) centroids
  float* sc2 = sc + K * d;            // (K,)
  float* ssum = sc2 + K;              // (K, d) this block's sums
  float* scnt = ssum + K * d;         // (K,)
  float* sd2 = scnt + K;              // (kRowsPerBlock,)
  float* sval = sd2 + kRowsPerBlock;  // (kRowsPerBlock,)
  int* sa = reinterpret_cast<int*>(sval + kRowsPerBlock);  // (kRowsPerBlock,)

  for (int i = threadIdx.x; i < K * d; i += blockDim.x) ssum[i] = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) scnt[i] = 0.f;
  load_centroids(c, K, d, sc, sc2);

  const int r0 = blockIdx.x * kRowsPerBlock;
  const int nr = min(kRowsPerBlock, N - r0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int rr = warp; rr < nr; rr += kWarps) {
    int best_k;
    float best_d2;
    nearest<VPL>(x + static_cast<size_t>(r0 + rr) * d, sc, sc2, d, K, lane, best_k, best_d2);
    if (lane == 0) {
      sa[rr] = best_k;
      sd2[rr] = best_d2;
      sval[rr] = valid[r0 + rr];
    }
  }
  __syncthreads();

  // thread f owns column f of every cluster: rows added in row order
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    for (int rr = 0; rr < nr; ++rr) {
      const float vv = sval[rr];
      if (vv != 0.f) ssum[sa[rr] * d + f] += vv * x[static_cast<size_t>(r0 + rr) * d + f];
    }
  }
  if (threadIdx.x == 0) {
    float inertia = 0.f;
    for (int rr = 0; rr < nr; ++rr) {
      const float vv = sval[rr];
      if (vv != 0.f) {
        scnt[sa[rr]] += vv;
        inertia += sd2[rr] * vv;
      }
    }
    part_inertia[blockIdx.x] = inertia;
  }
  __syncthreads();

  float* ps = part_sums + static_cast<size_t>(blockIdx.x) * K * d;
  for (int i = threadIdx.x; i < K * d; i += blockDim.x) ps[i] = ssum[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    part_counts[static_cast<size_t>(blockIdx.x) * K + i] = scnt[i];
}

// One thread per output value: sums the partials in block order.
__global__ void kmeans_update_reduce_kernel(const float* __restrict__ part_sums,
                                            const float* __restrict__ part_counts,
                                            const float* __restrict__ part_inertia,
                                            int nblocks, int K, int d, float* __restrict__ sums,
                                            float* __restrict__ counts,
                                            float* __restrict__ inertia) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int kd = K * d;
  float acc = 0.f;
  if (i < kd) {
    for (int blk = 0; blk < nblocks; ++blk) acc += part_sums[static_cast<size_t>(blk) * kd + i];
    sums[i] = acc;
  } else if (i < kd + K) {
    for (int blk = 0; blk < nblocks; ++blk)
      acc += part_counts[static_cast<size_t>(blk) * K + (i - kd)];
    counts[i - kd] = acc;
  } else if (i == kd + K) {
    for (int blk = 0; blk < nblocks; ++blk) acc += part_inertia[blk];
    inertia[0] = acc;
  }
}

template <int VPL>
cudaError_t assign_launch(const float* x, const float* c, int N, int d, int K, int* a,
                          float* d2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(K) * d + K);
  cudaError_t err = rt::allow_smem(kmeans_assign_kernel<VPL>, smem);
  if (err != cudaSuccess) return err;
  // four rows a warp: fewer blocks, so fewer centroid loads per row
  const int blocks = (N + 4 * kWarps - 1) / (4 * kWarps);
  kmeans_assign_kernel<VPL><<<blocks, kThreads, smem, stream>>>(x, c, N, d, K, a, d2);
  return cudaGetLastError();
}

template <int VPL>
cudaError_t update_launch(const float* x, const float* c, const float* valid, int N, int d,
                          int K, float* part_sums, float* part_counts, float* part_inertia,
                          float* sums, float* counts, float* inertia, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(K) * d + 2 * K) +
                      (2 * sizeof(float) + sizeof(int)) * kRowsPerBlock;
  cudaError_t err = rt::allow_smem(kmeans_update_partial_kernel<VPL>, smem);
  if (err != cudaSuccess) return err;
  const int nblocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  kmeans_update_partial_kernel<VPL><<<nblocks, kThreads, smem, stream>>>(
      x, c, valid, N, d, K, part_sums, part_counts, part_inertia);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outputs = K * d + K + 1;
  kmeans_update_reduce_kernel<<<(outputs + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_sums, part_counts, part_inertia, nblocks, K, d, sums, counts, inertia);
  return cudaGetLastError();
}

}  // namespace

// x: (N, d); c: (K, d) fp32, contiguous; d <= 256. Writes assign (N,) int32
// and dist2 (N,) fp32.
extern "C" int rt_kmeans_assign(const float* x, const float* c, int N, int d, int K, int* assign,
                                float* dist2, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  if (K <= 0 || d <= 0 || d > 256) return cudaErrorInvalidValue;
  if (d <= 32) return assign_launch<1>(x, c, N, d, K, assign, dist2, stream);
  if (d <= 64) return assign_launch<2>(x, c, N, d, K, assign, dist2, stream);
  if (d <= 128) return assign_launch<4>(x, c, N, d, K, assign, dist2, stream);
  return assign_launch<8>(x, c, N, d, K, assign, dist2, stream);
}

// x: (N, d); c: (K, d); valid: (N,) fp32 weights (0 = row ignored).
// Scratch: part_sums (nblocks, K, d), part_counts (nblocks, K),
// part_inertia (nblocks,) with nblocks = ceil(N / rows_per_block), where
// rows_per_block must be kRowsPerBlock (256). Writes sums (K, d),
// counts (K,), inertia (1,). d <= 256, N >= 1.
extern "C" int rt_kmeans_update(const float* x, const float* c, const float* valid, int N, int d,
                                int K, float* part_sums, float* part_counts,
                                float* part_inertia, float* sums, float* counts, float* inertia,
                                int rows_per_block, cudaStream_t stream) {
  if (rows_per_block != kRowsPerBlock) return cudaErrorInvalidValue;
  if (N <= 0 || K <= 0 || d <= 0 || d > 256) return cudaErrorInvalidValue;
  if (d <= 32)
    return update_launch<1>(x, c, valid, N, d, K, part_sums, part_counts, part_inertia, sums,
                            counts, inertia, stream);
  if (d <= 64)
    return update_launch<2>(x, c, valid, N, d, K, part_sums, part_counts, part_inertia, sums,
                            counts, inertia, stream);
  if (d <= 128)
    return update_launch<4>(x, c, valid, N, d, K, part_sums, part_counts, part_inertia, sums,
                            counts, inertia, stream);
  return update_launch<8>(x, c, valid, N, d, K, part_sums, part_counts, part_inertia, sums,
                          counts, inertia, stream);
}
