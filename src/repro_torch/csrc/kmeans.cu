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
// What bounds them on the H100: at the build's shape (N = 32,768 store rows
// of which 18,000 are live, d = 128, K = 14) the update must read 9.2 MB of
// live rows (2.8 us at 3.35 TB/s) and do 64 MFLOP of distances (about 1 us of
// fp32 FMA), so bytes and latency bound it, not arithmetic. Tensor cores are
// not the lever: the product is thin (K = 14 columns), TF32 would flip
// near-tie labels and widen the sums' error, and 3xTF32 would cost more than
// the FMAs it replaces. Plain fp32 FMAs, no TF32.
//
// Design (both kernels; kmeans_plan in kernels/kmeans_assign/ops.py mirrors
// the launch: rows a block, blocks, K tile, shared bytes, join warps):
//   * A block of 128 threads takes kRows = 64 consecutive rows, so the live
//     rows alone give the 132 SMs two blocks each at the build's shape. It
//     reads its slice of `valid` first; a block with no live row exits. Only
//     live rows are copied into a shared tile, by coalesced cp.async (16-byte
//     when d % 4 == 0 and x and the centroids are 16-byte aligned), then the
//     first K tile of centroids (through L1, which the blocks of an SM share:
//     every block reads the same centroids). The tile's row stride is an odd
//     number of float4s, so eight rows read at one column hit eight bank
//     groups.
//   * Distances without shuffles: four lanes own two rows (g and g + 32) and
//     split a K tile of KT <= 16 centroids in quarters; a lane holds the dot
//     products of its two rows with its KT / 4 centroids in registers and
//     walks the rows' float4s, each centroid float4 read once for both rows
//     (the four quarters sit at shared offsets in four different bank groups,
//     so a warp's centroid read is four broadcasts in one pass). x2 and c2 are
//     sums of four float4-lane partials; c2 is computed once a tile by KT
//     threads, with no barrier per row. d2 = (x2 - 2 xc) + c2, best k by
//     strict "<" in increasing k; the four quarters' bests are joined by two
//     exchanges (the lower d2, on a tie the lower k).
//   * Segment sums in registers: warp w owns the clusters k0 + w, k0 + w + 4,
//     ... of a tile; a ballot over the rows' labels lists its rows, which it
//     adds in row order, its lanes owning consecutive float4 columns.
//     Counts and inertia are butterfly warp sums over the block's rows (lane
//     = row mod 32, warps 0 and 1) joined warp 0 then warp 1. A block writes
//     its K * d + K + 1 partials once, coalesced, in block-major order, and a
//     flag that it is live.
//   * The cross-block join is a second small kernel: a block of 32 warps takes
//     32 outputs (lane = output); warp w adds the live blocks w, w + 32, ... in
//     block order, then the 32 warp sums are added in order. Both the partial
//     writes and the join's reads are coalesced; each partial is written once
//     and read once.
//   * No float atomics (nothing here but the fixed orders above), so a call
//     is bitwise repeatable. The sums, counts and inertia depend only on the
//     live rows and their row indices: dead rows are never read, a dead block
//     is skipped by its flag, a dead row inside a live block adds an exact 0
//     to a fixed tree or nothing to a sum, and more capacity only appends dead
//     blocks at the end of each warp's chain. A store that is compacted, grown
//     or refilled therefore clusters bit for bit alike.
#include "common.cuh"

namespace km {

constexpr int kRows = 64;               // rows a block
constexpr int kThreads = 128;           // four lanes a pair of rows
constexpr int kWarps = kThreads / 32;
constexpr int kJoinWarps = 32;          // join kernel: 32 warps x 32 outputs
constexpr int kJoinOutputs = 32;
constexpr int kFlagChunk = 1024;        // live flags staged a chunk at a time

// Row stride of the shared row tile, in float4: ceil(d / 4) made odd.
__host__ __device__ inline int stride4(int d) { return ((d + 3) / 4) | 1; }

// Stride between the four quarters of a centroid tile, in float4: its kt / 4
// rows rounded up to 1 mod 8, so that the quarters start in bank groups 0-3.
__host__ __device__ inline int quarter4(int d, int kt) {
  const int q = kt / 4 * stride4(d);
  return q + ((9 - q % 8) % 8);
}

// Shared bytes of a launch with K tile kt: the row tile, the centroid tile,
// kt squared norms, the rows' weights, weighted d2 and labels, two warps' kt
// counts and inertia, and each warp's list of rows.
__host__ __device__ inline size_t smem_bytes(int d, int kt) {
  return sizeof(float) * (static_cast<size_t>(4 * stride4(d)) * kRows +
                          16 * static_cast<size_t>(quarter4(d, kt)) + kt + 3 * kRows +
                          2 * (kt + 1) + kWarps * kRows);
}

// The K tile a launch takes: the fewest of 4, 8, 16 centroids that hold K,
// else 16 and a loop over tiles.
inline int k_tile(int K) { return K <= 4 ? 4 : K <= 8 ? 8 : 16; }

struct Smem {
  float* tile;   // (kRows, 4 * stride4) rows
  float* sc;     // 4 quarters of quarter4 float4s: the K tile's centroids
  float* sc2;    // (kt,)
  float* sw;     // (kRows,) row weights, 0 = dead or past N
  float* sd;     // (kRows,) weighted min d2
  int* sl;       // (kRows,) labels
  float* red;    // (2, kt + 1) counts, inertia of warps 0 and 1
  int* list;     // (kWarps, kRows) each warp's rows of a tile, in order
};

__device__ __forceinline__ Smem carve(float* smem, int d, int kt) {
  Smem s;
  s.tile = smem;
  s.sc = s.tile + 4 * stride4(d) * kRows;
  s.sc2 = s.sc + 16 * quarter4(d, kt);
  s.sw = s.sc2 + kt;
  s.sd = s.sw + kRows;
  s.sl = reinterpret_cast<int*>(s.sd + kRows);
  s.red = reinterpret_cast<float*>(s.sl + kRows);
  s.list = reinterpret_cast<int*>(s.red + 2 * (kt + 1));
  return s;
}

// Shared float offset of centroid kk of a K tile: quarter kk / (kt / 4).
__device__ __forceinline__ int c_off(int kk, int kt, int d) {
  const int kq = kt / 4;
  return 4 * ((kk / kq) * quarter4(d, kt) + (kk % kq) * stride4(d));
}

// cp.async of 16 bytes through L1 (.ca): the blocks of an SM share the
// centroids' lines there instead of each asking L2 for them.
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Copies src (n floats) into dst (n rounded up to float4s) by the lanes of a
// warp, zero-filling the tail; zero-fills it all when !real. l1: through L1.
__device__ __forceinline__ void copy_row(float* dst, const float* __restrict__ src, int n,
                                         bool real, bool vec, bool l1, int lane) {
  const int n4 = (n + 3) / 4;
  if (vec) {
    for (int j = lane; j < n4; j += 32) {
      if (real && l1)
        cp_async16_l1(dst + 4 * j, src + 4 * j);
      else if (real)
        rt::cp_async16(dst + 4 * j, src + 4 * j);
      else
        *reinterpret_cast<float4*>(dst + 4 * j) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int f = lane; f < 4 * n4; f += 32) {
      if (real && f < n)
        rt::cp_async4(dst + f, src + f);
      else
        dst[f] = 0.f;
    }
  }
}

// Starts copying the block's live rows (sw != 0) into the tile, warp w taking
// rows w, w + 4, ...; dead rows are zero-filled. One cp.async group.
__device__ __forceinline__ void load_rows(const float* __restrict__ x, int d, int row0,
                                          bool vec, const Smem& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps)
    copy_row(s.tile + r * 4 * stride4(d), x + static_cast<size_t>(row0 + r) * d, d,
             s.sw[r] != 0.f, vec, false, lane);
  rt::cp_async_commit();
}

// Starts copying centroids k0 .. k0 + kt - 1 (zero rows past K) into the
// centroid tile, warp w taking centroids w, w + 4, ..., through L1: every
// block reads them. One cp.async group.
__device__ __forceinline__ void issue_centroids(const float* __restrict__ c, int K, int d,
                                                int k0, int kt, bool vec, const Smem& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kk = warp; kk < kt; kk += kWarps)
    copy_row(s.sc + c_off(kk, kt, d), c + static_cast<size_t>(k0 + kk) * d, d, k0 + kk < K,
             vec, true, lane);
  rt::cp_async_commit();
}

// Squared norm of a padded row: four float4-lane partials over the row's
// float4s in order, then (x + y) + (z + w).
__device__ __forceinline__ float sq_norm(const float4* r, int d4) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < d4; ++j) {
    const float4 v = r[j];
    a.x = fmaf(v.x, v.x, a.x);
    a.y = fmaf(v.y, v.y, a.y);
    a.z = fmaf(v.z, v.z, a.z);
    a.w = fmaf(v.w, v.w, a.w);
  }
  return (a.x + a.y) + (a.z + a.w);
}

// The centroid tile has landed in this thread's copies: a barrier, the
// tile's squared norms by kt threads, a barrier.
__device__ __forceinline__ void finish_centroids(int d, int kt, const Smem& s) {
  __syncthreads();
  if (threadIdx.x < kt)
    s.sc2[threadIdx.x] =
        sq_norm(reinterpret_cast<const float4*>(s.sc + c_off(threadIdx.x, kt, d)), (d + 3) / 4);
  __syncthreads();
}

// acc += a . b over the four lanes in order.
__device__ __forceinline__ void dot4(float& acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// Rows x0 and x1 against quarter q of a K tile: KT / 4 dot products a row in
// registers, each over the row's columns in order, and the rows' squared
// norms; updates each row's best (d2, k) by strict "<" in increasing k
// (bk < 0: none yet).
template <int KT>
__device__ __forceinline__ void nearest_quarter(const float4* x0, const float4* x1,
                                                const Smem& s, int d, int k0, int K, int q,
                                                int (&bk)[2], float (&bd)[2]) {
  constexpr int KQ = KT / 4;
  const int d4 = (d + 3) / 4;
  const int s4 = stride4(d);
  const float4* sc = reinterpret_cast<const float4*>(s.sc + c_off(q * KQ, KT, d));
  float a0[KQ], a1[KQ];
#pragma unroll
  for (int k = 0; k < KQ; ++k) a0[k] = a1[k] = 0.f;
  float4 p0 = make_float4(0.f, 0.f, 0.f, 0.f), p1 = p0;
#pragma unroll 4
  for (int j = 0; j < d4; ++j) {
    const float4 u = x0[j], v = x1[j];
    p0.x = fmaf(u.x, u.x, p0.x);
    p0.y = fmaf(u.y, u.y, p0.y);
    p0.z = fmaf(u.z, u.z, p0.z);
    p0.w = fmaf(u.w, u.w, p0.w);
    p1.x = fmaf(v.x, v.x, p1.x);
    p1.y = fmaf(v.y, v.y, p1.y);
    p1.z = fmaf(v.z, v.z, p1.z);
    p1.w = fmaf(v.w, v.w, p1.w);
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
      const float4 cv = sc[k * s4 + j];   // one address a quarter
      dot4(a0[k], u, cv);
      dot4(a1[k], v, cv);
    }
  }
  const float x2[2] = {(p0.x + p0.y) + (p0.z + p0.w), (p1.x + p1.y) + (p1.z + p1.w)};
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    const int kk = k0 + q * KQ + k;
    if (kk < K) {
      const float c2 = s.sc2[q * KQ + k];
      const float d0 = __fadd_rn(fmaf(-2.f, a0[k], x2[0]), c2);
      const float d1 = __fadd_rn(fmaf(-2.f, a1[k], x2[1]), c2);
      if (d0 < bd[0] || bk[0] < 0) {
        bd[0] = d0;
        bk[0] = kk;
      }
      if (d1 < bd[1] || bk[1] < 0) {
        bd[1] = d1;
        bk[1] = kk;
      }
    }
  }
}

// Joins a lane's best with that of lane ^ m: the lower d2, on a tie the
// lower k; a lane without one (bk < 0) loses.
__device__ __forceinline__ void join_best(int& bk, float& bd, int m) {
  const int pk = __shfl_xor_sync(0xffffffffu, bk, m);
  const float pd = __shfl_xor_sync(0xffffffffu, bd, m);
  if (pk >= 0 && (bk < 0 || pd < bd || (pd == bd && pk < bk))) {
    bk = pk;
    bd = pd;
  }
}

// Nearest centroid of rows g and g + 32 (g = thread / 4) for every lane of
// the quad. On entry the rows and the first K tile are in flight. Dead rows
// end with (0, 0).
template <int KT>
__device__ __forceinline__ void assign_rows(const float* __restrict__ c, int K, int d, bool vec,
                                            const Smem& s, int (&bk)[2], float (&bd)[2]) {
  const int g = threadIdx.x / 4, q = threadIdx.x % 4;
  const bool live0 = s.sw[g] != 0.f, live1 = s.sw[g + 32] != 0.f;
  const float4* tile = reinterpret_cast<const float4*>(s.tile);
  const float4* x0 = tile + g * stride4(d);
  const float4* x1 = tile + (g + 32) * stride4(d);
  bk[0] = bk[1] = -1;
  bd[0] = bd[1] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KT) {
    if (k0 > 0) {
      __syncthreads();                    // the previous tile is read
      issue_centroids(c, K, d, k0, KT, vec, s);
    }
    rt::cp_async_wait<0>();
    finish_centroids(d, KT, s);
    if (live0 || live1) nearest_quarter<KT>(x0, x1, s, d, k0, K, q, bk, bd);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    join_best(bk[i], bd[i], 1);
    join_best(bk[i], bd[i], 2);
  }
  if (!live0) bk[0] = 0, bd[0] = 0.f;
  if (!live1) bk[1] = 0, bd[1] = 0.f;
}

template <int KT>
__global__ void __launch_bounds__(kThreads)
assign_rows_kernel(const float* __restrict__ x, const float* __restrict__ c, int N, int d,
                   int K, int vec, int* __restrict__ assign, float* __restrict__ dist2) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, d, KT);
  const int row0 = blockIdx.x * kRows;
  if (threadIdx.x < kRows) s.sw[threadIdx.x] = row0 + threadIdx.x < N ? 1.f : 0.f;
  __syncthreads();
  load_rows(x, d, row0, vec != 0, s);
  issue_centroids(c, K, d, 0, KT, vec != 0, s);
  int bk[2];
  float bd[2];
  assign_rows<KT>(c, K, d, vec != 0, s, bk, bd);
  if (threadIdx.x % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + threadIdx.x / 4 + 32 * i;
      if (row < N) {
        assign[row] = bk[i];
        dist2[row] = bd[i];
      }
    }
  }
}

// Phase 1 of the update: one block's partials (K * d sums, K counts, the
// inertia) at part + blockIdx.x * (K * d + K + 1), and live[blockIdx.x].
// valid == nullptr weighs every row 1. CPL: float4 columns a lane owns in
// the sums (d <= 128: 1, else 2).
template <int KT, int CPL>
__global__ void __launch_bounds__(kThreads)
update_rows_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ valid, int N, int d, int K, int vec,
                   float* __restrict__ part, int* __restrict__ live) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, d, KT);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int row0 = blockIdx.x * kRows;
  float w = 0.f;
  if (t < kRows) {
    const int row = row0 + t;
    w = row < N ? (valid != nullptr ? valid[row] : 1.f) : 0.f;
    s.sw[t] = w;
  }
  if (!__syncthreads_or(w != 0.f)) {      // no live row: a zero partial
    if (t == 0) live[blockIdx.x] = 0;
    return;
  }
  load_rows(x, d, row0, vec != 0, s);
  issue_centroids(c, K, d, 0, KT, vec != 0, s);
  int bk[2];
  float bd[2];
  assign_rows<KT>(c, K, d, vec != 0, s, bk, bd);
  if (t % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = t / 4 + 32 * i;
      s.sl[r] = bk[i];
      s.sd[r] = s.sw[r] * bd[i];          // 0 for a dead row
    }
  }
  __syncthreads();

  constexpr int KW = KT / 4;              // clusters a warp owns in a tile
  const int O = K * d + K + 1;
  const int d4 = (d + 3) / 4;
  const int s4 = stride4(d);
  const float4* tile = reinterpret_cast<const float4*>(s.tile);
  float* pb = part + static_cast<size_t>(blockIdx.x) * O;
  for (int k0 = 0; k0 < K; k0 += KT) {
    // sums: warp w lists its rows (label k0 + w + 4 i) in row order, then
    // adds them, its lanes owning consecutive float4 columns
    int n_own = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane + 32 * half;
      const int slot = s.sl[r] - k0;
      const bool own = s.sw[r] != 0.f && slot >= 0 && slot < KT && slot % kWarps == warp;
      const unsigned m = __ballot_sync(0xffffffffu, own);
      if (own) s.list[warp * kRows + n_own + __popc(m & ((1u << lane) - 1u))] =
          r | (slot / kWarps) << 8;
      n_own += __popc(m);
    }
    __syncwarp();
    float4 acc[KW][CPL];
#pragma unroll
    for (int i = 0; i < KW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int n = 0; n < n_own; ++n) {
      const int e = s.list[warp * kRows + n];
      const int r = e & 255, own = e >> 8;
      const float wr = s.sw[r];
      const float4* xr = tile + r * s4;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int jj = lane + 32 * j;
        const float4 xv = jj < d4 ? xr[jj] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < KW; ++i) {
          if (i == own) {
            acc[i][j].x = fmaf(wr, xv.x, acc[i][j].x);
            acc[i][j].y = fmaf(wr, xv.y, acc[i][j].y);
            acc[i][j].z = fmaf(wr, xv.z, acc[i][j].z);
            acc[i][j].w = fmaf(wr, xv.w, acc[i][j].w);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = k0 + warp + kWarps * i;
      if (k < K) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int f = 4 * (lane + 32 * j);
          float* dst = pb + static_cast<size_t>(k) * d + f;
          if (f < d) dst[0] = acc[i][j].x;
          if (f + 1 < d) dst[1] = acc[i][j].y;
          if (f + 2 < d) dst[2] = acc[i][j].z;
          if (f + 3 < d) dst[3] = acc[i][j].w;
        }
      }
    }
    // counts (and, with the first tile, the inertia): warp sums over the
    // block's rows, lane = row mod 32, in warps 0 and 1
    if (warp < 2) {
      const int lab = s.sl[t];
      const float wt = s.sw[t];
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const float cnt = rt::warp_sum(lab == k0 + k ? wt : 0.f);
        if (lane == 0) s.red[warp * (KT + 1) + k] = cnt;
      }
      if (k0 == 0) {
        const float in = rt::warp_sum(s.sd[t]);
        if (lane == 0) s.red[warp * (KT + 1) + KT] = in;
      }
    }
    __syncthreads();
    if (t <= KT && (t == KT ? k0 == 0 : k0 + t < K))
      pb[t == KT ? K * d + K : K * d + k0 + t] = s.red[t] + s.red[KT + 1 + t];
    __syncthreads();                      // red is rewritten by the next tile
  }
  if (t == 0) live[blockIdx.x] = 1;
}

// Phase 2: out[o] = the live blocks' partials o, added in a fixed order:
// warp w takes blocks w, w + 32, ... in order, then the warps in order.
__global__ void __launch_bounds__(kJoinWarps * 32)
update_join_kernel(const float* __restrict__ part, const int* __restrict__ live, int nblocks,
                   int O, float* __restrict__ out) {
  __shared__ float red[kJoinWarps][kJoinOutputs];
  __shared__ int flags[kFlagChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o = blockIdx.x * kJoinOutputs + lane;
  const int oc = o < O ? o : O - 1;
  float acc = 0.f;
  for (int b0 = 0; b0 < nblocks; b0 += kFlagChunk) {
    const int nb = min(kFlagChunk, nblocks - b0);
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += kJoinWarps * 32) flags[i] = live[b0 + i];
    __syncthreads();
#pragma unroll 16
    for (int i = warp; i < nb; i += kJoinWarps)
      acc += flags[i] ? part[static_cast<size_t>(b0 + i) * O + oc] : 0.f;
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && o < O) {
    float v = red[0][lane];
#pragma unroll
    for (int ww = 1; ww < kJoinWarps; ++ww) v += red[ww][lane];
    out[o] = v;
  }
}

inline int blocks_of(int N) { return (N + kRows - 1) / kRows; }

template <int KT>
cudaError_t assign_launch(const float* x, const float* c, int N, int d, int K, int vec,
                          int* a, float* d2, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, KT);
  cudaError_t err = rt::allow_smem(assign_rows_kernel<KT>, smem);
  if (err != cudaSuccess) return err;
  assign_rows_kernel<KT><<<blocks_of(N), kThreads, smem, stream>>>(x, c, N, d, K, vec, a, d2);
  return cudaGetLastError();
}

template <int KT, int CPL>
cudaError_t update_launch(const float* x, const float* c, const float* valid, int N, int d,
                          int K, int vec, float* part, int* live, float* out,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(d, KT);
  cudaError_t err = rt::allow_smem(update_rows_kernel<KT, CPL>, smem);
  if (err != cudaSuccess) return err;
  const int nblocks = blocks_of(N);
  update_rows_kernel<KT, CPL>
      <<<nblocks, kThreads, smem, stream>>>(x, c, valid, N, d, K, vec, part, live);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int O = K * d + K + 1;
  update_join_kernel<<<(O + kJoinOutputs - 1) / kJoinOutputs, kJoinWarps * 32, 0, stream>>>(
      part, live, nblocks, O, out);
  return cudaGetLastError();
}

template <int CPL>
cudaError_t update_by_k(const float* x, const float* c, const float* valid, int N, int d,
                        int K, int vec, float* part, int* live, float* out,
                        cudaStream_t stream) {
  switch (k_tile(K)) {
    case 4:
      return update_launch<4, CPL>(x, c, valid, N, d, K, vec, part, live, out, stream);
    case 8:
      return update_launch<8, CPL>(x, c, valid, N, d, K, vec, part, live, out, stream);
    default:
      return update_launch<16, CPL>(x, c, valid, N, d, K, vec, part, live, out, stream);
  }
}

// cudaFuncGetAttributes of a kernel into out[4]: registers, static and
// dynamic shared bytes, local (spill) bytes.
template <typename Kernel>
cudaError_t attributes(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

}  // namespace km

// x: (N, d); c: (K, d) fp32, contiguous; 1 <= d <= 256, K >= 1. Writes assign
// (N,) int32 and dist2 (N,) fp32. vec != 0: d % 4 == 0 and x and c 16-byte
// aligned.
extern "C" int rt_kmeans_assign(const float* x, const float* c, int N, int d, int K, int vec,
                                int* assign, float* dist2, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  if (N < 0 || K <= 0 || d <= 0 || d > 256) return cudaErrorInvalidValue;
  switch (km::k_tile(K)) {
    case 4: return km::assign_launch<4>(x, c, N, d, K, vec, assign, dist2, stream);
    case 8: return km::assign_launch<8>(x, c, N, d, K, vec, assign, dist2, stream);
    default: return km::assign_launch<16>(x, c, N, d, K, vec, assign, dist2, stream);
  }
}

// x: (N, d); c: (K, d); valid: (N,) fp32 weights (0 = row ignored) or null
// (every row weighs 1). Scratch: part (ceil(N / 64), K * d + K + 1) fp32 and
// live (ceil(N / 64),) int32, neither zeroed. Writes out = [sums (K, d),
// counts (K,), inertia (1,)]. 1 <= d <= 256, K >= 1, N >= 1; vec as above.
extern "C" int rt_kmeans_update(const float* x, const float* c, const float* valid, int N,
                                int d, int K, int vec, float* part, int* live, float* out,
                                cudaStream_t stream) {
  if (N <= 0 || K <= 0 || d <= 0 || d > 256) return cudaErrorInvalidValue;
  if (d <= 128) return km::update_by_k<1>(x, c, valid, N, d, K, vec, part, live, out, stream);
  return km::update_by_k<2>(x, c, valid, N, d, K, vec, part, live, out, stream);
}

// The attributes of the kernel a launch with (d, K) takes, and the dynamic
// shared bytes it asks for: out[4] as km::attributes.
extern "C" int rt_kmeans_assign_attributes(int d, int K, int* out) {
  if (K <= 0 || d <= 0 || d > 256) return cudaErrorInvalidValue;
  const int kt = km::k_tile(K);
  const size_t smem = km::smem_bytes(d, kt);
  if (kt == 4) return km::attributes(km::assign_rows_kernel<4>, smem, out);
  if (kt == 8) return km::attributes(km::assign_rows_kernel<8>, smem, out);
  return km::attributes(km::assign_rows_kernel<16>, smem, out);
}

extern "C" int rt_kmeans_update_attributes(int d, int K, int* out) {
  if (K <= 0 || d <= 0 || d > 256) return cudaErrorInvalidValue;
  const int kt = km::k_tile(K);
  const size_t smem = km::smem_bytes(d, kt);
  const bool wide = d > 128;
  if (kt == 4)
    return wide ? km::attributes(km::update_rows_kernel<4, 2>, smem, out)
                : km::attributes(km::update_rows_kernel<4, 1>, smem, out);
  if (kt == 8)
    return wide ? km::attributes(km::update_rows_kernel<8, 2>, smem, out)
                : km::attributes(km::update_rows_kernel<8, 1>, smem, out);
  return wide ? km::attributes(km::update_rows_kernel<16, 2>, smem, out)
              : km::attributes(km::update_rows_kernel<16, 1>, smem, out);
}
