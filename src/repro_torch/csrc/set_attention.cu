// Fused masked, frequency-weighted set attention (Stage-2 SAB/PMA), forward
// and backward.
//
// The forward replaces the TPU kernel src/repro/kernels/set_attention/
// set_attn.py::_set_attn_kernel (reached through _fwd_call /
// set_attention_pallas and ops.py::masked_set_attention). Per (batch row b,
// head h):
//     o = softmax(q k^T / sqrt(dh) + key_bias[b] + (mask[b] ? 0 : NEG_INF)) v
// with NEG_INF = -2^30 added on top of the bias exactly as the plain version
// (and src/repro/kernels/set_attention/ref.py) does, so a fully masked row
// collapses to a uniform softmax over its M keys and never gives NaN.
//
// What bounds the forward on the H100: at the main path's SAB shapes
// (B = 512, H = 4, N = M = 64, dh = 64) the kernel must move 0.13 GB (q, k, v
// read once, o written once) and do 2.1 GFLOP of fp32 work; at 3.35 TB/s
// and 67 TFLOP/s the bytes weigh slightly more, and for the PMA (N = 1) they
// are all of it. So the design reads each input once, keeps every
// intermediate on chip, as the TPU kernel kept it in VMEM, and feeds the
// FMA units from registers:
//   * N > 4 (the SABs): one block of 256 threads (16 x 16) per (b, h). Per
//     tile of 64 queries x 64 keys each thread computes a 4 x 4 block of
//     scores (rows 4 ty .., keys 4 tx ..) from registers, reading 4 q and 4
//     k values as float4 from transposed (d-major) shared copies: 16 FMAs
//     per two loads. The softmax stays in registers, reduced over the 16
//     lanes that share a row with shuffles; P is written to shared memory
//     once, over the space of k^T, for O = P V, which is tiled the same way
//     (4 rows x 4 columns a thread, float4 loads of P and V). 51 KB of
//     shared memory a block at 64 x 64 x 64, so 4 blocks sit on an SM;
//   * N <= 4 (the PMA's one seed query): a register tile would leave 255 of
//     256 threads idle, so each warp takes one (b, h) and a block up to 8:
//     each lane computes the scores of keys lane, lane + 32, ... (float4
//     loads of its k rows), the warp reduces the softmax with shuffles, and
//     each lane sums P v over its head-dim columns, reading v coalesced;
//   * each score is the FMA chain over d ascending, then * scale, + bias,
//     + mask (masked_score, shared with the backward), so a masked key of a
//     row with any valid key gets P exactly 0, which the backward relies on;
//   * M past one 64-key tile: a running max over key tiles (flash style),
//     with the output divided by the row sum at the end;
//   * float4 global loads and stores where dh % 4 == 0 and the rows are
//     16-byte aligned (the wrapper decides), scalar otherwise; any N >= 1,
//     M >= 1 and dh <= 256 (44 in the smallest configuration). Keys and
//     rows that pad a tile are zero-filled and get p = 0, so the output does
//     not depend on padding.
// Plain fp32 FMAs, no TF32 tensor cores, whose 10-bit mantissa would break
// the 1e-5 tolerance.
//
// The backward replaces set_attn.py::_set_attn_bwd_kernel (reached through
// _bwd_call and the custom VJP _set_attention_bwd). It recomputes P from
// (q, k, bias, mask) instead of reading saved probabilities (flash-style),
// then, per (b, h):
//     dV = P^T dO      dP = dO V^T      delta = rowsum(dP * P)
//     dS = P * (dP - delta)             dQ = scale dS K      dK = scale dS^T Q
//     db[b, h, :] = sum_n dS            (summed over heads by the wrapper)
// What bounds it: at Stage-2 training's shape (B = 64 sets, H = 4,
// N = M = dh = 64) it moves 29 MB (q, k, v, dO in; dq, dk, dv out) and does
// five (N, M, dh) products, 0.67 GFLOP: the fp32 operations weigh slightly
// more than the bytes, so the design feeds the FMA units from registers,
// as the forward does:
//   * N > 4 (the SABs), bwd::tiled_kernel: one block of 256 threads
//     (16 x 16) per (b, h), tiles of 64 queries x 64 keys x 64 head-dim
//     columns. q, dO, k and v are kept row-major (row stride 68 floats, so
//     the same float4 of eight adjacent rows lies on eight distinct bank
//     quads), so each of the five products
//     is a 4 x 4 register tile fed by 16-byte loads, 16 FMAs per two loads:
//     the scores and dP a thread holds are rows 4 ty + i and keys tx + 16 j
//     (8 adjacent key rows a quarter warp: no bank conflict); the row
//     softmax and delta are reduced over the 16 lanes of a half warp with
//     shuffles; P and dS go to shared memory once, row-major, and dQ (rows
//     4 ty + i, columns 4 tx + e), dK and dV (keys 4 ty + i, columns 4 tx + e)
//     are accumulated in registers from float4 reads of them. 104 KB of
//     shared memory at any dh (head-dim chunks of 64 are loaded in turn),
//     so two blocks sit on an SM and B H = 256 blocks make one wave;
//   * M > 64: the row max and sum, then delta, are taken over the key
//     tiles first (the scores recomputed each time); N > 64 or M > 64: dQ,
//     dK, dV and db are summed over tiles in place in global memory, each
//     element always by the same thread of the one block of its (b, h);
//   * N <= 4 (the PMA), bwd::small_n_kernel: at N = 1, dK and dV are outer
//     products and the kernel is bound by bytes, so it is built to keep
//     many loads in flight: one block of 128 threads per (b, h) stages 64
//     rows each of k and v by 16-byte cp.async, all in flight at once;
//     threads 0-63 compute the scores and 64-127 dP, a key a thread (float4
//     reads of its own row, stride dh + 4: no bank conflict); warp n reduces
//     row n's softmax and delta with shuffles; dK, dV (float4 columns) and
//     db are written coalesced, and dQ is summed over the keys in order.
//     Taken while 64 rows of k and v, q, dO, P and dS fit in 227 KB, else
//     the tiled kernel takes the shape;
//   * the scores are recomputed with the forward's exact arithmetic and
//     order (the FMA chain over d ascending, then masked_score: * scale,
//     + bias, + the additive mask), so they are bitwise the forward's, and
//     so are the row max and each exp(s - max) when M <= 64. P = exp / sum
//     may still differ from the forward's by a rounding of the row sum: the
//     forward divides the output, not P, by the sum, and for M > 64 its
//     running max also rescales the partial sums. A masked key of a row
//     with any valid key has exp exactly 0 in both, so P is exactly 0 and
//     its dK, dV and db come out exactly 0. A fully masked row keeps its
//     uniform P and its (non-zero) gradients, as in the plain version;
//   * each block writes only its own dq/dk/dv tiles and its per-head db row:
//     no atomics, so two runs give the same bits (the training resume relies
//     on it);
//   * plain fp32 FMAs, fp32 accumulation, no TF32; any N, M >= 1 and
//     dh <= 256, as the forward.
//
// bf16 (Stage 2 on bf16 BBEs, as the JAX kernel takes them): every kernel is
// also instanced on the element type T of q, k, v, o (and dO, dq, dk, dv).
// A bf16 instance widens each element exactly as it loads it (into the
// same fp32 shared tiles and registers; the vector route reads 4 elements,
// 8 bytes, where the fp32 one reads a float4), runs the fp32 instance's
// arithmetic in its order, keeps the bias, P and dS in fp32 (the numerics
// policy of the JAX kernel's docstring) and rounds each output once. Where the tiled
// backward sums an output over tiles in place (N or M > 64), the bf16
// instance keeps the partial sums in an fp32 scratch the wrapper gives it
// and rounds the last sum. So a bf16 instance on x equals the fp32 instance
// on x.float(), its outputs rounded, bit for bit. The backward's staging
// is synchronous in bf16 (plain loads, widened, then stored), where fp32
// copies by cp.async.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30

// One score: the dot product (an FMA chain over d ascending), * scale,
// + key bias, + the additive mask, each rounded on its own (no contraction),
// as the forward and the backward both compute it.
__device__ __forceinline__ float masked_score(float dot, float scale, const float* bp,
                                              const uint8_t* mp, int m) {
  float s = __fmul_rn(dot, scale);
  if (bp) s = __fadd_rn(s, bp[m]);
  if (mp) s = __fadd_rn(s, mp[m] ? 0.f : kNegInf);
  return s;
}

namespace fwd {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // queries and keys a tile
constexpr int kLd = kTile + 4;  // row of q^T, k^T and P: float4-aligned, two rows 4 apart on other banks
constexpr int kSmallN = 4;      // N up to this: one warp per (b, h)
constexpr int kWarps = kThreads / 32;

// dst[d * kLd + r] = src[r * dh + d] for r < rows, 0 for rows <= r < kTile
// (scalar loads: rows that are not aligned to 4 elements).
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* __restrict__ src, int rows,
                                                int dh) {
  for (int i = threadIdx.x; i < kTile * dh; i += kThreads) {
    const int r = i / dh;
    const int d = i - r * dh;
    dst[d * kLd + r] = r < rows ? rt::to_f32(src[r * dh + d]) : 0.f;
  }
}

// dst[r * ldv + d] = src[r * dh + d] for r < rows, 0 for rows <= r < kTile
// (scalar loads).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int rows, int dh,
                                          int ldv) {
  for (int i = threadIdx.x; i < kTile * dh; i += kThreads) {
    const int r = i / dh;
    const int d = i - r * dh;
    dst[r * ldv + d] = r < rows ? rt::to_f32(src[r * dh + d]) : 0.f;
  }
}

// The same loads 4 elements at a time (dh % 4 == 0, rows aligned to 4
// elements: float4s, or 8 bytes of bf16) for a key tile (and, when sQt is
// given, the query tile): q, k and v of two chunks a thread are all in
// flight before the first store (four spill at 3 blocks an SM).
template <typename T>
__device__ __forceinline__ void load_tiles_vec(float* sQt, const T* __restrict__ qs, int q_rows,
                                               float* sKt, const T* __restrict__ ks, float* sV,
                                               const T* __restrict__ vs, int kv_rows, int dh,
                                               int ldv) {
  const int d4n = dh / 4;
  const int total = kTile * d4n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = threadIdx.x; base < total; base += 2 * kThreads) {
    float4 xq[2], xk[2], xv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = base + u * kThreads;
      const int r = i / d4n;
      const int off = r * dh + 4 * (i - r * d4n);
      const bool in = i < total;
      xq[u] = sQt && in && r < q_rows ? rt::ldg4(qs + off) : zero;
      xk[u] = in && r < kv_rows ? rt::ldg4(ks + off) : zero;
      xv[u] = in && r < kv_rows ? rt::ldg4(vs + off) : zero;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = base + u * kThreads;
      if (i >= total) break;
      const int r = i / d4n;
      const int d = 4 * (i - r * d4n);
      if (sQt) {
        sQt[d * kLd + r] = xq[u].x;
        sQt[(d + 1) * kLd + r] = xq[u].y;
        sQt[(d + 2) * kLd + r] = xq[u].z;
        sQt[(d + 3) * kLd + r] = xq[u].w;
      }
      sKt[d * kLd + r] = xk[u].x;
      sKt[(d + 1) * kLd + r] = xk[u].y;
      sKt[(d + 2) * kLd + r] = xk[u].z;
      sKt[(d + 3) * kLd + r] = xk[u].w;
      *reinterpret_cast<float4*>(sV + r * ldv + d) = xv[u];
    }
  }
}

// Shared floats of the tiled kernel: q^T, k^T then P, v.
inline size_t tiled_floats(int dh) {
  const int ldv = (dh + 3) & ~3;
  return static_cast<size_t>(dh) * kLd + static_cast<size_t>(dh > kTile ? dh : kTile) * kLd +
         static_cast<size_t>(kTile) * ldv;
}

// T: element type of q, k, v, o; DC: blocks of 64 head-dim columns (dh <=
// 64 DC); MINB: blocks an SM.
template <typename T, int DC, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
tiled_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ bias, const uint8_t* __restrict__ mask, T* __restrict__ o,
             int H, int N, int M, int dh, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldv = (dh + 3) & ~3;
  float* sQt = smem;                              // (dh, kLd)
  float* sKP = sQt + dh * kLd;                    // (dh, kLd) k^T, then (kTile, kLd) P
  float* sV = sKP + (dh > kTile ? dh : kTile) * kLd;  // (kTile, ldv)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const T* qp = q + static_cast<size_t>(bh) * N * dh;
  const T* kp = k + static_cast<size_t>(bh) * M * dh;
  const T* vp = v + static_cast<size_t>(bh) * M * dh;
  T* op = o + static_cast<size_t>(bh) * N * dh;
  const float* bp = bias ? bias + static_cast<size_t>(b) * M : nullptr;
  const uint8_t* mp = mask ? mask + static_cast<size_t>(b) * M : nullptr;

  for (int n0 = 0; n0 < N; n0 += kTile) {
    float m[4], l[4], acc[4][4 * DC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.f;
    }
    for (int m0 = 0; m0 < M; m0 += kTile) {
      const int mm = min(kTile, M - m0);
      // the previous key tile's P and v (and, with a new query tile, the
      // previous q^T) are read
      __syncthreads();
      const T* qs = qp + static_cast<size_t>(n0) * dh;
      const T* ks = kp + static_cast<size_t>(m0) * dh;
      const T* vs = vp + static_cast<size_t>(m0) * dh;
      if (vec) {
        load_tiles_vec(m0 == 0 ? sQt : nullptr, qs, min(kTile, N - n0), sKP, ks, sV, vs, mm, dh,
                       ldv);
      } else {
        if (m0 == 0) load_transposed(sQt, qs, min(kTile, N - n0), dh);
        load_transposed(sKP, ks, mm, dh);
        load_rows(sV, vs, mm, dh, ldv);
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < dh; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(sQt + d * kLd + 4 * ty);
        const float4 c = *reinterpret_cast<const float4*>(sKP + d * kLd + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
      }

      float corr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = m0 + 4 * tx + j;
          // keys past M do not exist: p = 0
          s[i][j] = key < M ? masked_score(s[i][j], scale, bp, mp, key) : -INFINITY;
          mt = fmaxf(mt, s[i][j]);
        }
        const float m_new = fmaxf(m[i], rt::half_warp_max(mt));  // finite: key m0 exists
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
        l[i] = l[i] * corr[i] + rt::half_warp_sum(sum);
      }
      __syncthreads();  // every thread is done with k^T: P takes its place
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(sKP + (4 * ty + i) * kLd + 4 * tx) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      __syncthreads();

#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * DC; ++c) acc[i][c] *= corr[i];
      for (int mk = 0; mk < mm; mk += 4) {  // P and v are 0 past mm
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(sKP + (4 * ty + i) * kLd + mk);
          p[i][0] = x.x;
          p[i][1] = x.y;
          p[i][2] = x.z;
          p[i][3] = x.w;
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = 64 * c + 4 * tx;
          if (col >= dh) continue;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(sV + (mk + r) * ldv + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][4 * c] = fmaf(p[i][r], x.x, acc[i][4 * c]);
              acc[i][4 * c + 1] = fmaf(p[i][r], x.y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = fmaf(p[i][r], x.z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = fmaf(p[i][r], x.w, acc[i][4 * c + 3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + 4 * ty + i;
      if (n >= N) continue;
      T* orow = op + static_cast<size_t>(n) * dh;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = 64 * c + 4 * tx;
        if (col >= dh) continue;
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = acc[i][4 * c + e] / l[i];
        if (vec) {
          rt::store4(orow + col, make_float4(r[0], r[1], r[2], r[3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < dh) orow[col + e] = rt::from_f32<T>(r[e]);
        }
      }
    }
  }
}

// Shared floats of one warp of small_n_kernel: 32 rows of k (row stride
// dh + 4), q and the scores, rounded up to keep the next warp's rows
// 16-byte aligned.
__host__ __device__ __forceinline__ size_t small_n_warp_floats(int N, int M, int dh) {
  return (32 * static_cast<size_t>(dh + 4) + static_cast<size_t>(N) * (dh + M) + 3) & ~size_t{3};
}

// N <= kSmallN: one warp per (b, h), kWarps of them a block. With vec,
// k comes through shared memory 32 rows at a time (coalesced 16-byte
// loads; a row stride of dh + 4 keeps a lane's float4 reads of its own row
// off its neighbours' banks) and the lanes split P v by (key parity group,
// float4 column), reading v coalesced; the groups' partial sums are added
// in group order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
small_n_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, const uint8_t* __restrict__ mask,
               T* __restrict__ o, int BH, int H, int N, int M, int dh, float scale, int vec) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x * (blockDim.x / 32) + warp;
  if (bh >= BH) return;  // no block-wide barrier below
  const int ldk = dh + 4;
  float* sk = reinterpret_cast<float*>(smem4) +
              static_cast<size_t>(warp) * small_n_warp_floats(N, M, dh);  // (32, ldk)
  float* sq = sk + 32 * ldk;                                        // (N, dh)
  float* sp = sq + N * dh;                                          // (N, M)
  const int b = bh / H;
  const T* qp = q + static_cast<size_t>(bh) * N * dh;
  const T* kp = k + static_cast<size_t>(bh) * M * dh;
  const T* vp = v + static_cast<size_t>(bh) * M * dh;
  T* op = o + static_cast<size_t>(bh) * N * dh;
  const float* bp = bias ? bias + static_cast<size_t>(b) * M : nullptr;
  const uint8_t* mp = mask ? mask + static_cast<size_t>(b) * M : nullptr;

  for (int i = lane; i < N * dh; i += 32) sq[i] = rt::to_f32(qp[i]);
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + lane;
    float acc[kSmallN] = {0.f, 0.f, 0.f, 0.f};
    if (vec) {
      const int d4n = dh / 4;
      __syncwarp();  // the previous chunk's rows are read
      for (int i = lane; i < 32 * d4n; i += 32) {
        const int r = i / d4n;
        const int d = 4 * (i - r * d4n);
        *reinterpret_cast<float4*>(sk + r * ldk + d) =
            m0 + r < M ? rt::ldg4(kp + (m0 + r) * dh + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncwarp();
      for (int d = 0; d < dh; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(sk + lane * ldk + d);
#pragma unroll
        for (int n = 0; n < kSmallN; ++n) {
          if (n >= N) break;
          const float4 y = *reinterpret_cast<const float4*>(sq + n * dh + d);
          acc[n] = fmaf(y.x, x.x, acc[n]);
          acc[n] = fmaf(y.y, x.y, acc[n]);
          acc[n] = fmaf(y.z, x.z, acc[n]);
          acc[n] = fmaf(y.w, x.w, acc[n]);
        }
      }
    } else {
      __syncwarp();  // sq is written
      if (m < M)
        for (int d = 0; d < dh; ++d) {
          const float x = rt::to_f32(kp[static_cast<size_t>(m) * dh + d]);
#pragma unroll
          for (int n = 0; n < kSmallN; ++n)
            if (n < N) acc[n] = fmaf(sq[n * dh + d], x, acc[n]);
        }
    }
    if (m < M) {
#pragma unroll
      for (int n = 0; n < kSmallN; ++n)
        if (n < N) sp[n * M + m] = masked_score(acc[n], scale, bp, mp, m);
    }
  }
  __syncwarp();
  float l[kSmallN];
#pragma unroll
  for (int n = 0; n < kSmallN; ++n) {
    l[n] = 1.f;
    if (n >= N) continue;
    float* row = sp + n * M;
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, row[m]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      sum += e;
    }
    l[n] = rt::warp_sum(sum);
  }
  __syncwarp();
  if (!vec) {
    for (int d = lane; d < dh; d += 32) {
      float acc[kSmallN] = {0.f, 0.f, 0.f, 0.f};
      for (int m = 0; m < M; ++m) {
        const float x = rt::to_f32(vp[static_cast<size_t>(m) * dh + d]);
#pragma unroll
        for (int n = 0; n < kSmallN; ++n)
          if (n < N) acc[n] = fmaf(sp[n * M + m], x, acc[n]);
      }
#pragma unroll
      for (int n = 0; n < kSmallN; ++n)
        if (n < N) op[n * dh + d] = rt::from_f32<T>(acc[n] / l[n]);
    }
    return;
  }
  // lane = (group g, float4 column c4): group g sums keys m = g mod groups
  const int d4n = dh / 4;
  const int cols = d4n < 32 ? d4n : 32;  // float4 columns a pass
  const int groups = 32 / cols;
  const int g = lane / cols;
  const int c4 = lane - g * cols;
  for (int col0 = 0; col0 < d4n; col0 += cols) {
    const int col = col0 + c4;
    const bool active = g < groups && col < d4n;
    float4 acc[kSmallN];
#pragma unroll
    for (int n = 0; n < kSmallN; ++n) acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {
#pragma unroll 4
      for (int m = g; m < M; m += groups) {
        const float4 x = rt::ldg4(vp + static_cast<size_t>(m) * dh + 4 * col);
#pragma unroll
        for (int n = 0; n < kSmallN; ++n) {
          if (n >= N) break;
          const float p = sp[n * M + m];
          acc[n].x = fmaf(p, x.x, acc[n].x);
          acc[n].y = fmaf(p, x.y, acc[n].y);
          acc[n].z = fmaf(p, x.z, acc[n].z);
          acc[n].w = fmaf(p, x.w, acc[n].w);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kSmallN; ++n) {
      if (n >= N) break;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int gg = 0; gg < groups; ++gg) {  // the groups' sums, in group order
        const int src = gg * cols + c4;
        t.x += __shfl_sync(0xffffffffu, acc[n].x, src);
        t.y += __shfl_sync(0xffffffffu, acc[n].y, src);
        t.z += __shfl_sync(0xffffffffu, acc[n].z, src);
        t.w += __shfl_sync(0xffffffffu, acc[n].w, src);
      }
      if (g == 0 && col < d4n)
        rt::store4(op + n * dh + 4 * col,
                   make_float4(t.x / l[n], t.y / l[n], t.z / l[n], t.w / l[n]));
    }
  }
}

// Warps a block of small_n_kernel (up to kWarps, as many as 227 KB of
// shared memory hold; 0 if not one), and their shared bytes.
inline int small_n_warps(int N, int M, int dh) {
  const size_t per_warp = sizeof(float) * small_n_warp_floats(N, M, dh);
  const size_t fit = 232448 / per_warp;
  return static_cast<int>(fit < static_cast<size_t>(kWarps) ? fit : kWarps);
}
inline size_t small_n_bytes(int N, int M, int dh) {
  return sizeof(float) * small_n_warps(N, M, dh) * small_n_warp_floats(N, M, dh);
}

}  // namespace fwd

namespace bwd {

constexpr int kThreads = 256;               // 16 x 16
constexpr int kTile = 64;                   // queries, keys and head-dim columns a tile
constexpr int kLd = kTile + 4;              // row stride: 17 float4s
constexpr int kTileFloats = kTile * kLd;
constexpr int kSmallN = 4;                  // N up to this: small_n_kernel
constexpr int kSmallThreads = 128;          // threads a block of small_n_kernel
constexpr int kMaxHeadDim = 256;

// Shared bytes of tiled_kernel: chunks of q, dO, k, v, then P and dS.
constexpr size_t kTiledBytes = sizeof(float) * 6 * kTileFloats;
constexpr size_t kMaxSmem = 232448;         // 227 KB, a block's most

// Loads head-dim columns c0 .. c0 + 63 of tiles t0 .. t1 - 1 of four
// (rows x dh) row-major tiles into (kTile, kLd) shared tiles, zero past
// rows[t] and past dh: by 16-byte cp.async when vec (dh % 4 == 0, aligned
// rows), all of a thread's copies in flight at once and committed as one
// group, which the caller waits for; else element by element. The
// caller's barrier publishes them. bf16 tiles are widened on the way: 8-byte
// loads of 4 elements when vec (then an empty commit group), else element
// loads.
template <typename T>
__device__ __forceinline__ void load_chunks(float* const (&dst)[4], const T* const (&src)[4],
                                            const int (&rows)[4], int t0, int t1, int dh,
                                            int c0, int vec) {
  const int w = min(kTile, dh - c0);
  if (vec && !std::is_same<T, float>::value) {
#pragma unroll
    for (int u = 0; u < kTile * kTile / 4 / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i >> 4;
      const int c = 4 * (i & 15);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < t0 || t >= t1) continue;
        const bool in = r < rows[t] && c < w;
        *reinterpret_cast<float4*>(dst[t] + r * kLd + c) =
            in ? rt::ldg4(src[t] + static_cast<size_t>(r) * dh + c0 + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    rt::cp_async_commit();
  } else if (vec) {
#pragma unroll
    for (int u = 0; u < kTile * kTile / 4 / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i >> 4;
      const int c = 4 * (i & 15);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < t0 || t >= t1) continue;
        const bool in = r < rows[t] && c < w;
        rt::cp_async16(dst[t] + r * kLd + c,
                       in ? src[t] + static_cast<size_t>(r) * dh + c0 + c : src[t], in ? 16 : 0);
      }
    }
    rt::cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i >> 6;
      const int c = i & 63;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (t >= t0 && t < t1)
          dst[t][r * kLd + c] =
              r < rows[t] && c < w ? rt::to_f32(src[t][static_cast<size_t>(r) * dh + c0 + c])
                                   : 0.f;
    }
  }
}

// s[i][j] += a[4 ty + i][d] b[tx + 16 j][d] for d < w4, d ascending: one FMA
// chain a score, as the forward's.
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* a, const float* b,
                                          int w4, int tx, int ty) {
  for (int d = 0; d < w4; d += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(a + (4 * ty + i) * kLd + d);
      av[i][0] = x.x;
      av[i][1] = x.y;
      av[i][2] = x.z;
      av[i][3] = x.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
      bv[j][0] = x.x;
      bv[j][1] = x.y;
      bv[j][2] = x.z;
      bv[j][3] = x.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i][e], bv[j][e], s[i][j]);
  }
}

// Stores four values of a row at column col (< dh), adding what is there
// when accumulate: by 16 bytes when vec.
__device__ __forceinline__ void put4(float* p, int col, int dh, const float (&x)[4], int vec,
                                     bool accumulate) {
  if (vec) {
    float4* p4 = reinterpret_cast<float4*>(p + col);
    float4 o = make_float4(x[0], x[1], x[2], x[3]);
    if (accumulate) {
      const float4 old = *p4;
      o.x += old.x;
      o.y += old.y;
      o.z += old.z;
      o.w += old.w;
    }
    *p4 = o;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < dh) p[col + e] = accumulate ? p[col + e] + x[e] : x[e];
  }
}

// put4 into a bf16 output row p whose partial sums over tiles live in the
// fp32 row acc (null when one tile writes the output): the sum
// goes to acc until the last tile, which rounds it once into p. Its fp32
// sums are the fp32 instance's.
__device__ __forceinline__ void put4(__nv_bfloat16* p, float* acc, int col, int dh,
                                     const float (&x)[4], int vec, bool accumulate, bool last) {
  float y[4] = {x[0], x[1], x[2], x[3]};
  if (accumulate) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < dh) y[e] = x[e] + acc[col + e];
  }
  if (!last) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < dh) acc[col + e] = y[e];
  } else if (vec) {
    rt::store4(p + col, make_float4(y[0], y[1], y[2], y[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < dh) p[col + e] = __float2bfloat16_rn(y[e]);
  }
}
__device__ __forceinline__ void put4(float* p, float*, int col, int dh, const float (&x)[4],
                                     int vec, bool accumulate, bool) {
  put4(p, col, dh, x, vec, accumulate);
}

// N > kSmallN (and the rest): see the note at the top of the file. T:
// element type of q, k, v, dout, dq, dk, dv; scratch: the bf16 instance's fp32
// partial sums of dq (B, H, N, dh), then dk and dv (B, H, M, dh), when N or M
// is past one tile (else null).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tiled_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ bias, const uint8_t* __restrict__ mask,
             const T* __restrict__ dout, T* dq, T* dk, T* dv, float* db, float* scratch,
             int H, int N, int M, int dh, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + kTileFloats;
  float* sK = sDO + kTileFloats;
  float* sV = sK + kTileFloats;
  float* sP = sV + kTileFloats;
  float* sDS = sP + kTileFloats;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const T* qp = q + static_cast<size_t>(bh) * N * dh;
  const T* dop = dout + static_cast<size_t>(bh) * N * dh;
  const T* kp = k + static_cast<size_t>(bh) * M * dh;
  const T* vp = v + static_cast<size_t>(bh) * M * dh;
  T* dqp = dq + static_cast<size_t>(bh) * N * dh;
  T* dkp = dk + static_cast<size_t>(bh) * M * dh;
  T* dvp = dv + static_cast<size_t>(bh) * M * dh;
  float* dbp = db + static_cast<size_t>(bh) * M;
  const float* bp = bias ? bias + static_cast<size_t>(b) * M : nullptr;
  const uint8_t* mp = mask ? mask + static_cast<size_t>(b) * M : nullptr;
  const size_t BH = static_cast<size_t>(gridDim.x);
  // the bf16 instance's fp32 partial sums of dq, dk, dv (or null)
  float* sq32 = scratch ? scratch + static_cast<size_t>(bh) * N * dh : nullptr;
  float* sk32 = scratch ? scratch + BH * N * dh + static_cast<size_t>(bh) * M * dh : nullptr;
  float* sv32 = scratch ? scratch + BH * (N + M) * dh + static_cast<size_t>(bh) * M * dh : nullptr;
  const int nkt = (M + kTile - 1) / kTile;
  const int ndc = (dh + kTile - 1) / kTile;

  // Scores (and dP) of a query and a key tile over every head-dim chunk,
  // masked: keys past M get -inf. Leaves the last chunk of q, k (dO, v) in
  // shared memory.
  auto products = [&](int n0, int m0, bool with_dp, float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    float* const dst[4] = {sQ, sK, sDO, sV};
    const int rows[4] = {min(kTile, N - n0), min(kTile, M - m0), min(kTile, N - n0),
                         min(kTile, M - m0)};
    const T* const src[4] = {qp + static_cast<size_t>(n0) * dh, kp + static_cast<size_t>(m0) * dh,
                             dop + static_cast<size_t>(n0) * dh,
                             vp + static_cast<size_t>(m0) * dh};
    for (int c0 = 0; c0 < dh; c0 += kTile) {
      __syncthreads();  // every thread is done with the previous chunks
      load_chunks(dst, src, rows, 0, 2, dh, c0, vec);  // q, k
      if (with_dp) {
        load_chunks(dst, src, rows, 2, 4, dh, c0, vec);  // dO, v: land under the scores
        rt::cp_async_wait<1>();
      } else {
        rt::cp_async_wait<0>();
      }
      __syncthreads();
      const int w4 = (min(kTile, dh - c0) + 3) & ~3;
      tile_dots(s, sQ, sK, w4, tx, ty);
      if (with_dp) {
        rt::cp_async_wait<0>();
        __syncthreads();
        tile_dots(dp, sDO, sV, w4, tx, ty);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = m0 + tx + 16 * j;
        s[i][j] = key < M ? masked_score(s[i][j], scale, bp, mp, key) : -INFINITY;
      }
  };

  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int nn = min(kTile, N - n0);
    float s[4][4], dp[4][4];
    float mrow[4], lrow[4], delta[4];
    if (nkt > 1) {
      // the rows' max and sum over every key tile, then delta
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mrow[i] = -INFINITY;
        lrow[i] = 0.f;
        delta[i] = 0.f;
      }
      for (int m0 = 0; m0 < M; m0 += kTile) {
        products(n0, m0, false, s, dp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) mt = fmaxf(mt, s[i][j]);
          const float m_new = fmaxf(mrow[i], rt::half_warp_max(mt));  // key m0 exists
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
          lrow[i] = lrow[i] * expf(mrow[i] - m_new) + rt::half_warp_sum(sum);
          mrow[i] = m_new;
        }
      }
      for (int m0 = 0; m0 < M; m0 += kTile) {
        products(n0, m0, true, s, dp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) part = fmaf(dp[i][j], expf(s[i][j] - mrow[i]) / lrow[i], part);
          delta[i] += rt::half_warp_sum(part);
        }
      }
    }

    for (int m0 = 0; m0 < M; m0 += kTile) {
      const int mm = min(kTile, M - m0);
      products(n0, m0, true, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (nkt == 1) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) mt = fmaxf(mt, s[i][j]);
          mrow[i] = rt::half_warp_max(mt);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - mrow[i]);
          lrow[i] = rt::half_warp_sum(sum);
        }
        const bool row = n0 + 4 * ty + i < N;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = row ? expf(s[i][j] - mrow[i]) / lrow[i] : 0.f;  // P
          part = fmaf(dp[i][j], s[i][j], part);
        }
        if (nkt == 1) delta[i] = rt::half_warp_sum(part);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dp[i][j] = s[i][j] * (dp[i][j] - delta[i]);  // dS
          sP[(4 * ty + i) * kLd + tx + 16 * j] = s[i][j];
          sDS[(4 * ty + i) * kLd + tx + 16 * j] = dp[i][j];
        }
      }
      __syncthreads();

      // db: column sums of dS, rows in order
      if (threadIdx.x < mm) {
        float acc = 0.f;
        for (int n = 0; n < nn; ++n) acc += sDS[n * kLd + threadIdx.x];
        float* p = dbp + m0 + threadIdx.x;
        *p = n0 > 0 ? *p + acc : acc;
      }

      for (int c0 = 0; c0 < dh; c0 += kTile) {
        if (ndc > 1) {
          float* const dst[4] = {sQ, sDO, sK, sV};
          const T* const src[4] = {qp + static_cast<size_t>(n0) * dh,
                                   dop + static_cast<size_t>(n0) * dh,
                                   kp + static_cast<size_t>(m0) * dh, nullptr};
          const int rows[4] = {nn, nn, mm, 0};
          __syncthreads();
          load_chunks(dst, src, rows, 0, 3, dh, c0, vec);
          rt::cp_async_wait<0>();
          __syncthreads();
        }
        const int col = c0 + 4 * tx;
        const int mm4 = (mm + 3) & ~3;  // P, dS and k rows are 0 past mm

        // dQ = scale dS K: rows 4 ty + i, columns col ..
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        for (int mk = 0; mk < mm4; mk += 4) {
          float ds[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(sDS + (4 * ty + i) * kLd + mk);
            ds[i][0] = x.x;
            ds[i][1] = x.y;
            ds[i][2] = x.z;
            ds[i][3] = x.w;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(sK + (mk + r) * kLd + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][0] = fmaf(ds[i][r], x.x, acc[i][0]);
              acc[i][1] = fmaf(ds[i][r], x.y, acc[i][1]);
              acc[i][2] = fmaf(ds[i][r], x.z, acc[i][2]);
              acc[i][3] = fmaf(ds[i][r], x.w, acc[i][3]);
            }
          }
        }
        if (col < dh) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = n0 + 4 * ty + i;
            if (n >= N) continue;
            const float x[4] = {acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale,
                                acc[i][3] * scale};
            put4(dqp + static_cast<size_t>(n) * dh,
                 sq32 ? sq32 + static_cast<size_t>(n) * dh : nullptr, col, dh, x, vec, m0 > 0,
                 m0 + kTile >= M);
          }
        }

        // dK = scale dS^T Q and dV = P^T dO: keys 4 ty + i, columns col ..
        float ak[4][4], av[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) ak[i][e] = av[i][e] = 0.f;
        for (int n = 0; n < nn; ++n) {
          const float4 d4 = *reinterpret_cast<const float4*>(sDS + n * kLd + 4 * ty);
          const float4 p4 = *reinterpret_cast<const float4*>(sP + n * kLd + 4 * ty);
          const float4 q4 = *reinterpret_cast<const float4*>(sQ + n * kLd + 4 * tx);
          const float4 o4 = *reinterpret_cast<const float4*>(sDO + n * kLd + 4 * tx);
          const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i][0] = fmaf(dsv[i], q4.x, ak[i][0]);
            ak[i][1] = fmaf(dsv[i], q4.y, ak[i][1]);
            ak[i][2] = fmaf(dsv[i], q4.z, ak[i][2]);
            ak[i][3] = fmaf(dsv[i], q4.w, ak[i][3]);
            av[i][0] = fmaf(pv[i], o4.x, av[i][0]);
            av[i][1] = fmaf(pv[i], o4.y, av[i][1]);
            av[i][2] = fmaf(pv[i], o4.z, av[i][2]);
            av[i][3] = fmaf(pv[i], o4.w, av[i][3]);
          }
        }
        if (col < dh) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = m0 + 4 * ty + i;
            if (m >= M) continue;
            const float xk[4] = {ak[i][0] * scale, ak[i][1] * scale, ak[i][2] * scale,
                                 ak[i][3] * scale};
            const bool last = n0 + kTile >= N;
            put4(dkp + static_cast<size_t>(m) * dh,
                 sk32 ? sk32 + static_cast<size_t>(m) * dh : nullptr, col, dh, xk, vec, n0 > 0,
                 last);
            put4(dvp + static_cast<size_t>(m) * dh,
                 sv32 ? sv32 + static_cast<size_t>(m) * dh : nullptr, col, dh, av[i], vec, n0 > 0,
                 last);
          }
        }
      }
    }
  }
}

// Shared floats of small_n_kernel: 64 rows each of k and v (row stride
// dh + 4), q and dO, then the scores / P and dP / dS of the N rows.
__host__ __device__ __forceinline__ size_t small_n_floats(int N, int M, int dh) {
  return 2 * static_cast<size_t>(kTile) * (dh + 4) + 2 * static_cast<size_t>(N) * (dh + M);
}

// N <= kSmallN while small_n_floats fit in 227 KB: one block of
// kSmallThreads per (b, h), see the note at the top of the file.
template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
small_n_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, const uint8_t* __restrict__ mask,
               const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ db, int H, int N, int M, int dh,
               float scale, int vec) {
  extern __shared__ float4 smem4[];
  const int ldk = dh + 4;
  float* sk = reinterpret_cast<float*>(smem4);  // (kTile, ldk)
  float* sv = sk + kTile * ldk;                 // (kTile, ldk)
  float* sq = sv + kTile * ldk;                 // (N, dh)
  float* sdo = sq + N * dh;                     // (N, dh)
  float* sp = sdo + N * dh;                     // (N, M) scores, then P
  float* sds = sp + N * M;                      // (N, M) dP, then dS
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const T* qp = q + static_cast<size_t>(bh) * N * dh;
  const T* dop = dout + static_cast<size_t>(bh) * N * dh;
  const T* kp = k + static_cast<size_t>(bh) * M * dh;
  const T* vp = v + static_cast<size_t>(bh) * M * dh;
  T* dqp = dq + static_cast<size_t>(bh) * N * dh;
  T* dkp = dk + static_cast<size_t>(bh) * M * dh;
  T* dvp = dv + static_cast<size_t>(bh) * M * dh;
  const float* bp = bias ? bias + static_cast<size_t>(b) * M : nullptr;
  const uint8_t* mp = mask ? mask + static_cast<size_t>(b) * M : nullptr;
  const int d4n = dh / 4;

  // rows m0 .. m0 + 63 of k (and v) into sk (sv), zero past M; bf16 rows
  // widened by 8-byte loads of 4 elements
  auto stage = [&](int m0, bool with_v) {
    if (vec && !std::is_same<T, float>::value) {
      for (int i = tid; i < kTile * d4n; i += kSmallThreads) {
        const int r = i / d4n;
        const int d = 4 * (i - r * d4n);
        const bool in = m0 + r < M;
        const size_t off = in ? static_cast<size_t>(m0 + r) * dh + d : 0;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(sk + r * ldk + d) = in ? rt::ldg4(kp + off) : zero;
        if (with_v) *reinterpret_cast<float4*>(sv + r * ldk + d) = in ? rt::ldg4(vp + off) : zero;
      }
    } else if (vec) {
      for (int i = tid; i < kTile * d4n; i += kSmallThreads) {
        const int r = i / d4n;
        const int d = 4 * (i - r * d4n);
        const bool in = m0 + r < M;
        const size_t off = in ? static_cast<size_t>(m0 + r) * dh + d : 0;
        rt::cp_async16(sk + r * ldk + d, kp + off, in ? 16 : 0);
        if (with_v) rt::cp_async16(sv + r * ldk + d, vp + off, in ? 16 : 0);
      }
      rt::cp_async_commit();
      rt::cp_async_wait<0>();
    } else {
      for (int i = tid; i < kTile * dh; i += kSmallThreads) {
        const int r = i / dh;
        const int d = i - r * dh;
        const bool in = m0 + r < M;
        sk[r * ldk + d] = in ? rt::to_f32(kp[static_cast<size_t>(m0 + r) * dh + d]) : 0.f;
        if (with_v)
          sv[r * ldk + d] = in ? rt::to_f32(vp[static_cast<size_t>(m0 + r) * dh + d]) : 0.f;
      }
    }
  };

  for (int i = tid; i < N * dh; i += kSmallThreads) {
    sq[i] = rt::to_f32(qp[i]);
    sdo[i] = rt::to_f32(dop[i]);
  }
  // scores (threads 0-63) and dP (threads 64-127), a thread a key
  const int key = tid & (kTile - 1);
  const bool is_dp = tid >= kTile;
  const float* rows = is_dp ? sv : sk;
  const float* vecs = is_dp ? sdo : sq;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    __syncthreads();  // the previous chunk's rows are read
    stage(m0, true);
    __syncthreads();
    const int m = m0 + key;
    if (m >= M) continue;
    float acc[kSmallN] = {0.f, 0.f, 0.f, 0.f};
    if (vec) {
      for (int d = 0; d < dh; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(rows + key * ldk + d);
#pragma unroll
        for (int n = 0; n < kSmallN; ++n) {
          if (n >= N) break;
          const float4 a = *reinterpret_cast<const float4*>(vecs + n * dh + d);
          acc[n] = fmaf(a.x, x.x, acc[n]);
          acc[n] = fmaf(a.y, x.y, acc[n]);
          acc[n] = fmaf(a.z, x.z, acc[n]);
          acc[n] = fmaf(a.w, x.w, acc[n]);
        }
      }
    } else {
      for (int d = 0; d < dh; ++d) {
        const float x = rows[key * ldk + d];
#pragma unroll
        for (int n = 0; n < kSmallN; ++n)
          if (n < N) acc[n] = fmaf(vecs[n * dh + d], x, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kSmallN; ++n)
      if (n < N) {
        if (is_dp)
          sds[n * M + m] = acc[n];
        else
          sp[n * M + m] = masked_score(acc[n], scale, bp, mp, m);
      }
  }
  __syncthreads();
  // softmax, delta = rowsum(dP P) and dS: warp n takes row n
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (warp < N) {
    float* row = sp + warp * M;
    float* drow = sds + warp * M;
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, row[m]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      sum += e;
    }
    sum = rt::warp_sum(sum);
    float dot = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float p = row[m] / sum;
      row[m] = p;
      dot = fmaf(drow[m], p, dot);
    }
    dot = rt::warp_sum(dot);
    for (int m = lane; m < M; m += 32) drow[m] = row[m] * (drow[m] - dot);
  }
  __syncthreads();

  // db, and the outer products dK = scale dS^T q, dV = P^T dO, coalesced
  for (int m = tid; m < M; m += kSmallThreads) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc += sds[n * M + m];
    db[static_cast<size_t>(bh) * M + m] = acc;
  }
  if (vec) {
    for (int i = tid; i < M * d4n; i += kSmallThreads) {
      const int m = i / d4n;
      const int c = i - m * d4n;
      float4 ak = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int n = 0; n < kSmallN; ++n) {
        if (n >= N) break;
        const float ds = sds[n * M + m];
        const float p = sp[n * M + m];
        const float4 a = reinterpret_cast<const float4*>(sq + n * dh)[c];
        const float4 o = reinterpret_cast<const float4*>(sdo + n * dh)[c];
        ak.x = fmaf(ds, a.x, ak.x);
        ak.y = fmaf(ds, a.y, ak.y);
        ak.z = fmaf(ds, a.z, ak.z);
        ak.w = fmaf(ds, a.w, ak.w);
        av.x = fmaf(p, o.x, av.x);
        av.y = fmaf(p, o.y, av.y);
        av.z = fmaf(p, o.z, av.z);
        av.w = fmaf(p, o.w, av.w);
      }
      rt::store4(dkp + static_cast<size_t>(m) * dh + 4 * c,
                 make_float4(ak.x * scale, ak.y * scale, ak.z * scale, ak.w * scale));
      rt::store4(dvp + static_cast<size_t>(m) * dh + 4 * c, av);
    }
  } else {
    for (int i = tid; i < M * dh; i += kSmallThreads) {
      const int m = i / dh;
      const int d = i - m * dh;
      float ak = 0.f, av = 0.f;
#pragma unroll
      for (int n = 0; n < kSmallN; ++n)
        if (n < N) {
          ak = fmaf(sds[n * M + m], sq[n * dh + d], ak);
          av = fmaf(sp[n * M + m], sdo[n * dh + d], av);
        }
      dkp[static_cast<size_t>(m) * dh + d] = rt::from_f32<T>(ak * scale);
      dvp[static_cast<size_t>(m) * dh + d] = rt::from_f32<T>(av);
    }
  }

  // dQ = scale dS K: a thread per (n, float4 column) (per (n, d) without
  // vec), keys in order; k comes back through shared memory when M spans
  // more than one chunk
  constexpr int kPer = kSmallN * kMaxHeadDim / kSmallThreads;  // outputs a thread at most
  const int nout = vec ? N * d4n : N * dh;
  const int per_row = vec ? d4n : dh;
  float aq[kPer][4];
#pragma unroll
  for (int u = 0; u < kPer; ++u) aq[u][0] = aq[u][1] = aq[u][2] = aq[u][3] = 0.f;
  const int nkc = (M + kTile - 1) / kTile;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    if (nkc > 1) {
      __syncthreads();  // the previous chunk's rows are read
      stage(m0, false);
      __syncthreads();
    }
    const int mm = min(kTile, M - m0);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kSmallThreads;
      if (i >= nout) break;
      const int n = i / per_row;
      const int c = i - n * per_row;
      const float* dsr = sds + n * M + m0;
      if (vec) {
        for (int m = 0; m < mm; ++m) {
          const float ds = dsr[m];
          const float4 x = *reinterpret_cast<const float4*>(sk + m * ldk + 4 * c);
          aq[u][0] = fmaf(ds, x.x, aq[u][0]);
          aq[u][1] = fmaf(ds, x.y, aq[u][1]);
          aq[u][2] = fmaf(ds, x.z, aq[u][2]);
          aq[u][3] = fmaf(ds, x.w, aq[u][3]);
        }
      } else {
        for (int m = 0; m < mm; ++m) aq[u][0] = fmaf(dsr[m], sk[m * ldk + c], aq[u][0]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kSmallThreads;
    if (i >= nout) break;
    if (vec)
      rt::store4(dqp + 4 * i,
                 make_float4(aq[u][0] * scale, aq[u][1] * scale, aq[u][2] * scale,
                             aq[u][3] * scale));
    else
      dqp[i] = rt::from_f32<T>(aq[u][0] * scale);
  }
}

}  // namespace bwd

}  // namespace

namespace {

template <typename Kernel, typename T>
cudaError_t launch_tiled(Kernel kernel, const T* q, const T* k, const T* v, const float* bias,
                         const uint8_t* mask, T* o, int B, int H, int N, int M, int dh,
                         float scale, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd::tiled_floats(dh);
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, fwd::kThreads, smem, stream>>>(q, k, v, bias, mask, o, H, N, M, dh, scale,
                                                 vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const T* q, const T* k, const T* v, const float* bias, const uint8_t* mask,
                    T* o, int B, int H, int N, int M, int dh, int vec, float scale,
                    cudaStream_t stream) {
  if (N <= fwd::kSmallN) {
    // k rows, q and the scores of each warp, as many warps as fit
    const int warps = fwd::small_n_warps(N, M, dh);
    if (warps == 0) return cudaErrorInvalidValue;
    const size_t smem = fwd::small_n_bytes(N, M, dh);
    cudaError_t err = rt::allow_smem(fwd::small_n_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    const int blocks = (B * H + warps - 1) / warps;
    fwd::small_n_kernel<T><<<blocks, 32 * warps, smem, stream>>>(q, k, v, bias, mask, o,
                                                                 B * H, H, N, M, dh, scale, vec);
    return cudaGetLastError();
  }
  if (dh <= 64)
    return launch_tiled(fwd::tiled_kernel<T, 1, 3>, q, k, v, bias, mask, o, B, H, N, M, dh,
                        scale, vec, stream);
  if (dh <= 128)
    return launch_tiled(fwd::tiled_kernel<T, 2, 2>, q, k, v, bias, mask, o, B, H, N, M, dh,
                        scale, vec, stream);
  return launch_tiled(fwd::tiled_kernel<T, 4, 1>, q, k, v, bias, mask, o, B, H, N, M, dh, scale,
                      vec, stream);
}

template <typename T>
cudaError_t forward_attributes(int N, int dh, cudaFuncAttributes* a) {
  if (N <= fwd::kSmallN) return cudaFuncGetAttributes(a, fwd::small_n_kernel<T>);
  if (dh <= 64) return cudaFuncGetAttributes(a, fwd::tiled_kernel<T, 1, 3>);
  if (dh <= 128) return cudaFuncGetAttributes(a, fwd::tiled_kernel<T, 2, 2>);
  return cudaFuncGetAttributes(a, fwd::tiled_kernel<T, 4, 1>);
}

template <typename T>
cudaError_t backward(const T* q, const T* k, const T* v, const float* bias, const uint8_t* mask,
                     const T* dout, T* dq, T* dk, T* dv, float* db, float* acc, int B, int H,
                     int N, int M, int dh, int vec, float scale, cudaStream_t stream) {
  const size_t small = sizeof(float) * bwd::small_n_floats(N, M, dh);
  if (N <= bwd::kSmallN && small <= bwd::kMaxSmem) {
    cudaError_t err = rt::allow_smem(bwd::small_n_kernel<T>, small);
    if (err != cudaSuccess) return err;
    bwd::small_n_kernel<T><<<B * H, bwd::kSmallThreads, small, stream>>>(
        q, k, v, bias, mask, dout, dq, dk, dv, db, H, N, M, dh, scale, vec);
    return cudaGetLastError();
  }
  // a bf16 output summed over tiles needs its fp32 scratch
  if (!std::is_same<T, float>::value && (N > bwd::kTile || M > bwd::kTile) && !acc)
    return cudaErrorInvalidValue;
  cudaError_t err = rt::allow_smem(bwd::tiled_kernel<T>, bwd::kTiledBytes);
  if (err != cudaSuccess) return err;
  bwd::tiled_kernel<T><<<B * H, bwd::kThreads, bwd::kTiledBytes, stream>>>(
      q, k, v, bias, mask, dout, dq, dk, dv, db, acc, H, N, M, dh, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_attributes(int N, int M, int dh, cudaFuncAttributes* a, size_t* smem) {
  *smem = sizeof(float) * bwd::small_n_floats(N, M, dh);
  if (N <= bwd::kSmallN && *smem <= bwd::kMaxSmem)
    return cudaFuncGetAttributes(a, bwd::small_n_kernel<T>);
  *smem = bwd::kTiledBytes;
  return cudaFuncGetAttributes(a, bwd::tiled_kernel<T>);
}

using bf16_t = __nv_bfloat16;

}  // namespace

// q, o: (B, H, N, dh); k, v: (B, H, M, dh), all fp32 (bf16 == 0) or all
// bf16; bias: (B, M) fp32 or null; mask: (B, M) uint8 (nonzero = valid
// key) or null. Contiguous; dh <= 256. vec != 0: dh % 4 == 0 and q, k, v,
// o aligned to 4 elements (16 bytes in fp32, 8 in bf16).
extern "C" int rt_set_attention_forward(const void* q, const void* k, const void* v,
                                        const float* bias, const uint8_t* mask, void* o, int B,
                                        int H, int N, int M, int dh, int vec, int bf16,
                                        float scale, cudaStream_t stream) {
  if (B * H == 0 || N == 0) return cudaSuccess;
  if (M <= 0 || dh <= 0 || dh > 256) return cudaErrorInvalidValue;
  if (bf16)
    return forward(static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
                   static_cast<const bf16_t*>(v), bias, mask, static_cast<bf16_t*>(o), B, H, N,
                   M, dh, vec, scale, stream);
  return forward(static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), bias, mask, static_cast<float*>(o), B, H, N, M,
                 dh, vec, scale, stream);
}

// The kernel a forward launch at (N, M, dh) on fp32 (bf16 == 0) or bf16
// inputs takes: out = {registers a thread, static shared bytes, dynamic
// shared bytes a block, local (spill) bytes a thread}.
extern "C" int rt_set_attention_forward_attributes(int bf16, int N, int M, int dh, int* out) {
  if (N <= 0 || M <= 0 || dh <= 0 || dh > 256) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err =
      bf16 ? forward_attributes<bf16_t>(N, dh, &a) : forward_attributes<float>(N, dh, &a);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(N <= fwd::kSmallN ? fwd::small_n_bytes(N, M, dh)
                                              : sizeof(float) * fwd::tiled_floats(dh));
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

// Inputs as the forward's, plus dout: (B, H, N, dh). Outputs dq: (B, H, N,
// dh); dk, dv: (B, H, M, dh), in the inputs' dtype; db: (B, H, M) fp32, the
// key-bias gradient of each head. acc: for bf16 on the tiled route with N
// or M > 64, an fp32 scratch of B H (N + 2 M) dh floats (else null). dh <=
// 256. vec != 0: dh % 4 == 0 and q, k, v, dout, dq, dk, dv aligned to 4
// elements. N <= 4 takes small_n_kernel while its shared memory fits in
// 227 KB, everything else the tiled kernel.
extern "C" int rt_set_attention_backward(const void* q, const void* k, const void* v,
                                         const float* bias, const uint8_t* mask, const void* dout,
                                         void* dq, void* dk, void* dv, float* db, float* acc,
                                         int B, int H, int N, int M, int dh, int vec, int bf16,
                                         float scale, cudaStream_t stream) {
  if (B * H == 0 || N == 0) return cudaSuccess;
  if (M <= 0 || dh <= 0 || dh > bwd::kMaxHeadDim) return cudaErrorInvalidValue;
  if (bf16)
    return backward(static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
                    static_cast<const bf16_t*>(v), bias, mask,
                    static_cast<const bf16_t*>(dout), static_cast<bf16_t*>(dq),
                    static_cast<bf16_t*>(dk), static_cast<bf16_t*>(dv), db, acc, B, H, N, M, dh,
                    vec, scale, stream);
  return backward(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), bias, mask, static_cast<const float*>(dout),
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), db,
                  nullptr, B, H, N, M, dh, vec, scale, stream);
}

// The kernel a backward launch at (N, M, dh) on fp32 (bf16 == 0) or bf16
// inputs takes: out as the forward's.
extern "C" int rt_set_attention_backward_attributes(int bf16, int N, int M, int dh, int* out) {
  if (N <= 0 || M <= 0 || dh <= 0 || dh > bwd::kMaxHeadDim) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  size_t smem = 0;
  const cudaError_t err = bf16 ? backward_attributes<bf16_t>(N, M, dh, &a, &smem)
                               : backward_attributes<float>(N, M, dh, &a, &smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}
