// Streaming-softmax (flash) GQA attention for the LM zoo: the forward
// (prefill and training) and, in namespace bwd, its backward (training).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash.py::
// _flash_kernel (reached through flash_pallas and ops.py::flash_attention,
// and from the models through models/attention.py::attn_apply). Per batch
// row b, head h and query position i:
//     o[b,i,h] = softmax_j(scale q[b,i,h] . k[b,j,h/g] + mask(i,j)) v[b,j,h/g]
// with g = H/K, scale = D^-0.5, masked scores set to NEG_INF = -2^30 (not
// -inf), the causal rule j <= i (widened by the prefix-LM rule to j <= i or
// j < prefix_len: every row sees the whole prefix, as models/attention.py::
// _mask_bias("prefix") of the JAX package; prefix_len 0 is the plain causal
// rule) and the window rule i - j < window on absolute positions counted from
// 0 for both q and k (also when S != T), a running max m, a running
// denominator l and an fp32 accumulator, and the output acc / max(l, 1e-30)
// cast to q's dtype. The TPU kernel has no prefix rule (its caller drops the
// prefix); the prefix bounds below follow the causal ones. Each kernel has a
// PREFIX template flag, set for causal launches with prefix_len > 0: without
// it the instance is the causal kernel as it was before the rule (the same
// code, the same tiles and bits, and its speed: a run-time prefix test in the
// shared instances cost 7-12% at smollm's and qwen3-moe's shapes on the
// H100).
//
// Two hand-written kernels, chosen by dtype in the wrapper
// (kernels/flash_attention/ops.py); a failed build or launch of either raises.
//
// bf16: rt_flash_attention_forward_bf16, on the tensor cores (wgmma, sm_90a).
// What bounds it on the H100: at smollm-135m's prefill (B 4, S 2048, H 9,
// K 3, D 64, causal) it must move 25 MB (q, k, v read once, o written once:
// 7.5 us at 3.35 TB/s) and do 4 D = 256 FLOPs per unmasked (q, k) pair,
// 19 GFLOP: 20 us at the bf16 tensor-core rate. So the operations bound it,
// and the design feeds the tensor cores and keeps every intermediate on
// chip, as the TPU kernel kept it in VMEM:
//   * one block per (128-query tile, head, batch row): two consumer
//     warpgroups of 64 query rows each (one of 64 at D > 128, where the O
//     accumulator takes 128 registers a thread). The block loops over
//     64-key tiles of kv head h / g (GQA in the index);
//   * S = Q K^T by wgmma m64n64k16, Q and K both K-major in shared memory in
//     the 128-byte swizzled layout the descriptors read, all D / 16 steps
//     issued as one batch; O += P V by wgmma m64n64k16 per 64 output
//     columns, P the register A operand (the fp32 accumulator fragment
//     converted to bf16 in place: its layout is the A fragment's), V an
//     MN-major B operand read through the descriptor's transpose bit;
//   * the softmax works on the raw fp32 scores: the row max over them, then
//     p = 2^(s scale log2(e) - m scale log2(e)) in one FMA and one MUFU.EX2
//     a score, so the scale is applied in fp32 after the product and q is
//     never rounded after scaling. Masked scores are NEG_INF before the
//     scale (the plain version masks after it): either way exp underflows
//     to exactly 0 beside a visible key, and a row with none so far weighs
//     its masked keys equally;
//   * P in bf16 is a rounding the TPU kernel does not make (it multiplies
//     fp32 P by fp32 v); l sums the fp32 P. The JAX suite's bf16 bound (atol
//     3e-2, rtol 1e-2) holds;
//   * the O accumulator (64 rows x D fp32 a warpgroup) stays in registers;
//     row max and sum are reduced over the accumulator's lane quad by
//     shuffles, and l is kept per thread until the end;
//   * K/V go through a ring of two stages of two 64-key tiles each (one at
//     D > 128): the next stage's loads are in flight while the current one
//     is multiplied, with one block barrier a stage. The loads are 16-byte
//     cp.async (not TMA): the zoo hands q, k, v as strided views of fused
//     projections, one cp.async per 16 bytes takes any such view whose rows
//     are 16-byte aligned with no tensor map to encode on the host per call,
//     zero-fills rows past S or T and head-dim columns up to the padded width
//     by its source size, and writes the same swizzled layout a TMA load
//     would. Rows that are not 16-byte aligned (D % 8 != 0, odd strides or
//     offsets; the wrapper decides from the pointers and strides) are copied
//     element by element by the same kernel into the same layout;
//   * tiles that the causal rule or the window mask for every row of a
//     warpgroup are skipped (the pl.when(run) bounds of the TPU kernel, at
//     64 rows x 64 keys), but for tiles that start inside the prefix; only
//     tiles that straddle the diagonal (and reach past the prefix), the
//     window edge or T apply the rule to the score fragment, the rest run
//     unmasked, a tile wholly inside the prefix among them;
//   * under the causal rule blockIdx.y runs from the last query tile (the
//     most key tiles, with a prefix too) to the first, so the heavy tiles
//     start first;
//   * no atomics: two runs give the same bits.
// Head dims: D up to 256, padded to 64, 128 or 256 columns (zero-filled).
// Tried on the H100 and dropped (no gain at smollm's shape): three stages
// with two tiles of prefetch, one warpgroup a block, and issuing the P V
// product of the previous tile behind Q K^T of the current one (the
// compiler serialised the wgmma across the branch that skips tiles).
//
// fp32: rt_flash_attention_forward_f32, the first design of this kernel, in plain
// fp32 FMAs, kept for fp32 inputs: tensor cores would need TF32, which
// breaks the 2e-5 fp32 bound. Its bound at the same shape is the fp32 peak
// (67 TFLOP/s), 0.29 ms or more:
//   * one block of 256 threads (16 x 16) per (64-query tile, head, batch
//     row), looping over 64-key tiles of kv head h / g;
//   * key tiles that the causal rule (past the prefix) or the window mask
//     out for every row of the query tile are never loaded (the loop
//     bounds), as pl.when(run) skipped them;
//   * q (pre-scaled, fp32) and the k tile sit transposed in shared memory
//     with a padded row, v row-major, the P tile with a padded row. Each
//     thread computes a 4 x 4 block of scores from registers; the row max and
//     sum are reduced over the 16 lanes of a half warp with shuffles; each
//     thread keeps 4 rows x D/16 columns of the fp32 accumulator;
//   * plain fp32 FMAs, fp32 accumulation, no TF32, no atomics.
//
// Common to both: a row whose first visible key lies in a later tile carries
// m = NEG_INF and the l and acc of the masked keys of earlier computed tiles
// until its first real score, where the correction exp(m_prev - m_new)
// underflows to 0 and clears them, as in the TPU kernel. Any S and T: rows
// past S are computed on zeros and not stored; keys past T get p = 0 (they do
// not exist, unlike masked keys, which get NEG_INF). The model layout
// (B, S, H, D) / (B, T, K, D) is read in place through its strides, with
// unit stride over D; o is written contiguous. One difference from the plain
// version (kernels/flash_attention/ref.py), shared with the TPU kernel: a row
// with no visible key at all (only possible with a window, when S > T +
// window - 1) gets the mean of v over the computed tiles' keys, or 0 when
// every tile was skipped, where the plain version averages all T keys.
//
// The log-sum-exp. Each forward kernel has an LSE template flag, set when
// the wrapper passes an lse pointer (autograd): the instance also writes,
// for every stored row, lse = log sum_j exp(scale q.k_j + mask) in natural
// log units of the scaled, masked scores, fp32, (B, H, S). The fp32
// kernel's m is already scaled (lse = m + log l); the bf16 kernel keeps a
// raw max and powers of 2, so it writes (m scale log2(e) + log2 l) ln 2.
// Without the flag (serving) an instance is the code it was before the
// flag: the same registers (bf16 122, 153, 218; fp32 80, 93, 128 at D <=
// 64, 128, 256 on the H100) and the same bits.
//
// The backward (namespace bwd): rt_flash_attention_backward_{f32,bf16}.
// No TPU kernel computes it: JAX differentiates its chunked oracle
// (models/attention.py::_chunked_attention) by a custom VJP that
// recomputes p from the saved row statistics, and so does this code:
//     p = exp(scale q.k - lse) (0 where masked, for keys past T and rows
//     past S), delta = rowsum(dO o), dS = p (dO.v - delta),
//     dq = scale dS k, dk = scale dS^T q, dv = p^T dO,
// dk and dv summed over the G query heads of each kv head. The masks are
// the forward's, the PREFIX flag among them, and every product is summed
// in a fixed order with no atomics, so two runs give the same bits (the
// Trainer's exact resume needs them). delta comes from the stored o (JAX
// takes it from the fp32 output before the cast): the same in fp32, o's
// rounding apart in bf16. A pre-pass writes delta (fp32, (B, H, S)), a
// warp a row; then a dK/dV kernel (a block per key tile, kv head and
// batch row, looping over the G query heads and the 64-row query tiles
// that see the tile: from its diagonal under the causal rule, from 0 when
// it starts inside the prefix, up to the window's reach past its last
// key) and a dQ kernel (a block per 64-query tile, head and batch row,
// heavy causal tiles first, looping over the forward's key tiles), each
// keeping its gradient in registers and writing it once.
//
// What bounds it on the H100: at smollm-135m's training shape (B 8, S
// 2048, H 9, K 3, D 64, causal) it must move about 100 MB (q, k, v, o, dO
// read once, dq, dk, dv written once, lse and delta: 0.03 ms at 3.35
// TB/s) and do 10 D operations per visible pair (5 products), 96.7 GFLOP:
// 0.098 ms at the bf16 tensor-core rate. So the operations bound it.
//
// bf16 (bwd::dkdv_wgmma_kernel, bwd::dq_wgmma_kernel): the products on the
// tensor cores, as FA3's backward computes them. Per 64 x 64 (key, query)
// tile the dK/dV kernel takes S^T = K Q^T and dP^T = V dO^T by wgmma
// (both operands K-major in the 128-byte swizzled layout of the forward's
// `wg::` helpers), P^T = 2^(S^T scale log2(e) - lse log2(e)) (0 where
// masked; the rule only on tiles that reach past the diagonal, the window
// or the edges), dS^T = P^T (dP^T - delta) in fp32 registers, then dV +=
// P^T dO and dK += dS^T Q by wgmma with P^T and dS^T as register A
// operands and dO, Q MN-major through the descriptor's transpose bit; the
// dQ kernel recomputes S and dP (7 products a pair against the least 5:
// the price of a dQ without atomics) and does dQ += dS K. P^T and dS^T go
// to the tensor cores in two bf16 parts (hi + lo, a second product on the
// residual): one bf16 rounding broke the bf16 gates (1e-2 + 1e-2) at
// single dV, dK elements of long causal rows on the card, and the CPU
// model of the arithmetic (tests/test_torch_lm_train.py::_wgmma_model)
// fails them without the low part. The streamed tiles come by TMA into a
// ring of two stages (see tma_stage), unaligned views by load_tile. A block
// holds 64 rows and one warpgroup at D <= 128 (three blocks an SM at D 64,
// two at D 128); at D 256 two warpgroups split the 256 columns of dK, dV
// (dQ) and swap S and dP through shared memory, one block an SM
// (231,440 bytes). Registers on the H100, 0 spills: dK/dV 165-167, 239-240,
// 242-244; dQ 122-125, 154-157, 143-145 at D <= 64, 128, 256. Tried on the
// card and dropped (smollm's shape, A/B in one call, probe builds not
// kept): two warpgroups of 64 keys sharing a block's loads, in lockstep
// behind its barriers (slower than a warpgroup a block); issuing the next
// step's S / dP ahead of this one's gradients (ptxas serialised every
// wgmma, C7515: slower); the exponentials overlapping the dP product
// inside a step (no gain); rings of three and four stages (slower: fewer
// blocks an SM); 16-byte cp.async for the streamed tiles (their issue
// took a larger share of a D 64 step than any product: slower than TMA).
//
// fp32 (bwd::dkdv_kernel, bwd::dq_kernel): PR 17's kernels, unchanged:
// tensor cores would need TF32, which breaks the fp32 bound (1e-4 + 1e-3).
// fp32 FMAs on the SIMT pipes: one block of 256 threads (16 x 16) a BK-key
// tile (64 keys, 32 at D > 128, where fp32 copies of four 64-row operands
// would not fit 227 KB: static_asserts in `launch` hold every instance to
// it) recomputes S and dP from transposed fp32 copies of q (scaled), dO,
// k and v in shared memory (rows padded to 65 or 33 floats); 7 D FMAs a
// visible pair at one shared load per two FMAs: 6.83 ms at smollm's shape
// (PERF.md). Rows with no visible key get p = 0 in both (the forward
// averages their keys; the test shapes stay out of that regime).
#include <cuda.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30

namespace simt {

constexpr int kBQ = 64;                     // queries a block
constexpr int kBK = 64;                     // keys a tile
constexpr int kThreads = 256;               // 16 x 16
constexpr int kRows = kBQ / 16;             // score / output rows a thread
constexpr int kCols = kBK / 16;             // score columns a thread
constexpr int kLdQ = kBQ + 1;               // padded rows of sQ, sK, sP
constexpr int kLdK = kBK + 1;
constexpr int kLdP = kBK + 1;

// ND = accumulator columns a thread (head dim rounded up to 16, over 16);
// PREFIX: the causal rule is widened by prefix_len (else prefix_len unread);
// LSE: each stored row's log-sum-exp goes to lse (else lse unread).
template <int ND, bool PREFIX, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S, int Tk, int H,
                     int G, int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh,
                     int vsb, int vss, int vsh, int causal, int window, int prefix_len,
                     float scale, float* __restrict__ lse) {
  constexpr int DP = ND * 16;  // row stride of sV; columns D..DP-1 are 0
  extern __shared__ float smem[];
  float* sQ = smem;             // (D, kLdQ): q^T, scaled
  float* sK = sQ + D * kLdQ;    // (D, kLdK): k^T of the tile
  float* sV = sK + D * kLdK;    // (kBK, DP)
  float* sP = sV + kBK * DP;    // (kBQ, kLdP): probabilities of the tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = q + static_cast<int64_t>(b) * qsb + static_cast<int64_t>(h) * qsh;
  const float* kb = k + static_cast<int64_t>(b) * ksb + static_cast<int64_t>(h / G) * ksh;
  const float* vb = v + static_cast<int64_t>(b) * vsb + static_cast<int64_t>(h / G) * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int pos = q0 + r;
    sQ[d * kLdQ + r] = pos < S ? qb[static_cast<int64_t>(pos) * qss + d] * scale : 0.f;
  }

  // key tiles with any visible key for some row of this query tile
  const int q_last = min(S, q0 + kBQ) - 1;
  int k_end = Tk;
  if (causal) k_end = min(k_end, PREFIX ? max(q_last + 1, prefix_len) : q_last + 1);
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first key row q0 can see
    if (lo > 0) k_begin = (lo / kBK) * kBK;
  }

  float m[kRows], l[kRows], acc[kRows][ND];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, Tk - k0);
    __syncthreads();  // sQ written; the previous tile's sK, sV, sP read
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int c = i / DP;
      const int d = i - c * DP;
      float kv = 0.f;
      float vv = 0.f;
      if (c < nk && d < D) {
        kv = kb[static_cast<int64_t>(k0 + c) * kss + d];
        vv = vb[static_cast<int64_t>(k0 + c) * vss + d];
      }
      if (d < D) sK[d * kLdK + c] = kv;
      sV[c * DP + d] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = sQ[d * kLdQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = sK[d * kLdK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        bool visible = true;
        if (causal) visible = kpos <= qpos || (PREFIX && kpos < prefix_len);
        if (window > 0) visible = visible && (qpos - kpos < window);
        if (!visible) s[i][j] = kNegInf;
        if (c >= nk) s[i][j] = -INFINITY;  // no such key: p = 0 below
        mt = fmaxf(mt, s[i][j]);
      }
      mt = rt::half_warp_max(mt);
      const float m_new = fmaxf(m[i], mt);  // >= NEG_INF: finite
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        ls += p;
      }
      ls = rt::half_warp_sum(ls);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + ls;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= corr[i];
    for (int c = 0; c < nk; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sP[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float vv = sV[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<int64_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = acc[i][j] / den;
    }
    // m is in units of the scaled scores (sQ holds q scale)
    if (LSE && tx == 0) lse[(static_cast<int64_t>(b) * H + h) * S + qpos] = m[i] + logf(den);
  }
}

// q^T, k^T (padded rows), v (columns rounded up to 16) and the P tile
inline size_t smem_bytes(int D, int nd) {
  return sizeof(float) * (static_cast<size_t>(D) * (kLdQ + kLdK) +
                          static_cast<size_t>(kBK) * nd * 16 + static_cast<size_t>(kBQ) * kLdP);
}

template <int ND, bool PREFIX, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int Tk, int H, int K, int D, int qsb, int qss, int qsh, int ksb,
                   int kss, int ksh, int vsb, int vss, int vsh, int causal, int window,
                   int prefix_len, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, ND);
  auto kernel = flash_forward_kernel<ND, PREFIX, LSE>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, Tk, H, H / K, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
      causal, window, prefix_len, scale, lse);
  return cudaGetLastError();
}

template <bool PREFIX, bool LSE>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int S, int Tk, int H, int K, int D, int qsb, int qss, int qsh, int ksb,
                     int kss, int ksh, int vsb, int vss, int vsh, int causal, int window,
                     int prefix_len, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<4, PREFIX, LSE>(q, k, v, o, lse, B, S, Tk, H, K, D, qsb, qss, qsh, ksb, kss,
                                  ksh, vsb, vss, vsh, causal, window, prefix_len, scale, stream);
  if (D <= 128)
    return launch<8, PREFIX, LSE>(q, k, v, o, lse, B, S, Tk, H, K, D, qsb, qss, qsh, ksb, kss,
                                  ksh, vsb, vss, vsh, causal, window, prefix_len, scale, stream);
  return launch<16, PREFIX, LSE>(q, k, v, o, lse, B, S, Tk, H, K, D, qsb, qss, qsh, ksb, kss,
                                 ksh, vsb, vss, vsh, causal, window, prefix_len, scale, stream);
}

}  // namespace simt

namespace wg {

constexpr int kBK = 64;        // keys a tile
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16
constexpr int kAtomBytes = 1024;  // 8 rows of 128 B, the swizzle's period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c8 of row r in a tile of R rows whose columns
// come in blocks of 64 (one 128-byte row each): block-major, rows of 128 B,
// chunks XOR-swizzled by r % 8 (CU_TENSOR_MAP_SWIZZLE_128B's layout).
template <int R>
__device__ __forceinline__ uint32_t swizzled(int r, int c8) {
  return (c8 >> 3) * (R * kRowBytes) + r * kRowBytes + (((c8 & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset 16 B (unused: one swizzle atom spans each operand's 64-wide
// contiguous extent), stride byte offset 1024 B (the next 8 rows).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, made visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching accumulator registers across a wgmma
// that is still in flight.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, A (64 x 16) and B (16 x 64) both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A (64 x 16) in registers, B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x (MUFU.EX2, flush to zero): the softmax's exponential, in base 2
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copies rows r0 .. r0 + R - 1 (those below nrows; the rest, and columns
// D .. DP - 1, as zeros) of a (rows, D) bf16 view with row stride rs into
// the swizzled tile at dst: by 16-byte cp.async when vec, else element by
// element with plain loads and stores.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int r0,
                                          int nrows, int rs, int D, int vec, int tid) {
  constexpr int C8 = DP / 8;  // 16-byte chunks a row
  for (int i = tid; i < R * C8; i += NT) {
    const int r = i / C8;
    const int c8 = i - r * C8;
    const int row = r0 + r;
    const uint32_t at = dst + swizzled<R>(r, c8);
    if (vec) {
      const bool ok = row < nrows && c8 * 8 < D;
      const __nv_bfloat16* p = ok ? src + static_cast<int64_t>(row) * rs + c8 * 8 : src;
      cp_async16(at, p, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t pair = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c8 * 8 + 2 * j + e;
          if (row < nrows && col < D)
            pair |= static_cast<uint32_t>(__bfloat16_as_ushort(
                        src[static_cast<int64_t>(row) * rs + col]))
                    << (16 * e);
        }
        w[j] = pair;
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(w[0]), "r"(w[1]),
                   "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// The Q tile, two stages of (K, V) of SUB key tiles each, and slack to
// align to the swizzle atom.
template <int DP, int NWG, int SUB>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(64 * NWG * DP * 2) + 4 * static_cast<size_t>(SUB * kBK * DP * 2) +
         kAtomBytes;
}

// S = Q K^T of one warpgroup: sQw its 64 rows of the Q tile (column blocks
// BQ rows apart), sK the key tile (column blocks KR rows apart). All DP / 16
// steps of 16 run: the columns past D are zeros.
template <int DP, int BQ, int KR>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sQw, uint32_t sK) {
  const uint64_t dq = descriptor(sQw);
  const uint64_t dk = descriptor(sK);
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 columns = 32 B into the row
    wgmma_ss(s, dq + (((ks / 4) * (BQ * kRowBytes) + off) >> 4),
             dk + (((ks / 4) * (KR * kRowBytes) + off) >> 4), ks > 0);
  }
}

// O += P V: P the A fragments of four steps of 16 keys, sV the value tile
// (column blocks KR rows apart).
template <int DC, int KR>
__device__ __forceinline__ void issue_pv(float (&acc)[DC][32], const uint32_t (&pa)[4][4],
                                         uint32_t sV) {
  const uint64_t dv = descriptor(sV);
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[c], pa[kk], dv + ((c * (KR * kRowBytes) + kk * 16 * kRowBytes) >> 4));
}

// The online softmax of one score tile of a warpgroup (the thread's rows
// qrow, qrow + 8; keys k0 + column): the mask where need_mask, the new row
// max m, the correction corr of the old O and l, P in bf16 as the A
// fragments of four k16 steps (the accumulator's columns 16 kk .. 16 kk + 15
// are exactly A's k range of step kk), and l += the rounded P.
template <bool PREFIX>
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint32_t (&pa)[4][4], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], bool need_mask,
                                             int qrow, int k0, int lane, int Tk, int causal,
                                             int window, int prefix_len, float scale_log2) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int i = (x >> 1) & 1;
    if (need_mask) {
      const int qpos = qrow + 8 * i;
      const int kpos = k0 + (x >> 2) * 8 + (lane & 3) * 2 + (x & 1);
      bool visible = true;
      if (causal) visible = kpos <= qpos || (PREFIX && kpos < prefix_len);
      if (window > 0) visible = visible && (qpos - kpos < window);
      if (!visible) s[x] = kNegInf;
      if (kpos >= Tk) s[x] = -INFINITY;  // no such key: p = 0 below
    }
    mt[i] = fmaxf(mt[i], s[x]);
  }
  float ms[2];  // the new max, scaled
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    const float m_new = fmaxf(m[i], mt[i]);  // >= NEG_INF: finite
    corr[i] = ex2((m[i] - m_new) * scale_log2);
    m[i] = m_new;
    ms[i] = m_new * scale_log2;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int x = 8 * kk + 2 * r;  // r = 0, 2: row qrow; 1, 3: qrow + 8
      const int i = r & 1;
      const float p0 = ex2(fmaf(s[x], scale_log2, -ms[i]));
      const float p1 = ex2(fmaf(s[x + 1], scale_log2, -ms[i]));
      l[i] += p0 + p1;
      const __nv_bfloat162 p = __floats2bfloat162_rn(p0, p1);  // .x in the low half
      pa[kk][r] = *reinterpret_cast<const uint32_t*>(&p);
    }
}

template <int DC>
__device__ __forceinline__ void rescale(float (&acc)[DC][32], const float (&corr)[2]) {
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    fence_regs(acc[c]);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] *= corr[(x >> 1) & 1];
  }
}

// DP: padded head dim (64, 128, 256); NWG: consumer warpgroups of 64 rows;
// SUB: 64-key tiles a load stage holds (2 halves the block barriers; 1 at
// D > 128, where two stages of 128 keys would not fit); PREFIX: the causal
// rule is widened by prefix_len (else prefix_len unread); LSE: each stored
// row's log-sum-exp goes to lse (else lse unread).
template <int DP, int NWG, int MINB, int SUB, bool PREFIX, bool LSE>
__global__ void __launch_bounds__(NWG * 128, MINB)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                   int Tk, int H, int G, int D, int qsb, int qss, int qsh, int ksb, int kss,
                   int ksh, int vsb, int vss, int vsh, int causal, int window,
                   int prefix_len, int vec, float scale_log2, float* __restrict__ lse) {
  constexpr int BQ = 64 * NWG;
  constexpr int NT = 128 * NWG;
  constexpr int DC = DP / 64;    // 64-column blocks of the head dim
  constexpr int KR = SUB * kBK;  // key rows a stage
  constexpr uint32_t kQBytes = BQ * DP * 2;
  constexpr uint32_t kStageBytes = KR * DP * 2;  // K or V of one stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + kAtomBytes - 1) & ~(kAtomBytes - 1u);
  // stage st: K at sKV + 2 st kStageBytes, V right after it
  const uint32_t sKV = sQ + kQBytes;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // this thread's warpgroup
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heavy tiles first
  const int q0 = qt * BQ;
  const int qw0 = q0 + 64 * wgi;  // first row of this warpgroup
  const uint32_t sQw = sQ + wgi * 64 * kRowBytes;
  const int qrow = qw0 + warp * 16 + lane / 4;  // this thread's rows: qrow, qrow + 8
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * qsb + static_cast<int64_t>(h) * qsh;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * ksb + static_cast<int64_t>(h / G) * ksh;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * vsb + static_cast<int64_t>(h / G) * vsh;

  // key tiles with any visible key for some row of this block
  int k_end = Tk;
  if (causal) k_end = min(k_end, PREFIX ? max(min(S, q0 + BQ), prefix_len) : min(S, q0 + BQ));
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first key row q0 can see
    if (lo > 0) k_begin = (lo / kBK) * kBK;
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int n_stages = (n_tiles + SUB - 1) / SUB;
  // the rows of this warpgroup, as a 64-row TPU block would bound them
  const int w_last = min(S, qw0 + 64) - 1;
  const int w_first_key = qw0 - window + 1;

  load_tile<BQ, DP, NT>(sQ, qb, q0, S, qss, D, vec, tid);
  if (n_stages > 0) {
    load_tile<KR, DP, NT>(sKV, kb, k_begin, Tk, kss, D, vec, tid);
    load_tile<KR, DP, NT>(sKV + kStageBytes, vb, k_begin, Tk, vss, D, vec, tid);
  }
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;

  for (int u = 0; u < n_stages; ++u) {
    const uint32_t sK0 = sKV + (u & 1) * 2 * kStageBytes;
    const uint32_t sV0 = sK0 + kStageBytes;
    cp_async_wait_all();  // Q and this stage have landed (this thread's part)
    fence_async_shared();
    // every thread's part has landed, and every warpgroup is done with the
    // previous stage, which the next stage's loads now refill
    __syncthreads();
    if (u + 1 < n_stages) {
      const uint32_t nK = sKV + ((u + 1) & 1) * 2 * kStageBytes;
      const int r0 = k_begin + (u + 1) * KR;
      load_tile<KR, DP, NT>(nK, kb, r0, Tk, kss, D, vec, tid);
      load_tile<KR, DP, NT>(nK + kStageBytes, vb, r0, Tk, vss, D, vec, tid);
      cp_async_commit();
    }
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const int k0 = k_begin + (u * SUB + sub) * kBK;
      // a tile past this warpgroup's diagonal runs when it starts inside
      // the prefix; one that reaches past the diagonal needs the causal rule
      // unless it lies wholly inside the prefix
      const bool run = k0 < k_end && qw0 < S &&
                       (!causal || k0 <= w_last || (PREFIX && k0 < prefix_len)) &&
                       (window <= 0 || k0 + kBK - 1 >= w_first_key);
      if (!run) continue;
      const bool need_mask = k0 + kBK > Tk ||
                             (causal && k0 + kBK - 1 > qw0 &&
                              (!PREFIX || k0 + kBK > prefix_len)) ||
                             (window > 0 && qw0 + 63 - k0 >= window);
      float s[32];
      float corr[2];
      uint32_t pa[4][4];
      fence_regs(s);
      wgmma_fence();
      issue_qk<DP, BQ, KR>(s, sQw, sK0 + sub * kBK * kRowBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      softmax_tile<PREFIX>(s, pa, m, l, corr, need_mask, qrow, k0, lane, Tk, causal, window,
                   prefix_len, scale_log2);
      rescale<DC>(acc, corr);
      wgmma_fence();
      issue_pv<DC, KR>(acc, pa, sV0 + sub * kBK * kRowBytes);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
    }
  }

  if (qw0 >= S) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow + 8 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // m is a raw score and l sums powers of 2: natural units are
    // (m scale log2(e) + log2 l) ln 2
    if (LSE && (lane & 3) == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qpos] =
          (m[i] * scale_log2 + log2f(den)) * 0.6931471805599453f;
    __nv_bfloat16* orow = o + ((static_cast<int64_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = c * 64 + nb * 8 + (lane & 3) * 2;
        const float lo = acc[c][nb * 4 + 2 * i] / den;
        const float hi = acc[c][nb * 4 + 2 * i + 1] / den;
        if (col + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(lo, hi);
        } else {
          if (col < D) orow[col] = __float2bfloat16(lo);
          if (col + 1 < D) orow[col + 1] = __float2bfloat16(hi);
        }
      }
  }
}

template <int DP, int NWG, int MINB, int SUB, bool PREFIX, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int Tk, int H, int K, int D, int qsb, int qss, int qsh, int ksb,
                   int kss, int ksh, int vsb, int vss, int vsh, int causal, int window,
                   int prefix_len, int vec, float scale, cudaStream_t stream) {
  constexpr int BQ = 64 * NWG;
  constexpr size_t smem = smem_bytes<DP, NWG, SUB>();
  const int n_q = (S + BQ - 1) / BQ;
  if (n_q > 65535 || static_cast<int64_t>(B) * H > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<DP, NWG, MINB, SUB, PREFIX, LSE>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, n_q);
  kernel<<<grid, 128 * NWG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, Tk, H, H / K, D,
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, window, prefix_len, vec,
      scale * 1.4426950408889634f, lse);
  return cudaGetLastError();
}

template <bool PREFIX, bool LSE>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int S, int Tk, int H, int K, int D, int qsb, int qss, int qsh, int ksb,
                     int kss, int ksh, int vsb, int vss, int vsh, int causal, int window,
                     int prefix_len, int vec, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<64, 2, 2, 2, PREFIX, LSE>(q, k, v, o, lse, B, S, Tk, H, K, D, qsb, qss, qsh,
                                            ksb, kss, ksh, vsb, vss, vsh, causal, window,
                                            prefix_len, vec, scale, stream);
  if (D <= 128)
    return launch<128, 2, 1, 2, PREFIX, LSE>(q, k, v, o, lse, B, S, Tk, H, K, D, qsb, qss, qsh,
                                             ksb, kss, ksh, vsb, vss, vsh, causal, window,
                                             prefix_len, vec, scale, stream);
  return launch<256, 1, 1, 1, PREFIX, LSE>(q, k, v, o, lse, B, S, Tk, H, K, D, qsb, qss, qsh,
                                           ksb, kss, ksh, vsb, vss, vsh, causal, window,
                                           prefix_len, vec, scale, stream);
}

}  // namespace wg

namespace bwd {

constexpr int kBQ = 64;         // query rows a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLdQ = kBQ + 1;   // padded rows of sQ, sO

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d] in fp32: a warp a
// row, lanes over d, summed by shuffles (the same bits every run).
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int B, int S, int H, int D, int osb, int oss, int osh, int dsb, int dss, int dsh) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(B) * H * S) return;  // the whole warp
  const int i = static_cast<int>(row % S);
  const int64_t bh = row / S;
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);
  const T* orow = o + static_cast<int64_t>(b) * osb + static_cast<int64_t>(i) * oss +
                  static_cast<int64_t>(h) * osh;
  const T* drow = dout + static_cast<int64_t>(b) * dsb + static_cast<int64_t>(i) * dss +
                  static_cast<int64_t>(h) * dsh;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
  acc = rt::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// Rows r0 .. r0 + R - 1 of a (nrows, D) view with row stride rs, times
// `scale`, into dst transposed in fp32: dst[d * (R + 1) + r]; rows past
// nrows and columns D .. DP - 1 are zeros.
template <int R, int DP, typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src, int r0, int nrows, int rs,
                                       int D, float scale, int tid) {
  for (int i = tid; i < R * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i - r * DP;
    const int row = r0 + r;
    dst[d * (R + 1) + r] =
        (row < nrows && d < D) ? to_f(src[static_cast<int64_t>(row) * rs + d]) * scale : 0.f;
  }
}

// lse and delta of rows q0 .. q0 + kBQ - 1 of (b, h) ((B, H, S) fp32), 0
// past S.
__device__ __forceinline__ void load_rows(float* sL, float* sD, const float* lse,
                                          const float* delta, int64_t bh, int q0, int S,
                                          int tid) {
  for (int i = tid; i < kBQ; i += kThreads) {
    const int pos = q0 + i;
    const int64_t at = bh * S + pos;
    sL[i] = pos < S ? lse[at] : 0.f;
    sD[i] = pos < S ? delta[at] : 0.f;
  }
}

// The score tile of one (query tile, key tile) pair: s = (q scale) . k and
// dp = dO . v over d < D, p = exp(s - lse) where the pair is visible (else
// 0), dS = p (dp - delta); rows ty + 16 i, keys tx + 16 j of this thread.
// Writes dS into sS and, when sP is not null, p into sP ((kBQ, BK + 1)).
template <int BK, bool PREFIX>
__device__ __forceinline__ void score_tile(const float* sQ, const float* sO, const float* sK,
                                           const float* sV, const float* sL, const float* sD,
                                           float* sP, float* sS, int q0, int k0, int S, int Tk,
                                           int D, int causal, int window, int prefix_len,
                                           int tx, int ty) {
  constexpr int KC = BK / 16;
  constexpr int LK = BK + 1;
  float s[4][KC], dp[4][KC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KC; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], bk[KC], bv[KC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sQ[d * kLdQ + ty + 16 * i];
      g[i] = sO[d * kLdQ + ty + 16 * i];
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      bk[j] = sK[d * LK + tx + 16 * j];
      bv[j] = sV[d * LK + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      bool visible = qpos < S && kpos < Tk;
      if (causal) visible = visible && (kpos <= qpos || (PREFIX && kpos < prefix_len));
      if (window > 0) visible = visible && (qpos - kpos < window);
      const float p = visible ? expf(s[i][j] - sL[r]) : 0.f;
      if (sP != nullptr) sP[r * LK + c] = p;
      sS[r * LK + c] = p * (dp[i][j] - sD[r]);
    }
  }
}

template <int ND, int BK>
constexpr size_t dkdv_smem_bytes() {
  // q^T, dO^T (DP, kLdQ); k^T, v^T (DP, BK + 1); P, dS (kBQ, BK + 1); lse, delta
  return sizeof(float) * (2 * ND * 16 * kLdQ + 2 * ND * 16 * (BK + 1) + 2 * kBQ * (BK + 1) +
                          2 * kBQ);
}

template <int ND, int BK>
constexpr size_t dq_smem_bytes() {
  // q^T, dO^T (DP, kLdQ); k^T, v^T (DP, BK + 1); dS (kBQ, BK + 1); lse, delta
  return sizeof(float) * (2 * ND * 16 * kLdQ + 2 * ND * 16 * (BK + 1) + kBQ * (BK + 1) +
                          2 * kBQ);
}

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may have on the H100

// dK and dV of one (b, kv head, BK-key tile): loops over the G query heads
// of the kv head and the query tiles that see a key of the tile, and keeps
// dK, dV (BK x DP fp32) in registers: key rows ty + 16 i, columns tx + 16 j
// of this thread. Each element is written once.
template <int ND, int BK, bool PREFIX, typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
            int Tk, int H, int K, int G, int D, int qsb, int qss, int qsh, int ksb, int kss,
            int ksh, int vsb, int vss, int vsh, int dsb, int dss, int dsh, int causal,
            int window, int prefix_len, float scale) {
  constexpr int DP = ND * 16;
  constexpr int KC = BK / 16;
  constexpr int LK = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;              // (DP, kLdQ): q^T scaled
  float* sO = sQ + DP * kLdQ;    // (DP, kLdQ): dO^T
  float* sK = sO + DP * kLdQ;    // (DP, LK): k^T of the tile
  float* sV = sK + DP * LK;      // (DP, LK): v^T of the tile
  float* sP = sV + DP * LK;      // (kBQ, LK)
  float* sS = sP + kBQ * LK;     // (kBQ, LK): dS
  float* sL = sS + kBQ * LK;     // (kBQ): lse
  float* sD = sL + kBQ;          // (kBQ): delta

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t kvo = static_cast<int64_t>(b) * ksb + static_cast<int64_t>(kh) * ksh;
  load_t<BK, DP>(sK, k + kvo, k0, Tk, kss, D, 1.f, tid);
  load_t<BK, DP>(sV, v + static_cast<int64_t>(b) * vsb + static_cast<int64_t>(kh) * vsh, k0, Tk,
                 vss, D, 1.f, tid);

  // query rows that see some key of this tile: from the tile's diagonal
  // under the causal rule (every row when the tile starts inside the
  // prefix), up to the window's reach past its last key
  int q_begin = 0;
  if (causal && !(PREFIX && k0 < prefix_len)) q_begin = (k0 / kBQ) * kBQ;
  int q_end = S;
  if (window > 0) q_end = min(q_end, k0 + BK - 1 + window);

  float aK[KC][ND], aV[KC][ND];
#pragma unroll
  for (int i = 0; i < KC; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) aK[i][j] = aV[i][j] = 0.f;

  for (int h = kh * G; h < (kh + 1) * G; ++h) {
    const T* qb = q + static_cast<int64_t>(b) * qsb + static_cast<int64_t>(h) * qsh;
    const T* db = dout + static_cast<int64_t>(b) * dsb + static_cast<int64_t>(h) * dsh;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // the previous tile's sQ, sO, sP, sS read
      load_t<kBQ, DP>(sQ, qb, q0, S, qss, D, scale, tid);
      load_t<kBQ, DP>(sO, db, q0, S, dss, D, 1.f, tid);
      load_rows(sL, sD, lse, delta, static_cast<int64_t>(b) * H + h, q0, S, tid);
      __syncthreads();
      score_tile<BK, PREFIX>(sQ, sO, sK, sV, sL, sD, sP, sS, q0, k0, S, Tk, D, causal, window,
                             prefix_len, tx, ty);
      __syncthreads();
      // dV += P^T dO, dK += dS^T (q scale)
      for (int r = 0; r < kBQ; ++r) {
        float p[KC], ds[KC], g[ND], a[ND];
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          p[i] = sP[r * LK + ty + 16 * i];
          ds[i] = sS[r * LK + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          g[j] = sO[(tx + 16 * j) * kLdQ + r];
          a[j] = sQ[(tx + 16 * j) * kLdQ + r];
        }
#pragma unroll
        for (int i = 0; i < KC; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            aV[i][j] = fmaf(p[i], g[j], aV[i][j]);
            aK[i][j] = fmaf(ds[i], a[j], aK[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Tk) continue;
    const int64_t at = ((static_cast<int64_t>(b) * Tk + kpos) * K + kh) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk[at + d] = from_f<T>(aK[i][j]);
        dv[at + d] = from_f<T>(aV[i][j]);
      }
    }
  }
}

// dQ of one (b, head, 64-query tile): loops over the key tiles the tile's
// rows see (the forward's bounds), dQ (64 x DP fp32) in registers: rows
// ty + 16 i, columns tx + 16 j of this thread; written once, times scale.
template <int ND, int BK, bool PREFIX, typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int S, int Tk, int H, int G,
          int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh, int vsb, int vss,
          int vsh, int dsb, int dss, int dsh, int causal, int window, int prefix_len,
          float scale) {
  constexpr int DP = ND * 16;
  constexpr int LK = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;              // (DP, kLdQ): q^T scaled
  float* sO = sQ + DP * kLdQ;    // (DP, kLdQ): dO^T
  float* sK = sO + DP * kLdQ;    // (DP, LK): k^T of the tile
  float* sV = sK + DP * LK;      // (DP, LK): v^T of the tile
  float* sS = sV + DP * LK;      // (kBQ, LK): dS
  float* sL = sS + kBQ * LK;     // (kBQ): lse
  float* sD = sL + kBQ;          // (kBQ): delta

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // under the causal rule the last query tiles see the most keys: first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* kb = k + static_cast<int64_t>(b) * ksb + static_cast<int64_t>(h / G) * ksh;
  const T* vb = v + static_cast<int64_t>(b) * vsb + static_cast<int64_t>(h / G) * vsh;
  load_t<kBQ, DP>(sQ, q + static_cast<int64_t>(b) * qsb + static_cast<int64_t>(h) * qsh, q0, S,
                  qss, D, scale, tid);
  load_t<kBQ, DP>(sO, dout + static_cast<int64_t>(b) * dsb + static_cast<int64_t>(h) * dsh, q0,
                  S, dss, D, 1.f, tid);
  load_rows(sL, sD, lse, delta, static_cast<int64_t>(b) * H + h, q0, S, tid);

  // key tiles with a visible key for some row of this tile
  const int q_last = min(S, q0 + kBQ) - 1;
  int k_end = Tk;
  if (causal) k_end = min(k_end, PREFIX ? max(q_last + 1, prefix_len) : q_last + 1);
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first key row q0 can see
    if (lo > 0) k_begin = (lo / BK) * BK;
  }

  float acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // sQ, sO written; the previous tile's sK, sV, sS read
    load_t<BK, DP>(sK, kb, k0, Tk, kss, D, 1.f, tid);
    load_t<BK, DP>(sV, vb, k0, Tk, vss, D, 1.f, tid);
    __syncthreads();
    score_tile<BK, PREFIX>(sQ, sO, sK, sV, sL, sD, nullptr, sS, q0, k0, S, Tk, D, causal,
                           window, prefix_len, tx, ty);
    __syncthreads();
    // dQ += dS k
    for (int c = 0; c < BK; ++c) {
      float ds[4], kk[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(ty + 16 * i) * LK + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) kk[j] = sK[(tx + 16 * j) * LK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    T* row = dq + ((static_cast<int64_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = from_f<T>(acc[i][j] * scale);
    }
  }
}

// Key-tile width: 64, or 32 at D > 128, where the fp32 copies of q^T, dO^T,
// k^T and v^T of 64-row tiles would not fit in shared memory.
template <int ND>
constexpr int key_tile() {
  return ND > 8 ? 32 : 64;
}

template <int ND, bool PREFIX, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                   const float* delta, T* dq, T* dk, T* dv, int B, int S, int Tk, int H, int K,
                   int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh, int vsb, int vss,
                   int vsh, int dsb, int dss, int dsh, int causal, int window, int prefix_len,
                   float scale, cudaStream_t stream) {
  constexpr int BK = key_tile<ND>();
  static_assert(dkdv_smem_bytes<ND, BK>() <= kMaxSmem, "dK/dV tiles exceed shared memory");
  static_assert(dq_smem_bytes<ND, BK>() <= kMaxSmem, "dQ tiles exceed shared memory");
  const int G = H / K;
  if (Tk > 0) {
    auto kernel = dkdv_kernel<ND, BK, PREFIX, T>;
    constexpr size_t smem = dkdv_smem_bytes<ND, BK>();
    cudaError_t err = rt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Tk + BK - 1) / BK, K, B), kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, Tk, H, K, G, D, qsb, qss, qsh, ksb, kss, ksh, vsb,
        vss, vsh, dsb, dss, dsh, causal, window, prefix_len, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = dq_kernel<ND, BK, PREFIX, T>;
  constexpr size_t smem = dq_smem_bytes<ND, BK>();
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, Tk, H, G, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
      dsb, dss, dsh, causal, window, prefix_len, scale);
  return cudaGetLastError();
}

template <bool PREFIX, typename T>
cudaError_t dispatch(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                     const float* delta, T* dq, T* dk, T* dv, int B, int S, int Tk, int H, int K,
                     int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh, int vsb,
                     int vss, int vsh, int dsb, int dss, int dsh, int causal, int window,
                     int prefix_len, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<4, PREFIX, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb,
                                qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal,
                                window, prefix_len, scale, stream);
  if (D <= 128)
    return launch<8, PREFIX, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb,
                                qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal,
                                window, prefix_len, scale, stream);
  return launch<16, PREFIX, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb,
                               qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal,
                               window, prefix_len, scale, stream);
}

// ---- bf16: the five products on wgmma ----

constexpr float kLog2e = 1.4426950408889634f;

// (qpos, kpos) is a visible pair of stored rows and existing keys.
template <bool PREFIX>
__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int Tk, int causal, int window,
                                        int prefix_len) {
  bool vis = qpos < S && kpos < Tk;
  if (causal) vis = vis && (kpos <= qpos || (PREFIX && kpos < prefix_len));
  if (window > 0) vis = vis && (qpos - kpos < window);
  return vis;
}

// A pair of fp32 values (x0 in the low half) in two bf16 parts: hi =
// bf16(x), lo = bf16(x - hi), so that hi + lo is x within 2^-16 of it. One
// bf16 rounding of P^T or dS^T moves single dV, dK elements of long causal
// rows by up to the bf16 gates' bound (atol 1e-2 + rtol 1e-2) on the card;
// the low part's second product takes that away. Elements x, x + 1 (x = 8
// kk + 2 r) of an m64n64 accumulator fragment are register r of the A
// operand of k16 step kk (its columns 16 kk .. 16 kk + 15 are the step's k
// range, as in the forward's P V).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// lse and delta of rows r0 .. r0 + 63 of row block bh ((B, H, S) fp32)
// into sL[0 .. 63] and sL[64 .. 127] by 4-byte cp.async, 0 past S.
__device__ __forceinline__ void load_stats(uint32_t sL, const float* lse, const float* delta,
                                           int64_t bh, int r0, int S, int tid) {
  if (tid >= 128) return;
  const int pos = r0 + (tid & 63);
  const float* src = tid < 64 ? lse : delta;
  const bool ok = pos < S;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sL + 4 * tid),
               "l"(ok ? src + bh * S + pos : src), "r"(ok ? 4 : 0)
               : "memory");
}

// Writes rows (row, row + 8) x this warpgroup's DCW column blocks (from
// block c0) of an m64 accumulator, times mul, in bf16: dst + r * rs is row
// r; rows at or past nrows are dropped.
template <int DCW>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int64_t rs, const float (&acc)[DCW][32],
                                           int row, int nrows, int c0, int lane, int D,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= nrows) continue;
    __nv_bfloat16* out = dst + static_cast<int64_t>(row + 8 * i) * rs;
#pragma unroll
    for (int c = 0; c < DCW; ++c)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = (c0 + c) * 64 + nb * 8 + (lane & 3) * 2;
        const float lo = acc[c][nb * 4 + 2 * i] * mul;
        const float hi = acc[c][nb * 4 + 2 * i + 1] * mul;
        if (col + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(lo, hi);
        } else {
          if (col < D) out[col] = __float2bfloat16(lo);
          if (col + 1 < D) out[col + 1] = __float2bfloat16(hi);
        }
      }
  }
}

// A block owns 64 rows (keys of dK/dV, queries of dQ). SPLIT false: one
// warpgroup holds every column of their gradient, and several blocks share
// an SM, each at its own step (two warpgroups in one block, sharing its
// loads, ran in lockstep behind its barriers: slower on the H100). At D
// 64 the dK/dV kernel is held to 168 registers, three blocks an SM
// (faster than two, and 0 spills once dS is split into its fragments
// pair by pair); true (D 256): two warpgroups, warpgroup 0 computes S (or S^T),
// warpgroup 1 dP (dP^T), they swap the two fp32 fragments through shared
// memory (the same thread of each holds the same elements), and each
// keeps half the columns of the gradient.
constexpr uint32_t kSwapBytes = 2 * 32 * 128 * 4;  // two fp32 m64n64 fragments

// The streamed tiles (Q and dO for dK/dV, K and V for dQ) come by TMA when
// every row is 16-byte aligned and the views' strides grow with their dims
// (`tma`): one thread asks for each 64 x 64 box of a stage, and an
// mbarrier a stage counts the bytes in. Issuing them by 16-byte cp.async
// from every thread took a larger share of a D 64 step than any product
// on the H100 (per-phase clock64 stamps in a probe build). A tensor map
// is encoded on the host each call (the views are strided), over dims
// (D, heads, rows, batch) with 64 x 1 x 64 x 1 boxes in the 128-byte
// swizzled layout: the layout load_tile writes, so both routes give the
// same bits. The other tiles, loaded once a block, and every tile of an
// unaligned view go by load_tile.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival of the stage's phase, and the bytes its copies bring.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// The 64 x 64 box at (column x, head y, row z, batch w) of a map into dst.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                        int y, int z, int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(w), "r"(bar)
      : "memory");
}
// Both 64-row tiles of a stage (DP / 64 boxes each) at row r0 of head h.
template <int DP>
__device__ __forceinline__ void tma_stage(uint32_t dst, const CUtensorMap* a, const CUtensorMap* b,
                                          uint32_t bar, int h, int r0, int batch) {
  constexpr uint32_t kTile = 64 * DP * 2;
  mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
  for (int c = 0; c < DP / 64; ++c) {
    tma_box(dst + c * 64 * wg::kRowBytes, a, bar, c * 64, h, r0, batch);
    tma_box(dst + kTile + c * 64 * wg::kRowBytes, b, bar, c * 64, h, r0, batch);
  }
}

template <int DP, bool SPLIT>
constexpr size_t dkdv_wgmma_smem() {
  // K, V of the block's keys; two stages of Q, dO; the swap buffers; two
  // stages of lse, delta; two mbarriers; slack to align to the swizzle atom
  return 6 * static_cast<size_t>(64 * DP * 2) + (SPLIT ? kSwapBytes : 0) + 2 * 128 * 4 + 16 +
         wg::kAtomBytes;
}

template <int DP, bool SPLIT>
constexpr size_t dq_wgmma_smem() {
  // Q, dO of the block's rows; two stages of K, V; the swap buffers; two
  // mbarriers; slack
  return 6 * static_cast<size_t>(64 * DP * 2) + (SPLIT ? kSwapBytes : 0) + 16 + wg::kAtomBytes;
}

// The S / dP pair of one tile in both layouts: SPLIT hands warpgroup 0's
// fragment (in a) to warpgroup 1 and back through swap, so that on return
// s holds warpgroup 0's product and dp warpgroup 1's in both; else a and
// the second product are simply s and dp.
template <bool SPLIT>
__device__ __forceinline__ void swap_pair(float (&s)[32], float (&dp)[32], float* swap, int wgi,
                                          int t) {
  if constexpr (SPLIT) {
#pragma unroll
    for (int x = 0; x < 32; ++x) swap[wgi * 4096 + x * 128 + t] = s[x];
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float other = swap[(1 - wgi) * 4096 + x * 128 + t];
      dp[x] = wgi == 0 ? other : s[x];
      s[x] = wgi == 0 ? s[x] : other;
    }
  }
}

// dK and dV of one (b, kv head, 64-key tile): loops over the G query
// heads of the kv head and the 64-row query tiles that see a key of the
// tile (PR 17's bounds), Q, dO, lse and delta in a ring of two stages.
// Per tile: S^T = K Q^T and dP^T = V dO^T (wgmma, both K-major), P^T =
// 2^(S^T scale log2(e) - lse log2(e)) (0 where masked), dS^T = P^T (dP^T -
// delta), then dV += P^T dO and dK += dS^T Q (wgmma, P^T and dS^T in two
// bf16 parts as register A operands, dO and Q MN-major). dK, dV stay in
// fp32 registers, written once (dK times scale).
template <int DP, bool SPLIT, bool PREFIX>
__global__ void __launch_bounds__(SPLIT ? 256 : 128, SPLIT ? 1 : (DP == 64 ? 3 : 2))
dkdv_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int Tk,
                  int H, int K, int G, int D, int qsb, int qss, int qsh, int ksb, int kss,
                  int ksh, int vsb, int vss, int vsh, int dsb, int dss, int dsh, int causal,
                  int window, int prefix_len, int vec, int tma, float scale, float scale_log2,
                  const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_o) {
  constexpr int NT = SPLIT ? 256 : 128;
  constexpr int DC = DP / 64;
  constexpr int DCW = SPLIT ? DC / 2 : DC;  // column blocks of dK, dV a warpgroup keeps
  static_assert(!SPLIT || DC % 2 == 0, "the split halves the column blocks");
  constexpr uint32_t kQBytes = 64 * DP * 2;  // a 64-row tile of q, dO, k or v
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t sK = (raw + wg::kAtomBytes - 1) & ~(wg::kAtomBytes - 1u);
  const uint32_t sV = sK + kQBytes;
  const uint32_t sQ0 = sV + kQBytes;  // stage st: Q at sQ0 + 2 st kQBytes, dO after it
  const uint32_t sSwap = sQ0 + 4 * kQBytes;
  const uint32_t sStats = sSwap + (SPLIT ? kSwapBytes : 0);  // stage st: 128 floats
  const uint32_t sBar = sStats + 2 * 512;                     // stage st: an mbarrier
  float* swap = reinterpret_cast<float*>(smem_raw + (sSwap - raw));
  const float* stats = reinterpret_cast<const float*>(smem_raw + (sStats - raw));

  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kh = blockIdx.x % K;
  const int b = blockIdx.x / K;
  const int k0 = blockIdx.y * 64;  // under the causal rule the first key tiles are the heaviest
  const int krow = k0 + warp * 16 + lane / 4;  // this thread's keys: krow, krow + 8
  const int c0 = SPLIT ? wgi * DCW : 0;        // its first column block
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * ksb + static_cast<int64_t>(kh) * ksh;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * vsb + static_cast<int64_t>(kh) * vsh;

  // query rows that see some key of the tile: from its diagonal under the
  // causal rule (every row when it starts inside the prefix), up to the
  // window's reach past its last key
  int q_begin = 0;
  if (causal && !(PREFIX && k0 < prefix_len)) q_begin = k0;
  int q_end = S;
  if (window > 0) q_end = min(q_end, k0 + 63 + window);
  const int n_q = q_end > q_begin ? (q_end - q_begin + 63) / 64 : 0;
  const int n = G * n_q;  // (head, query tile) steps, heads outer

  auto load_stage = [&](int u) {
    const int h = kh * G + u / n_q;
    const int q0 = q_begin + (u % n_q) * 64;
    const uint32_t sQs = sQ0 + (u & 1) * 2 * kQBytes;
    if (tma) {
      if (tid == 0) tma_stage<DP>(sQs, &tm_q, &tm_o, sBar + (u & 1) * 8, h, q0, b);
    } else {
      wg::load_tile<64, DP, NT>(sQs,
                                q + static_cast<int64_t>(b) * qsb + static_cast<int64_t>(h) * qsh,
                                q0, S, qss, D, vec, tid);
      wg::load_tile<64, DP, NT>(
          sQs + kQBytes, dout + static_cast<int64_t>(b) * dsb + static_cast<int64_t>(h) * dsh, q0,
          S, dss, D, vec, tid);
    }
    load_stats(sStats + (u & 1) * 512, lse, delta, static_cast<int64_t>(b) * H + h, q0, S, tid);
  };
  if (tma && tid == 0) {
    mbar_init(sBar);
    mbar_init(sBar + 8);
    mbar_init_fence();
  }
  __syncthreads();
  wg::load_tile<64, DP, NT>(sK, kb, k0, Tk, kss, D, vec, tid);
  wg::load_tile<64, DP, NT>(sV, vb, k0, Tk, vss, D, vec, tid);
  if (n > 0) load_stage(0);
  wg::cp_async_commit();

  float ak[DCW][32], av[DCW][32];
#pragma unroll
  for (int c = 0; c < DCW; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) ak[c][x] = av[c][x] = 0.f;

  for (int u = 0; u < n; ++u) {
    const int q0 = q_begin + (u % n_q) * 64;
    const uint32_t sQs = sQ0 + (u & 1) * 2 * kQBytes;
    const uint32_t sOs = sQs + kQBytes;
    const float* sL = stats + (u & 1) * 128;
    wg::cp_async_wait_all();  // this step's tiles have landed (this thread's part)
    wg::fence_async_shared();
    // every thread's part has landed, and every warpgroup is done with the
    // previous step, whose stage the next step's loads now refill
    __syncthreads();
    if (tma) mbar_wait(sBar + (u & 1) * 8, (u >> 1) & 1);  // and this step's boxes
    if (u + 1 < n) {
      load_stage(u + 1);
      wg::cp_async_commit();
    }
    // the bounds skip no tile that a key of this one sees; the rule applies
    // where the tile reaches past the diagonal (beyond the prefix), the
    // window's edge, S or T
    const bool need_mask = q0 + 64 > S || k0 + 64 > Tk ||
                           (causal && k0 + 63 > q0 && (!PREFIX || k0 + 64 > prefix_len)) ||
                           (window > 0 && q0 + 63 - k0 >= window);
    float s[32], dp[32];
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::wgmma_fence();
    if constexpr (SPLIT) {  // S^T in warpgroup 0, dP^T in 1: the same code, other tiles
      wg::issue_qk<DP, 64, 64>(s, wgi ? sV : sK, wgi ? sOs : sQs);
    } else {
      wg::issue_qk<DP, 64, 64>(s, sK, sQs);
      wg::issue_qk<DP, 64, 64>(dp, sV, sOs);
    }
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(s);
    wg::fence_regs(dp);
    // P^T in place of S^T: rows are keys, columns queries q0 + nb 8 +
    // (lane & 3) 2 + e of this thread
    if (!SPLIT || wgi == 0) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int col = (x >> 2) * 8 + (lane & 3) * 2 + (x & 1);
        float p = wg::ex2(fmaf(s[x], scale_log2, -sL[col] * kLog2e));
        if (need_mask && !visible<PREFIX>(q0 + col, krow + 8 * ((x >> 1) & 1), S, Tk, causal,
                                          window, prefix_len))
          p = 0.f;
        s[x] = p;
      }
    }
    swap_pair<SPLIT>(s, dp, swap, wgi, tid % 128);
    // dS^T = P^T (dP^T - delta), pair by pair into its fragments beside
    // P^T's (each pair of P^T and dP^T dies as its fragments are made)
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * kk + 2 * r;
        const float* sD = sL + 64 + (x >> 2) * 8 + (lane & 3) * 2;
        split_bf16(s[x], s[x + 1], p_hi[kk][r], p_lo[kk][r]);
        split_bf16(s[x] * (dp[x] - sD[0]), s[x + 1] * (dp[x + 1] - sD[1]), ds_hi[kk][r],
                   ds_lo[kk][r]);
      }
#pragma unroll
    for (int c = 0; c < DCW; ++c) {
      wg::fence_regs(av[c]);
      wg::fence_regs(ak[c]);
    }
    wg::wgmma_fence();
    wg::issue_pv<DCW, 64>(av, p_hi, sOs + c0 * 64 * wg::kRowBytes);
    wg::issue_pv<DCW, 64>(av, p_lo, sOs + c0 * 64 * wg::kRowBytes);
    wg::issue_pv<DCW, 64>(ak, ds_hi, sQs + c0 * 64 * wg::kRowBytes);
    wg::issue_pv<DCW, 64>(ak, ds_lo, sQs + c0 * 64 * wg::kRowBytes);
    wg::wgmma_commit();
    wg::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DCW; ++c) {
      wg::fence_regs(av[c]);
      wg::fence_regs(ak[c]);
    }
  }
  wg::cp_async_wait_all();  // no copy in flight at exit (n == 0)

  const int64_t at = (static_cast<int64_t>(b) * Tk * K + kh) * D;
  store_rows<DCW>(dk + at, static_cast<int64_t>(K) * D, ak, krow, Tk, c0, lane, D, scale);
  store_rows<DCW>(dv + at, static_cast<int64_t>(K) * D, av, krow, Tk, c0, lane, D, 1.f);
}

// dQ of one (b, head, 64-query tile): loops over the forward's key
// tiles of 64 (K, V in a ring of two stages): S = Q K^T and dP = dO V^T
// (wgmma, K-major), P = 2^(S scale log2(e) - lse log2(e)) (0 where
// masked), dS = P (dP - delta), dQ += dS K (wgmma, dS in two bf16 parts
// as register A operands, K MN-major). dQ stays in fp32 registers, written
// once, times scale: no atomics, the same bits every run.
template <int DP, bool SPLIT, bool PREFIX>
__global__ void __launch_bounds__(SPLIT ? 256 : 128, SPLIT ? 1 : 2)
dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int S, int Tk, int H, int G, int D, int qsb,
                int qss, int qsh, int ksb, int kss, int ksh, int vsb, int vss, int vsh, int dsb,
                int dss, int dsh, int causal, int window, int prefix_len, int vec, int tma,
                float scale, float scale_log2, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v) {
  constexpr int NT = SPLIT ? 256 : 128;
  constexpr int DC = DP / 64;
  constexpr int DCW = SPLIT ? DC / 2 : DC;
  static_assert(!SPLIT || DC % 2 == 0, "the split halves the column blocks");
  constexpr uint32_t kKBytes = 64 * DP * 2;  // a 64-row tile of q, dO, k or v
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t sQ = (raw + wg::kAtomBytes - 1) & ~(wg::kAtomBytes - 1u);
  const uint32_t sO = sQ + kKBytes;
  const uint32_t sK0 = sO + kKBytes;  // stage st: K at sK0 + 2 st kKBytes, V after it
  const uint32_t sSwap = sK0 + 4 * kKBytes;
  const uint32_t sBar = sSwap + (SPLIT ? kSwapBytes : 0);  // stage st: an mbarrier
  float* swap = reinterpret_cast<float*>(smem_raw + (sSwap - raw));

  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heavy tiles first
  const int q0 = qt * 64;
  const int qrow = q0 + warp * 16 + lane / 4;  // this thread's rows: qrow, qrow + 8
  const int c0 = SPLIT ? wgi * DCW : 0;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * ksb + static_cast<int64_t>(h / G) * ksh;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * vsb + static_cast<int64_t>(h / G) * vsh;

  // key tiles with any visible key for some row of this tile (the forward's)
  int k_end = Tk;
  if (causal) k_end = min(k_end, PREFIX ? max(min(S, q0 + 64), prefix_len) : min(S, q0 + 64));
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first key row q0 can see
    if (lo > 0) k_begin = (lo / 64) * 64;
  }
  const int n = k_end > k_begin ? (k_end - k_begin + 63) / 64 : 0;

  // K and V of key tile u into its stage
  auto load_stage = [&](int u) {
    const uint32_t sKs = sK0 + (u & 1) * 2 * kKBytes;
    const int k0 = k_begin + u * 64;
    if (tma) {
      if (tid == 0) tma_stage<DP>(sKs, &tm_k, &tm_v, sBar + (u & 1) * 8, h / G, k0, b);
    } else {
      wg::load_tile<64, DP, NT>(sKs, kb, k0, Tk, kss, D, vec, tid);
      wg::load_tile<64, DP, NT>(sKs + kKBytes, vb, k0, Tk, vss, D, vec, tid);
    }
  };
  if (tma && tid == 0) {
    mbar_init(sBar);
    mbar_init(sBar + 8);
    mbar_init_fence();
  }
  __syncthreads();
  wg::load_tile<64, DP, NT>(sQ, q + static_cast<int64_t>(b) * qsb + static_cast<int64_t>(h) * qsh,
                            q0, S, qss, D, vec, tid);
  wg::load_tile<64, DP, NT>(sO,
                            dout + static_cast<int64_t>(b) * dsb + static_cast<int64_t>(h) * dsh,
                            q0, S, dss, D, vec, tid);
  if (n > 0) load_stage(0);
  wg::cp_async_commit();
  // lse log2(e) and delta of this thread's rows (0 past S)
  float l2[2], dl[2];
  const int64_t bh = static_cast<int64_t>(b) * H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow + 8 * i;
    l2[i] = qpos < S ? lse[bh * S + qpos] * kLog2e : 0.f;
    dl[i] = qpos < S ? delta[bh * S + qpos] : 0.f;
  }

  float acc[DCW][32];
#pragma unroll
  for (int c = 0; c < DCW; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;

  for (int u = 0; u < n; ++u) {
    const int k0 = k_begin + u * 64;
    const uint32_t sKs = sK0 + (u & 1) * 2 * kKBytes;
    const uint32_t sVs = sKs + kKBytes;
    wg::cp_async_wait_all();
    wg::fence_async_shared();
    __syncthreads();
    if (tma) mbar_wait(sBar + (u & 1) * 8, (u >> 1) & 1);
    if (u + 1 < n) {
      load_stage(u + 1);
      wg::cp_async_commit();
    }
    // rows past S are computed on zeros and dropped
    const bool need_mask = k0 + 64 > Tk ||
                           (causal && k0 + 63 > q0 && (!PREFIX || k0 + 64 > prefix_len)) ||
                           (window > 0 && q0 + 63 - k0 >= window);
    float s[32], dp[32];
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::wgmma_fence();
    if constexpr (SPLIT) {  // S in warpgroup 0, dP in 1
      wg::issue_qk<DP, 64, 64>(s, wgi ? sO : sQ, wgi ? sVs : sKs);
    } else {
      wg::issue_qk<DP, 64, 64>(s, sQ, sKs);
      wg::issue_qk<DP, 64, 64>(dp, sO, sVs);
    }
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(s);
    wg::fence_regs(dp);
    if (!SPLIT || wgi == 0) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        float p = wg::ex2(fmaf(s[x], scale_log2, -l2[i]));
        if (need_mask && !visible<PREFIX>(qrow + 8 * i,
                                          k0 + (x >> 2) * 8 + (lane & 3) * 2 + (x & 1), S, Tk,
                                          causal, window, prefix_len))
          p = 0.f;
        s[x] = p;
      }
    }
    swap_pair<SPLIT>(s, dp, swap, wgi, tid % 128);
    // dS = P (dP - delta), pair by pair into its fragments
    uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * kk + 2 * r;
        const float d = dl[r & 1];  // x's row: qrow + 8 (r & 1)
        split_bf16(s[x] * (dp[x] - d), s[x + 1] * (dp[x + 1] - d), ds_hi[kk][r], ds_lo[kk][r]);
      }
#pragma unroll
    for (int c = 0; c < DCW; ++c) wg::fence_regs(acc[c]);
    wg::wgmma_fence();
    wg::issue_pv<DCW, 64>(acc, ds_hi, sKs + c0 * 64 * wg::kRowBytes);
    wg::issue_pv<DCW, 64>(acc, ds_lo, sKs + c0 * 64 * wg::kRowBytes);
    wg::wgmma_commit();
    wg::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DCW; ++c) wg::fence_regs(acc[c]);
  }
  wg::cp_async_wait_all();

  store_rows<DCW>(dq + (static_cast<int64_t>(b) * S * H + h) * D, static_cast<int64_t>(H) * D,
                  acc, qrow, S, c0, lane, D, scale);
}

// Whether the head dim's instance splits the columns between its two
// warpgroups (D 256: 64 x 256 fp32 of dK and of dV would not fit one's
// registers).
template <int DP>
constexpr bool wgmma_split() {
  return DP > 128;
}

// Every row of a (n0, n1, n2, D) bf16 view with element strides s0, s1,
// s2 starts 16-byte aligned (the strides of dims of size 1 unread), as
// kernels/_lib.py::rows_aligned_16 decides for the forward.
inline bool rows_aligned_16(const void* p, int D, int n0, int s0, int n1, int s1, int n2, int s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && D % 8 == 0 && (n0 <= 1 || s0 % 8 == 0) &&
         (n1 <= 1 || s1 % 8 == 0) && (n2 <= 1 || s2 % 8 == 0);
}

// The tensor maps of the streamed tiles, when `tma`.
struct TileMaps {
  CUtensorMap q, o, k, v;
  int tma;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver (through the runtime: the library
// links no libcuda), or null.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of a (batch n3, rows n2, heads n1, D) bf16 view with element
// strides s3, s2, s1 over dims (D, heads, rows, batch), 64 x 1 x 64 x 1
// boxes, 128-byte swizzle, zeros past the edges. False (and no map) unless
// each dim's stride covers the dims inside it (a dim of size 1 takes the
// packed stride), as a tensor map wants.
inline bool encode_map(CUtensorMap* m, const void* p, int D, int n1, int s1, int n2, int s2,
                       int n3, int s3) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2), static_cast<cuuint64_t>(n3)};
  const int64_t strides[3] = {s1, s2, s3};
  cuuint64_t bytes[3];
  uint64_t extent = static_cast<uint64_t>(D) * 2;  // bytes the inner dims span
  for (int i = 0; i < 3; ++i) {
    uint64_t b = static_cast<uint64_t>(strides[i]) * 2;
    if (dims[i + 1] <= 1) b = (extent + 15) / 16 * 16;
    if (strides[i] < 0 || b % 16 != 0 || b < extent || b >= (1ull << 40)) return false;
    bytes[i] = b;
    extent = b * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, bytes, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, bool PREFIX>
cudaError_t launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         const __nv_bfloat16* dout, const float* lse, const float* delta,
                         __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int S,
                         int Tk, int H, int K, int D, int qsb, int qss, int qsh, int ksb, int kss,
                         int ksh, int vsb, int vss, int vsh, int dsb, int dss, int dsh,
                         int causal, int window, int prefix_len, int vec, const TileMaps& maps,
                         float scale, cudaStream_t stream) {
  constexpr bool SPLIT = wgmma_split<DP>();
  constexpr int NT = SPLIT ? 256 : 128;
  static_assert(dkdv_wgmma_smem<DP, SPLIT>() <= kMaxSmem, "dK/dV tiles exceed shared memory");
  static_assert(dq_wgmma_smem<DP, SPLIT>() <= kMaxSmem, "dQ tiles exceed shared memory");
  const int G = H / K;
  const float scale_log2 = scale * kLog2e;
  const int n_k = (Tk + 63) / 64;
  const int n_q = (S + 63) / 64;
  if (n_k > 65535 || n_q > 65535 || static_cast<int64_t>(B) * H > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (Tk > 0) {
    auto kernel = dkdv_wgmma_kernel<DP, SPLIT, PREFIX>;
    constexpr size_t smem = dkdv_wgmma_smem<DP, SPLIT>();
    cudaError_t err = rt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(B * K, n_k), NT, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, Tk, H, K, G, D, qsb, qss, qsh, ksb, kss, ksh, vsb,
        vss, vsh, dsb, dss, dsh, causal, window, prefix_len, vec, maps.tma, scale, scale_log2,
        maps.q, maps.o);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = dq_wgmma_kernel<DP, SPLIT, PREFIX>;
  constexpr size_t smem = dq_wgmma_smem<DP, SPLIT>();
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, n_q), NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, Tk, H, G, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
      dsb, dss, dsh, causal, window, prefix_len, vec, maps.tma, scale, scale_log2, maps.k,
      maps.v);
  return cudaGetLastError();
}

template <bool PREFIX>
cudaError_t dispatch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                           const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                           const float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk,
                           __nv_bfloat16* dv, int B, int S, int Tk, int H, int K, int D, int qsb,
                           int qss, int qsh, int ksb, int kss, int ksh, int vsb, int vss, int vsh,
                           int dsb, int dss, int dsh, int causal, int window, int prefix_len,
                           int vec, const TileMaps& maps, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_wgmma<64, PREFIX>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb,
                                    qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal,
                                    window, prefix_len, vec, maps, scale, stream);
  if (D <= 128)
    return launch_wgmma<128, PREFIX>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D,
                                     qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh,
                                     causal, window, prefix_len, vec, maps, scale, stream);
  return launch_wgmma<256, PREFIX>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb,
                                   qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal,
                                   window, prefix_len, vec, maps, scale, stream);
}

// The pre-pass, then dK/dV, then dQ, on `stream`; delta is scratch of
// B H S floats.
template <typename T>
int backward(const void* q_, const void* k_, const void* v_, const void* o_, const void* do_,
             const float* lse, float* delta, void* dq_, void* dk_, void* dv_, int B, int S,
             int Tk, int H, int K, int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh,
             int vsb, int vss, int vsh, int osb, int oss, int osh, int dsb, int dss, int dsh,
             int causal, int window, int prefix_len, float scale, cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || D <= 0 || D > 256 || Tk < 0 || window < 0 || prefix_len < 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(do_);
  const int64_t rows = static_cast<int64_t>(B) * H * S;
  constexpr int kRowsPerBlock = kThreads / 32;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o_), dout, delta, B, S, H, D, osb, oss, osh, dsb, dss, dsh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const int vec = rows_aligned_16(q, D, B, qsb, S, qss, H, qsh) &&
                    rows_aligned_16(k, D, B, ksb, Tk, kss, K, ksh) &&
                    rows_aligned_16(v, D, B, vsb, Tk, vss, K, vsh) &&
                    rows_aligned_16(dout, D, B, dsb, S, dss, H, dsh);
    TileMaps maps{};
    maps.tma = vec && encode_map(&maps.q, q, D, H, qsh, S, qss, B, qsb) &&
               encode_map(&maps.o, dout, D, H, dsh, S, dss, B, dsb) &&
               encode_map(&maps.k, k, D, K, ksh, Tk, kss, B, ksb) &&
               encode_map(&maps.v, v, D, K, vsh, Tk, vss, B, vsb);
    if (causal && prefix_len > 0)
      return dispatch_wgmma<true>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb,
                                  qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal,
                                  window, prefix_len, vec, maps, scale, stream);
    return dispatch_wgmma<false>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb,
                                 qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal,
                                 window, 0, vec, maps, scale, stream);
  } else {  // fp32: PR 17's FMA kernels
    if (causal && prefix_len > 0)
      return dispatch<true, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb, qss,
                               qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal, window,
                               prefix_len, scale, stream);
    return dispatch<false, T>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, H, K, D, qsb, qss,
                              qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh, causal, window, 0,
                              scale, stream);
  }
}

}  // namespace bwd


}  // namespace

// q: (B, S, H, D) with strides (qsb, qss, qsh, 1); k, v: (B, T, K, D) with
// strides (ksb, kss, ksh, 1) and (vsb, vss, vsh, 1); o: (B, S, H, D)
// contiguous; H % K == 0, 1 <= D <= 256; prefix_len >= 0 widens the causal
// rule (0: none; read only when causal); lse: null, or (B, H, S) fp32 for
// each row's log-sum-exp (natural log of the scaled, masked scores).
// fp32 on the FMA kernel.
extern "C" int rt_flash_attention_forward_f32(const void* q, const void* k, const void* v,
                                              void* o, void* lse, int B, int S, int T, int H,
                                              int K, int D, int qsb, int qss, int qsh, int ksb,
                                              int kss, int ksh, int vsb, int vss, int vsh,
                                              int causal, int window, int prefix_len,
                                              float scale, cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || D <= 0 || D > 256 || T < 0 || window < 0 || prefix_len < 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  const bool prefix = causal && prefix_len > 0;
  const int pl = prefix ? prefix_len : 0;
  if (prefix && l)
    return simt::dispatch<true, true>(q, k, v, o, l, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss,
                                      ksh, vsb, vss, vsh, causal, window, pl, scale, stream);
  if (prefix)
    return simt::dispatch<true, false>(q, k, v, o, l, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss,
                                       ksh, vsb, vss, vsh, causal, window, pl, scale, stream);
  if (l)
    return simt::dispatch<false, true>(q, k, v, o, l, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss,
                                       ksh, vsb, vss, vsh, causal, window, pl, scale, stream);
  return simt::dispatch<false, false>(q, k, v, o, l, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss,
                                      ksh, vsb, vss, vsh, causal, window, pl, scale, stream);
}

// As above, bf16 on the wgmma kernel. vec != 0: every row of q, k and v
// starts 16-byte aligned (D % 8 == 0, pointers and strides likewise), so
// tiles load by 16-byte cp.async; else element by element.
extern "C" int rt_flash_attention_forward_bf16(const void* q, const void* k, const void* v,
                                               void* o, void* lse, int B, int S, int T, int H,
                                               int K, int D, int qsb, int qss, int qsh, int ksb,
                                               int kss, int ksh, int vsb, int vss, int vsh,
                                               int causal, int window, int prefix_len, int vec,
                                               float scale, cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || D <= 0 || D > 256 || T < 0 || window < 0 || prefix_len < 0)
    return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  const bool prefix = causal && prefix_len > 0;
  const int pl = prefix ? prefix_len : 0;
  if (prefix && l)
    return wg::dispatch<true, true>(q, k, v, o, l, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss, ksh,
                                    vsb, vss, vsh, causal, window, pl, vec, scale, stream);
  if (prefix)
    return wg::dispatch<true, false>(q, k, v, o, l, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss,
                                     ksh, vsb, vss, vsh, causal, window, pl, vec, scale, stream);
  if (l)
    return wg::dispatch<false, true>(q, k, v, o, l, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss,
                                     ksh, vsb, vss, vsh, causal, window, pl, vec, scale, stream);
  return wg::dispatch<false, false>(q, k, v, o, l, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss,
                                    ksh, vsb, vss, vsh, causal, window, pl, vec, scale, stream);
}

// The backward: q, o, dout (B, S, H, D) and k, v (B, T, K, D) through their
// strides (unit stride over D), lse (B, H, S) fp32 as the forward wrote it,
// delta scratch of B H S floats; dq (B, S, H, D), dk, dv (B, T, K, D)
// contiguous, in the inputs' dtype. The mask arguments are the forward's.
extern "C" int rt_flash_attention_backward_f32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int T, int H,
    int K, int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh, int vsb, int vss,
    int vsh, int osb, int oss, int osh, int dsb, int dss, int dsh, int causal, int window,
    int prefix_len, float scale, cudaStream_t stream) {
  return bwd::backward<float>(q, k, v, o, dout, static_cast<const float*>(lse),
                              static_cast<float*>(delta), dq, dk, dv, B, S, T, H, K, D, qsb, qss,
                              qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, dsb, dss, dsh,
                              causal, window, prefix_len, scale, stream);
}

extern "C" int rt_flash_attention_backward_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int T, int H,
    int K, int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh, int vsb, int vss,
    int vsh, int osb, int oss, int osh, int dsb, int dss, int dsh, int causal, int window,
    int prefix_len, float scale, cudaStream_t stream) {
  return bwd::backward<__nv_bfloat16>(q, k, v, o, dout, static_cast<const float*>(lse),
                                      static_cast<float*>(delta), dq, dk, dv, B, S, T, H, K, D,
                                      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,
                                      dsb, dss, dsh, causal, window, prefix_len, scale, stream);
}

namespace {

template <typename Kernel>
int attributes(Kernel kernel, size_t dynamic_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(dynamic_smem);
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

template <bool PREFIX, bool LSE>
int flash_attributes(int bf16, int D, int* out) {
  if (bf16) {
    if (D <= 64)
      return attributes(wg::flash_wgmma_kernel<64, 2, 2, 2, PREFIX, LSE>,
                        wg::smem_bytes<64, 2, 2>(), out);
    if (D <= 128)
      return attributes(wg::flash_wgmma_kernel<128, 2, 1, 2, PREFIX, LSE>,
                        wg::smem_bytes<128, 2, 2>(), out);
    return attributes(wg::flash_wgmma_kernel<256, 1, 1, 1, PREFIX, LSE>,
                      wg::smem_bytes<256, 1, 1>(), out);
  }
  const int nd = D <= 64 ? 4 : D <= 128 ? 8 : 16;
  const size_t smem = simt::smem_bytes(D, nd);
  if (nd == 4) return attributes(simt::flash_forward_kernel<4, PREFIX, LSE>, smem, out);
  if (nd == 8) return attributes(simt::flash_forward_kernel<8, PREFIX, LSE>, smem, out);
  return attributes(simt::flash_forward_kernel<16, PREFIX, LSE>, smem, out);
}

template <int ND, bool PREFIX, typename T>
int backward_instance_attributes(int kernel, int* out) {
  constexpr int BK = bwd::key_tile<ND>();
  if (kernel == 0) return attributes(bwd::delta_kernel<T>, 0, out);
  if (kernel == 1)
    return attributes(bwd::dkdv_kernel<ND, BK, PREFIX, T>, bwd::dkdv_smem_bytes<ND, BK>(), out);
  return attributes(bwd::dq_kernel<ND, BK, PREFIX, T>, bwd::dq_smem_bytes<ND, BK>(), out);
}

template <bool PREFIX, typename T>
int backward_attributes(int D, int kernel, int* out) {
  if (D <= 64) return backward_instance_attributes<4, PREFIX, T>(kernel, out);
  if (D <= 128) return backward_instance_attributes<8, PREFIX, T>(kernel, out);
  return backward_instance_attributes<16, PREFIX, T>(kernel, out);
}

template <int DP, bool PREFIX>
int wgmma_instance_attributes(int kernel, int* out) {
  constexpr bool SPLIT = bwd::wgmma_split<DP>();
  if (kernel == 0) return attributes(bwd::delta_kernel<__nv_bfloat16>, 0, out);
  if (kernel == 1)
    return attributes(bwd::dkdv_wgmma_kernel<DP, SPLIT, PREFIX>,
                      bwd::dkdv_wgmma_smem<DP, SPLIT>(), out);
  return attributes(bwd::dq_wgmma_kernel<DP, SPLIT, PREFIX>, bwd::dq_wgmma_smem<DP, SPLIT>(),
                    out);
}

template <bool PREFIX>
int wgmma_attributes(int D, int kernel, int* out) {
  if (D <= 64) return wgmma_instance_attributes<64, PREFIX>(kernel, out);
  if (D <= 128) return wgmma_instance_attributes<128, PREFIX>(kernel, out);
  return wgmma_instance_attributes<256, PREFIX>(kernel, out);
}

}  // namespace

// The forward kernel a launch at head dim D takes (bf16 != 0: the wgmma
// kernel; prefix != 0: the instance a causal launch with prefix_len > 0
// takes; lse != 0: the instance that writes the log-sum-exp): out =
// {registers a thread, static shared bytes, dynamic shared bytes a block,
// local (spill) bytes a thread}.
extern "C" int rt_flash_attention_attributes(int bf16, int D, int prefix, int lse, int* out) {
  if (D <= 0 || D > 256) return cudaErrorInvalidValue;
  if (prefix) return lse ? flash_attributes<true, true>(bf16, D, out)
                         : flash_attributes<true, false>(bf16, D, out);
  return lse ? flash_attributes<false, true>(bf16, D, out)
             : flash_attributes<false, false>(bf16, D, out);
}

// The same for the backward's kernels: kernel 0 the delta pre-pass, 1 the
// dK/dV kernel, 2 the dQ kernel, of the instance a backward launch at head
// dim D (in bf16 when bf16 != 0, with the prefix rule when prefix != 0)
// takes.
extern "C" int rt_flash_attention_backward_attributes(int bf16, int D, int prefix, int kernel,
                                                      int* out) {
  if (D <= 0 || D > 256 || kernel < 0 || kernel > 2) return cudaErrorInvalidValue;
  if (bf16) return prefix ? wgmma_attributes<true>(D, kernel, out)
                          : wgmma_attributes<false>(D, kernel, out);
  return prefix ? backward_attributes<true, float>(D, kernel, out)
                : backward_attributes<false, float>(D, kernel, out);
}
