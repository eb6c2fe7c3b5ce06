// Streaming-softmax (flash) GQA attention, forward, for the LM zoo's prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash.py::
// _flash_kernel (reached through flash_pallas and ops.py::flash_attention,
// and from the models through models/attention.py::attn_apply). Per batch
// row b, head h and query position i:
//     o[b,i,h] = softmax_j(scale q[b,i,h] . k[b,j,h/g] + mask(i,j)) v[b,j,h/g]
// with g = H/K, scale = D^-0.5 applied to q in fp32 before the product,
// masked scores set to NEG_INF = -2^30 (not -inf), the causal rule j <= i and
// the window rule i - j < window on absolute positions counted from 0 for both
// q and k (also when S != T), a running max m, a running denominator l and an
// fp32 accumulator, and the output acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it on the H100: at smollm-135m's prefill (B 4, S 2048, H 9,
// K 3, D 64, bf16, causal) it must move 25 MB (q, k, v read once, o written
// once: 7.5 us at 3.35 TB/s) and do 4 D = 256 FLOPs per unmasked (q, k) pair,
// 19 GFLOP: 20 us at the bf16 tensor-core rate. So the operations bound it,
// and only a kernel on the tensor cores (wgmma, a later PR) can approach the
// bound. This first kernel does the same work in plain fp32 FMAs, whose peak
// (67 TFLOP/s) already puts it at 0.29 ms or more: right and simple first.
// The design keeps every intermediate on chip, as the TPU kernel kept it in
// VMEM, and reads q once and each k/v tile once a query tile:
//   * one block of 256 threads (16 x 16) per (64-query tile, head, batch row);
//     the block loops over 64-key tiles of its kv head h / g (GQA in the
//     index, no repeated heads), as the TPU kernel's sequential kv grid axis;
//   * key tiles that the causal rule or the window mask out for every row of
//     the query tile are never loaded (the loop bounds), as pl.when(run)
//     skipped them. A row whose first visible key lies in a later tile
//     carries m = NEG_INF and the l and acc of the masked keys of earlier
//     computed tiles until its first real score, where the correction
//     exp(m_prev - m_new) underflows to 0 and clears them, as in the TPU
//     kernel;
//   * q (pre-scaled, fp32) and the k tile sit transposed in shared memory
//     with a padded row, v row-major, the P tile with a padded row, so every
//     warp reads distinct banks or one broadcast address. Each thread
//     computes a 4 x 4 block of scores (rows ty + 16 i, keys tx + 16 j) from
//     registers; the row max and sum are reduced over the 16 lanes of a half
//     warp with shuffles; each thread keeps 4 rows x D/16 columns of the fp32
//     accumulator in registers;
//   * any S and T: rows past S are computed on zeros and not stored; keys past
//     T get p = 0 (they do not exist, unlike masked keys, which get NEG_INF);
//     any head dim up to 256, the accumulator's columns rounded up to 16
//     (instantiations for D <= 64, 128 and 256; 210 KB of shared memory at
//     D = 256); bf16 or fp32 inputs, the output in the input's dtype;
//   * the model layout (B, S, H, D) / (B, T, K, D) is read in place through
//     its strides, with unit stride over D; o is written contiguous;
//   * plain fp32 FMAs, fp32 accumulation, no TF32; no atomics, so two runs
//     give the same bits.
// One difference from the plain version (kernels/flash_attention/ref.py),
// shared with the TPU kernel: a row with no visible key at all (only
// possible without the causal rule, with a window, when S > T + window - 1)
// gets the mean of v over the computed tiles' keys, or 0 when every tile was
// skipped, where the plain version averages all T keys.
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30
constexpr int kBQ = 64;                     // queries a block
constexpr int kBK = 64;                     // keys a tile
constexpr int kThreads = 256;               // 16 x 16
constexpr int kRows = kBQ / 16;             // score / output rows a thread
constexpr int kCols = kBK / 16;             // score columns a thread
constexpr int kLdQ = kBQ + 1;               // padded rows of sQ, sK, sP
constexpr int kLdK = kBK + 1;
constexpr int kLdP = kBK + 1;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Reductions over the 16 lanes of a half warp (lanes that share ty).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ND = accumulator columns a thread (head dim rounded up to 16, over 16).
template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
                     int G, int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh,
                     int vsb, int vss, int vsh, int causal, int window, float scale) {
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
  const T* qb = q + static_cast<int64_t>(b) * qsb + static_cast<int64_t>(h) * qsh;
  const T* kb = k + static_cast<int64_t>(b) * ksb + static_cast<int64_t>(h / G) * ksh;
  const T* vb = v + static_cast<int64_t>(b) * vsb + static_cast<int64_t>(h / G) * vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int pos = q0 + r;
    sQ[d * kLdQ + r] = pos < S ? load_f(qb + static_cast<int64_t>(pos) * qss + d) * scale : 0.f;
  }

  // key tiles with any visible key for some row of this query tile
  const int q_last = min(S, q0 + kBQ) - 1;
  int k_end = Tk;
  if (causal) k_end = min(k_end, q_last + 1);
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
        kv = load_f(kb + static_cast<int64_t>(k0 + c) * kss + d);
        vv = load_f(vb + static_cast<int64_t>(k0 + c) * vss + d);
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
        if (causal) visible = kpos <= qpos;
        if (window > 0) visible = visible && (qpos - kpos < window);
        if (!visible) s[i][j] = kNegInf;
        if (c >= nk) s[i][j] = -INFINITY;  // no such key: p = 0 below
        mt = fmaxf(mt, s[i][j]);
      }
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[i], mt);  // >= NEG_INF: finite
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        ls += p;
      }
      ls = half_warp_sum(ls);
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
    T* orow = o + ((static_cast<int64_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store_f(orow + d, acc[i][j] / den);
    }
  }
}

template <typename T, int ND>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                   int H, int K, int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh,
                   int vsb, int vss, int vsh, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(D) * (kLdQ + kLdK) +
                                       static_cast<size_t>(kBK) * ND * 16 +
                                       static_cast<size_t>(kBQ) * kLdP);
  auto kernel = flash_forward_kernel<T, ND>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Tk, H, H / K, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                     int H, int K, int D, int qsb, int qss, int qsh, int ksb, int kss, int ksh,
                     int vsb, int vss, int vsh, int causal, int window, float scale,
                     cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, B, S, Tk, H, K, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                        vsh, causal, window, scale, stream);
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, B, S, Tk, H, K, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                        vsh, causal, window, scale, stream);
  return launch<T, 16>(q, k, v, o, B, S, Tk, H, K, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                       vsh, causal, window, scale, stream);
}

}  // namespace

// q: (B, S, H, D) with strides (qsb, qss, qsh, 1); k, v: (B, T, K, D) with
// strides (ksb, kss, ksh, 1) and (vsb, vss, vsh, 1); o: (B, S, H, D)
// contiguous. All bf16 (bf16 != 0) or all fp32. H % K == 0, 1 <= D <= 256.
extern "C" int rt_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                          int B, int S, int T, int H, int K, int D, int qsb,
                                          int qss, int qsh, int ksb, int kss, int ksh, int vsb,
                                          int vss, int vsh, int causal, int window, int bf16,
                                          float scale, cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || D <= 0 || D > 256 || T < 0 || window < 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss, ksh,
                                   vsb, vss, vsh, causal, window, scale, stream);
  return dispatch<float>(q, k, v, o, B, S, T, H, K, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                         vsh, causal, window, scale, stream);
}
