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
// are all of it. So the design reads each input once and keeps every
// intermediate on chip, as the TPU kernel kept it in VMEM:
//   * one block per (b, h); q, k, v and the whole (N, M) score matrix live in
//     shared memory (66 KB at 64 x 64 x 64), so the scores and probabilities
//     never touch device memory;
//   * k is stored with a row stride of dh + 1, so the threads of a warp that
//     compute neighbouring scores of one query read distinct banks;
//   * the softmax is one warp per query row (max, exp, sum, divide);
//   * no padding: any N >= 1 (the PMA's one seed query) and M >= 1 work, and
//     so does any dh (44 in the smallest configuration), within 227 KB.
// The scores use plain fp32 FMAs in the order q[0]k[0] + q[1]k[1] + ...; no
// TF32 tensor cores, whose 10-bit mantissa would break the 1e-5 tolerance.
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
// more than the bytes. The design keeps everything of one (b, h) on chip:
//   * one block per (b, h), 256 threads; q, dO, k, v (k and v with the
//     dh + 1 row stride) and the (N, M) matrices P and dP/dS in shared
//     memory, 97 KB at 64 x 64 x 64, so two blocks fit on an SM;
//   * the scores are recomputed with the forward's exact arithmetic and
//     order (bias, then the additive mask), so P is the forward's P and a
//     masked key of a row with any valid key has P exactly 0: its dK, dV
//     and db come out exactly 0. A fully masked row keeps its uniform P and
//     its (non-zero) gradients, as in the plain version;
//   * each block writes only its own dq/dk/dv tiles and its per-head db row:
//     no atomics, so two runs give the same bits (the training resume relies
//     on it);
//   * plain fp32 FMAs, fp32 accumulation, no TF32; any N, M >= 1 and any dh
//     within 227 KB of shared memory.
#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30
constexpr int kThreads = 128;
constexpr int kBwdThreads = 256;

__global__ void __launch_bounds__(kThreads)
set_attention_forward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ bias,
                             const uint8_t* __restrict__ mask, float* __restrict__ o,
                             int H, int N, int M, int dh, float scale) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;
  float* sq = smem;            // (N, dh)
  float* sk = sq + N * dh;     // (M, dh + 1)
  float* sv = sk + M * ldk;    // (M, dh)
  float* sp = sv + M * dh;     // (N, M) scores, then probabilities

  const int bh = blockIdx.x;
  const int b = bh / H;
  const float* qp = q + static_cast<size_t>(bh) * N * dh;
  const float* kp = k + static_cast<size_t>(bh) * M * dh;
  const float* vp = v + static_cast<size_t>(bh) * M * dh;
  const float* bp = bias ? bias + static_cast<size_t>(b) * M : nullptr;
  const uint8_t* mp = mask ? mask + static_cast<size_t>(b) * M : nullptr;

  for (int i = threadIdx.x; i < N * dh; i += blockDim.x) sq[i] = qp[i];
  for (int i = threadIdx.x; i < M * dh; i += blockDim.x) {
    sk[(i / dh) * ldk + i % dh] = kp[i];
    sv[i] = vp[i];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * M; i += blockDim.x) {
    const int n = i / M;
    const int m = i % M;
    const float* qr = sq + n * dh;
    const float* kr = sk + m * ldk;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kr[d], acc);
    float s = acc * scale;
    if (bp) s += bp[m];
    if (mp) s += mp[m] ? 0.f : kNegInf;
    sp[i] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int n = warp; n < N; n += nwarps) {
    float* row = sp + n * M;
    float mx = -FLT_MAX;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, row[m]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      sum += e;
    }
    sum = rt::warp_sum(sum);
    for (int m = lane; m < M; m += 32) row[m] = row[m] / sum;
  }
  __syncthreads();

  float* op = o + static_cast<size_t>(bh) * N * dh;
  for (int i = threadIdx.x; i < N * dh; i += blockDim.x) {
    const int n = i / dh;
    const int d = i % dh;
    const float* pr = sp + n * M;
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc = fmaf(pr[m], sv[m * dh + d], acc);
    op[i] = acc;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
set_attention_backward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ bias,
                              const uint8_t* __restrict__ mask, const float* __restrict__ dout,
                              float* __restrict__ dq, float* __restrict__ dk,
                              float* __restrict__ dv, float* __restrict__ db, int H, int N,
                              int M, int dh, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* sq = smem;            // (N, dh)
  float* sdo = sq + N * dh;    // (N, dh)
  float* sk = sdo + N * dh;    // (M, dh + 1)
  float* sv = sk + M * ld;     // (M, dh + 1)
  float* sp = sv + M * ld;     // (N, M) scores, then probabilities
  float* sds = sp + N * M;     // (N, M) dP, then dS

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t q_off = static_cast<size_t>(bh) * N * dh;
  const size_t k_off = static_cast<size_t>(bh) * M * dh;
  const float* bp = bias ? bias + static_cast<size_t>(b) * M : nullptr;
  const uint8_t* mp = mask ? mask + static_cast<size_t>(b) * M : nullptr;

  for (int i = threadIdx.x; i < N * dh; i += blockDim.x) {
    sq[i] = q[q_off + i];
    sdo[i] = dout[q_off + i];
  }
  for (int i = threadIdx.x; i < M * dh; i += blockDim.x) {
    const int r = (i / dh) * ld + i % dh;
    sk[r] = k[k_off + i];
    sv[r] = v[k_off + i];
  }
  __syncthreads();

  // scores, with the forward kernel's arithmetic in the same order
  for (int i = threadIdx.x; i < N * M; i += blockDim.x) {
    const int n = i / M;
    const int m = i % M;
    const float* qr = sq + n * dh;
    const float* kr = sk + m * ld;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kr[d], acc);
    float s = acc * scale;
    if (bp) s += bp[m];
    if (mp) s += mp[m] ? 0.f : kNegInf;
    sp[i] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int n = warp; n < N; n += nwarps) {
    float* row = sp + n * M;
    float mx = -FLT_MAX;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, row[m]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      sum += e;
    }
    sum = rt::warp_sum(sum);
    for (int m = lane; m < M; m += 32) row[m] = row[m] / sum;
  }

  // dP = dO V^T: reads neither P nor the scores, so it needs no barrier
  // after the softmax
  for (int i = threadIdx.x; i < N * M; i += blockDim.x) {
    const int n = i / M;
    const int m = i % M;
    const float* dor = sdo + n * dh;
    const float* vr = sv + m * ld;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(dor[d], vr[d], acc);
    sds[i] = acc;
  }
  __syncthreads();

  // delta = rowsum(dP * P), dS = P * (dP - delta): one warp per query row
  for (int n = warp; n < N; n += nwarps) {
    const float* pr = sp + n * M;
    float* dr = sds + n * M;
    float dot = 0.f;
    for (int m = lane; m < M; m += 32) dot = fmaf(dr[m], pr[m], dot);
    dot = rt::warp_sum(dot);
    for (int m = lane; m < M; m += 32) dr[m] = pr[m] * (dr[m] - dot);
  }
  __syncthreads();

  // dQ = scale dS K
  for (int i = threadIdx.x; i < N * dh; i += blockDim.x) {
    const int n = i / dh;
    const int d = i % dh;
    const float* dsr = sds + n * M;
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc = fmaf(dsr[m], sk[m * ld + d], acc);
    dq[q_off + i] = acc * scale;
  }
  // dK = scale dS^T Q and dV = P^T dO
  for (int i = threadIdx.x; i < M * dh; i += blockDim.x) {
    const int m = i / dh;
    const int d = i % dh;
    float acc_k = 0.f;
    float acc_v = 0.f;
    for (int n = 0; n < N; ++n) {
      acc_k = fmaf(sds[n * M + m], sq[n * dh + d], acc_k);
      acc_v = fmaf(sp[n * M + m], sdo[n * dh + d], acc_v);
    }
    dk[k_off + i] = acc_k * scale;
    dv[k_off + i] = acc_v;
  }
  // db for this head: column sums of dS
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc += sds[n * M + m];
    db[static_cast<size_t>(bh) * M + m] = acc;
  }
}

}  // namespace

// q, o: (B, H, N, dh); k, v: (B, H, M, dh); bias: (B, M) fp32 or null;
// mask: (B, M) uint8 (nonzero = valid key) or null. fp32, contiguous.
extern "C" int rt_set_attention_forward(const float* q, const float* k, const float* v,
                                        const float* bias, const uint8_t* mask, float* o,
                                        int B, int H, int N, int M, int dh, float scale,
                                        cudaStream_t stream) {
  if (B * H == 0 || N == 0) return cudaSuccess;
  if (M <= 0 || dh <= 0) return cudaErrorInvalidValue;
  // q, k (padded rows), v and the scores; a launch above 227 KB is refused
  const size_t smem = sizeof(float) * (static_cast<size_t>(N) * dh +
                                       static_cast<size_t>(M) * (dh + 1) +
                                       static_cast<size_t>(M) * dh + static_cast<size_t>(N) * M);
  cudaError_t err = rt::allow_smem(set_attention_forward_kernel, smem);
  if (err != cudaSuccess) return err;
  set_attention_forward_kernel<<<B * H, kThreads, smem, stream>>>(q, k, v, bias, mask, o, H, N,
                                                                  M, dh, scale);
  return cudaGetLastError();
}

// Inputs as the forward's, plus dout: (B, H, N, dh). Outputs dq: (B, H, N, dh);
// dk, dv: (B, H, M, dh); db: (B, H, M), the key-bias gradient of each head.
extern "C" int rt_set_attention_backward(const float* q, const float* k, const float* v,
                                         const float* bias, const uint8_t* mask,
                                         const float* dout, float* dq, float* dk, float* dv,
                                         float* db, int B, int H, int N, int M, int dh,
                                         float scale, cudaStream_t stream) {
  if (B * H == 0 || N == 0) return cudaSuccess;
  if (M <= 0 || dh <= 0) return cudaErrorInvalidValue;
  // q, dO, k and v (padded rows), P and dS; a launch above 227 KB is refused
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(N) * dh +
                                       2 * static_cast<size_t>(M) * (dh + 1) +
                                       2 * static_cast<size_t>(N) * M);
  cudaError_t err = rt::allow_smem(set_attention_backward_kernel, smem);
  if (err != cudaSuccess) return err;
  set_attention_backward_kernel<<<B * H, kBwdThreads, smem, stream>>>(
      q, k, v, bias, mask, dout, dq, dk, dv, db, H, N, M, dh, scale);
  return cudaGetLastError();
}
