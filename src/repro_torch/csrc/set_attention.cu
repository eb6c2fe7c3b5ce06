// Fused masked, frequency-weighted set attention (Stage-2 SAB/PMA), forward.
//
// Replaces the TPU kernel src/repro/kernels/set_attention/set_attn.py::
// _set_attn_kernel (reached through _fwd_call / set_attention_pallas and
// ops.py::masked_set_attention). Per (batch row b, head h):
//     o = softmax(q k^T / sqrt(dh) + key_bias[b] + (mask[b] ? 0 : NEG_INF)) v
// with NEG_INF = -2^30 added on top of the bias exactly as the plain version
// (and src/repro/kernels/set_attention/ref.py) does, so a fully masked row
// collapses to a uniform softmax over its M keys and never gives NaN.
//
// What bounds it on the H100: at the main path's SAB shapes (B = 512, H = 4,
// N = M = 64, dh = 64) the kernel must move 0.13 GB (q, k, v read once, o
// written once) and do 2.1 GFLOP of fp32 work; at 3.35 TB/s and 67 TFLOP/s
// the bytes weigh slightly more, and for the PMA (N = 1) they are all of
// it. So the design reads each input once and keeps every intermediate on
// chip, as the TPU kernel kept it in VMEM:
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
#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30
constexpr int kThreads = 128;

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
