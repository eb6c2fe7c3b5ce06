// Gated delta-rule recurrence (RWKV-7 core of the Stage-1 encoder), forward.
//
// Replaces the TPU kernel src/repro/kernels/wkv/wkv.py::_wkv_kernel (reached
// through wkv_pallas and ops.py::wkv_chunked). Per (batch, head), with the
// state S (dh x dh, S[k_dim][v_dim]) carried from token to token:
//     S <- diag(w_t) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  y_t = S^T r_t
//
// What bounds it on the H100: per encoder layer at the default shapes
// (B = 256, S = 128, H = 6, dh = 64) it must move 0.28 GB and do 5.6 GFLOP
// of fp32 work (7 dh^2 per token and head). Neither holds it back as much as
// the serial chain over the S tokens: every token's update depends on the
// previous one. The design keeps that chain short and local:
//   * one block per (batch, head), one thread per value column j. Thread j
//     keeps column S[:, j] (dh fp32 values) in registers for the whole
//     sequence. Decay, (S^T k)[j], the rank-1 update and (S^T r)[j] all act
//     on one column, so no reduction crosses threads and no barrier is
//     needed inside a token;
//   * r, k, w and beta of kChunk tokens are staged in shared memory with one
//     pair of barriers per chunk (every thread reads all dh entries of them);
//     v[j] and y[j] are the thread's own and go straight to/from memory;
//   * the model layout (B, S, H, dh) is read in place: no transposes.
// The TPU kernel's chunking (and the wrapper's fallback to one chunk when S
// does not divide) has no counterpart: any S works.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 16;  // tokens staged per barrier pair

template <int MAXDH>
__global__ void wkv_forward_kernel(const float* __restrict__ r, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ w,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ s0, float* __restrict__ y,
                                   float* __restrict__ sf, int S, int H, int dh) {
  __shared__ float sr[kChunk][MAXDH];
  __shared__ float sk[kChunk][MAXDH];
  __shared__ float sw[kChunk][MAXDH];
  __shared__ float sb[kChunk];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int j = threadIdx.x;  // value column; blockDim.x == dh

  float st[MAXDH];  // column S[:, j]
  const float* s0p = s0 ? s0 + static_cast<size_t>(bh) * dh * dh : nullptr;
#pragma unroll
  for (int i = 0; i < MAXDH; ++i)
    st[i] = (i < dh && s0p) ? s0p[static_cast<size_t>(i) * dh + j] : 0.f;

  const size_t tok_stride = static_cast<size_t>(H) * dh;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * dh + j;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int nt = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int c = 0; c < nt; ++c) {
      const size_t off = base + static_cast<size_t>(t0 + c) * tok_stride;
      sr[c][j] = r[off];
      sk[c][j] = k[off];
      sw[c][j] = w[off];
    }
    for (int c = j; c < nt; c += blockDim.x)
      sb[c] = beta[(static_cast<size_t>(b) * S + t0 + c) * H + h];
    __syncthreads();

    for (int c = 0; c < nt; ++c) {
      const size_t off = base + static_cast<size_t>(t0 + c) * tok_stride;
      const float vj = v[off];
      float skj = 0.f;  // (S^T k)[j] after the decay
#pragma unroll
      for (int i = 0; i < MAXDH; ++i) {
        if (i < dh) {
          st[i] *= sw[c][i];
          skj = fmaf(st[i], sk[c][i], skj);
        }
      }
      const float bd = sb[c] * (vj - skj);
      float yj = 0.f;  // (S^T r)[j] after the update
#pragma unroll
      for (int i = 0; i < MAXDH; ++i) {
        if (i < dh) {
          st[i] = fmaf(sk[c][i], bd, st[i]);
          yj = fmaf(st[i], sr[c][i], yj);
        }
      }
      y[off] = yj;
    }
  }

  if (sf) {
    float* sfp = sf + static_cast<size_t>(bh) * dh * dh;
#pragma unroll
    for (int i = 0; i < MAXDH; ++i)
      if (i < dh) sfp[static_cast<size_t>(i) * dh + j] = st[i];
  }
}

template <int MAXDH>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* beta, const float* s0, float* y, float* sf, int B, int S,
                   int H, int dh, cudaStream_t stream) {
  wkv_forward_kernel<MAXDH><<<B * H, dh, 0, stream>>>(r, k, v, w, beta, s0, y, sf, S, H, dh);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: (B, S, H, dh); beta: (B, S, H); s0 (may be null: zero
// state) and sf: (B, H, dh, dh). All fp32, contiguous. dh <= 128.
extern "C" int rt_wkv_forward(const float* r, const float* k, const float* v, const float* w,
                              const float* beta, const float* s0, float* y, float* sf, int B,
                              int S, int H, int dh, cudaStream_t stream) {
  if (B * H == 0 || S == 0) return cudaSuccess;
  if (dh <= 0 || dh > 128) return cudaErrorInvalidValue;
  if (dh <= 16) return launch<16>(r, k, v, w, beta, s0, y, sf, B, S, H, dh, stream);
  if (dh <= 32) return launch<32>(r, k, v, w, beta, s0, y, sf, B, S, H, dh, stream);
  if (dh <= 64) return launch<64>(r, k, v, w, beta, s0, y, sf, B, S, H, dh, stream);
  return launch<128>(r, k, v, w, beta, s0, y, sf, B, S, H, dh, stream);
}
