// Gated delta-rule recurrence (RWKV-7 core of the Stage-1 encoder), forward.
//
// Replaces the TPU kernel src/repro/kernels/wkv/wkv.py::_wkv_kernel (reached
// through wkv_pallas and ops.py::wkv_chunked). Per (batch, head), with the
// state S (dh x dh, S[k_dim][v_dim]) carried from token to token:
//     S <- diag(w_t) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  y_t = S^T r_t
//
// What bounds it on the H100: per encoder layer at the default shapes
// (B = 256, S = 128, H = 6, dh = 64) it must move 0.28 GB and do 5.6 GFLOP
// of fp32 work (7 dh^2 per token and head: a multiply and three FMAs per
// state entry), so the FMA issue rate is the bound, and the tokens are a
// serial chain. The design spends the issue slots on those four
// instructions per entry:
//   * one block per (batch, head). The state is cut into register tiles:
//     a thread holds kRows = dh_pad / RG rows of S (the k dimension) for 4
//     value columns, 64 fp32 registers at dh 64 (rows 16, 64 threads). Its
//     rows are float4 groups rg, rg + RG, ... (rg its row group), so the RG
//     groups of a warp read adjacent 16-byte words and never share a bank;
//   * per token, each 16-byte broadcast load of w, k or r feeds 16 FMAs (4
//     rows x 4 columns), against one shared load per FMA in a
//     column-per-thread design; the partial (S^T k)_j and (S^T r)_j of a
//     row group are summed over the RG groups with shfl.xor (2 steps at dh
//     64), which also cuts each token's serial FMA chain from dh to kRows;
//   * r, k, w, v and beta of kChunk tokens are staged by cp.async into one
//     of two shared buffers while the other is used, so no global load
//     waits inside the token loop; one barrier pair per chunk;
//   * the model layout (B, S, H, dh) is read in place: no transposes. Rows
//     are padded with zeros to dh_pad (32, 64 or 128); a zero row or column
//     of S stays zero, so padding changes nothing.
// Sums over the k dimension run in another order than the plain version's
// (a row group's rows, then the butterfly): within atol 1e-4 + rtol 1e-3.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 8;  // tokens a stage
constexpr int kCols = 4;   // value columns a thread (a multiple of 4)

// DHP: head dim padded; RG: row groups (threads sharing a column group).
template <int DHP, int RG>
struct Shape {
  static constexpr int kRows = DHP / RG;             // rows of S a thread
  static constexpr int kThreads = RG * DHP / kCols;  // threads a block
  static constexpr int kStage = 4 * kChunk * DHP + kChunk;  // w, k, r, v rows; beta
  static_assert(kRows % 4 == 0 && kCols % 4 == 0 && 32 % RG == 0 && kThreads % 32 == 0,
                "tile");
};

// Stages tokens t0 .. t0 + nt - 1 of w, k, r, v (rows of dh floats) and beta
// into buf: 16-byte copies when vec, else 4-byte ones. Columns past dh are
// never written (they hold the zeros of the kernel's start).
template <int DHP, int THREADS>
__device__ __forceinline__ void stage_chunk(float* buf, const float* w, const float* k,
                                            const float* r, const float* v,
                                            const float* __restrict__ beta, size_t base,
                                            size_t tok_stride, size_t beta_base, int beta_stride,
                                            int t0, int nt, int dh, int vec) {
  if (vec) {
    const int d4n = dh / 4;
    const int per_tok = 4 * d4n;
    for (int i = threadIdx.x; i < nt * per_tok; i += THREADS) {
      const int t = i / per_tok;
      const int rem = i - t * per_tok;
      const int a = rem / d4n;
      const int d = 4 * (rem - a * d4n);
      const float* src = a == 0 ? w : a == 1 ? k : a == 2 ? r : v;  // no local array
      rt::cp_async16(buf + (a * kChunk + t) * DHP + d,
                     src + base + static_cast<size_t>(t0 + t) * tok_stride + d);
    }
  } else {
    const int per_tok = 4 * dh;
    for (int i = threadIdx.x; i < nt * per_tok; i += THREADS) {
      const int t = i / per_tok;
      const int rem = i - t * per_tok;
      const int a = rem / dh;
      const int d = rem - a * dh;
      const float* src = a == 0 ? w : a == 1 ? k : a == 2 ? r : v;
      rt::cp_async4(buf + (a * kChunk + t) * DHP + d,
                    src + base + static_cast<size_t>(t0 + t) * tok_stride + d);
    }
  }
  for (int t = threadIdx.x; t < nt; t += THREADS)
    rt::cp_async4(buf + 4 * kChunk * DHP + t,
                  beta + beta_base + static_cast<size_t>(t0 + t) * beta_stride);
}

template <int DHP, int RG, int MINB>
__global__ void __launch_bounds__(Shape<DHP, RG>::kThreads, MINB)
wkv_forward_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ beta, const float* __restrict__ s0,
                   float* __restrict__ y, float* __restrict__ sf, int S, int H, int dh, int vec) {
  using Sh = Shape<DHP, RG>;
  constexpr int kRows = Sh::kRows;
  constexpr int kQ = kRows / 4;   // float4 row groups a thread
  constexpr int kC4 = kCols / 4;  // float4 column groups a thread
  __shared__ __align__(16) float stage[2][Sh::kStage];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int rg = threadIdx.x % RG;  // row group: rows 4 (rg + RG q) + e
  const int cg = threadIdx.x / RG;  // columns col .. col + kCols - 1
  const int col = kCols * cg;

  // padding columns (and rows) of both stages stay zero
  for (int i = threadIdx.x; i < 2 * Sh::kStage; i += Sh::kThreads) (&stage[0][0])[i] = 0.f;

  float st[kRows][kCols];  // S[4 (rg + RG q) + e][col + j]
  const float* s0p = s0 ? s0 + static_cast<size_t>(bh) * dh * dh : nullptr;
#pragma unroll
  for (int q = 0; q < kQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (rg + RG * q) + e;
      const bool row = s0p && i < dh;
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4) {
        const int c = col + 4 * c4;
        float* o = &st[4 * q + e][4 * c4];
        if (vec && row && c < dh) {
          const float4 x = *reinterpret_cast<const float4*>(s0p + static_cast<size_t>(i) * dh + c);
          o[0] = x.x;
          o[1] = x.y;
          o[2] = x.z;
          o[3] = x.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = row && c + j < dh ? s0p[static_cast<size_t>(i) * dh + c + j] : 0.f;
        }
      }
    }

  const size_t tok_stride = static_cast<size_t>(H) * dh;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * dh;
  const size_t beta_base = static_cast<size_t>(b) * S * H + h;
  const int nch = (S + kChunk - 1) / kChunk;

  __syncthreads();  // the zeros land before any copy into the same words
  stage_chunk<DHP, Sh::kThreads>(stage[0], w, k, r, v, beta, base, tok_stride, beta_base, H, 0,
                                 min(kChunk, S), dh, vec);
  rt::cp_async_commit();

  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * kChunk;
    const int nt = min(kChunk, S - t0);
    if (ch + 1 < nch) {
      // the other buffer was released by the barrier that ended chunk ch - 1
      stage_chunk<DHP, Sh::kThreads>(stage[(ch + 1) & 1], w, k, r, v, beta, base,
                                     tok_stride, beta_base, H, t0 + kChunk,
                                     min(kChunk, S - t0 - kChunk), dh, vec);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of chunk ch have landed

    const float* buf = stage[ch & 1];
    for (int c = 0; c < nt; ++c) {
      const float4* sw4 = reinterpret_cast<const float4*>(buf + c * DHP);
      const float4* sk4 = reinterpret_cast<const float4*>(buf + (kChunk + c) * DHP);
      const float4* sr4 = reinterpret_cast<const float4*>(buf + (2 * kChunk + c) * DHP);
      const float* sv = buf + (3 * kChunk + c) * DHP + col;
      const float bt = buf[4 * kChunk * DHP + c];

      float a[kCols];  // (S^T k)[col + j] after the decay, this row group
#pragma unroll
      for (int j = 0; j < kCols; ++j) a[j] = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 w4 = sw4[rg + RG * q];
        const float4 k4 = sk4[rg + RG * q];
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            st[4 * q + e][j] *= wv[e];
            a[j] = fmaf(st[4 * q + e][j], kv[e], a[j]);
          }
      }
#pragma unroll
      for (int off = 1; off < RG; off <<= 1)
#pragma unroll
        for (int j = 0; j < kCols; ++j) a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);

      float bd[kCols];
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4) {
        const float4 v4 = reinterpret_cast<const float4*>(sv)[c4];
        bd[4 * c4] = bt * (v4.x - a[4 * c4]);
        bd[4 * c4 + 1] = bt * (v4.y - a[4 * c4 + 1]);
        bd[4 * c4 + 2] = bt * (v4.z - a[4 * c4 + 2]);
        bd[4 * c4 + 3] = bt * (v4.w - a[4 * c4 + 3]);
      }

      float yv[kCols];  // (S^T r)[col + j] after the update, this row group
#pragma unroll
      for (int j = 0; j < kCols; ++j) yv[j] = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 k4 = sk4[rg + RG * q];
        const float4 r4 = sr4[rg + RG * q];
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            st[4 * q + e][j] = fmaf(kv[e], bd[j], st[4 * q + e][j]);
            yv[j] = fmaf(st[4 * q + e][j], rv[e], yv[j]);
          }
      }
#pragma unroll
      for (int off = 1; off < RG; off <<= 1)
#pragma unroll
        for (int j = 0; j < kCols; ++j) yv[j] += __shfl_xor_sync(0xffffffffu, yv[j], off);

      if (rg == 0) {
        float* yp = y + base + static_cast<size_t>(t0 + c) * tok_stride;
#pragma unroll
        for (int c4 = 0; c4 < kC4; ++c4) {
          const int cc = col + 4 * c4;
          if (cc >= dh) break;
          if (vec) {
            *reinterpret_cast<float4*>(yp + cc) =
                make_float4(yv[4 * c4], yv[4 * c4 + 1], yv[4 * c4 + 2], yv[4 * c4 + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (cc + j < dh) yp[cc + j] = yv[4 * c4 + j];
          }
        }
      }
    }
    __syncthreads();  // buffer ch & 1 is free for chunk ch + 2
  }

  if (sf) {
    float* sfp = sf + static_cast<size_t>(bh) * dh * dh;
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * (rg + RG * q) + e;
        if (i >= dh) continue;
#pragma unroll
        for (int c4 = 0; c4 < kC4; ++c4) {
          const int cc = col + 4 * c4;
          if (cc >= dh) break;
          const float* x = &st[4 * q + e][4 * c4];
          float* row = sfp + static_cast<size_t>(i) * dh + cc;
          if (vec) {
            *reinterpret_cast<float4*>(row) = make_float4(x[0], x[1], x[2], x[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (cc + j < dh) row[j] = x[j];
          }
        }
      }
  }
}

// One instance of the kernel: its launch and its attributes.
template <int DHP, int RG, int MINB>
struct Instance {
  static cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                            const float* beta, const float* s0, float* y, float* sf, int B,
                            int S, int H, int dh, int vec, cudaStream_t stream) {
    wkv_forward_kernel<DHP, RG, MINB><<<B * H, Shape<DHP, RG>::kThreads, 0, stream>>>(
        r, k, v, w, beta, s0, y, sf, S, H, dh, vec);
    return cudaGetLastError();
  }
  static cudaError_t attributes(cudaFuncAttributes* a) {
    return cudaFuncGetAttributes(a, wkv_forward_kernel<DHP, RG, MINB>);
  }
};

// The instances, by head dim: dh <= 32 (32 threads, 8 rows x 4 columns a
// thread), <= 64 (64 threads, 16 x 4), <= 128 (256 threads, 16 x 4, 8 row
// groups).
using Dh32 = Instance<32, 4, 16>;
using Dh64 = Instance<64, 4, 8>;
using Dh128 = Instance<128, 8, 2>;

}  // namespace

// r, k, v, w, y: (B, S, H, dh); beta: (B, S, H); s0 (may be null: zero
// state) and sf: (B, H, dh, dh). All fp32, contiguous. dh <= 128.
// vec != 0: dh % 4 == 0 and r, k, v, w, y, s0, sf 16-byte aligned.
extern "C" int rt_wkv_forward(const float* r, const float* k, const float* v, const float* w,
                              const float* beta, const float* s0, float* y, float* sf, int B,
                              int S, int H, int dh, int vec, cudaStream_t stream) {
  if (B * H == 0 || S == 0) return cudaSuccess;
  if (dh <= 0 || dh > 128) return cudaErrorInvalidValue;
  if (dh <= 32) return Dh32::launch(r, k, v, w, beta, s0, y, sf, B, S, H, dh, vec, stream);
  if (dh <= 64) return Dh64::launch(r, k, v, w, beta, s0, y, sf, B, S, H, dh, vec, stream);
  return Dh128::launch(r, k, v, w, beta, s0, y, sf, B, S, H, dh, vec, stream);
}

// The kernel a launch at head dim dh takes: out = {registers a thread,
// static shared bytes, dynamic shared bytes a block, local (spill) bytes a
// thread}.
extern "C" int rt_wkv_attributes(int dh, int* out) {
  if (dh <= 0 || dh > 128) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = dh <= 32   ? Dh32::attributes(&a)
                          : dh <= 64 ? Dh64::attributes(&a)
                                     : Dh128::attributes(&a);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}
