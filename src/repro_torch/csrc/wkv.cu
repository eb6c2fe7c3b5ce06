// Gated delta-rule recurrence (RWKV-7 core of the Stage-1 encoder), forward
// and backward.
//
// The forward replaces the TPU kernel src/repro/kernels/wkv/wkv.py::
// _wkv_kernel (reached through wkv_pallas and ops.py::wkv_chunked). Per
// (batch, head), with the state S (dh x dh, S[k_dim][v_dim]) carried from
// token to token:
//     S <- diag(w_t) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  y_t = S^T r_t
// For training it also writes S_{t-1} of every token (`states`), which the
// backward reads; the instance without it is the serving path's.
// The backward (namespace bwd, below the forward) has no TPU twin: the JAX
// package differentiates the lax.scan of repro/models/rwkv.py::wkv_scan_ref.
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
//
// bf16 (the Stage-1 encoder at dtype "bfloat16", whose r, k and v are
// bf16 and whose decays and beta are fp32, as in the JAX model): every
// kernel is also instanced on the element type T of r, k and v. The bf16
// instances stage the bf16 rows as they are (a 16-byte cp.async carries 8
// of them, so the vector route needs dh % 8 == 0; the element route copies
// them by plain loads) and widen each element exactly at its read, then
// run the fp32 instance's arithmetic in its order; y and the states stay
// fp32, and the backward rounds dr, dk and dv once. So a bf16 instance on
// x equals the fp32 instance on x.float(), its bf16 outputs rounded, bit
// for bit.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kChunk = 8;  // tokens a stage
constexpr int kCols = 4;   // value columns a thread (a multiple of 4)

// A stage of kChunk tokens, in bytes: the w rows (fp32), the k, r and v
// rows (T: element type of r, k, v), beta (fp32); DHP: head dim padded.
template <typename T, int DHP>
struct Stage {
  static constexpr int kKrv = 4 * kChunk * DHP;  // byte offset of the k, r, v rows
  static constexpr int kBeta = kKrv + 3 * kChunk * DHP * static_cast<int>(sizeof(T));
  static constexpr int kBytes = kBeta + 4 * kChunk;
  static_assert(kBeta % 16 == 0 && kBytes % 16 == 0, "stage alignment");
};

// RG: row groups (threads sharing a column group).
template <typename T, int DHP, int RG>
struct Shape : Stage<T, DHP> {
  static constexpr int kRows = DHP / RG;             // rows of S a thread
  static constexpr int kThreads = RG * DHP / kCols;  // threads a block
  static_assert(kRows % 4 == 0 && kCols % 4 == 0 && 32 % RG == 0 && kThreads % 32 == 0,
                "tile");
};

// Stages tokens t0 .. t0 + nt - 1 of w (fp32), k, r, v (T: rows of dh) and
// beta into buf: 16-byte copies when vec, else 4-byte ones (w, beta, fp32
// rows) and plain element copies (bf16 rows). The fp32 instance keeps its
// own loops (those of the kernel before the bf16 instances). Columns past
// dh are never written (they hold the zeros of the kernel's start).
template <typename T, int DHP, int THREADS>
__device__ __forceinline__ void stage_chunk(unsigned char* buf, const float* w, const T* k,
                                            const T* r, const T* v,
                                            const float* __restrict__ beta, size_t base,
                                            size_t tok_stride, size_t beta_base, int beta_stride,
                                            int t0, int nt, int dh, int vec) {
  using Sh = Stage<T, DHP>;
  float* bw = reinterpret_cast<float*>(buf);
  T* bkrv = reinterpret_cast<T*>(buf + Sh::kKrv);
  if constexpr (std::is_same<T, float>::value) {
    // w, k, r, v rows lie back to back: four rows of dh floats a token
    if (vec) {
      const int d4n = dh / 4;
      const int per_tok = 4 * d4n;
      for (int i = threadIdx.x; i < nt * per_tok; i += THREADS) {
        const int t = i / per_tok;
        const int rem = i - t * per_tok;
        const int a = rem / d4n;
        const int d = 4 * (rem - a * d4n);
        const float* src = a == 0 ? w : a == 1 ? k : a == 2 ? r : v;  // no local array
        rt::cp_async16(bw + (a * kChunk + t) * DHP + d,
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
        rt::cp_async4(bw + (a * kChunk + t) * DHP + d,
                      src + base + static_cast<size_t>(t0 + t) * tok_stride + d);
      }
    }
  } else if (vec) {
    constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte copy
    const int d4n = dh / 4;                                   // w's copies a row
    const int dtn = dh / kPer16;                              // k's, r's, v's
    const int per_tok = d4n + 3 * dtn;
    for (int i = threadIdx.x; i < nt * per_tok; i += THREADS) {
      const int t = i / per_tok;
      const int rem = i - t * per_tok;
      const size_t row = base + static_cast<size_t>(t0 + t) * tok_stride;
      if (rem < d4n) {
        const int d = 4 * rem;
        rt::cp_async16(bw + t * DHP + d, w + row + d);
      } else {
        const int a = (rem - d4n) / dtn;  // 0 k, 1 r, 2 v
        const int d = kPer16 * (rem - d4n - a * dtn);
        const T* src = a == 0 ? k : a == 1 ? r : v;  // no local array
        rt::cp_async16(bkrv + (a * kChunk + t) * DHP + d, src + row + d);
      }
    }
  } else {
    const int per_tok = 4 * dh;
    for (int i = threadIdx.x; i < nt * per_tok; i += THREADS) {
      const int t = i / per_tok;
      const int rem = i - t * per_tok;
      const int a = rem / dh;
      const int d = rem - a * dh;
      const size_t at = base + static_cast<size_t>(t0 + t) * tok_stride + d;
      if (a == 0) {
        rt::cp_async4(bw + t * DHP + d, w + at);
      } else {
        const T* src = a == 1 ? k : a == 2 ? r : v;
        bkrv[((a - 1) * kChunk + t) * DHP + d] = src[at];
      }
    }
  }
  float* bb = reinterpret_cast<float*>(buf + Sh::kBeta);
  for (int t = threadIdx.x; t < nt; t += THREADS)
    rt::cp_async4(bb + t, beta + beta_base + static_cast<size_t>(t0 + t) * beta_stride);
}

// Writes a thread's tile of the state (rows 4 (rg + RG q) + e, columns
// col .. col + kCols - 1) into the row-major dh x dh matrix at dst.
template <int RG, int kRows>
__device__ __forceinline__ void store_tile(float* dst, const float (&st)[kRows][kCols], int rg,
                                           int col, int dh, int vec) {
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (rg + RG * q) + e;
      if (i >= dh) continue;
#pragma unroll
      for (int c4 = 0; c4 < kCols / 4; ++c4) {
        const int cc = col + 4 * c4;
        if (cc >= dh) break;
        const float* x = &st[4 * q + e][4 * c4];
        float* row = dst + static_cast<size_t>(i) * dh + cc;
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

// SAVE: also write S_{t-1} of token t to states (B, S, H, dh, dh).
template <typename T, int DHP, int RG, int MINB, bool SAVE>
__global__ void __launch_bounds__(Shape<T, DHP, RG>::kThreads, MINB)
wkv_forward_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, const float* __restrict__ beta,
                   const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sf,
                   float* __restrict__ states, int S, int H, int dh, int vec) {
  using Sh = Shape<T, DHP, RG>;
  constexpr int kRows = Sh::kRows;
  constexpr int kQ = kRows / 4;   // float4 row groups a thread
  constexpr int kC4 = kCols / 4;  // float4 column groups a thread
  __shared__ __align__(16) unsigned char stage[2][Sh::kBytes];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int rg = threadIdx.x % RG;  // row group: rows 4 (rg + RG q) + e
  const int cg = threadIdx.x / RG;  // columns col .. col + kCols - 1
  const int col = kCols * cg;

  // padding columns (and rows) of both stages stay zero
  for (int i = threadIdx.x; i < 2 * Sh::kBytes / 4; i += Sh::kThreads)
    reinterpret_cast<float*>(&stage[0][0])[i] = 0.f;

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
  stage_chunk<T, DHP, Sh::kThreads>(stage[0], w, k, r, v, beta, base, tok_stride, beta_base, H,
                                    0, min(kChunk, S), dh, vec);
  rt::cp_async_commit();

  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * kChunk;
    const int nt = min(kChunk, S - t0);
    if (ch + 1 < nch) {
      // the other buffer was released by the barrier that ended chunk ch - 1
      stage_chunk<T, DHP, Sh::kThreads>(stage[(ch + 1) & 1], w, k, r, v, beta, base,
                                        tok_stride, beta_base, H, t0 + kChunk,
                                        min(kChunk, S - t0 - kChunk), dh, vec);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of chunk ch have landed

    const float* buf = reinterpret_cast<const float*>(stage[ch & 1]);
    const T* krv = reinterpret_cast<const T*>(stage[ch & 1] + Sh::kKrv);
    const float* bb = reinterpret_cast<const float*>(stage[ch & 1] + Sh::kBeta);
    for (int c = 0; c < nt; ++c) {
      if constexpr (SAVE)
        store_tile<RG, kRows>(
            states + (static_cast<size_t>(b) * S * H + static_cast<size_t>(t0 + c) * H + h) *
                         dh * dh,
            st, rg, col, dh, vec);
      const float4* sw4 = reinterpret_cast<const float4*>(buf + c * DHP);
      const T* sk = krv + c * DHP;  // rows widened 4 elements at a time
      const T* sr = krv + (kChunk + c) * DHP;
      const T* sv = krv + (2 * kChunk + c) * DHP + col;
      const float bt = bb[c];

      float a[kCols];  // (S^T k)[col + j] after the decay, this row group
#pragma unroll
      for (int j = 0; j < kCols; ++j) a[j] = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 w4 = sw4[rg + RG * q];
        const float4 k4 = rt::load4(sk + 4 * (rg + RG * q));
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
        const float4 v4 = rt::load4(sv + 4 * c4);
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
        const float4 k4 = rt::load4(sk + 4 * (rg + RG * q));
        const float4 r4 = rt::load4(sr + 4 * (rg + RG * q));
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
template <typename T, int DHP, int RG, int MINB>
struct Instance {
  static cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                            const float* beta, const float* s0, float* y, float* sf,
                            float* states, int B, int S, int H, int dh, int vec,
                            cudaStream_t stream) {
    const T* rt_ = static_cast<const T*>(r);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    constexpr int kThreads = Shape<T, DHP, RG>::kThreads;
    if (states)
      wkv_forward_kernel<T, DHP, RG, MINB, true><<<B * H, kThreads, 0, stream>>>(
          rt_, kt, vt, w, beta, s0, y, sf, states, S, H, dh, vec);
    else
      wkv_forward_kernel<T, DHP, RG, MINB, false><<<B * H, kThreads, 0, stream>>>(
          rt_, kt, vt, w, beta, s0, y, sf, nullptr, S, H, dh, vec);
    return cudaGetLastError();
  }
  static cudaError_t attributes(cudaFuncAttributes* a) {
    return cudaFuncGetAttributes(a, wkv_forward_kernel<T, DHP, RG, MINB, false>);
  }
};

// The instances, by head dim: dh <= 32 (32 threads, 8 rows x 4 columns a
// thread), <= 64 (64 threads, 16 x 4), <= 128 (256 threads, 16 x 4, 8 row
// groups); each for fp32 and for bf16 r, k, v.
template <typename T>
struct Instances {
  using Dh32 = Instance<T, 32, 4, 16>;
  using Dh64 = Instance<T, 64, 4, 8>;
  using Dh128 = Instance<T, 128, 8, 2>;
  static cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                            const float* beta, const float* s0, float* y, float* sf,
                            float* states, int B, int S, int H, int dh, int vec,
                            cudaStream_t stream) {
    if (dh <= 32)
      return Dh32::launch(r, k, v, w, beta, s0, y, sf, states, B, S, H, dh, vec, stream);
    if (dh <= 64)
      return Dh64::launch(r, k, v, w, beta, s0, y, sf, states, B, S, H, dh, vec, stream);
    return Dh128::launch(r, k, v, w, beta, s0, y, sf, states, B, S, H, dh, vec, stream);
  }
  static cudaError_t attributes(int dh, cudaFuncAttributes* a) {
    return dh <= 32 ? Dh32::attributes(a) : dh <= 64 ? Dh64::attributes(a) : Dh128::attributes(a);
  }
};

}  // namespace

// r, k, v: (B, S, H, dh), fp32 (bf16 == 0) or bf16; w, y: (B, S, H, dh)
// fp32; beta: (B, S, H) fp32; s0 (may be null: zero state) and sf: (B, H,
// dh, dh) fp32; states (null: not written): (B, S, H, dh, dh) fp32,
// S_{t-1} of each token. Contiguous; dh <= 128. vec != 0: r, k, v, w, y,
// s0, sf, states 16-byte aligned and dh % 4 == 0 (fp32) or dh % 8 == 0
// (bf16).
extern "C" int rt_wkv_forward(const void* r, const void* k, const void* v, const float* w,
                              const float* beta, const float* s0, float* y, float* sf,
                              float* states, int B, int S, int H, int dh, int vec, int bf16,
                              cudaStream_t stream) {
  if (B * H == 0 || S == 0) return cudaSuccess;
  if (dh <= 0 || dh > 128) return cudaErrorInvalidValue;
  if (bf16)
    return Instances<__nv_bfloat16>::launch(r, k, v, w, beta, s0, y, sf, states, B, S, H, dh,
                                            vec, stream);
  return Instances<float>::launch(r, k, v, w, beta, s0, y, sf, states, B, S, H, dh, vec, stream);
}

// The serving kernel (no states) a launch at head dim dh on fp32 (bf16 ==
// 0) or bf16 r, k, v takes: out = {registers a thread, static shared bytes,
// dynamic shared bytes a block, local (spill) bytes a thread}.
extern "C" int rt_wkv_attributes(int bf16, int dh, int* out) {
  if (dh <= 0 || dh > 128) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = bf16 ? Instances<__nv_bfloat16>::attributes(dh, &a)
                               : Instances<float>::attributes(dh, &a);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = 0;
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

// ---------------------------------------------------------------- backward
//
// Reverse pass over the tokens, per (batch, head), from G = dL/dS_T
// (dsf, or zeros) and S_{t-1} of every token as the forward wrote it:
//     A = diag(w_t) S_{t-1};  delta = v_t - A^T k_t;  S_t = A + beta_t k_t delta^T
//     G += r_t dy_t^T;  dr_t = S_t dy_t
//     ddelta = beta_t G^T k_t;  dbeta_t = k_t^T G delta;  dv_t = ddelta
//     dk_t = beta_t G delta - A ddelta
//     dA = G - k_t ddelta^T;  dw_t[i] = sum_j dA[i][j] S_{t-1}[i][j];  G <- diag(w_t) dA
// The last G is dL/dS_0.
//
// What bounds it on the H100: every token reads its saved state once (dh^2
// floats), 0.81 GB per layer at B 64, S 128, H 6, dh 64, against about
// 4.4 GFLOP of fp32 work (11 dh^2 a token and head), so the bytes bound it
// (0.24 ms at 3.35 TB/s) if the serial chain of tokens keeps enough loads in
// flight. The design:
//   * one block per (batch, head); G in register tiles: a thread holds
//     kRows rows (rows rg + RG m, so the RG row groups of a quarter warp
//     read adjacent rows) of 4 value columns. kRows is 8 (4 at dh <= 32):
//     G, the row partials and the column vectors stay under 128 registers,
//     so dh 128 runs 512 threads a block instead of spilling;
//   * S_{t-1}, w, k, r, v, dy and beta of a token are staged by cp.async
//     into one of two shared slots while the other token is used (one
//     commit group a token); state rows have a stride of dh_pad + 4 floats,
//     so the 16-byte loads of a quarter warp hit distinct banks;
//   * the two column sums (A^T k, G^T k) run in one pass over the tile and
//     are summed over the row groups by shfl.xor; the three row sums (dr,
//     dk, dw) and dbeta are summed over a warp's column groups by shfl.xor,
//     then over the warps through shared memory in warp order;
//   * no atomics: every output element has one writer and a fixed order of
//     sums, so two launches give the same bits;
//   * the model layout (B, S, H, dh) is read in place; rows and columns past
//     dh are zero in the slots and in G and stay zero.
// Sums run in another order than the plain version's: within atol 1e-4 +
// rtol 1e-3.
namespace bwd {

constexpr int kCols = 4;  // value columns a thread

// T: element type of r, k, v (and dr, dk, dv); DHP: head dim padded (32,
// 64, 128); ROWS: rows of G a thread. A slot holds, in bytes: the state
// rows (fp32, stride kStride), w (fp32), k, r, v (T), dy (fp32), beta.
template <typename T, int DHP, int ROWS>
struct Shape {
  static constexpr int kDHP = DHP;
  static constexpr int kRows = ROWS;
  static constexpr int kRG = DHP / ROWS;        // row groups (low lane bits)
  static constexpr int kCG = DHP / kCols;       // column groups
  static constexpr int kThreads = kRG * kCG;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStride = DHP + 4;       // a state row in shared, floats
  static constexpr int kW = 4 * DHP * kStride;  // byte offsets in a slot: w,
  static constexpr int kKrv = kW + 4 * DHP;     // k, r, v,
  static constexpr int kDy = kKrv + 3 * DHP * static_cast<int>(sizeof(T));  // dy,
  static constexpr int kBeta = kDy + 4 * DHP;   // beta (16-byte padded)
  static constexpr int kSlotBytes = kBeta + 16;
  // two slots, then the row partials [3][kWarps][DHP] and dbeta's [kWarps]
  static constexpr int kBytes = 2 * kSlotBytes + 4 * (3 * kWarps * DHP + kWarps);
  static_assert(32 % kRG == 0 && kThreads % 32 == 0 && kCG * kCols == DHP, "tile");
  static_assert(kDy % 16 == 0 && kSlotBytes % 16 == 0, "slot alignment");
};

// Stages token t of the saved state and of w, k, r, v, dy, beta into slot:
// 16-byte copies when vec, else 4-byte ones (fp32 entries) and plain element
// copies (bf16 rows). Entries past dh are never written (they hold the
// zeros of the start).
template <typename T, class Sh>
__device__ __forceinline__ void stage_token(unsigned char* slot, const float* __restrict__ states,
                                            const float* w, const T* k, const T* r, const T* v,
                                            const float* dy, const float* __restrict__ beta,
                                            size_t sbase, size_t vbase, size_t bidx, int dh,
                                            int vec) {
  float* ss = reinterpret_cast<float*>(slot);
  float* sw = reinterpret_cast<float*>(slot + Sh::kW);
  T* skrv = reinterpret_cast<T*>(slot + Sh::kKrv);
  float* sdy = reinterpret_cast<float*>(slot + Sh::kDy);
  if (vec) {
    constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte copy
    const int d4 = dh / 4;
    const int dtn = dh / kPer16;
    for (int i = threadIdx.x; i < dh * d4; i += Sh::kThreads) {
      const int row = i / d4;
      const int c = 4 * (i - row * d4);
      rt::cp_async16(ss + row * Sh::kStride + c, states + sbase + static_cast<size_t>(row) * dh + c);
    }
    if constexpr (std::is_same<T, float>::value) {
      // w, k, r, v, dy lie back to back: one row of dh floats each
      for (int i = threadIdx.x; i < 5 * d4; i += Sh::kThreads) {
        const int a = i / d4;
        const int c = 4 * (i - a * d4);
        const float* src = a == 0 ? w : a == 1 ? k : a == 2 ? r : a == 3 ? v : dy;
        rt::cp_async16(sw + a * Sh::kDHP + c, src + vbase + c);
      }
    } else {
      for (int i = threadIdx.x; i < 2 * d4 + 3 * dtn; i += Sh::kThreads) {
        if (i < d4) {
          rt::cp_async16(sw + 4 * i, w + vbase + 4 * i);
        } else if (i < d4 + 3 * dtn) {
          const int a = (i - d4) / dtn;  // 0 k, 1 r, 2 v
          const int c = kPer16 * (i - d4 - a * dtn);
          const T* src = a == 0 ? k : a == 1 ? r : v;
          rt::cp_async16(skrv + a * Sh::kDHP + c, src + vbase + c);
        } else {
          const int c = 4 * (i - d4 - 3 * dtn);
          rt::cp_async16(sdy + c, dy + vbase + c);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < dh * dh; i += Sh::kThreads) {
      const int row = i / dh;
      const int c = i - row * dh;
      rt::cp_async4(ss + row * Sh::kStride + c, states + sbase + i);
    }
    for (int i = threadIdx.x; i < 5 * dh; i += Sh::kThreads) {
      const int a = i / dh;  // 0 w, 1 k, 2 r, 3 v, 4 dy
      const int c = i - a * dh;
      if constexpr (std::is_same<T, float>::value) {
        const float* src = a == 0 ? w : a == 1 ? k : a == 2 ? r : a == 3 ? v : dy;
        rt::cp_async4(sw + a * Sh::kDHP + c, src + vbase + c);
      } else if (a == 0) {
        rt::cp_async4(sw + c, w + vbase + c);
      } else if (a == 4) {
        rt::cp_async4(sdy + c, dy + vbase + c);
      } else {
        const T* src = a == 1 ? k : a == 2 ? r : v;
        skrv[(a - 1) * Sh::kDHP + c] = src[vbase + c];
      }
    }
  }
  if (threadIdx.x == 0) rt::cp_async4(slot + Sh::kBeta, beta + bidx);
}

template <typename T, int DHP, int ROWS, int MINB>
__global__ void __launch_bounds__(Shape<T, DHP, ROWS>::kThreads, MINB)
wkv_backward_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ w, const float* __restrict__ beta,
                    const float* __restrict__ states, const float* __restrict__ dy,
                    const float* __restrict__ dsf, T* __restrict__ dr, T* __restrict__ dk,
                    T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ dbeta,
                    float* __restrict__ ds0, int S, int H, int dh, int vec) {
  using Sh = Shape<T, DHP, ROWS>;
  constexpr int R = ROWS;
  constexpr int RG = Sh::kRG;
  constexpr int W = Sh::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem + 2 * Sh::kSlotBytes);  // [3][W][DHP] row partials
  float* bpart = part + 3 * W * DHP;                                  // [W] dbeta partials

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int rg = tid % RG;  // rows rg + RG m
  const int col = kCols * (tid / RG);
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // padding rows and columns of both slots stay zero
  for (int i = tid; i < 2 * Sh::kSlotBytes / 4; i += Sh::kThreads)
    reinterpret_cast<float*>(smem)[i] = 0.f;

  float g[R][kCols];  // G[rg + RG m][col + c]
  const float* gp = dsf ? dsf + static_cast<size_t>(bh) * dh * dh : nullptr;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = rg + RG * m;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      g[m][c] = gp && i < dh && col + c < dh ? gp[static_cast<size_t>(i) * dh + col + c] : 0.f;
  }

  const size_t tok = static_cast<size_t>(H) * dh;  // (B, S, H, dh) token stride
  const size_t vbase = (static_cast<size_t>(b) * S * H + h) * dh;
  const size_t sbase = vbase * dh;                 // (B, S, H, dh, dh)
  const size_t bbase = static_cast<size_t>(b) * S * H + h;

  __syncthreads();  // the zeros land before any copy into the same words
  stage_token<T, Sh>(smem, states, w, k, r, v, dy, beta, sbase + (S - 1) * tok * dh,
                     vbase + (S - 1) * tok, bbase + static_cast<size_t>(S - 1) * H, dh, vec);
  rt::cp_async_commit();

  for (int n = 0; n < S; ++n) {
    const int t = S - 1 - n;
    if (n + 1 < S) {
      // the other slot was released by the barrier that ended token t + 1
      stage_token<T, Sh>(smem + ((n + 1) & 1) * Sh::kSlotBytes, states, w, k, r, v, dy, beta,
                         sbase + (t - 1) * tok * dh, vbase + (t - 1) * tok,
                         bbase + static_cast<size_t>(t - 1) * H, dh, vec);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();  // token t has landed for every thread

    const unsigned char* slot = smem + (n & 1) * Sh::kSlotBytes;
    const float* sl = reinterpret_cast<const float*>(slot);
    const float* sw = reinterpret_cast<const float*>(slot + Sh::kW);
    const T* sk = reinterpret_cast<const T*>(slot + Sh::kKrv);
    const T* sr = sk + DHP;
    const float4 v4 = rt::load4(sr + DHP + col);
    const float4 y4 = *reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(slot + Sh::kDy) + col);
    const float bt = *reinterpret_cast<const float*>(slot + Sh::kBeta);
    const float vv[kCols] = {v4.x, v4.y, v4.z, v4.w};
    const float dyv[kCols] = {y4.x, y4.y, y4.z, y4.w};

    // pass 1: G += r dy^T; the column sums (A^T k)_j and (G^T k)_j
    float a[kCols], gk[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) a[c] = gk[c] = 0.f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = rg + RG * m;
      const float wi = sw[i], ki = rt::to_f32(sk[i]), ri = rt::to_f32(sr[i]);
      const float4 s4 = *reinterpret_cast<const float4*>(sl + i * Sh::kStride + col);
      const float sp[kCols] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        a[c] = fmaf(sp[c] * wi, ki, a[c]);
        g[m][c] = fmaf(ri, dyv[c], g[m][c]);
        gk[c] = fmaf(g[m][c], ki, gk[c]);
      }
    }
#pragma unroll
    for (int off = 1; off < RG; off <<= 1)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        a[c] += __shfl_xor_sync(0xffffffffu, a[c], off);
        gk[c] += __shfl_xor_sync(0xffffffffu, gk[c], off);
      }
    float dl[kCols], dd[kCols];  // delta, ddelta
    float pb = 0.f;              // dbeta partial (row group 0 only)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dl[c] = vv[c] - a[c];
      dd[c] = bt * gk[c];
      pb = fmaf(dl[c], gk[c], pb);
    }
    if (rg != 0) pb = 0.f;

    // pass 2: the row partials of dr, dk, dw; G <- diag(w) (G - k ddelta^T)
    float pr[R], pk[R], pw[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = rg + RG * m;
      const float wi = sw[i], ki = rt::to_f32(sk[i]);
      const float4 s4 = *reinterpret_cast<const float4*>(sl + i * Sh::kStride + col);
      const float sp[kCols] = {s4.x, s4.y, s4.z, s4.w};
      const float bk = bt * ki;
      pr[m] = pk[m] = pw[m] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float A = sp[c] * wi;
        pr[m] = fmaf(fmaf(bk, dl[c], A), dyv[c], pr[m]);
        pk[m] = fmaf(bt * g[m][c], dl[c], pk[m]);
        pk[m] = fmaf(-A, dd[c], pk[m]);
        const float dA = fmaf(-ki, dd[c], g[m][c]);
        pw[m] = fmaf(dA, sp[c], pw[m]);
        g[m][c] = wi * dA;
      }
    }
    // over the warp's column groups (lanes rg + RG x)
#pragma unroll
    for (int off = RG; off < 32; off <<= 1) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        pr[m] += __shfl_xor_sync(0xffffffffu, pr[m], off);
        pk[m] += __shfl_xor_sync(0xffffffffu, pk[m], off);
        pw[m] += __shfl_xor_sync(0xffffffffu, pw[m], off);
      }
      pb += __shfl_xor_sync(0xffffffffu, pb, off);
    }
    if (lane < RG) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = rg + RG * m;
        part[(0 * W + warp) * DHP + i] = pr[m];
        part[(1 * W + warp) * DHP + i] = pk[m];
        part[(2 * W + warp) * DHP + i] = pw[m];
      }
      if (lane == 0) bpart[warp] = pb;
    }
    if (rg == 0) {  // dv = ddelta
      T* o = dv + vbase + t * tok;
      if (vec && col < dh) {
        rt::store4(o + col, make_float4(dd[0], dd[1], dd[2], dd[3]));
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (col + c < dh) o[col + c] = rt::from_f32<T>(dd[c]);
      }
    }
    __syncthreads();  // the partials are in; slot n & 1 is free for token t - 2

    // over the warps, in warp order: dr, dk, dw of token t, then dbeta
    for (int idx = tid; idx < 3 * DHP; idx += Sh::kThreads) {
      const int which = idx / DHP;
      const int i = idx - which * DHP;
      if (i >= dh) continue;
      float s = 0.f;
#pragma unroll
      for (int x = 0; x < W; ++x) s += part[(which * W + x) * DHP + i];
      const size_t at = vbase + t * tok + i;
      if constexpr (std::is_same<T, float>::value) {
        float* o = which == 0 ? dr : which == 1 ? dk : dw;
        o[at] = s;
      } else if (which == 2) {
        dw[at] = s;
      } else {
        (which == 0 ? dr : dk)[at] = rt::from_f32<T>(s);
      }
    }
    if (tid == 0) {
      float s = 0.f;
#pragma unroll
      for (int x = 0; x < W; ++x) s += bpart[x];
      dbeta[bbase + static_cast<size_t>(t) * H] = s;
    }
  }

  // dL/dS_0
  float* o = ds0 + static_cast<size_t>(bh) * dh * dh;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = rg + RG * m;
    if (i >= dh || col >= dh) continue;
    float* row = o + static_cast<size_t>(i) * dh + col;
    if (vec) {
      *reinterpret_cast<float4*>(row) = make_float4(g[m][0], g[m][1], g[m][2], g[m][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (col + c < dh) row[c] = g[m][c];
    }
  }
}

template <typename T, int DHP, int ROWS, int MINB>
struct Instance {
  using Sh = Shape<T, DHP, ROWS>;
  static cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                            const float* beta, const float* states, const float* dy,
                            const float* dsf, void* dr, void* dk, void* dv, float* dw,
                            float* dbeta, float* ds0, int B, int S, int H, int dh, int vec,
                            cudaStream_t stream) {
    const cudaError_t err = rt::allow_smem(wkv_backward_kernel<T, DHP, ROWS, MINB>, Sh::kBytes);
    if (err != cudaSuccess) return err;
    wkv_backward_kernel<T, DHP, ROWS, MINB><<<B * H, Sh::kThreads, Sh::kBytes, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, beta,
        states, dy, dsf, static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw,
        dbeta, ds0, S, H, dh, vec);
    return cudaGetLastError();
  }
  static cudaError_t attributes(cudaFuncAttributes* a) {
    return cudaFuncGetAttributes(a, wkv_backward_kernel<T, DHP, ROWS, MINB>);
  }
};

// dh <= 32: 64 threads (4 rows x 4 columns a thread); <= 64: 128 threads
// (8 x 4); <= 128: 512 threads (8 x 4, 16 row groups); each for fp32 and
// for bf16 r, k, v.
template <typename T>
struct Instances {
  using Dh32 = Instance<T, 32, 4, 8>;
  using Dh64 = Instance<T, 64, 8, 4>;
  using Dh128 = Instance<T, 128, 8, 1>;
  static cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                            const float* beta, const float* states, const float* dy,
                            const float* dsf, void* dr, void* dk, void* dv, float* dw,
                            float* dbeta, float* ds0, int B, int S, int H, int dh, int vec,
                            cudaStream_t stream) {
    if (dh <= 32)
      return Dh32::launch(r, k, v, w, beta, states, dy, dsf, dr, dk, dv, dw, dbeta, ds0, B, S,
                          H, dh, vec, stream);
    if (dh <= 64)
      return Dh64::launch(r, k, v, w, beta, states, dy, dsf, dr, dk, dv, dw, dbeta, ds0, B, S,
                          H, dh, vec, stream);
    return Dh128::launch(r, k, v, w, beta, states, dy, dsf, dr, dk, dv, dw, dbeta, ds0, B, S, H,
                         dh, vec, stream);
  }
  static cudaError_t attributes(int dh, cudaFuncAttributes* a, int* bytes) {
    *bytes = dh <= 32 ? Dh32::Sh::kBytes : dh <= 64 ? Dh64::Sh::kBytes : Dh128::Sh::kBytes;
    return dh <= 32 ? Dh32::attributes(a) : dh <= 64 ? Dh64::attributes(a) : Dh128::attributes(a);
  }
};

}  // namespace bwd

// r, k, v, dr, dk, dv: (B, S, H, dh), fp32 (bf16 == 0) or bf16; w, dy, dw:
// (B, S, H, dh) fp32; beta, dbeta: (B, S, H) fp32; states: (B, S, H, dh,
// dh) as rt_wkv_forward wrote it; dsf (may be null: zeros) and ds0: (B, H,
// dh, dh) fp32. Contiguous; S >= 1, dh <= 128. vec != 0: every pointer but
// beta's and dbeta's 16-byte aligned and dh % 4 == 0 (fp32) or dh % 8 == 0
// (bf16).
extern "C" int rt_wkv_backward(const void* r, const void* k, const void* v, const float* w,
                               const float* beta, const float* states, const float* dy,
                               const float* dsf, void* dr, void* dk, void* dv, float* dw,
                               float* dbeta, float* ds0, int B, int S, int H, int dh, int vec,
                               int bf16, cudaStream_t stream) {
  if (B * H == 0) return cudaSuccess;
  if (S <= 0 || dh <= 0 || dh > 128) return cudaErrorInvalidValue;
  if (bf16)
    return bwd::Instances<__nv_bfloat16>::launch(r, k, v, w, beta, states, dy, dsf, dr, dk, dv,
                                                 dw, dbeta, ds0, B, S, H, dh, vec, stream);
  return bwd::Instances<float>::launch(r, k, v, w, beta, states, dy, dsf, dr, dk, dv, dw, dbeta,
                                       ds0, B, S, H, dh, vec, stream);
}

// The backward kernel a launch at head dim dh on fp32 (bf16 == 0) or bf16
// r, k, v takes: out = {registers a thread, static shared bytes, dynamic
// shared bytes a block, local (spill) bytes a thread}.
extern "C" int rt_wkv_backward_attributes(int bf16, int dh, int* out) {
  if (dh <= 0 || dh > 128) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  int bytes = 0;
  const cudaError_t err = bf16 ? bwd::Instances<__nv_bfloat16>::attributes(dh, &a, &bytes)
                               : bwd::Instances<float>::attributes(dh, &a, &bytes);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = bytes;
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}
