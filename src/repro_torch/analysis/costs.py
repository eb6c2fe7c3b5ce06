"""The H100's published peaks, and the work of every hand-written kernel
of the port counted from its shapes.

`H100_SXM` holds the same fields as JAX's `Hardware`
(`repro.analysis.roofline`), plus the fp32 peak outside the tensor cores
and the links of a node and between nodes. Each constant is NVIDIA's
H100 SXM5 data sheet figure (dense rates, no sparsity, at the full 700 W
power limit).

Each kernel's function gives the `Work` of one call: the products and
other operations it does on these inputs (those of bf16 operands on the
tensor cores apart), and the bytes it must move, each input read once and
each output written once, whatever the kernel reads again. One formula
per kernel, in one place: the wrappers add it to an active step count
(`repro_torch.analysis.counting`) and `chip_smoke.py` takes its bounds
from it. `work_bound` turns a `Work` into the least time the card could
take for it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # per card, bf16 / fp16 on the tensor cores
    peak_flops_fp32: float   # per card, fp32 outside the tensor cores
    hbm_bw: float            # bytes/s per card
    link_bw: float           # bytes/s a direction per card within a node
    hbm_bytes: float         # capacity per card
    node_size: int           # cards a node joins by `link_bw`
    inter_node_bw: float     # bytes/s a direction per card between nodes


H100_SXM = Hardware(
    name="h100-sxm",
    # H100 SXM5 data sheet: BF16 Tensor Core 1,979 TFLOPS with sparsity,
    # 989 dense
    peak_flops=989e12,
    # FP32 67 TFLOPS (the CUDA cores)
    peak_flops_fp32=67e12,
    # HBM3 3.35 TB/s
    hbm_bw=3.35e12,
    # NVLink 4: 900 GB/s a card, 450 GB/s each direction, 8 cards an HGX
    # node
    link_bw=450e9,
    # 80 GB HBM3
    hbm_bytes=80e9,
    node_size=8,
    # ConnectX-7 NDR InfiniBand, 400 Gb/s a card: 50 GB/s each direction
    inter_node_bw=50e9,
)

PEAK_BYTES_PER_S = H100_SXM.hbm_bw
PEAK_FP32_FLOP_PER_S = H100_SXM.peak_flops_fp32
PEAK_BF16_FLOP_PER_S = H100_SXM.peak_flops


class Work(NamedTuple):
    """What one call must do: operations outside the tensor cores (or on
    fp32 operands), products of bf16 operands, and bytes moved."""
    flops_fp32: float
    flops_bf16: float
    bytes: float


def work_bound(work: Work) -> Tuple[float, str]:
    """(bound_ms, bound_by) of a `Work`: the larger of its bytes over the
    memory rate and its operations over their peaks (`flops_fp32` over
    the fp32 peak plus `flops_bf16` over the bf16 peak)."""
    t_bytes = work.bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (work.flops_fp32 / PEAK_FP32_FLOP_PER_S
             + work.flops_bf16 / PEAK_BF16_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------- wkv

def wkv(B: int, S: int, H: int, dh: int, dtype: torch.dtype = torch.float32,
        state_in: bool = False, save: bool = False) -> Work:
    """The wkv forward: r, k, v (`dtype`), w, beta read; y and the final
    state written (fp32); the initial state read when given, S_{t-1} of
    every token written when saved; 7 dh^2 fp32 operations a token and
    head."""
    n = B * S * H * dh
    state = B * H * dh * dh
    nbytes = (3 * _size(dtype) * n + 4 * (n + B * S * H)
              + 4 * (n + state) + 4 * state * state_in + 4 * n * dh * save)
    return Work(7 * B * H * S * dh * dh, 0.0, nbytes)


def wkv_backward(B: int, S: int, H: int, dh: int,
                 dtype: torch.dtype = torch.float32,
                 dstate_final: bool = True) -> Work:
    """The wkv backward: r, k, v (`dtype`), w, dy, beta, the saved states
    and the final state's cotangent (when given) read; dr, dk, dv
    (`dtype`), dw, dbeta and dS_0 written; 22 dh^2 fp32 operations a
    token and head (A formed in both passes)."""
    n = B * S * H * dh
    state = B * H * dh * dh
    e = _size(dtype)
    reads = 3 * e * n + 4 * (2 * n + B * S * H + n * dh
                             + state * dstate_final)
    writes = 3 * e * n + 4 * (n + B * S * H + state)
    return Work(22 * n * dh, 0.0, reads + writes)


# -------------------------------------------------------- set attention

def set_attention(B: int, H: int, N: int, M: int, dh: int,
                  dtype: torch.dtype = torch.float32, bias: bool = True,
                  mask: bool = True) -> Work:
    """The masked set-attention forward: q, k, v read and o written
    (`dtype`), the fp32 key bias and the byte mask read when given. In
    fp32, 4 dh + 5 operations a (query, key) pair; in bf16 Q K^T's 2 dh
    are bf16 products, P V (P fp32) and the softmax fp32."""
    e = _size(dtype)
    nbytes = (e * (2 * B * H * N * dh + 2 * B * H * M * dh)
              + 4 * B * M * bias + B * M * mask)
    pairs = B * H * N * M
    if dtype == torch.bfloat16:
        return Work(pairs * (2 * dh + 5), pairs * 2 * dh, nbytes)
    return Work(pairs * (4 * dh + 5), 0.0, nbytes)


def set_attention_backward(B: int, H: int, N: int, M: int, dh: int,
                           dtype: torch.dtype = torch.float32,
                           bias: bool = True, mask: bool = True) -> Work:
    """The set-attention backward: q, dO, k, v read and dq, dk, dv
    written (`dtype`), db (fp32, per head) written, bias and mask read
    when given. In fp32, 10 dh + 12 operations a pair (the recomputed
    scores, dP, dV, dK, dQ and the softmax's); in bf16 Q K^T and dO V^T
    (4 dh) are bf16 products."""
    e = _size(dtype)
    nbytes = (e * (2 * B * H * N * dh + 2 * B * H * M * dh)
              + e * (B * H * N * dh + 2 * B * H * M * dh) + 4 * B * H * M
              + 4 * B * M * bias + B * M * mask)
    pairs = B * H * N * M
    if dtype == torch.bfloat16:
        return Work(pairs * (6 * dh + 12), pairs * 4 * dh, nbytes)
    return Work(pairs * (10 * dh + 12), 0.0, nbytes)


# -------------------------------------------------------------- k-means

def kmeans_assign(N: int, d: int, K: int,
                  dtype: torch.dtype = torch.float32) -> Work:
    """Nearest centroid: the rows (`dtype`) and the fp32 centroids read,
    labels and distances written; 2 K d + 2 d + 3 K operations a row."""
    return Work(N * (2 * K * d + 2 * d + 3 * K), 0.0,
                _size(dtype) * N * d + 4 * K * d + 8 * N)


def kmeans_update(N: int, d: int, K: int, dtype: torch.dtype = torch.float32,
                  n_valid: int = -1, valid: bool = True) -> Work:
    """One Lloyd step over the live rows (`n_valid`; -1: all N): their
    rows (`dtype`), the weights of all N rows (when given) and the
    centroids read, the sums, counts and inertia written; 2 K d + 3 d +
    3 K operations a live row."""
    nv = N if n_valid < 0 else n_valid
    nbytes = (_size(dtype) * nv * d + 4 * N * valid + 4 * K * d
              + 4 * (K * d + K + 1))
    return Work(nv * (2 * K * d + 2 * d + 3 * K + d), 0.0, nbytes)


# ------------------------------------------------------ flash attention

def visible_pairs(S: int, T: int, causal: bool, window: int = 0,
                  prefix_len: int = 0) -> int:
    """Unmasked (query, key) pairs of one head, positions from 0 for both:
    key j is visible to query i when j <= i or j < prefix_len (causal),
    and i - j < window (window > 0). Summed per query row in closed form
    (O(S) memory at any T)."""
    if S <= 0 or T <= 0:
        return 0
    i = np.arange(S, dtype=np.int64)
    if causal:
        top = np.maximum(np.minimum(i, T - 1), min(prefix_len, T) - 1)
    else:
        top = np.full(S, T - 1, dtype=np.int64)
    low = np.maximum(i - window, -1) if window > 0 else np.full(S, -1)
    return int(np.maximum(top - low, 0).sum())


def flash_attention(B: int, S: int, T: int, H: int, K: int, D: int,
                    dtype: torch.dtype = torch.bfloat16, causal: bool = True,
                    window: int = 0, prefix_len: int = 0,
                    lse: bool = False) -> Work:
    """The flash forward: q, k, v read and o written (`dtype`), the fp32
    log-sum-exp of each row written when asked; 4 D operations a visible
    pair (Q K^T and P V), bf16 products in bf16."""
    e = _size(dtype)
    nbytes = e * (2 * B * S * H * D + 2 * B * T * K * D) + 4 * B * H * S * lse
    flops = 4 * D * B * H * visible_pairs(S, T, causal, window, prefix_len)
    if dtype == torch.bfloat16:
        return Work(0.0, flops, nbytes)
    return Work(flops, 0.0, nbytes)


def flash_attention_backward(B: int, S: int, T: int, H: int, K: int, D: int,
                             dtype: torch.dtype = torch.bfloat16,
                             causal: bool = True, window: int = 0,
                             prefix_len: int = 0) -> Work:
    """The flash backward: q, k, v, o, dO read and dq, dk, dv written
    (`dtype`), the log-sum-exp read and delta written (fp32); 10 D
    operations a visible pair (S = Q K^T, dP = dO V^T, dV, dK, dQ)."""
    e = _size(dtype)
    nbytes = e * (4 * B * S * H * D + 4 * B * T * K * D) + 2 * 4 * B * H * S
    flops = 10 * D * B * H * visible_pairs(S, T, causal, window, prefix_len)
    if dtype == torch.bfloat16:
        return Work(0.0, flops, nbytes)
    return Work(flops, 0.0, nbytes)
