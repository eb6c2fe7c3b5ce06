"""The benchmark's frozen arithmetic: the H100's published peaks, the
work of the wkv recurrence, and the matrix-product parameters of both
stages, from which the roofline and mfu metrics are taken.

Peaks: NVIDIA's H100 SXM5 data sheet (dense rates, no sparsity, at the
full 700 W): 67 TFLOP/s fp32 on the CUDA cores (TF32 off), 3.35 TB/s
of HBM3. A configuration in another dtype adds its peak here.
"""
from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def wkv_work(B: int, S: int, H: int, dh: int, dtype: str, train: bool):
    """(operations, bytes) the recurrence needs over (B, S, H, dh),
    whatever implements it: r, k, v (in `dtype`), w, beta read and y
    written (fp32), the state carried in and out (fp32); in training
    also dy read, dr, dk, dv (`dtype`), dw, dbeta written. 7 dh^2
    operations a token and head forward, 22 backward. Per-token states a
    design may save are not counted."""
    e = DTYPE_BYTES[dtype]
    n = B * S * H * dh
    gates = B * S * H
    state = B * H * dh * dh
    nbytes = 3 * e * n + 4 * (n + gates) + 4 * n + 2 * 4 * state
    ops = 7 * n * dh
    if train:
        nbytes += 4 * n + 3 * e * n + 4 * (n + gates) + 2 * 4 * state
        ops += 22 * n * dh
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the fp32 peak (the recurrence runs on the CUDA cores) and the
    bytes over the HBM rate."""
    return max(ops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S)


def stage1_params(cfg: dict) -> int:
    """Matrix-product parameters a token meets in the encoder's forward:
    each layer's time mix (wr, wk, wv, ww, wo: d x d; wbeta: d x H) and
    channel mix (d x 4d, 4d x d), and the pool's d x d; embedding tables
    left out."""
    d, H = sum(cfg["dim_embeds"]), cfg["num_heads"]
    return cfg["num_layers"] * (13 * d * d + d * H) + d * d + d


def stage1_block_params(cfg: dict) -> int:
    """... and those a block meets once: the output projection."""
    return sum(cfg["dim_embeds"]) * cfg["bbe_dim"]


def pretrain_params(cfg: dict, vocab: int) -> int:
    """Matrix-product parameters a token meets in pre-training: the
    backbone's layers, the NTP head (d x d, d x V) and the NIP head
    (d x d, d x nip_horizon V); the pool is not on this path."""
    d, H = sum(cfg["dim_embeds"]), cfg["num_heads"]
    return (cfg["num_layers"] * (13 * d * d + d * H)
            + 2 * d * d + d * vocab * (1 + cfg["nip_horizon"]))


def stage2_element_params(cfg: dict) -> int:
    """A set element's: the input projection ((bbe_dim + 1) x d), each
    SAB's q, k, v, o (4 d^2) and feed-forward (d x 2d, 2d x d), the
    pooling block's k and v (2 d^2)."""
    d = cfg["d_model"]
    return (cfg["bbe_dim"] + 1) * d + cfg["num_sabs"] * 8 * d * d + 2 * d * d


def stage2_set_params(cfg: dict) -> int:
    """A set's, met once a seed: the pooling block's q, o and
    feed-forward, the output projection and the CPI head."""
    d, s = cfg["d_model"], cfg["sig_dim"]
    return cfg["num_seeds"] * 6 * d * d + cfg["num_seeds"] * d * s + s * d + d
