"""Wrapper of the set-attention forward kernel: dispatch by device,
checks, launch count.

Replaces `repro.kernels.set_attention.ops.masked_set_attention`. The CUDA
kernel takes any N >= 1 and M >= 1 unpadded, so none of the TPU
wrapper's tile padding is carried over."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.set_attention.ref import set_attention_reference


def masked_set_attention(q, k, v, key_bias=None, key_mask=None):
    """q: (B,H,N,dh); k,v: (B,H,M,dh); key_bias: (B,M) additive bias;
    key_mask: (B,M) valid flags. Returns (B,H,N,dh).

    CPU tensors take the plain version; CUDA tensors (fp32, contiguous)
    launch the kernel, which needs (N·dh + M·(2dh+1) + N·M)·4 bytes of
    shared memory a block, at most 227 KB."""
    if _lib.device_kind(q, k, v, key_bias, key_mask) == "cpu":
        return set_attention_reference(q, k, v, key_bias, key_mask)
    B, H, N, dh = q.shape
    M = k.shape[2]
    _lib.require(q, "q", (B, H, N, dh))
    _lib.require(k, "k", (B, H, M, dh))
    _lib.require(v, "v", (B, H, M, dh))
    if key_bias is not None:
        _lib.require(key_bias, "key_bias", (B, M))
    if key_mask is not None:
        key_mask = key_mask.to(torch.uint8)
        _lib.require(key_mask, "key_mask", (B, M), torch.uint8)
    if M == 0:
        raise ValueError("masked_set_attention: needs at least one key")
    o = torch.empty_like(q)
    lib = _lib.load_library()
    rc = lib.rt_set_attention_forward(
        _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(key_bias),
        _lib.ptr(key_mask), _lib.ptr(o), B, H, N, M, dh, dh ** -0.5,
        _lib.stream())
    _lib.check(rc, "set_attention")
    masked_set_attention.launches += 1
    return o


masked_set_attention.launches = 0
