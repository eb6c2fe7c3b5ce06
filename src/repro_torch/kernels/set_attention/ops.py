"""Wrappers of the set-attention kernels: dispatch by device, checks,
launch counts, and the autograd Function that joins the two.

Replaces `repro.kernels.set_attention.ops.masked_set_attention` and the
custom VJP around it (`set_attn.py:154-171`). The CUDA kernels take any
N >= 1 and M >= 1 unpadded, so none of the TPU wrapper's tile padding is
carried over.

`masked_set_attention` is differentiable on both devices: when a
gradient is wanted it runs through `_SetAttention`, whose forward saves
only its inputs and whose backward recomputes P (flash-style, as the JAX
custom VJP does) through `set_attention_backward`: the backward kernel on
CUDA tensors, the plain backward on CPU tensors. Without a gradient to
take (inference, `torch.inference_mode`) the forward runs alone and
nothing is saved.

On meta tensors both return empty outputs of the kernels' shapes and
dtypes; under an active step count (`repro_torch.analysis.counting`) each
call is one kernel record of its `analysis.costs` work.

dtypes, as JAX's kernel takes them: q, k, v (and the cotangent do) fp32
or bf16, one dtype; the bias fp32. The output and dq, dk, dv come back in
that dtype, db in fp32. A bf16 q on CUDA launches the kernels' bf16
instances, which read the inputs as they are and keep P in fp32."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.analysis import costs, counting
from repro_torch.kernels import _lib
from repro_torch.kernels.set_attention.ref import (
    set_attention_backward_reference, set_attention_reference,
)


def _cuda_inputs(q, k, v, key_bias, key_mask):
    """Checks the CUDA kernels' inputs; returns (B, H, N, M, dh, mask as
    uint8 or None, the kernels' bf16 flag)."""
    B, H, N, dh = q.shape
    M = k.shape[2]
    bf16 = _lib.float_or_bf16(q, "q")
    _lib.require(q, "q", (B, H, N, dh), q.dtype)
    _lib.require(k, "k", (B, H, M, dh), q.dtype)
    _lib.require(v, "v", (B, H, M, dh), q.dtype)
    if key_bias is not None:
        _lib.require(key_bias, "key_bias", (B, M))
    if key_mask is not None:
        # a bool mask is its own uint8 bytes (0 / 1): no conversion launch
        key_mask = (key_mask.view(torch.uint8) if key_mask.dtype == torch.bool
                    else key_mask.to(torch.uint8))
        _lib.require(key_mask, "key_mask", (B, M), torch.uint8)
    if M == 0:
        raise ValueError("masked_set_attention: needs at least one key")
    return B, H, N, M, dh, key_mask, bf16


def _vec(*tensors) -> bool:
    """The vector route: rows of whole 4-element groups, aligned to them
    (16 bytes in fp32, 8 in bf16)."""
    return _lib.rows_aligned(4 * tensors[0].element_size(), *tensors)


# head dims the forward and backward kernels take
MAX_HEAD_DIM = 256
# the backward's routes (csrc/set_attention.cu, namespace bwd)
SMALL_N = 4                      # N up to this: a block of 128 per (b, h)
TILED_SHARED_BYTES = 4 * 6 * 64 * 68   # q, dO, k, v chunks, P and dS
SHARED_LIMIT = 232448            # 227 KB a block


def backward_plan(N: int, M: int, dh: int,
                  dtype: torch.dtype = torch.float32) -> dict:
    """The backward kernel that a launch at (N, M, dh) takes, as
    `rt_set_attention_backward` chooses it: "small_n" (128 threads per
    (b, h)) for N <= 4 while 64 rows each of k and v, q, dO, P and dS fit
    in 227 KB, else "tiled" (256 threads per (b, h), 104,448 bytes at any
    N, M and dh); with its threads and dynamic shared bytes a block (the
    same in bf16, whose instances widen the inputs into the fp32 tiles),
    and `scratch_floats`, the fp32 partial sums of dq, dk, dv that the
    tiled bf16 instance keeps when N or M is past one tile of 64 (else 0),
    per (b, h). Raises for a shape no kernel takes."""
    if N <= 0 or M <= 0 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"set_attention_backward: no kernel takes N {N}, "
                         f"M {M}, head dim {dh} (1..{MAX_HEAD_DIM})")
    small = 4 * (2 * 64 * (dh + 4) + 2 * N * (dh + M))
    if N <= SMALL_N and small <= SHARED_LIMIT:
        return dict(route="small_n", threads=128, shared_bytes=small,
                    scratch_floats=0)
    scratch = (dtype == torch.bfloat16 and max(N, M) > 64) * (N + 2 * M) * dh
    return dict(route="tiled", threads=256, shared_bytes=TILED_SHARED_BYTES,
                scratch_floats=scratch)


def _work(q, k, key_bias, key_mask, backward: bool = False):
    B, H, N, dh = q.shape
    fn = costs.set_attention_backward if backward else costs.set_attention
    return fn(B, H, N, k.shape[2], dh, q.dtype, key_bias is not None,
              key_mask is not None)


def _forward(q, k, v, key_bias, key_mask):
    count = counting.ACTIVE
    if count is not None and count.open:
        with count.kernel("set_attention",
                          _work(q, k, key_bias, key_mask)):
            return _forward(q, k, v, key_bias, key_mask)
    kind = _lib.device_kind(q, k, v, key_bias, key_mask)
    if kind == "cpu":
        return set_attention_reference(q, k, v, key_bias, key_mask)
    B, H, N, M, dh, key_mask, bf16 = _cuda_inputs(q, k, v, key_bias,
                                                  key_mask)
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"masked_set_attention: head dim {dh} > "
                         f"{MAX_HEAD_DIM}")
    o = torch.empty_like(q)
    if kind == "meta":
        return o
    lib = _lib.load_library()
    rc = lib.rt_set_attention_forward(
        _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(key_bias),
        _lib.ptr(key_mask), _lib.ptr(o), B, H, N, M, dh,
        int(_vec(q, k, v, o)), bf16, dh ** -0.5, _lib.stream())
    _lib.check(rc, "set_attention")
    _lib.counted(masked_set_attention, bf16)
    return o


def set_attention_backward(q, k, v, key_bias, key_mask, do):
    """Cotangents of `masked_set_attention(q, k, v, key_bias, key_mask)`
    for the output cotangent do: (B,H,N,dh). Returns (dq, dk, dv, db),
    db (B,H,M) fp32 per head (not yet summed over heads).

    CPU tensors take the plain backward; CUDA tensors (q, k, v, do fp32 or
    bf16, contiguous, dh <= 256) launch the backward kernel that
    `backward_plan` names, in q's dtype, with vector loads and stores when
    every row is aligned to 4 elements. Under an active step count, one
    kernel record."""
    count = counting.ACTIVE
    if count is not None and count.open:
        with count.kernel("set_attention_backward",
                          _work(q, k, key_bias, key_mask, backward=True)):
            return set_attention_backward(q, k, v, key_bias, key_mask, do)
    kind = _lib.device_kind(q, k, v, key_bias, key_mask, do)
    if kind == "cpu":
        return set_attention_backward_reference(q, k, v, key_bias, key_mask,
                                                do)
    B, H, N, M, dh, key_mask, bf16 = _cuda_inputs(q, k, v, key_bias,
                                                  key_mask)
    _lib.require(do, "do", (B, H, N, dh), q.dtype)
    if N == 0:
        return (torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v),
                torch.zeros((B, H, M), dtype=torch.float32, device=q.device))
    plan = backward_plan(N, M, dh, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    db = torch.empty((B, H, M), dtype=torch.float32, device=q.device)
    scratch = (torch.empty(B * H * plan["scratch_floats"],
                           dtype=torch.float32, device=q.device)
               if plan["scratch_floats"] else None)
    if kind == "meta":
        return dq, dk, dv, db
    lib = _lib.load_library()
    rc = lib.rt_set_attention_backward(
        _lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(key_bias),
        _lib.ptr(key_mask), _lib.ptr(do), _lib.ptr(dq), _lib.ptr(dk),
        _lib.ptr(dv), _lib.ptr(db), _lib.ptr(scratch), B, H, N, M, dh,
        int(_vec(q, k, v, do)), bf16, dh ** -0.5, _lib.stream())
    _lib.check(rc, "set_attention_backward")
    _lib.counted(set_attention_backward, bf16)
    return dq, dk, dv, db


class _SetAttention(torch.autograd.Function):
    """Forward kernel (or plain forward) with the backward kernel (or
    plain backward) as its gradient. Saves only (q, k, v, key_bias,
    key_mask): P is recomputed in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, key_mask):
        ctx.save_for_backward(q, k, v, key_bias, key_mask)
        return _forward(q, k, v, key_bias, key_mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, key_bias, key_mask = ctx.saved_tensors
        dq, dk, dv, db = set_attention_backward(q, k, v, key_bias, key_mask,
                                                do.contiguous())
        # the bias is shared by the heads: sum their gradients, in order
        dbias = db.sum(dim=1) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None


def masked_set_attention(q, k, v, key_bias=None, key_mask=None):
    """q: (B,H,N,dh); k,v: (B,H,M,dh); key_bias: (B,M) additive bias;
    key_mask: (B,M) valid flags. Returns (B,H,N,dh).

    CPU tensors take the plain version; CUDA tensors (fp32 or bf16,
    contiguous, dh <= 256) launch the forward kernel's instance of q's
    dtype: a register-tiled block per
    (b, h) for N > 4 (4·(68·(dh + max(dh, 64)) + 64·dh) bytes of shared
    memory, 51 KB at dh 64), a warp per (b, h) for N <= 4 (the PMA;
    4·(32·(dh + 4) + N·(dh + M)) bytes a warp, which must fit in 227 KB).
    Differentiable in q, k, v and key_bias (not in the mask)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, key_bias)):
        return _SetAttention.apply(q, k, v, key_bias, key_mask)
    return _forward(q, k, v, key_bias, key_mask)


# launches of the kernels, and of their bf16 instances among them
masked_set_attention.launches = masked_set_attention.launches_bf16 = 0
set_attention_backward.launches = set_attention_backward.launches_bf16 = 0
