"""Wrappers of the flash-attention kernels: dispatch by device and dtype,
checks, launch counts, and the autograd Function that joins the forward
and the backward.

Replaces `repro.kernels.flash_attention.ops.flash_attention` (the Pallas
`_flash_kernel`). Takes the model layout q (B,S,H,D), k/v (B,T,K,D) as it
is: the CUDA kernels read the strides in place, no transpose. There are
no block arguments: the kernels take any S and T (they mask the ragged
tile) and any head dim up to 256.

Two hand-written forward kernels in `csrc/flash_attention.cu`, chosen by
dtype: bf16 runs on the tensor cores (`wgmma`), fp32 on plain fp32 FMAs
(tensor cores would need TF32, which breaks the fp32 bound). The bf16
kernel loads its tiles by 16-byte copies when every row of q, k and v
starts 16-byte aligned, and element by element otherwise
(`_lib.rows_aligned_16`). Each can also write the log-sum-exp of every
row (its `LSE` instances), which the backward kernels (namespace `bwd`)
read: bf16 on the tensor cores (`wgmma`, P and dS in two bf16 parts,
the streamed tiles by TMA when the rows are 16-byte aligned), fp32 on
plain fp32 FMAs.

On meta tensors the forward and the backward return empty outputs of
the kernels' shapes and dtypes; under an active step count
(`repro_torch.analysis.counting`) each call is one kernel record of its
`analysis.costs` work.

`flash_attention` is differentiable on both devices. When grad mode is on
and q, k or v requires a gradient, the call runs through
`_FlashAttention`: the forward with the log-sum-exp, saving q, k, v, o
and lse, and the backward kernel (`flash_attention_backward`) as its
gradient on CUDA; on the CPU the plain forward, and as its gradient
autograd of the plain version, recomputed (contiguous gradients, as the
kernel's). Without a gradient to take (serving, `torch.no_grad`) the
forward runs alone, the instance it was before the backward existed."""
from __future__ import annotations

import contextlib

import torch
from torch.autograd.function import once_differentiable

from repro_torch.analysis import costs, counting
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_reference,
)

MAX_HEAD_DIM = 256
_ENTRY_POINTS = {torch.float32: "rt_flash_attention_forward_f32",
                 torch.bfloat16: "rt_flash_attention_forward_bf16"}
_BACKWARD = {torch.float32: "rt_flash_attention_backward_f32",
             torch.bfloat16: "rt_flash_attention_backward_bf16"}
_INT_MAX = 2 ** 31 - 1


def kernel_for(dtype: torch.dtype) -> str:
    """The C entry point that takes inputs of this dtype."""
    if dtype not in _ENTRY_POINTS:
        raise TypeError(f"flash_attention: no kernel for {dtype}; q, k, v "
                        f"must be bfloat16 or float32")
    return _ENTRY_POINTS[dtype]


def _check(name, q, k, v, prefix_len, window, **rows):
    """Shapes, dtypes, head dim, mask arguments and strides of a CUDA
    call; `rows` are more (B,S,H,D) tensors in q's layout (o, dout)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be 4-d (B,S,H,D) / "
                         f"(B,T,K,D)")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, K, D) or tuple(v.shape) != (B, T, K, D):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be (B, T, K, D) = "
                         f"{(B, T, K, D)}")
    if K == 0 or H % K:
        raise ValueError(f"{name}: {H} heads are no multiple of {K} kv "
                         f"heads")
    tensors = {"q": q, "k": k, "v": v, **rows}
    if q.dtype not in _ENTRY_POINTS or any(t.dtype != q.dtype
                                           for t in tensors.values()):
        raise TypeError(f"{name}: {', '.join(tensors)} must share one "
                        f"dtype, bfloat16 or float32; got "
                        f"{', '.join(str(t.dtype) for t in tensors.values())}")
    for key, t in rows.items():
        if tuple(t.shape) != (B, S, H, D):
            raise ValueError(f"{name}: {key} {tuple(t.shape)} is not q's "
                             f"shape {(B, S, H, D)}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} outside 1..{MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    if prefix_len < 0:
        raise ValueError(f"{name}: prefix_len {prefix_len} < 0")
    for key, t in tensors.items():
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {key} must have unit stride over the "
                             f"head dim")
        if max(t.stride()[:3]) > _INT_MAX:
            raise ValueError(f"{name}: {key} strides exceed int32")


def _work(q, k, causal, window, prefix_len, lse=False, backward=False):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if backward:
        return costs.flash_attention_backward(B, S, T, H, K, D, q.dtype,
                                              causal, window, prefix_len)
    return costs.flash_attention(B, S, T, H, K, D, q.dtype, causal, window,
                                 prefix_len, lse)


def flash_forward(q, k, v, causal: bool = True, window: int = 0,
                  prefix_len: int = 0, return_lse: bool = False):
    """The forward alone, no autograd: o (B,S,H,D) in q's dtype, and with
    `return_lse` also the fp32 log-sum-exp (B,H,S) of each row's scaled,
    masked scores (the kernel's `LSE` instance on CUDA; its o is bitwise
    the other instance's). CPU tensors take the plain version; under an
    active step count, one kernel record."""
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} < 0")
    count = counting.ACTIVE
    if count is not None and count.open:
        with count.kernel("flash_attention", _work(
                q, k, causal, window, prefix_len, lse=return_lse)):
            return flash_forward(q, k, v, causal, window, prefix_len,
                                 return_lse)
    kind = _lib.device_kind(q, k, v)
    if kind == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len,
                                   return_lse=return_lse)
    _check("flash_attention", q, k, v, prefix_len, window)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if kind == "meta":
        return (o, lse) if return_lse else o
    if o.numel():
        fn = getattr(_lib.load_library(), kernel_for(q.dtype))
        args = [_lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(o),
                _lib.ptr(lse), B, S, T, H, K, D, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], int(causal), int(window),
                min(int(prefix_len), T)]
        if q.dtype == torch.bfloat16:
            args.append(int(_lib.rows_aligned_16(q, k, v)))
        rc = fn(*args, D ** -0.5, _lib.stream())
        _lib.check(rc, "flash_attention")
        _lib.counted(flash_attention)
    return (o, lse) if return_lse else o


def flash_attention_backward(q, k, v, o, do, lse, causal: bool = True,
                             window: int = 0, prefix_len: int = 0):
    """(dq, dk, dv) of `flash_attention(q, k, v, ...)` for the output
    cotangent `do` (B,S,H,D), from its output `o` and log-sum-exp `lse`
    (B,H,S) fp32, in the inputs' dtype.

    CPU tensors take the plain version (`attention_backward_reference`);
    CUDA tensors launch the backward kernels (a delta pre-pass, dK/dV,
    dQ; bf16 products on `wgmma` with fp32 sums, fp32 on FMAs; no
    atomics: the same bits every run), q, k, v, o and do read through
    their strides. Under an active step count, one kernel record."""
    count = counting.ACTIVE
    if count is not None and count.open:
        with count.kernel("flash_attention_backward", _work(
                q, k, causal, window, prefix_len, backward=True)):
            return flash_attention_backward(q, k, v, o, do, lse, causal,
                                            window, prefix_len)
    kind = _lib.device_kind(q, k, v, o, do, lse)
    if kind == "cpu":
        return attention_backward_reference(q, k, v, o, do, lse, causal,
                                            window, prefix_len)
    _check("flash_attention_backward", q, k, v, prefix_len, window, o=o,
           dout=do)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    _lib.require(lse, "lse", (B, H, S))
    make = torch.zeros if q.numel() == 0 or k.numel() == 0 else torch.empty
    dq = make((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = make((B, T, K, D), dtype=k.dtype, device=k.device)
    dv = make((B, T, K, D), dtype=v.dtype, device=v.device)
    if make is torch.zeros:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if kind == "meta":
        return dq, dk, dv
    fn = getattr(_lib.load_library(), _BACKWARD[q.dtype])
    rc = fn(_lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(o), _lib.ptr(do),
            _lib.ptr(lse), _lib.ptr(delta), _lib.ptr(dq), _lib.ptr(dk),
            _lib.ptr(dv), B, S, T, H, K, D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *do.stride()[:3], int(causal), int(window),
            min(int(prefix_len), T), D ** -0.5, _lib.stream())
    _lib.check(rc, "flash_attention_backward")
    _lib.counted(flash_attention_backward)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel's `LSE` instance with the backward kernels as
    its gradient. Saves q, k, v (as given: views of a fused projection
    stay views), o and lse (B·H·S fp32). On CPU tensors the backward is
    autograd of the plain version, recomputed from q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        o, lse = flash_forward(q, k, v, causal, window, prefix_len,
                               return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, prefix_len)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = _plain_backward(q, k, v, do, *ctx.mask)
        else:
            dq, dk, dv = flash_attention_backward(q, k, v, o, do, lse,
                                                  *ctx.mask)
        return dq, dk, dv, None, None, None


def _plain_backward(q, k, v, do, causal, window, prefix_len):
    """(dq, dk, dv) by autograd of the plain version on CPU tensors,
    recomputed from q, k, v, and made contiguous, as the kernel writes
    them, so that the ops after it see the card's layout (and a step
    count sees the card's ops); one kernel record under an active
    count."""
    count = counting.ACTIVE
    region = (count.kernel("flash_attention_backward", _work(
        q, k, causal, window, prefix_len, backward=True))
        if count is not None and count.open else contextlib.nullcontext())
    with region, torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = attention_reference(*inputs, causal=causal, window=window,
                                prefix_len=prefix_len)
        return tuple(g.contiguous()
                     for g in torch.autograd.grad(o, inputs, do))


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    prefix_len: int = 0):
    """softmax(q k^T / sqrt(D) + mask) v with GQA (H % K == 0).

    q: (B,S,H,D); k, v: (B,T,K,D), one dtype, bf16 or fp32 on CUDA.
    With `causal`, key j is visible to query i when j <= i or j <
    `prefix_len` (the prefix-LM rule; 0: plain causal; prefix_len >= T:
    every key); `window` > 0 also needs i - j < window.
    Returns (B,S,H,D) in q's dtype. CPU tensors take the plain version,
    CUDA tensors launch the kernel; when grad mode is on and an input
    requires a gradient, either goes through `_FlashAttention`, so its
    backward launches the backward kernels on CUDA (and on the CPU is
    autograd of the plain version, recomputed). So the forward and the
    backward are one call each, and one kernel record each under a step
    count, on every device."""
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} < 0")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                     int(prefix_len))
    return flash_forward(q, k, v, causal, window, prefix_len)


flash_attention.launches = 0
flash_attention_backward.launches = 0
