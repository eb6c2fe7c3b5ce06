"""Wrapper of the flash-attention kernels: dispatch by device and dtype,
checks, launch count.

Replaces `repro.kernels.flash_attention.ops.flash_attention` (the Pallas
`_flash_kernel`). Takes the model layout q (B,S,H,D), k/v (B,T,K,D) as it
is: the CUDA kernels read the strides in place, no transpose. There are
no block arguments: the kernels take any S and T (they mask the ragged
tile) and any head dim up to 256.

Two hand-written kernels in `csrc/flash_attention.cu`, chosen by dtype:
bf16 runs on the tensor cores (`wgmma`), fp32 on plain fp32 FMAs (tensor
cores would need TF32, which breaks the fp32 bound). The bf16 kernel
loads its tiles by 16-byte copies when every row of q, k and v starts
16-byte aligned, and element by element otherwise
(`_lib.rows_aligned_16`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import attention_reference

MAX_HEAD_DIM = 256
_ENTRY_POINTS = {torch.float32: "rt_flash_attention_forward_f32",
                 torch.bfloat16: "rt_flash_attention_forward_bf16"}
_INT_MAX = 2 ** 31 - 1


def kernel_for(dtype: torch.dtype) -> str:
    """The C entry point that takes inputs of this dtype."""
    if dtype not in _ENTRY_POINTS:
        raise TypeError(f"flash_attention: no kernel for {dtype}; q, k, v "
                        f"must be bfloat16 or float32")
    return _ENTRY_POINTS[dtype]


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    prefix_len: int = 0):
    """softmax(q k^T / sqrt(D) + mask) v with GQA (H % K == 0).

    q: (B,S,H,D); k, v: (B,T,K,D), one dtype, bf16 or fp32 on CUDA.
    With `causal`, key j is visible to query i when j <= i or j <
    `prefix_len` (the prefix-LM rule; 0: plain causal; prefix_len >= T:
    every key); `window` > 0 also needs i - j < window.
    Returns (B,S,H,D) in q's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel. The kernel has no backward, as its
    JAX twin has no VJP: on CUDA an input that requires a gradient (with
    grad mode on) raises rather than give a result that autograd would
    silently treat as a constant."""
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len {prefix_len} < 0")
    if _lib.device_kind(q, k, v) == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel has no "
                           "gradient; run it under torch.no_grad() or "
                           "torch.inference_mode() or on inputs that do "
                           "not require grad")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d (B,S,H,D) / "
                         "(B,T,K,D)")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, K, D) or tuple(v.shape) != (B, T, K, D):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be (B, T, K, D) = "
                         f"{(B, T, K, D)}")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {H} heads are no multiple of "
                         f"{K} kv heads")
    if q.dtype not in _ENTRY_POINTS or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype, "
                        f"bfloat16 or float32; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} outside "
                         f"1..{MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must have unit "
                             f"stride over the head dim")
        if max(t.stride()[:3]) > _INT_MAX:
            raise ValueError(f"flash_attention: {name} strides exceed int32")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = getattr(_lib.load_library(), kernel_for(q.dtype))
    args = [_lib.ptr(q), _lib.ptr(k), _lib.ptr(v), _lib.ptr(o), B, S, T, H,
            K, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), min(int(prefix_len), T)]
    if q.dtype == torch.bfloat16:
        args.append(int(_lib.rows_aligned_16(q, k, v)))
    rc = fn(*args, D ** -0.5, _lib.stream())
    _lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
