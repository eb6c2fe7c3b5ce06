"""Wrapper of the wkv kernel: dispatch by device, checks, launch count.

Replaces `repro.kernels.wkv.ops.wkv_chunked`. Takes the model layout
(B,S,H,dh) as it is; the CUDA kernel reads it in place. There is no
chunk argument: the kernel takes any sequence length."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.wkv.ref import wkv_reference

MAX_HEAD_DIM = 128


def wkv(r, k, v, w, beta, state: Optional[torch.Tensor] = None):
    """Delta-rule recurrence over a sequence, state chained in and out.

    r,k,v,w: (B,S,H,dh); beta: (B,S,H); state: (B,H,dh,dh) or None
    (zeros). Returns (y (B,S,H,dh) fp32, final_state (B,H,dh,dh) fp32).
    CPU tensors take the plain version; CUDA tensors (fp32, contiguous,
    dh <= 128) launch the kernel."""
    if _lib.device_kind(r, k, v, w, beta, state) == "cpu":
        return wkv_reference(r, k, v, w, beta, state)
    B, S, H, dh = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _lib.require(t, name, (B, S, H, dh))
    _lib.require(beta, "beta", (B, S, H))
    if state is not None:
        _lib.require(state, "state", (B, H, dh, dh))
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"wkv: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    y = torch.empty_like(r)
    if S == 0:
        sf = (torch.zeros((B, H, dh, dh), dtype=torch.float32,
                          device=r.device) if state is None else state.clone())
        return y, sf
    sf = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    lib = _lib.load_library()
    rc = lib.rt_wkv_forward(_lib.ptr(r), _lib.ptr(k), _lib.ptr(v), _lib.ptr(w),
                            _lib.ptr(beta), _lib.ptr(state), _lib.ptr(y),
                            _lib.ptr(sf), B, S, H, dh, _lib.stream())
    _lib.check(rc, "wkv")
    wkv.launches += 1
    return y, sf


wkv.launches = 0
