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
CHUNK = 8        # tokens a shared-memory stage of the kernel (two stages)


def kernel_plan(dh: int) -> dict:
    """The kernel instance that takes head dim dh, as `csrc/wkv.cu`
    chooses it: head dim padded to 32, 64 or 128, threads a block (4 value
    columns and `rows` rows of the state a thread), row groups summed by
    shuffles, and static shared bytes (two stages of w, k, r, v rows and
    beta). Raises for a head dim the kernel does not take."""
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"wkv: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    padded, groups = (32, 4) if dh <= 32 else (64, 4) if dh <= 64 else (128, 8)
    return dict(padded=padded, row_groups=groups, rows=padded // groups,
                threads=groups * padded // 4,
                shared_bytes=4 * 2 * (4 * CHUNK * padded + CHUNK))


def wkv(r, k, v, w, beta, state: Optional[torch.Tensor] = None):
    """Delta-rule recurrence over a sequence, state chained in and out.

    r,k,v,w: (B,S,H,dh); beta: (B,S,H); state: (B,H,dh,dh) or None
    (zeros). Returns (y (B,S,H,dh) fp32, final_state (B,H,dh,dh) fp32).
    CPU tensors take the plain version; CUDA tensors (fp32, contiguous,
    dh <= 128) launch the kernel (`kernel_plan`), with 16-byte loads and
    stores when every row is 16-byte aligned. The kernel has no backward,
    as its JAX twin `wkv_pallas` has no VJP: on CUDA, an input that
    requires a gradient (with grad mode on) raises rather than give a
    result that autograd would silently treat as a constant."""
    inputs = (r, k, v, w, beta, state)
    if _lib.device_kind(*inputs) == "cpu":
        return wkv_reference(*inputs)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError("wkv: the CUDA kernel has no gradient; run it "
                           "under torch.no_grad() or torch.inference_mode()"
                           " or on inputs that do not require grad")
    B, S, H, dh = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _lib.require(t, name, (B, S, H, dh))
    _lib.require(beta, "beta", (B, S, H))
    if state is not None:
        _lib.require(state, "state", (B, H, dh, dh))
    kernel_plan(dh)
    y = torch.empty_like(r)
    if S == 0:
        sf = (torch.zeros((B, H, dh, dh), dtype=torch.float32,
                          device=r.device) if state is None else state.clone())
        return y, sf
    sf = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    # contiguous inputs, fresh outputs: rows are 16-byte aligned when the
    # inputs' data is and a row is whole float4s
    vec = dh % 4 == 0 and not any(
        t.data_ptr() % 16 for t in (r, k, v, w, state) if t is not None)
    lib = _lib.load_library()
    rc = lib.rt_wkv_forward(_lib.ptr(r), _lib.ptr(k), _lib.ptr(v), _lib.ptr(w),
                            _lib.ptr(beta), _lib.ptr(state), _lib.ptr(y),
                            _lib.ptr(sf), B, S, H, dh, int(vec), _lib.stream())
    _lib.check(rc, "wkv")
    wkv.launches += 1
    return y, sf


wkv.launches = 0
