"""Wrappers of the wkv kernels: dispatch by device, checks, launch counts,
and the autograd Function that joins the forward and the backward.

Replaces `repro.kernels.wkv.ops.wkv_chunked`. Takes the model layout
(B,S,H,dh) as it is; the CUDA kernels read it in place. There is no
chunk argument: the kernels take any sequence length.

`wkv` is differentiable on both devices: when a gradient is wanted it
runs through `_WKV`, whose forward also keeps S_{t-1} of every token
(the kernel writes them on CUDA) and whose backward is
`wkv_backward`: the backward kernel on CUDA tensors, the plain reverse
loop on CPU tensors. Without a gradient to take (serving,
`torch.no_grad`) the forward runs alone and saves nothing.

On meta tensors both return empty outputs of the kernels' shapes and
dtypes; under an active step count (`repro_torch.analysis.counting`) each
call is one kernel record of its `analysis.costs` work.

dtypes, as JAX's kernel takes them: r, k, v fp32 or bf16 (one dtype);
w, beta and the state fp32 (the RWKV model computes them in fp32); y and
the states fp32 whatever r's dtype. A bf16 r, k, v on CUDA launches the
kernels' bf16 instances, which read them as they are. `wkv` converts a
bf16 w or beta to fp32 first, exactly (every bf16 value is an fp32
value): JAX's kernel widens them in its first step too."""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.analysis import costs, counting
from repro_torch.kernels import _lib
from repro_torch.kernels.wkv.ref import wkv_backward_reference, wkv_reference

MAX_HEAD_DIM = 128
CHUNK = 8        # tokens a shared-memory stage of the kernel (two stages)


def _bytes(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _padded(dh: int) -> int:
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"wkv: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    return 32 if dh <= 32 else 64 if dh <= 64 else 128


def kernel_plan(dh: int, dtype: torch.dtype = torch.float32) -> dict:
    """The forward kernel instance that takes head dim dh and r, k, v of
    `dtype`, as `csrc/wkv.cu` chooses it: head dim padded to 32, 64 or
    128, threads a block (4 value columns and `rows` rows of the state a
    thread), row groups summed by shuffles, and static shared bytes (two
    stages of w rows (fp32), k, r, v rows (`dtype`) and beta). Raises for
    a head dim the kernel does not take."""
    padded = _padded(dh)
    groups = 4 if padded <= 64 else 8
    stage = 4 * CHUNK * padded + 3 * CHUNK * padded * _bytes(dtype) \
        + 4 * CHUNK
    return dict(padded=padded, row_groups=groups, rows=padded // groups,
                threads=groups * padded // 4, shared_bytes=2 * stage)


def backward_plan(dh: int, dtype: torch.dtype = torch.float32) -> dict:
    """The backward kernel instance that takes head dim dh and r, k, v of
    `dtype`, as `csrc/wkv.cu` (namespace bwd) chooses it: head dim padded,
    `rows` rows of G a thread in `row_groups` groups, threads a block, and
    dynamic shared bytes (two token slots of the saved state, rows of
    stride padded + 4, w, k, r, v (`dtype`), dy and beta; then the row
    partials of each warp)."""
    padded = _padded(dh)
    rows = 4 if padded == 32 else 8
    groups = padded // rows
    threads = groups * padded // 4
    warps = threads // 32
    slot = 4 * (padded * (padded + 4) + 2 * padded) \
        + 3 * padded * _bytes(dtype) + 16
    return dict(padded=padded, rows=rows, row_groups=groups, threads=threads,
                shared_bytes=2 * slot + 4 * (3 * warps * padded + warps))


def _aligned(*tensors) -> bool:
    """True when every given tensor's data is 16-byte aligned (fresh
    outputs always are); with dh % 4 == 0 (fp32) or dh % 8 == 0 (bf16)
    every row then is too."""
    return not any(t.data_ptr() % 16 for t in tensors if t is not None)


def _vec(r, dh: int, *tensors) -> bool:
    """The 16-byte route: whole 16-byte rows of r's dtype and of fp32,
    and aligned data."""
    per16 = 16 // r.element_size()
    return dh % max(4, per16) == 0 and _aligned(r, *tensors)


def _forward(r, k, v, w, beta, state, save: bool):
    """(y, final state, S_{t-1} of every token (B,S,H,dh,dh) or None).
    The states are written only when `save` and only by the kernel; the
    plain backward recomputes them. Under an active step count, one
    kernel record."""
    count = counting.ACTIVE
    if count is not None and count.open:
        with count.kernel("wkv", costs.wkv(*r.shape, r.dtype,
                                           state is not None, save)):
            return _forward(r, k, v, w, beta, state, save)
    inputs = (r, k, v, w, beta, state)
    kind = _lib.device_kind(*inputs)
    if kind == "cpu":
        return (*wkv_reference(*inputs), None)
    B, S, H, dh = r.shape
    bf16 = _lib.float_or_bf16(r, "r")
    for name, t in (("r", r), ("k", k), ("v", v)):
        _lib.require(t, name, (B, S, H, dh), r.dtype)
    _lib.require(w, "w", (B, S, H, dh))
    _lib.require(beta, "beta", (B, S, H))
    if state is not None:
        _lib.require(state, "state", (B, H, dh, dh))
    kernel_plan(dh)
    y = torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device)
    if S == 0:
        sf = (torch.zeros((B, H, dh, dh), dtype=torch.float32,
                          device=r.device) if state is None else state.clone())
        return y, sf, (torch.empty((B, 0, H, dh, dh), dtype=torch.float32,
                                   device=r.device) if save else None)
    sf = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    states = (torch.empty((B, S, H, dh, dh), dtype=torch.float32,
                          device=r.device) if save else None)
    if kind == "meta":
        return y, sf, states
    # contiguous inputs, fresh outputs: rows are 16-byte aligned when the
    # inputs' data is and a row is whole 16-byte vectors
    vec = _vec(r, dh, k, v, w, state)
    lib = _lib.load_library()
    rc = lib.rt_wkv_forward(_lib.ptr(r), _lib.ptr(k), _lib.ptr(v), _lib.ptr(w),
                            _lib.ptr(beta), _lib.ptr(state), _lib.ptr(y),
                            _lib.ptr(sf), _lib.ptr(states), B, S, H, dh,
                            int(vec), bf16, _lib.stream())
    _lib.check(rc, "wkv")
    _lib.counted(wkv, bf16)
    return y, sf, states


def wkv_backward(r, k, v, w, beta, state, states, dy,
                 dstate_final: Optional[torch.Tensor] = None):
    """Cotangents of `wkv(r, k, v, w, beta, state)` for the output
    cotangents dy (B,S,H,dh) fp32 and dstate_final (B,H,dh,dh) or None
    (zeros). Returns (dr, dk, dv, dw, dbeta, dstate): dr, dk, dv in the
    dtype of r, k, v, the rest fp32.

    CPU tensors take the plain reverse loop (`wkv_backward_reference`,
    which recomputes the states from `state`); CUDA tensors (r, k, v fp32
    or bf16, the rest fp32, contiguous, dh <= 128) launch the backward
    kernel's instance of r's dtype (`backward_plan`) on `states`, S_{t-1}
    of every token as the forward kernel wrote them, with 16-byte loads
    and stores when every row is 16-byte aligned. Under an active step
    count, one kernel record."""
    count = counting.ACTIVE
    if count is not None and count.open:
        with count.kernel("wkv_backward", costs.wkv_backward(
                *r.shape, r.dtype, dstate_final is not None)):
            return wkv_backward(r, k, v, w, beta, state, states, dy,
                                dstate_final)
    kind = _lib.device_kind(r, k, v, w, beta, state, states, dy,
                            dstate_final)
    if kind == "cpu":
        return wkv_backward_reference(r, k, v, w, beta, state, dy,
                                      dstate_final)
    B, S, H, dh = r.shape
    bf16 = _lib.float_or_bf16(r, "r")
    for name, t in (("r", r), ("k", k), ("v", v)):
        _lib.require(t, name, (B, S, H, dh), r.dtype)
    for name, t in (("w", w), ("dy", dy)):
        _lib.require(t, name, (B, S, H, dh))
    _lib.require(beta, "beta", (B, S, H))
    _lib.require(states, "states", (B, S, H, dh, dh))
    for name, t in (("state", state), ("dstate_final", dstate_final)):
        if t is not None:
            _lib.require(t, name, (B, H, dh, dh))
    backward_plan(dh)
    grads = [torch.empty_like(t) for t in (r, k, v, w, beta)]
    ds0 = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    if S == 0:
        if dstate_final is None:
            ds0.zero_()
        else:
            ds0.copy_(dstate_final)
        return (*grads, ds0)
    if kind == "meta":
        return *grads, ds0
    vec = _vec(r, dh, k, v, w, states, dy, dstate_final)
    lib = _lib.load_library()
    rc = lib.rt_wkv_backward(
        _lib.ptr(r), _lib.ptr(k), _lib.ptr(v), _lib.ptr(w), _lib.ptr(beta),
        _lib.ptr(states), _lib.ptr(dy), _lib.ptr(dstate_final),
        *map(_lib.ptr, grads), _lib.ptr(ds0), B, S, H, dh, int(vec), bf16,
        _lib.stream())
    _lib.check(rc, "wkv_backward")
    _lib.counted(wkv_backward, bf16)
    return (*grads, ds0)


class _WKV(torch.autograd.Function):
    """Forward kernel (or plain forward) with the backward kernel (or
    plain backward) as its gradient. Saves the inputs and, on CUDA, the
    states S_{t-1} of every token (B·S·H·dh² fp32)."""

    @staticmethod
    def forward(ctx, r, k, v, w, beta, state):
        y, sf, states = _forward(r, k, v, w, beta, state, save=True)
        ctx.save_for_backward(r, k, v, w, beta, state, states)
        return y, sf

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dsf):
        r, k, v, w, beta, state, states = ctx.saved_tensors
        *grads, ds = wkv_backward(r, k, v, w, beta, state, states,
                                  dy.contiguous(), dsf.contiguous())
        return (*grads, ds if ctx.needs_input_grad[5] else None)


def wkv(r, k, v, w, beta, state: Optional[torch.Tensor] = None):
    """Delta-rule recurrence over a sequence, state chained in and out.

    r,k,v,w: (B,S,H,dh); beta: (B,S,H); state: (B,H,dh,dh) or None
    (zeros). Returns (y (B,S,H,dh) fp32, final_state (B,H,dh,dh) fp32).
    CPU tensors take the plain version; CUDA tensors (r, k, v fp32 or
    bf16, the state fp32, contiguous, dh <= 128) launch the kernel's
    instance of r's dtype (`kernel_plan`), with 16-byte loads and stores
    when every row is 16-byte aligned. A bf16 w or beta is converted to
    fp32 first (exactly). Differentiable in every input through `_WKV`
    when grad mode is on and one requires grad."""
    w, beta = (t.float() if t.dtype == torch.bfloat16 else t
               for t in (w, beta))
    inputs = (r, k, v, w, beta, state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _WKV.apply(*inputs)
    return _forward(*inputs, save=False)[:2]


# launches of the kernels, and of their bf16 instances among them
wkv.launches = wkv.launches_bf16 = 0
wkv_backward.launches = wkv_backward.launches_bf16 = 0
