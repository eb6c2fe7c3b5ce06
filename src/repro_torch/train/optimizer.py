"""Optimizers, port of `repro.train.optimizer`: AdamW and factored
Adafactor, the warmup + cosine schedule and global-norm clipping.

Functions over named tensors, pure as the JAX ones are: `params` and
`grads` are dicts {name: tensor} (the port's `state_dict` names), and an
update returns new params and a new state without touching its inputs.
The state layout maps one to one onto JAX's, so checkpoints cross over
(`repro_torch.train.checkpoint`):

  AdamW      {"m": {name: fp32}, "v": {name: fp32}, "count": int32 0-d}
  Adafactor  {"slots": {name: {"vr", "vc", "m"} | {"v", "m"}},
              "count": int32 0-d}   (m in bf16, vr/vc/v in fp32)

Updates run in fp32 whatever the parameter dtype; the new parameter is
cast back to it. The JAX package's layer-chunked update
(`CHUNKED_UPDATE`) is off there and is not ported.

The state specs (`adamw_state_specs`, `adafactor_state_specs`) give each
moment its parameter's logical axes, so the FSDP rules shard optimizer
state as they shard weights. Under a mesh the Trainer runs an update on
this rank's shards: AdamW is elementwise; Adafactor's row and column
means and its RMS clip read whole rows, columns and tensors, so its
update takes `shards`, the process groups that split each parameter's
dims, and sums over them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_norm

Tensors = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def lr_schedule(step, *, base_lr: float, warmup_steps: int, total_steps: int,
                min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32 as the JAX version computes
    it. Returns a 0-d fp32 tensor on the CPU."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)
    prog = torch.clamp((step - warmup_steps) / max(1, total_steps -
                                                   warmup_steps), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def global_norm_clip(grads: Tensors, max_norm: float
                     ) -> Tuple[Tensors, torch.Tensor]:
    """Scales every gradient by min(1, max_norm / global norm). Returns
    (clipped grads, global norm before clipping). The scale is fp32, so a
    bf16 gradient comes back fp32, as JAX promotes it."""
    g = tree_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return {k: x.to(torch.promote_types(x.dtype, scale.dtype)) * scale
            for k, x in grads.items()}, g


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _count(params: Tensors) -> torch.Tensor:
    device = next(iter(params.values())).device if params else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params: Tensors) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "count": _count(params)}


@torch.no_grad()
def adamw_update(grads: Tensors, state: dict, params: Tensors, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01) -> Tuple[Tensors, dict]:
    """Bias-corrected Adam moments in fp32 plus decoupled weight decay."""
    count = state["count"] + 1
    c = count.float()
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        g = grads[name].float()
        m = b1 * state["m"][name] + (1 - b1) * g
        v = b2 * state["v"][name] + (1 - b2) * torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        new_p[name] = (p.float() - lr * step).to(p.dtype)
        new_m[name], new_v[name] = m, v
    return new_p, {"m": new_m, "v": new_v, "count": count}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; first moment kept for stability)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Tensors) -> dict:
    def init_one(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        m = torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
                    "m": m}
        return {"v": torch.zeros(p.shape, **f32), "m": m}

    return {"slots": {k: init_one(p) for k, p in params.items()},
            "count": _count(params)}


class Shards:
    """How a parameter is split over a mesh: its full shape and, for each
    dim split over mesh axes of size > 1, their process groups. `mean`
    is the mean over full dims of a local block, summed over those
    groups; over dims no group splits it is `torch.mean` itself."""

    def __init__(self, shape: Sequence[int], groups: Dict[int, list]):
        self.shape = tuple(shape)
        self.groups = groups

    def mean(self, x: torch.Tensor, dims: Sequence[int], x_dim=None,
             keepdim: bool = False) -> torch.Tensor:
        """Mean of x over the parameter's `dims` (all of x's dims when
        x_dim is None, else x's dim `x_dim`)."""
        groups = [g for d in dims for g in self.groups.get(d, ())]
        if not groups:
            return (torch.mean(x) if x_dim is None
                    else x.mean(x_dim, keepdim=keepdim))
        s = x.sum() if x_dim is None else x.sum(x_dim, keepdim=keepdim)
        for g in groups:
            dist.all_reduce(s, group=g)
        n = 1
        for d in dims:
            n *= self.shape[d]
        return s / n


@torch.no_grad()
def adafactor_update(grads: Tensors, state: dict, params: Tensors, *, lr,
                     b1: float = 0.9, decay: float = 0.99, eps: float = 1e-30,
                     weight_decay: float = 0.0, clip_threshold: float = 1.0,
                     shards: Optional[Dict[str, Shards]] = None
                     ) -> Tuple[Tensors, dict]:
    """Factored (row/column) second moment, RMS update clipping, bf16
    first moment. `shards` ({name: Shards}): the tensors are this rank's
    blocks of the named parameters, and the means span the whole
    parameter."""
    count = state["count"] + 1
    new_p, new_slots = {}, {}
    for name, p in params.items():
        slot = state["slots"][name]
        sh = (shards or {}).get(name) or Shards(p.shape, {})
        n = p.ndim
        g = grads[name].float()
        g2 = torch.square(g) + eps
        if "vr" in slot:
            vr = decay * slot["vr"] + (1 - decay) * sh.mean(g2, [n - 1], -1)
            vc = decay * slot["vc"] + (1 - decay) * sh.mean(g2, [n - 2], -2)
            row_mean = torch.clamp(sh.mean(vr, [n - 2], -1, keepdim=True),
                                   min=eps)
            denom = (vr[..., None] / row_mean[..., None]) * vc[..., None, :]
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            new_slot = {"vr": vr, "vc": vc}
        else:
            v = decay * slot["v"] + (1 - decay) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
            new_slot = {"v": v}
        # update clipping (Adafactor's RMS trick)
        rms = torch.sqrt(sh.mean(torch.square(u), range(n)) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        m = b1 * slot["m"].float() + (1 - b1) * u
        step = m
        if weight_decay:
            step = step + weight_decay * p.float()
        new_p[name] = (p.float() - lr * step).to(p.dtype)
        new_slot["m"] = m.to(torch.bfloat16)
        new_slots[name] = new_slot
    return new_p, {"slots": new_slots, "count": count}


# ---------------------------------------------------------------------------
# optimizer state sharding specs
# ---------------------------------------------------------------------------

def adamw_state_specs(param_specs: dict) -> dict:
    return {"m": param_specs, "v": param_specs, "count": ()}


def adafactor_state_specs(param_specs: dict) -> dict:
    def spec_one(spec):
        spec = tuple(spec)
        if len(spec) >= 2:
            return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:], "m": spec}
        return {"v": spec, "m": spec}

    return {"slots": {k: spec_one(s) for k, s in param_specs.items()},
            "count": ()}


def make_optimizer(name: str) -> Tuple[Callable, Callable, Callable]:
    """-> (init_fn, update_fn, state_specs_fn)"""
    if name == "adamw":
        return adamw_init, adamw_update, adamw_state_specs
    if name == "adafactor":
        return adafactor_init, adafactor_update, adafactor_state_specs
    raise ValueError(f"unknown optimizer {name}")
