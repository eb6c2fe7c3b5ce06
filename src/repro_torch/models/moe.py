"""Mixture-of-Experts MLP of the LM zoo: top-k routing with GShard-style
capacity dispatch. Port of `repro.models.moe`.

Tokens are taken in groups of g (the largest divisor of B*S not above
`group_size`); each (token, choice) gets a slot in its expert's buffer of
`capacity` rows from a cumsum over the group, token-major and the choices
in descending-probability order, and pairs past the capacity are dropped
(Switch/GShard). Dispatch and combine are the dense one-hot einsums of
the reference, (G, g, E, C), each term of their sums a single product,
so they are exact; every expert's buffer goes through its gated-SiLU (or
GELU) MLP, empty rows included. Like the reference, the whole module is
plain tensor algebra: no kernel of the port runs here.

The auxiliary load-balance loss is Switch's: the mean router probability
of each expert times the share of (token, choice) pairs routed to it,
counted before drops, times E. Inside a data-parallel step both means
span the global batch (summed over the ranks, the probabilities'
differentiably), so every rank holds the global aux; the groups are the
global batch's, which each rank's rows must hold whole (`group_of`).

Top-k ties go to the lower expert index, as `jax.lax.top_k` does: the
port takes the first k of a stable descending sort (`torch.topk` makes no
promise on ties), so a row of equal logits routes to experts 0..k-1.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.collectives import active, all_sum, share, total
from repro_torch.models.layers import init_array, param


class MoE(nn.Module):
    """router (d, E) in fp32 always; wi, wg (E, d, f) and wo (E, f, d) in
    `dtype`, wg only when `gated`. Each leaf is drawn with the fan-in rule
    of `init_array`, which takes shape[0]: E for the expert leaves, as in
    the reference; the router's scale is 0.02."""

    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int,
                 num_experts: int, dtype: torch.dtype, gated: bool = True):
        super().__init__()
        self.gated = gated
        self.router = param(init_array(gen, (d_model, num_experts),
                                       scale=0.02))
        self.wi = param(init_array(gen, (num_experts, d_model, d_ff)), dtype)
        if gated:
            self.wg = param(init_array(gen, (num_experts, d_model, d_ff)),
                            dtype)
        self.wo = param(init_array(gen, (num_experts, d_ff, d_model)), dtype)

    def forward(self, x, *, top_k: int, capacity_factor: float = 1.25):
        return moe_apply(self, x, top_k=top_k,
                         capacity_factor=capacity_factor, gated=self.gated)


class Routing(NamedTuple):
    """The router's decisions over G groups of g tokens: `probs` (G,g,E)
    fp32; `gates` (G,g,k) fp32, the top-k probabilities renormalised;
    `idx` (G,g,k) the experts in descending-probability order; `slot`
    (G,g,k) each pair's row in its expert's buffer; `kept` (G,g,k) slot <
    capacity; `capacity` C."""
    probs: torch.Tensor
    gates: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor
    capacity: int


def group_of(n_tokens: int, group_size: int = 256) -> int:
    """The routing group: the largest divisor of the batch's token count
    not above `group_size`. Inside a data-parallel step the count is the
    global batch's, and this rank's tokens must be whole groups of it (so
    that each rank routes the global groups of its rows); else
    ValueError, never a different routing."""
    shard = active()
    n = n_tokens * (1 if shard is None else shard.size)
    g = min(group_size, n)
    while n % g:
        g -= 1
    if n_tokens % g:
        raise ValueError(f"MoE routing groups of {g} tokens (of the global "
                         f"batch's {n}) do not fit this rank's "
                         f"{n_tokens}: shard the batch so that each rank "
                         f"holds whole groups")
    return g


def route(router: torch.Tensor, x, top_k: int,
          capacity_factor: float = 1.25, group_size: int = 256) -> Routing:
    """x: (B, S, d) -> the routing of its B*S tokens (`Routing`)."""
    B, S, d = x.shape
    E = router.shape[1]
    g = group_of(B * S, group_size)
    xt = x.reshape(-1, g, d)
    probs = torch.softmax(xt.float() @ router, dim=-1)           # (G,g,E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = order.values[..., :top_k]
    idx = order.indices[..., :top_k]                             # (G,g,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    capacity = max(4, int(g * top_k * capacity_factor / E))
    # each pair's slot: the count of earlier pairs of its group, token-
    # major, that chose the same expert
    flat = F.one_hot(idx, E).reshape(xt.shape[0], g * top_k, E)
    slot = (flat.cumsum(1) - 1).gather(
        -1, idx.reshape(xt.shape[0], g * top_k, 1)).reshape(idx.shape)
    return Routing(probs, gates, idx, slot, slot < capacity, capacity)


def moe_apply(params: MoE, x, *, top_k: int, capacity_factor: float = 1.25,
              group_size: int = 256, gated: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss (fp32))."""
    B, S, d = x.shape
    dt = x.dtype
    E = params.router.shape[1]
    r = route(params.router, x, top_k, capacity_factor, group_size)
    xt = x.reshape(r.idx.shape[0], -1, d)                        # (G,g,d)
    onehot = F.one_hot(r.idx, E)                                 # (G,g,k,E)
    slot_oh = (F.one_hot(torch.where(r.kept, r.slot, 0), r.capacity)
               * r.kept[..., None])                              # (G,g,k,C)
    disp = torch.einsum("sgke,sgkc->sgec", onehot.to(dt), slot_oh.to(dt))
    # the reference's three-operand einsum with the gates folded into the
    # one-hot first: each (e, c) term is the one gate, exactly
    combine = torch.einsum("sgke,sgkc->sgec",
                           onehot.float() * r.gates[..., None],
                           slot_oh.float())
    del slot_oh
    expert_in = torch.einsum("sgec,sgd->escd", disp, xt)         # (E,G,C,d)
    del disp
    h = torch.einsum("escd,edf->escf", expert_in, params.wi.to(dt))
    if gated:
        gv = torch.einsum("escd,edf->escf", expert_in, params.wg.to(dt))
        h = (gv * torch.sigmoid(gv)) * h                         # silu(g) * up
        del gv
    else:
        h = F.gelu(h, approximate="tanh")
    del expert_in
    y = torch.einsum("escf,efd->escd", h, params.wo.to(h.dtype))
    del h
    out = torch.einsum("escd,sgec->sgd", y.float(), combine)
    # Switch-style load balance: mean router prob x routed fraction, both
    # over the global batch's groups inside a data-parallel step
    me = all_sum(share(r.probs.mean(dim=(0, 1))))                # (E,)
    ce = total(share(onehot.float().mean(dim=(0, 1, 2)))) * E
    aux = torch.sum(me * ce)
    return out.reshape(B, S, d).to(dt), aux


def compare_routing(ref: Routing, other: Routing, ulps: float = 8.0):
    """Holds `other` (say the card's) to `ref` (the CPU's), two routings of
    the same tokens computed from inputs that may differ by rounding.

    A token is a near tie where two of ref's top k+1 probabilities, next
    to each other in order, are closer than `ulps` fp32 ulps of the
    larger: rounding may swap them. Returns a dict of (G, g) bool masks
    and counts: `flips`, the tokens whose experts differ; `near_ties`;
    `unexplained`, the flips at tokens that are no near tie, and the slot
    or kept differences in groups without a flip (a flip moves the slots
    of the pairs after it in its group); `clean_groups` (G,), the groups
    with no difference at all."""
    k = ref.idx.shape[-1]
    top = torch.sort(ref.probs, dim=-1, descending=True).values
    top = top[..., :k + 1]
    gaps = top[..., :-1] - top[..., 1:]
    near = (gaps < ulps * torch.finfo(torch.float32).eps * top[..., :-1]
            ).any(-1)
    other = Routing(*(t.to(ref.idx.device) if torch.is_tensor(t) else t
                      for t in other))
    flips = (ref.idx != other.idx).any(-1)
    moved = ((ref.slot != other.slot) | (ref.kept != other.kept)).any(-1)
    group_flipped = flips.any(-1, keepdim=True)
    unexplained = (flips & ~near) | (moved & ~group_flipped)
    return dict(flips=flips, near_ties=near, unexplained=unexplained,
                clean_groups=~(flips | moved).any(-1),
                n_flips=int(flips.sum()), n_near_ties=int(near.sum()),
                n_unexplained=int(unexplained.sum()))


@contextlib.contextmanager
def record_routing(model: nn.Module) -> Iterator[List[Routing]]:
    """Yields a list to which every MoE layer of `model` that runs inside
    the block appends, in call order, the `Routing` of its input: the
    decisions its forward takes, recomputed by a forward pre-hook."""
    seen: List[Routing] = []

    def hook(module, args, kwargs):
        seen.append(route(module.router, args[0], kwargs["top_k"],
                          kwargs.get("capacity_factor", 1.25)))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, MoE)]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def moe_specs(gated: bool = True) -> dict:
    """Logical-axis specs of a `MoE`'s parameters (`moe_init`'s)."""
    specs = {"router": ("embed", None),
             "wi": ("expert", "embed", "expert_ff"),
             "wo": ("expert", "expert_ff", "embed")}
    if gated:
        specs["wg"] = ("expert", "embed", "expert_ff")
    return specs
