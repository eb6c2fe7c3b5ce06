"""Logical-axis sharding (MaxText style), port of
`repro.distributed.sharding`.

Model code names every parameter and activation dimension with a
*logical* axis; a rule table maps logical axes to physical mesh axes, so
a parallelism strategy is a rule table, with no change to the models.
Physical mesh axes: ("pod", "data", "model") across pods, ("data",
"model") in one (`repro_torch.launch.mesh`).

A *spec* is what JAX's `PartitionSpec` holds, as a plain tuple: one entry
a tensor dim, each None, a mesh axis name or a tuple of names. The rules
read a mesh's axis names and sizes only, so they take a
`torch.distributed.device_mesh.DeviceMesh`, a `MeshConfig`, or a plain
description ({name: size} or ((name, size), ...)): the 16 x 16 and
2 x 16 x 16 production meshes are checked without 256 ranks.
`make_shardings` turns specs into DTensor placements on a real mesh:
mesh dim i gets `Shard(d)` when tensor dim d's entry names that axis,
else `Replicate()`. A dim over several mesh axes is split in mesh order,
the major axis first, as JAX splits `P(("pod", "data"))`.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Logical = Tuple[Optional[str], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Default rule table: logical axis -> mesh axis (or tuple of mesh axes).
# "batch" spreads over every data-parallel axis; "embed" is the FSDP axis
# (weights' d_model dim sharded over the data axis); tensor/expert
# parallelism lives on "model".
LOGICAL_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("pod", "data"),
    "seq": None,               # sequence parallelism off by default
    "embed": "data",           # FSDP weight shard
    "embed_act": None,         # activations' d_model dim
    "vocab": "model",          # LM-head / logits vocab sharding
    "in_vocab": None,          # input embedding: replicated vocab
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": None,            # decode cache sequence axis
    "ff": "model",
    "expert": "model",
    "expert_ff": None,
    "layers": None,            # stacked-layer axis (PP would map this)
    "state": None,
    "set": None,               # set-transformer element axis
    "pool": None,
}


def arch_rules(cfg, rules: Optional[Dict] = None) -> Dict[str, Any]:
    """`rules` (default `LOGICAL_RULES`) with the arch's
    `ModelConfig.sharding_overrides` applied on top."""
    out = dict(rules or LOGICAL_RULES)
    if cfg is not None and cfg.sharding_overrides:
        out.update(dict(cfg.sharding_overrides))
    return out


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, a MeshConfig (`axes`, `shape`),
    a {name: size} mapping or a sequence of (name, size) pairs, in mesh
    order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                               # DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    if hasattr(mesh, "axes") and hasattr(mesh, "shape"):  # MeshConfig
        return dict(zip(mesh.axes, mesh.shape))
    return dict(mesh)


def logical_to_pspec(logical: Logical, mesh, rules: Optional[Dict] = None
                     ) -> Spec:
    """Map a tuple of logical axis names (one a tensor dim) to a spec
    valid for `mesh`: mesh axes the mesh lacks are dropped (the same rules
    serve one pod and several), and no mesh axis is used twice."""
    rules = rules or LOGICAL_RULES
    avail = set(axis_sizes(mesh))
    used = set()
    parts = []
    for name in logical:
        if name is None:
            parts.append(None)
            continue
        mapped = rules.get(name, None)
        if mapped is None:
            parts.append(None)
            continue
        if isinstance(mapped, str):
            mapped = (mapped,)
        mapped = tuple(a for a in mapped if a in avail and a not in used)
        used.update(mapped)
        if not mapped:
            parts.append(None)
        elif len(mapped) == 1:
            parts.append(mapped[0])
        else:
            parts.append(mapped)
    return tuple(parts)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def prune_pspec(pspec: Spec, shape: Sequence[int], mesh) -> Spec:
    """Drop mesh axes from dims they do not evenly divide (a batch of 1 on
    a 32-way data axis, a 49155 vocab on a 16-way model axis), so that
    every spec is valid for its concrete shape."""
    pspec = tuple(pspec)
    parts = []
    for dim, axes in zip(shape, pspec + (None,) * (len(shape) - len(pspec))):
        if axes is None:
            parts.append(None)
            continue
        cand = (axes,) if isinstance(axes, str) else tuple(axes)
        kept = []
        for a in cand:
            size = _axis_size(mesh, a)
            if dim % (size * _axis_size(mesh, tuple(kept))) == 0:
                kept.append(a)
        parts.append(None if not kept else
                     kept[0] if len(kept) == 1 else tuple(kept))
    return tuple(parts)


def pruned_spec(logical: Logical, shape: Sequence[int], mesh,
                rules: Optional[Dict] = None) -> Spec:
    """The spec a tensor of `shape` with logical axes `logical` is stored
    by on `mesh`: `logical_to_pspec`, then `prune_pspec`."""
    return prune_pspec(logical_to_pspec(logical, mesh, rules), shape, mesh)


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry (None, an axis name or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_block(full: torch.Tensor, spec: Spec, mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """The block of `full` that the rank at `coords` ({axis: index})
    holds when `full` is stored by `spec` on `mesh`: along each dim split
    over axes (the first major, as DTensor and JAX split it), the
    index-th of as many equal slices as those axes have ranks. A view."""
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        n, i = 1, 0
        for a in axes:
            n *= sizes[a]
            i = i * sizes[a] + coords.get(a, 0)
        if full.shape[d] % n:
            raise ValueError(f"dim {d} ({full.shape[d]}) does not split "
                             f"{n} ways over {axes}")
        k = full.shape[d] // n
        full = full.narrow(d, i * k, k)
    return full


class ComputeSplit(NamedTuple):
    """Which units of an arch's attention LM a rank computes only its
    share of, by whole units over the "model" axis of `M` ranks: query
    heads (`heads`; `kv_heads` too when M divides the kv heads), MLP
    columns (`ff`), experts (`experts`) or every expert's columns
    (`expert_ff`), and the vocab rows of the head (`vocab`) and of the
    input table (`in_vocab`). False where the rules keep the unit off
    "model", where the stored spec does not split it (prune_pspec), or
    where M does not divide the unit count: those are computed whole on
    every rank of "model". All False at M = 1, and for a model that is no
    LM of the zoo (`cfg` None: the Stage-1 encoder, the Stage-2 model).

    The recurrent mixers (RWKV, Mamba, mLSTM, sLSTM), the Stage-1 pool
    and heads and the Stage-2 attention, MLPs and CPI head decide their
    units from their parameters' stored specs instead
    (`collectives.ModelShard.splits`), with the same rule: a rank
    computes its share of a unit where the pruned spec splits it over
    "model" and M divides the whole units along it (an RWKV, mLSTM or
    sLSTM layer's heads, a set attention's heads; any count of ff
    channels); elsewhere it computes the unit whole."""
    M: int
    heads: bool
    kv_heads: bool
    ff: bool
    experts: bool
    expert_ff: bool
    vocab: bool
    in_vocab: bool


def compute_split(cfg, mesh, rules: Optional[Dict] = None) -> ComputeSplit:
    """The `ComputeSplit` of `cfg` on `mesh` under `rules` (the arch's
    overrides applied by the caller, `arch_rules`). The specs split the
    flattened projection columns, not heads: wq's H*hd columns are stored
    split whenever M divides them (smollm: 9 heads of 64 at M 2, 4.5 heads
    a rank), but the compute splits heads only where M divides H;
    otherwise a rank gathers the projection over "model" and computes
    every head. The same holds for the kv heads (qwen3-moe's 4 and
    paligemma's 1 at M 16)."""
    M = axis_sizes(mesh).get("model", 1)
    if M == 1 or cfg is None:
        return ComputeSplit(M, *(False,) * 7)

    def on_model(logical, shape, dim):
        spec = pruned_spec(logical, shape, mesh, rules)
        return "model" in axes_of(spec[dim])

    d, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    heads = on_model(("embed", "heads"), (d, H * hd), 1) and H % M == 0
    kv = heads and on_model(("embed", "kv_heads"), (d, K * hd), 1) \
        and K % M == 0
    ff = cfg.d_ff > 0 and on_model(("embed", "ff"), (d, cfg.d_ff), 1)
    experts = expert_ff = False
    if cfg.moe is not None:
        shape = (cfg.moe.num_experts, d, cfg.moe.d_ff)
        logical = ("expert", "embed", "expert_ff")
        experts = on_model(logical, shape, 0)
        expert_ff = on_model(logical, shape, 2)
    V = cfg.vocab_size
    vocab = on_model(("vocab", "embed"), (V, d), 0)
    in_vocab = vocab if cfg.tie_embeddings else on_model(
        ("in_vocab", "embed"), (V, d), 0)
    return ComputeSplit(M, heads, kv, ff, experts, expert_ff, vocab,
                        in_vocab)


def is_logical(x) -> bool:
    """A leaf of a spec tree: a tuple of axis names / None."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map(fn, tree, *others):
    """fn over the logical-spec leaves of a nested dict / list tree (and
    the matching leaves of `others`)."""
    if is_logical(tree):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def placements(pspec: Spec, mesh) -> tuple:
    """The DTensor placements of a spec on a DeviceMesh: one a mesh dim,
    `Shard(d)` where tensor dim d's entry names the axis, else
    `Replicate()`. Raises when a dim's axes are not in mesh order (DTensor
    splits a dim over several mesh dims major first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, axes in enumerate(pspec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {pspec}: dim {d} splits over {axes}, "
                             f"not in the mesh's axis order {names}")
        for i in order:
            out[i] = Shard(d)
    return tuple(out)


def make_shardings(logical_tree, mesh, rules: Optional[Dict] = None,
                   shapes=None):
    """Tree of logical specs -> tree of DTensor placements on `mesh`.

    With `shapes` (a matching tree of tensors or shapes) every spec is
    first pruned to be valid for the concrete shape."""
    def one(logical, *shape):
        spec = logical_to_pspec(logical, mesh, rules)
        if shape:
            s = shape[0]
            spec = prune_pspec(spec, tuple(getattr(s, "shape", s)), mesh)
        return placements(spec, mesh)

    if shapes is None:
        return _map(one, logical_tree)
    return _map(one, logical_tree, shapes)


def distribute(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """A DTensor holding this rank's shard of `full` (which every rank
    holds whole): local chunks, no communication."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, place)


def shard_params(params: Dict[str, torch.Tensor], specs, mesh,
                 rules: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """{name: full tensor} -> {name: DTensor} placed by the rules (each
    spec pruned to its tensor's shape)."""
    place = make_shardings({k: specs[k] for k in params}, mesh, rules,
                           shapes=params)
    return {k: distribute(v, mesh, place[k]) for k, v in params.items()}


# The current logical mesh + rules, set by the Trainer so that model code
# can place activation constraints without threading a mesh handle through
# every call. None: constraints are the identity.
_ACTIVE: dict = {"mesh": None, "rules": None}


def set_logical_mesh(mesh, rules: Optional[Dict] = None):
    _ACTIVE["mesh"] = mesh
    _ACTIVE["rules"] = rules


def get_logical_mesh():
    return _ACTIVE["mesh"]


def with_sharding_constraint(x, logical: Logical,
                             rules: Optional[Dict] = None):
    """Activation sharding constraint by logical axis names. The identity
    when no mesh is installed and on a rank-local tensor: the port's
    compute is rank-local, and where GSPMD would move an activation to
    meet a constraint, the tensor-parallel layers call their collectives
    themselves (`collectives.ModelShard`: copy-in, reduce-out, gathers),
    so there is nothing left for a constraint to do. A DTensor is
    redistributed to the spec's placements."""
    from torch.distributed.tensor import DTensor
    mesh = _ACTIVE["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_pspec(logical, mesh, rules or _ACTIVE["rules"])
    spec = prune_pspec(spec, x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))
