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

from typing import Any, Dict, Optional, Sequence, Tuple, Union

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
    when no mesh is installed and on a rank-local tensor (the port's
    compute is rank-local); a DTensor is redistributed to the spec's
    placements."""
    from torch.distributed.tensor import DTensor
    mesh = _ACTIVE["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_pspec(logical, mesh, rules or _ACTIVE["rules"])
    spec = prune_pspec(spec, x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))
