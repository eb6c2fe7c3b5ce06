"""JAX parameter trees (as numpy) -> the port's modules.

A tree is what `jax.tree_util.tree_map(np.asarray, params)` gives for the
parameters of `repro.core.bbe.bbe_init` or `repro.core.signature.
signature_init`: nested dicts and lists of numpy arrays. The port's
modules name their parameters after the tree's keys and keep the JAX
layout of dense weights ((d_in, d_out), applied as x @ w), so the tree
maps onto `state_dict` keys by path, with two layout changes:

  * `blocks` of the Stage-1 encoder carries a leading `num_layers` axis
    (`bbe_init` builds it with `jax.vmap`); it is unstacked into the
    `blocks` ModuleList, one layer per index;
  * lists (`embeds`, the Stage-2 `sabs`) become numbered entries.

`lm_params_from_jax` loads an LM of the zoo (`repro.models.transformer.
lm_init`): its `layers/p<pos>/...` leaves carry a leading `n_periods`
axis (the `jax.vmap` init), split so that layer n * period + pos gets
index n (a decoder block's `cross` and `cross_norm` among them), and an
encoder-decoder's `encoder/layers/...` leaves a leading `encoder_layers`
axis, split into `encoder.layers.<i>`; the LM keeps the leaves' dtype
(the config's `param_dtype`, but for the leaves JAX keeps in fp32 in
every model: RWKV's `w_bias`,
Mamba's `A_log` and `D`, mLSTM's `b_i` and `b_f`, sLSTM's `b_zifo`, the
MoE `router`; an MoE layer's `moe/{router,wi,wg,wo}` map onto
`layers.<i>.moe.*` like any other leaf), and
bf16 leaves (numpy's `ml_dtypes.bfloat16`) cross as their bits, never
through float.

Loading is strict: a missing or extra leaf, or a shape that differs,
raises, and so does a leaf whose dtype is not the module's for it
(TypeError, naming both): a Stage-1/2 tree holds its config's dtype
(float32 or bfloat16) in every leaf but the Stage-1 `w_bias`, fp32 in
every model, so a bf16 tree loads into a bf16 config only. bf16 leaves
(numpy's `ml_dtypes.bfloat16`) cross as their bits. Nothing here imports
jax.

Checkpoint directories cross in both directions through the shared
on-disk format (`repro_torch.train.checkpoint`): the key of a leaf is
its `state_dict` name with "." -> "/", which is the JAX tree's path.
  * JAX -> port: `signature_params_from_checkpoint` and
    `bbe_params_from_checkpoint` load the Stage-2 / Stage-1 weights of a
    directory written by `repro.train.checkpoint.save_checkpoint`;
    `stage2_engine_from_checkpoint` restores a JAX `Stage2Engine`
    checkpoint (params, AdamW state, step) into a port engine, and a port
    `Trainer` of the Stage-1 encoder restores a JAX Stage-1 `Trainer`'s
    with its own `load`.
  * port -> JAX: `save_signature_checkpoint`, `save_bbe_checkpoint` (and
    the port Trainer's own checkpoints) write directories that
    `repro.train.checkpoint.restore_checkpoint` reads with a JAX template.
Stage-1 checkpoints keep `blocks` stacked, as `bbe_init` does: the
encoder's `pack_checkpoint` / `unpack_checkpoint` convert the names.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.bbe import BBEConfig, BBEEncoder
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.signature import SignatureConfig, SignatureModel
from repro_torch.device import Device, resolve_device
from repro_torch.distributed.collectives import MeshComm, shard_module
from repro_torch.models.transformer import (
    LM, period_of, shard_lm, stacked_key, unstack_lm_layers,
)
from repro_torch.train import checkpoint
from repro_torch.train.stage2 import Stage2Engine


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _load(module: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"parameter tree does not match the module: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    loaded = {}
    for key, value in flat.items():
        t = _leaf_tensor(value)
        if tuple(t.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: tree shape {tuple(t.shape)} vs module "
                             f"shape {tuple(state[key].shape)}")
        if t.dtype != state[key].dtype:
            raise TypeError(f"{key}: tree dtype {value.dtype}, the module "
                            f"holds {state[key].dtype}")
        loaded[key] = t
    module.load_state_dict(loaded, strict=True)
    return module


def bbe_params_from_jax(tree: Dict[str, Any], cfg: BBEConfig, mesh=None,
                        rules=None) -> BBEEncoder:
    """Stage-1 encoder with the weights of a `bbe_init` tree (CPU); with
    `mesh` (a DeviceMesh or a `MeshComm`), holding this rank's blocks of
    them as `collectives.shard_module` places them."""
    flat = dict(_flatten({k: v for k, v in tree.items() if k != "blocks"}))
    for key, stacked in _flatten(tree["blocks"]):
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"blocks.{key}: leading axis {stacked.shape[0]}"
                             f" != num_layers {cfg.num_layers}")
        for layer in range(cfg.num_layers):
            flat[f"blocks.{layer}.{key}"] = stacked[layer]
    encoder = _load(BBEEncoder(cfg), flat)
    return encoder if mesh is None else shard_module(encoder, mesh, rules)


def signature_params_from_jax(tree: Dict[str, Any], cfg: SignatureConfig,
                              mesh=None, rules=None) -> SignatureModel:
    """Stage-2 model with the weights of a `signature_init` tree (CPU);
    with `mesh` (a DeviceMesh or a `MeshComm`), holding this rank's blocks
    of them as `collectives.shard_module` places them."""
    model = _load(SignatureModel(cfg), dict(_flatten(tree)))
    return model if mesh is None else shard_module(model, mesh, rules)


def _leaf_tensor(value: np.ndarray) -> torch.Tensor:
    """numpy leaf -> CPU tensor of the same dtype; bf16 by its bits."""
    if value.dtype.name == "bfloat16":
        bits = np.array(value).view(np.int16)      # a writable copy
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(value))


def lm_params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, mesh=None,
                       rules=None) -> LM:
    """An LM of the zoo (CPU) with the weights of a `lm_init` tree; with
    `mesh` (a DeviceMesh or a `MeshComm`), holding this rank's blocks of
    them as `Model.init(mesh=, rules=)` places them.

    The stacked leaves are split by `transformer.stacked_key`, the rule
    the LM's checkpoint hooks stack by. Strict on names and shapes like
    `_load`; each leaf must have the dtype of the module's parameter,
    which follows JAX leaf by leaf."""
    n_periods = cfg.num_layers // period_of(cfg)
    stacked = {k.replace(".", "/"): v for k, v in _flatten(tree)}
    for key, leaf in stacked.items():
        for part, n, name in (("layers/p", n_periods, "n_periods"),
                              ("encoder/layers/", cfg.encoder_layers,
                               "encoder_layers")):
            if key.startswith(part) and leaf.shape[0] != n:
                raise ValueError(f"{key}: leading axis {leaf.shape[0]} != "
                                 f"{name} {n}")
    model = LM(cfg)
    state = model.state_dict()
    named = [k.replace(".", "/") for k in state]
    want = {(stacked_key(cfg, k) or (k,))[0] for k in named}
    missing = sorted(want - set(stacked))
    extra = sorted(set(stacked) - want)
    if missing or extra:
        raise KeyError(f"parameter tree does not match the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    flat = unstack_lm_layers(cfg, stacked, named)
    loaded = {}
    for key, value in flat.items():
        key = key.replace("/", ".")
        t = _leaf_tensor(value)
        if tuple(t.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: tree shape {tuple(t.shape)} vs module "
                             f"shape {tuple(state[key].shape)}")
        if t.dtype != state[key].dtype:
            raise TypeError(f"{key}: tree dtype {t.dtype} vs module dtype "
                            f"{state[key].dtype} (param_dtype "
                            f"{cfg.param_dtype}; some leaves stay fp32)")
        loaded[key] = t
    model.load_state_dict(loaded, strict=True)
    if mesh is None:
        return model
    comm = mesh if isinstance(mesh, MeshComm) else MeshComm.of_mesh(mesh)
    return shard_lm(model, comm, rules)


def _named(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters under their checkpoint keys."""
    return {k.replace(".", "/"): v for k, v in model.state_dict().items()}


# a leaf's dtype as a manifest records it; the JAX writer records a bf16
# leaf as "uint16" (its bits), the port's as "bfloat16"
_SAVED_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "uint16": torch.bfloat16}


def _restore_params(path: str, template: Dict[str, torch.Tensor]):
    """`checkpoint.restore_checkpoint` of the leaves of `template`, after
    checking that each was saved in its template's dtype (TypeError,
    naming both, as `_load` raises): the restore would cast it."""
    saved = checkpoint.read_manifest(path)["dtypes"]
    for key, t in template.items():
        got = _SAVED_DTYPES.get(saved.get(key))
        if key in saved and got != t.dtype:
            raise TypeError(f"{key}: checkpoint dtype {saved[key]}, the "
                            f"module holds {t.dtype}")
    return checkpoint.restore_checkpoint(path, template)[0]


def bbe_params_from_checkpoint(path: str, cfg: BBEConfig) -> BBEEncoder:
    """Stage-1 encoder (CPU) with the "params/..." leaves of the checkpoint
    directory `path` (a `step_*` directory of either package), its
    `blocks` stacked along a leading `num_layers` axis. Each leaf must
    have been saved in the module's dtype for it."""
    model = BBEEncoder(cfg)
    named = {"params/" + k: v for k, v in _named(model).items()}
    tree = _restore_params(path, model.pack_checkpoint(named))
    flat = model.unpack_checkpoint(tree, named)
    model.load_state_dict({k[len("params/"):].replace("/", "."): v
                           for k, v in flat.items()}, strict=True)
    return model


def save_bbe_checkpoint(model: BBEEncoder, directory: str, step: int = 0,
                        opt_state: Optional[Dict] = None,
                        keep: int = 3) -> str:
    """Writes the encoder's weights (and `opt_state` when given, in the
    optimizer layout of `repro_torch.train.optimizer`) as checkpoint
    `step` in `directory`, `blocks` stacked, for `repro.train.checkpoint.
    restore_checkpoint` with a {"params": bbe_init tree[, "opt": ...]}
    template."""
    tree: Dict[str, Any] = {"params": _named(model)}
    if opt_state is not None:
        tree["opt"] = opt_state
    return checkpoint.save_checkpoint(
        directory, step, model.pack_checkpoint(checkpoint._flatten(tree)),
        meta={"step": step}, keep=keep)


def signature_params_from_checkpoint(path: str, cfg: SignatureConfig
                                     ) -> SignatureModel:
    """Stage-2 model (CPU) with the "params/..." leaves of the checkpoint
    directory `path` (a `step_*` directory of either package), each saved
    in the module's dtype for it."""
    model = SignatureModel(cfg)
    named = {"params/" + k: v for k, v in _named(model).items()}
    tree = _restore_params(path, named)
    model.load_state_dict({k[len("params/"):].replace("/", "."): v
                           for k, v in tree.items()}, strict=True)
    return model


def stage2_engine_from_checkpoint(path: str, sig_cfg: SignatureConfig,
                                  matrix, cfg: TrainConfig,
                                  device: Device = "cuda") -> Stage2Engine:
    """A port `Stage2Engine` on `device` in the state a JAX (or port)
    `Stage2Engine` checkpoint holds: params, optimizer state and step."""
    model = SignatureModel(sig_cfg).to(resolve_device(device))
    engine = Stage2Engine(sig_cfg, model, matrix, cfg)
    engine.trainer.load(path)
    return engine


def save_signature_checkpoint(model: SignatureModel, directory: str,
                              step: int = 0, opt_state: Optional[Dict] = None,
                              keep: int = 3) -> str:
    """Writes the model's weights (and `opt_state` when given, in the
    optimizer layout of `repro_torch.train.optimizer`) as checkpoint
    `step` in `directory`, for `repro.train.checkpoint.restore_checkpoint`
    with a {"params": signature_init tree[, "opt": ...]} template."""
    tree: Dict[str, Any] = {"params": _named(model)}
    if opt_state is not None:
        tree["opt"] = opt_state
    return checkpoint.save_checkpoint(directory, step, tree,
                                      meta={"step": step}, keep=keep)
