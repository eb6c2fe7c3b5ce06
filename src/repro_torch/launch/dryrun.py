"""Dry-run of the production mesh on meta tensors: how much work one
device's share of each step is, and what it holds. Port of
`repro.launch.dryrun`.

For every (architecture x input shape x mesh) cell:
  1. build the model on meta tensors (shapes and dtypes, no storage), as
     `Model.param_count` does, as the blocks device 0 of the mesh holds
     (`transformer.shard_lm` over a `MeshComm` in "count" mode, rank 0
     of every axis): each parameter by its pruned spec, so no process
     group is set up;
  2. run the step as one rank of the mesh runs it, under a
     `analysis.counting.StepCount`: the `Trainer`'s own `advance` on its
     tensor-parallel route (the rank's heads, ff columns, recurrent
     channels, experts or expert columns and vocab rows on "model",
     FSDP's gathers on "data"), `Model.prefill` and `Model.decode_step`
     on the global batch, whose rows the model splits over the data
     axes: products by dtype, bytes, kernel records, token loops probed
     (`token_loop`), and the peak of live bytes. Every collective the
     step enters is a record of the count (`collectives.MeshComm`: over
     "model" under "model all-reduce", "model all-to-all" etc.), so a
     device holds its parameter blocks, its optimizer state, its rows
     and cache, and the step's counted peak;
  3. write the roofline report (`analysis.roofline`, the H100) to
     artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json, which
     `python -m repro_torch.analysis.report` renders.

Everything in a report is derived from the H100 data sheet's constants
(`analysis.costs.H100_SXM`) and the counted work, not measured. JAX's
`--keep-hlo` has no counterpart: torch compiles no program to keep.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--multi-pod both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.analysis.costs import H100_SXM
from repro_torch.analysis.counting import StepCount
from repro_torch.analysis.roofline import format_report, roofline_terms
from repro_torch.config import (
    SHAPES, MeshConfig, TrainConfig, canon, get_arch,
)
from repro_torch.distributed.collectives import MeshComm
from repro_torch.distributed.sharding import (
    LOGICAL_RULES, arch_rules, axis_sizes, make_shardings,
)
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import build_model
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import tree_size_bytes

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# Assigned architectures (the 40-cell matrix); semanticbbv_encoder is an
# extra, not part of the assignment.
ASSIGNED = [
    "whisper_tiny", "grok_1_314b", "qwen3_moe_235b_a22b", "qwen3_4b",
    "qwen2_7b", "granite_3_2b", "smollm_135m", "xlstm_1_3b",
    "paligemma_3b", "jamba_1_5_large_398b",
]

TENSOR_PARALLEL_NOTE = ("tensor-parallel: each rank computes its heads, ff "
                        "columns, recurrent channels, experts and vocab rows "
                        "on \"model\" from its blocks")


def policy_for(model) -> Dict[str, Any]:
    """Per-size runtime policy, JAX's: optimizer, remat ("full" always:
    each period of layers recomputed in the backward) and microbatch
    (gradients accumulated over sequential slices: 8 for 50B+, 4 for
    1B+). JAX's `impl` ("chunked") has no counterpart: the port's
    attention is the flash kernel on every device."""
    n = model.param_count()
    if n >= 5e10:
        return dict(optimizer="adafactor", remat="full", microbatch=8)
    if n >= 1e9:
        return dict(optimizer="adamw", remat="full", microbatch=4)
    return dict(optimizer="adamw", remat="full", microbatch=1)


def rules_for(shape_name: str, cfg=None) -> Dict[str, Any]:
    rules = dict(LOGICAL_RULES)
    if SHAPES[shape_name].kind == "decode":
        # GQA head counts (1..8) never divide the 16-way model axis, so the
        # decode cache shards its sequence dim instead
        rules["kv_seq"] = "model"
    if shape_name == "long_500k":
        # batch=1: spend the idle data axis on the sequence dim too
        rules["kv_seq"] = ("data", "model")
    return arch_rules(cfg, rules)


def batch_specs(model, shape) -> Dict[str, Any]:
    """Logical axes for every input leaf."""
    specs = {}
    for k in model.input_specs(shape):
        if k == "tokens":
            specs[k] = ("batch", "seq") if shape.kind != "decode" \
                else ("batch", None)
        elif k in ("frames", "patches"):
            specs[k] = ("batch", None, "embed_act")
        elif k == "pos":
            specs[k] = ()
        elif k == "cache":
            specs[k] = model.cache_specs(shape)
    return specs


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def local_shape(shape, place, sizes: Dict[str, int]) -> tuple:
    """The shape of one device's block of a tensor of `shape` placed by
    `place` (one placement a mesh axis, in the mesh's order)."""
    out = list(shape)
    for n, pl in zip(sizes.values(), place):
        d = getattr(pl, "dim", None)
        if d is not None:
            out[d] //= n
    return tuple(out)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def make_train_step(model, params: torch.nn.Module, policy: Dict[str, Any],
                    train_cfg: TrainConfig) -> Trainer:
    """The `Trainer` of a zoo LM (`params`, its module, whole or one
    rank's blocks) under `policy`: `Model.loss` under its remat, its
    optimizer and microbatch. Its `advance(batch)` is the step (JAX's
    make_train_step returns a jitted function instead)."""
    cfg = dataclasses.replace(train_cfg, optimizer=policy["optimizer"],
                              microbatch=int(policy.get("microbatch", 1)),
                              remat=policy["remat"])

    def loss_fn(p, batch):
        return model.loss(p, batch, remat=cfg.remat)

    return Trainer(loss_fn, params, cfg)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def count_cell(arch_id: str, shape_name: str, multi_pod: bool
               ) -> Dict[str, Any]:
    """Count one (arch, shape, mesh) cell: SKIP for a shape the model does
    not take, else OK with the count, the bytes one device holds and the
    roofline report (as JSON, and the `RooflineReport` under "report")."""
    cfg = get_arch(arch_id)
    model = build_model(cfg)
    shape = SHAPES[shape_name]
    mesh_cfg = MeshConfig(multi_pod=multi_pod)
    base = {"arch": arch_id, "shape": shape_name,
            "mesh": _mesh_name(multi_pod)}
    if not model.supports_shape(shape):
        return dict(base, status="SKIP(full-attn)")
    rules = rules_for(shape_name, cfg)
    t0 = time.monotonic()
    with torch.device("meta"):
        params = tfm.LM(cfg)
    n_params = sum(p.numel() for p in params.parameters())
    return _count_sharded(model, params, shape, mesh_cfg, rules, base,
                          n_params, t0)


def _count_sharded(model, params, shape, mesh_cfg, rules, base, n_params,
                   t0) -> Dict[str, Any]:
    """`count_cell` on the tensor-parallel route: the step on this
    device's blocks, every collective counted as it is entered."""
    cfg = model.cfg
    sizes = axis_sizes(mesh_cfg)
    comm = MeshComm(sizes, {a: 0 for a in sizes}, "count")
    tfm.shard_lm(params, comm, rules)
    policy = policy_for(model)
    inputs = model.input_specs(shape)
    in_place = make_shardings(batch_specs(model, shape), mesh_cfg, rules,
                              shapes=inputs)
    rows = local_shape(inputs["tokens"].shape, in_place["tokens"], sizes)[0]
    named = {n.replace(".", "/"): p for n, p in params.named_parameters()}
    held: Dict[str, float] = {"params": tree_size_bytes(named)}
    if shape.kind == "decode":
        cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                               torch.bfloat16, torch.device("meta"),
                               tp=params.tp)
        held["cache"] = tree_size_bytes(cache)
    else:
        held["inputs"] = tree_size_bytes({
            k: _meta(local_shape(v.shape, in_place[k], sizes), v.dtype)
            for k, v in inputs.items()})
    if shape.kind == "train":
        trainer = make_train_step(model, params, policy, TrainConfig())
        held["opt"] = tree_size_bytes(trainer.state.opt_state)
    with StepCount() as count:
        if shape.kind == "train":
            trainer.advance(inputs)
        elif shape.kind == "prefill":
            model.prefill(params, inputs)
        else:
            model.decode_step(params, cache, inputs["tokens"],
                              _meta((), torch.int32))
    seconds = time.monotonic() - t0
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = model.active_param_count()
    per_token = 6 * n_active if shape.kind == "train" else 2 * n_active
    rep = roofline_terms(
        count, arch=base["arch"], shape=base["shape"], mesh=base["mesh"],
        chips=mesh_cfg.num_devices, model_flops=float(per_token) * tokens,
        argument_bytes=float(sum(held.values())),
        temp_bytes=float(count.peak_bytes), axis_sizes=sizes)
    return dict(base, status="OK", chips=mesh_cfg.num_devices,
                policy=policy, params=n_params, active_params=n_active,
                rows_per_device=rows, held_bytes=held,
                count=count.summary(), roofline=rep.to_json(),
                model_axis=TENSOR_PARALLEL_NOTE, count_s=seconds,
                report=rep)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             save: bool = True) -> Dict[str, Any]:
    """`count_cell`, printed and written to ARTIFACT_DIR; a cell that
    raises is FAIL."""
    name = f"{arch_id}_{shape_name}_{_mesh_name(multi_pod)}"
    try:
        art = count_cell(arch_id, shape_name, multi_pod)
    except Exception as e:
        traceback.print_exc()
        return {"status": f"FAIL: {type(e).__name__}: {e}", "arch": arch_id,
                "shape": shape_name, "mesh": _mesh_name(multi_pod),
                "name": name}
    art["name"] = name
    rep = art.pop("report", None)
    if rep is None:
        print(f"{name}: {art['status']}")
    else:
        held = rep.argument_bytes + rep.temp_bytes
        fits = held < H100_SXM.hbm_bytes
        print(format_report(rep))
        print(f"  counted in {art['count_s']:.1f}s  per-device bytes="
              f"{held / 1e9:.2f}GB ({'FITS' if fits else 'OVER'} "
              f"{H100_SXM.hbm_bytes / 1e9:.0f}GB); {art['model_axis']}")
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        with open(os.path.join(ARTIFACT_DIR, name + ".json"), "w") as f:
            json.dump(art, f, indent=1, default=str)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="full 40-cell matrix (+ multi-pod per --multi-pod)")
    args = ap.parse_args(argv)

    archs = (ASSIGNED if args.all or args.arch == "all"
             else [canon(args.arch)])
    shapes = list(SHAPES) if args.all or args.shape == "all" \
        else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]
    t0 = time.monotonic()
    results = [run_cell(arch, shape, mp) for arch in archs
               for shape in shapes for mp in pods]
    ok = sum(1 for r in results if r["status"] == "OK")
    skip = sum(1 for r in results if r["status"].startswith("SKIP"))
    fail = [r for r in results if r["status"].startswith("FAIL")]
    print(f"\n=== dry-run: {ok} OK, {skip} SKIP, {len(fail)} FAIL "
          f"of {len(results)} cells in {time.monotonic() - t0:.1f} s ===")
    for r in fail:
        print("  FAIL:", r["name"], r["status"])
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
