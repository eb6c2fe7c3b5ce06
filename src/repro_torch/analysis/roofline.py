"""Three-term roofline of one device's share of a step, on the H100
(port of `repro.analysis.roofline`, whose target was the TPU v5e):

  compute term    = fp32 FLOPs / fp32 peak + bf16 FLOPs / bf16 peak
  memory term     = bytes / HBM rate
  collective term = collective bytes / the slowest link a mesh axis
                    crosses (an axis wider than a node's 8 cards, or the
                    "pod" axis, leaves the node: 50 GB/s, else NVLink's
                    450 GB/s); the records over "model" (the tensor-
                    parallel compute's, "model all-reduce" etc.) on the
                    model axis' own link, the others on the other axes'

The quantities come from `repro_torch.analysis.counting` (a `StepCount`,
or any object with `flops_fp32`, `flops_bf16`, `bytes` and
`collective_bytes`), taken on one device's share of the step, so every
term is per device. The compute term reckons as `costs.work_bound` does. JAX's
report also kept XLA's own `cost_analysis` numbers (`xla_flops`,
`xla_bytes`); torch has no compiler analysis to keep, so they are gone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from repro_torch.analysis.costs import H100_SXM, Hardware


# the kinds of the collectives over the "model" axis
# (`distributed.collectives.MeshComm`)
MODEL_PREFIX = "model "


def link_for(axis_sizes: Optional[Mapping[str, int]],
             hw: Hardware = H100_SXM) -> float:
    """The slowest link (bytes/s a direction a card) that collectives over
    a mesh of these axes cross: between nodes when an axis has more ranks
    than a node holds, or is "pod"; within one otherwise."""
    if not axis_sizes:
        return hw.link_bw
    leaves = any(n > hw.node_size or (a == "pod" and n > 1)
                 for a, n in axis_sizes.items())
    return hw.inter_node_bw if leaves else hw.link_bw


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # counted per-device quantities
    flops_per_device: float
    flops_fp32_per_device: float
    flops_bf16_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    # model-level accounting
    model_flops: float                  # 6·N·D (active params × tokens)
    # memory fit: what one device holds before the step (parameters,
    # optimizer state, inputs) and the peak of what the step adds
    argument_bytes: float = 0.0
    temp_bytes: float = 0.0
    # the link the collectives cross (bytes/s; 0: the hardware's NVLink),
    # and the one those over "model" cross
    link_bw: float = 0.0
    model_link_bw: float = 0.0

    def terms(self, hw: Hardware = H100_SXM) -> Dict[str, float]:
        t_compute = (self.flops_fp32_per_device / hw.peak_flops_fp32
                     + self.flops_bf16_per_device / hw.peak_flops)
        t_memory = self.bytes_per_device / hw.hbm_bw
        on_model = sum(v for k, v in self.collective_breakdown.items()
                       if k.startswith(MODEL_PREFIX))
        t_collective = ((self.collective_bytes_per_device - on_model)
                        / (self.link_bw or hw.link_bw)
                        + on_model / (self.model_link_bw or hw.link_bw))
        dominant = max(("compute", t_compute), ("memory", t_memory),
                       ("collective", t_collective), key=lambda kv: kv[1])
        total_flops = self.flops_per_device * self.chips
        return {
            "compute_s": t_compute,
            "memory_s": t_memory,
            "collective_s": t_collective,
            "dominant": dominant[0],
            "bound_s": dominant[1],
            # fraction of the roofline-limited time spent on useful math
            "roofline_fraction": (t_compute / dominant[1]
                                  if dominant[1] > 0 else 0.0),
            "model_flops": self.model_flops,
            "useful_flops_ratio": (self.model_flops / total_flops
                                   if total_flops else 0.0),
            "mfu_upper_bound": (self.model_flops /
                                (dominant[1] * self.chips * hw.peak_flops)
                                if dominant[1] > 0 else 0.0),
        }

    def to_json(self, hw: Hardware = H100_SXM) -> dict:
        d = dataclasses.asdict(self)
        d["terms"] = self.terms(hw)
        d["hardware"] = hw.name
        return d


def roofline_terms(count, *, arch: str, shape: str, mesh: str, chips: int,
                   model_flops: float, argument_bytes: float = 0.0,
                   temp_bytes: float = 0.0,
                   axis_sizes: Optional[Mapping[str, int]] = None,
                   hw: Hardware = H100_SXM) -> RooflineReport:
    """The report of one device's `count` of a step on `chips` devices of
    a mesh with these axes."""
    coll = dict(count.collective_bytes)
    sizes = dict(axis_sizes or {})
    model = {"model": sizes.pop("model")} if "model" in sizes else None
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_per_device=count.flops_fp32 + count.flops_bf16,
        flops_fp32_per_device=count.flops_fp32,
        flops_bf16_per_device=count.flops_bf16,
        bytes_per_device=count.bytes,
        collective_bytes_per_device=sum(coll.values()),
        collective_breakdown=coll, model_flops=model_flops,
        argument_bytes=argument_bytes, temp_bytes=temp_bytes,
        link_bw=link_for(sizes or axis_sizes, hw),
        model_link_bw=link_for(model, hw))


def format_report(rep: RooflineReport, hw: Hardware = H100_SXM) -> str:
    t = rep.terms(hw)
    lines = [
        f"[{rep.arch} × {rep.shape} × {rep.mesh}] {rep.chips} chips "
        f"({hw.name})",
        f"  compute    {t['compute_s']*1e3:12.3f} ms "
        f"({rep.flops_per_device/1e12:.2f} TFLOP/device: fp32 "
        f"{rep.flops_fp32_per_device/1e12:.2f}, bf16 "
        f"{rep.flops_bf16_per_device/1e12:.2f})",
        f"  memory     {t['memory_s']*1e3:12.3f} ms "
        f"({rep.bytes_per_device/1e9:.2f} GB/device)",
        f"  collective {t['collective_s']*1e3:12.3f} ms "
        f"({rep.collective_bytes_per_device/1e9:.3f} GB/device at "
        f"{(rep.link_bw or hw.link_bw)/1e9:.0f} GB/s, \"model\" at "
        f"{(rep.model_link_bw or hw.link_bw)/1e9:.0f} GB/s: "
        + ", ".join(f"{k}={v/1e9:.2f}GB"
                    for k, v in rep.collective_breakdown.items()) + ")",
        f"  dominant={t['dominant']}  roofline_fraction="
        f"{t['roofline_fraction']:.3f}  mfu_upper_bound="
        f"{t['mfu_upper_bound']:.3f}",
        f"  model_flops={rep.model_flops/1e12:.2f}T  "
        f"useful/counted={t['useful_flops_ratio']:.3f}  "
        f"mem: held={rep.argument_bytes/1e9:.2f}GB "
        f"step peak={rep.temp_bytes/1e9:.2f}GB",
    ]
    return "\n".join(lines)
