"""gem5-proxy interval performance models.

gem5 is unavailable offline; this analytic interval CPU model stands in
for it as the deterministic ground-truth oracle. The benchmark keeps the
in-order core of the system's two:

- ``INORDER_CPU``  — gem5 TimingSimpleCPU analogue: one instruction at a
  time, full exposure to memory and dependency latency.

It maps an Interval (block frequencies + phase memory pressure) to CPI.
The mapping is a smooth, deterministic function of semantically meaningful
block features, so a signature that captures block semantics *can* learn
it — which is the property the paper's CPI-regression co-training needs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from chipbench.traffic.isa import BasicBlock
from chipbench.traffic.trace import Interval


@dataclass(frozen=True)
class CPUModel:
    name: str
    issue_width: float
    rob_depth: int
    mispredict_penalty: float
    l1_bytes: int
    l2_bytes: int
    l3_bytes: int
    l1_lat: float
    l2_lat: float
    l3_lat: float
    mem_lat: float
    mlp: float          # memory-level parallelism factor (1 = none)
    warmup_intervals: float  # cold-cache decay constant (in intervals)


INORDER_CPU = CPUModel(
    name="timing_simple", issue_width=1.0, rob_depth=1,
    mispredict_penalty=3.0,
    l1_bytes=32 << 10, l2_bytes=256 << 10, l3_bytes=4 << 20,
    l1_lat=3.0, l2_lat=12.0, l3_lat=36.0, mem_lat=180.0,
    mlp=1.0, warmup_intervals=0.8,
)



def _miss_curve(working_set: float, cache_bytes: float) -> float:
    """Smooth fraction of accesses missing a cache of given size."""
    if working_set <= 0:
        return 0.0
    x = working_set / cache_bytes
    return float(x ** 2 / (1.0 + x ** 2))  # 0 when ws<<cache, ->1 when ws>>cache


_MEM_KIND_FACTOR = {"seq": 0.12, "stride": 0.45, "random": 1.0}


def _block_cpi(b: BasicBlock, cpu: CPUModel, working_scale: float,
               cold_factor: float) -> float:
    """Average cycles/instruction contributed by one execution of block b."""
    f = b.features()
    n = f["n"]
    counts = f["counts"]

    # --- core pipeline term ---
    if cpu.issue_width <= 1.0:
        # in-order: serialized latency of the dependence-free schedule is
        # roughly dep_depth; remaining instrs issue 1/cycle
        core_cycles = max(n, f["dep_depth"])
    else:
        # OoO: throughput-bound unless the dependency chain is longer than
        # what the window can hide
        throughput = n / cpu.issue_width
        chain = f["dep_depth"] * min(1.0, n / cpu.rob_depth)
        core_cycles = max(throughput, chain)

    # --- long-latency ops not fully pipelined ---
    core_cycles += counts["div"] * 18.0 / cpu.issue_width
    core_cycles += counts["fpdiv"] * 10.0 / cpu.issue_width

    # --- memory term ---
    loads = f["loads"]
    if loads:
        ws = f["working_set"] * working_scale
        kind = _MEM_KIND_FACTOR[f["mem_kind"]]
        m1 = _miss_curve(ws, cpu.l1_bytes) * kind
        m2 = _miss_curve(ws, cpu.l2_bytes) * kind
        m3 = _miss_curve(ws, cpu.l3_bytes) * kind
        # cold caches inflate miss rates early in the run
        m1 = min(1.0, m1 + cold_factor * 0.5)
        m2 = min(1.0, m2 + cold_factor * 0.8)
        m3 = min(1.0, m3 + cold_factor)
        avg_lat = (cpu.l1_lat
                   + m1 * (cpu.l2_lat - cpu.l1_lat)
                   + m2 * (cpu.l3_lat - cpu.l2_lat)
                   + m3 * (cpu.mem_lat - cpu.l3_lat))
        exposed = avg_lat / cpu.mlp
        # in-order cores expose the full latency of every load; OoO hides
        # L1/L2 behind the window
        hidden = cpu.l1_lat if cpu.issue_width > 1 else 0.0
        core_cycles += loads * max(0.0, exposed - hidden)

    # --- branch term ---
    br = counts["branch"]
    if br:
        bias = f["branch_bias"]
        mispredict_rate = 2.0 * bias * (1.0 - bias) * 0.55 + 0.01
        core_cycles += br * mispredict_rate * cpu.mispredict_penalty

    return core_cycles / n


def interval_cpi(interval: Interval, blocks: Dict[int, BasicBlock],
                 cpu: CPUModel = INORDER_CPU) -> float:
    """Ground-truth CPI of an interval on a CPU model (the "gem5 run")."""
    cold = float(np.exp(-interval.index / cpu.warmup_intervals))
    total_instr = 0.0
    total_cycles = 0.0
    for bid, cnt in interval.counts.items():
        b = blocks[bid]
        cpi_b = _block_cpi(b, cpu, interval.working_scale, cold)
        total_instr += cnt * b.num_instrs
        total_cycles += cnt * b.num_instrs * cpi_b
    if total_instr == 0:
        return 1.0
    return float(total_cycles / total_instr)

