"""The base world of the signing service, vectorised for set-up: the
SPEC-like programs of the suites asked for (`asmgen.SPEC_INT_LIKE`,
`SPEC_FP_LIKE`), their 10M-instruction intervals and each interval's
ground-truth CPI on the in-order core.

`trace` draws the same statistics as `trace.trace_program` (each
interval's phase from the cyclic schedule, its loop mixture jittered by
a Dirichlet draw, block counts from the mixture and the loops' weights,
its memory pressure jittered) from one generator a program instead of
one an interval. `interval_cpis` is `perfmodel.interval_cpi` over many
intervals at once; the tests hold both to the loop versions.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from chipbench.traffic.asmgen import Program, spec_programs
from chipbench.traffic.isa import INSTR_CLASSES, BasicBlock, stable_hash
from chipbench.traffic.perfmodel import _MEM_KIND_FACTOR, CPUModel, INORDER_CPU
from chipbench.traffic.trace import INTERVAL_INSTRS, Interval


def trace(program: Program, n_intervals: int, seed: int,
          interval_instrs: int = INTERVAL_INSTRS) -> List[Interval]:
    rng = np.random.RandomState(stable_hash("world-ivl", program.pid, seed))
    schedule: List[int] = []
    while len(schedule) < n_intervals:
        for pi, ph in enumerate(program.phases):
            schedule.extend([pi] * ph.duration)
    phase = np.asarray(schedule[:n_intervals])
    n_loops = len(program.loops)
    mix = np.stack([p.loop_mix for p in program.phases])[phase]
    mix = mix + rng.dirichlet(np.ones(n_loops), size=n_intervals) * 0.08
    mix = mix / mix.sum(1, keepdims=True)
    jitter = 2 ** rng.uniform(-0.15, 0.15, size=n_intervals)
    scale = np.asarray([program.phases[p].working_scale for p in phase]) * jitter
    # one column per (loop, block) entry, in the loops' order
    loop_of = np.concatenate([[li] * len(lp.blocks)
                              for li, lp in enumerate(program.loops)])
    weight = np.concatenate([lp.weights for lp in program.loops])
    blocks = [b for lp in program.loops for b in lp.blocks]
    lens = np.asarray([max(1, b.num_instrs) for b in blocks], np.float64)
    budget = mix[:, loop_of] * interval_instrs
    counts = np.where(budget >= 1,
                      np.floor(weight[None] * budget / lens[None]), 0)
    counts = counts.astype(np.int64)
    out = []
    for it in range(n_intervals):
        c: Dict[int, int] = {}
        total = 0
        for j in np.flatnonzero(counts[it] > 0):
            b = blocks[j]
            c[b.bid] = c.get(b.bid, 0) + int(counts[it, j])
            total += int(counts[it, j]) * b.num_instrs
        out.append(Interval(program=program.name, index=it, counts=c,
                            phase_id=int(phase[it]),
                            working_scale=float(scale[it]), num_instrs=total))
    return out


def _features(blocks: Sequence[BasicBlock]) -> Dict[str, np.ndarray]:
    feats = [b.features() for b in blocks]
    col = lambda f: np.asarray([x[f] for x in feats], np.float64)  # noqa: E731
    return {
        "n": col("n"), "dep": col("dep_depth"), "loads": col("loads"),
        "ws": col("working_set"), "bias": col("branch_bias"),
        "kind": np.asarray([_MEM_KIND_FACTOR[x["mem_kind"]] for x in feats]),
        **{c: np.asarray([x["counts"][c] for x in feats], np.float64)
           for c in INSTR_CLASSES}}


def _miss(ws, cache):
    x = ws / cache
    return np.where(ws > 0, x ** 2 / (1.0 + x ** 2), 0.0)


def interval_cpis(intervals: Sequence[Interval],
                  blocks: Dict[int, BasicBlock],
                  cpu: CPUModel = INORDER_CPU) -> np.ndarray:
    """`perfmodel.interval_cpi` of every interval, as one array."""
    bids = sorted({b for iv in intervals for b in iv.counts})
    col = {b: j for j, b in enumerate(bids)}
    f = _features([blocks[b] for b in bids])
    cnt = np.zeros((len(intervals), len(bids)))
    for i, iv in enumerate(intervals):
        for b, c in iv.counts.items():
            cnt[i, col[b]] = c
    idx = np.asarray([iv.index for iv in intervals], np.float64)
    cold = np.exp(-idx / cpu.warmup_intervals)[:, None]
    scale = np.asarray([iv.working_scale for iv in intervals])[:, None]
    n = f["n"][None]
    if cpu.issue_width <= 1.0:
        core = np.maximum(n, f["dep"][None])
    else:
        core = np.maximum(n / cpu.issue_width,
                          f["dep"][None] * np.minimum(1.0, n / cpu.rob_depth))
    core = core + (f["div"] * 18.0 + f["fpdiv"] * 10.0)[None] / cpu.issue_width
    ws = f["ws"][None] * scale
    kind = f["kind"][None]
    m1 = np.minimum(1.0, _miss(ws, cpu.l1_bytes) * kind + cold * 0.5)
    m2 = np.minimum(1.0, _miss(ws, cpu.l2_bytes) * kind + cold * 0.8)
    m3 = np.minimum(1.0, _miss(ws, cpu.l3_bytes) * kind + cold)
    lat = (cpu.l1_lat + m1 * (cpu.l2_lat - cpu.l1_lat)
           + m2 * (cpu.l3_lat - cpu.l2_lat) + m3 * (cpu.mem_lat - cpu.l3_lat))
    hidden = cpu.l1_lat if cpu.issue_width > 1 else 0.0
    core = core + np.where(f["loads"][None] > 0, f["loads"][None]
                           * np.maximum(0.0, lat / cpu.mlp - hidden), 0.0)
    bias = f["bias"]
    mis = 2.0 * bias * (1.0 - bias) * 0.55 + 0.01
    core = core + (f["branch"] * mis * cpu.mispredict_penalty)[None]
    instr = cnt * n
    cycles = instr * (core / n)
    tot = instr.sum(1)
    return np.where(tot > 0, cycles.sum(1) / np.maximum(tot, 1), 1.0)


def base_world(n_intervals: int, seed: int, suites: Sequence[str]):
    """(programs, {bid: block}, {name: intervals}, {name: CPIs}) of the
    suites ("int", "fp"), in that order."""
    programs = [p for suite in suites for p in spec_programs(suite)]
    blocks = {b.bid: b for p in programs for b in p.unique_blocks}
    intervals = {p.name: trace(p, n_intervals, seed) for p in programs}
    cpis = {n: interval_cpis(ivs, blocks) for n, ivs in intervals.items()}
    return programs, blocks, intervals, cpis
