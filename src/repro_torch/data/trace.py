"""Execution tracing at the basic-block level.

The paper partitions dynamic execution into 10M-instruction intervals and
records per-interval basic-block frequencies (the BBV). Executing 1T real
instructions is out of scope offline, so `trace_program` synthesizes the
*block-level statistics* of such a trace directly: per interval it draws a
block-frequency vector from the program's current phase (mixture over hot
loops + sampling noise) and scales counts to the interval's instruction
budget. This is the data gate simulation described in DESIGN.md §3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from repro_torch.data.asmgen import Program
from repro_torch.data.isa import BasicBlock, stable_hash

INTERVAL_INSTRS = 10_000_000  # paper: 10M-instruction intervals


@dataclass
class Interval:
    """One sampling interval of a program's execution."""
    program: str
    index: int               # position within the program's trace
    counts: Dict[int, int]   # block id -> execution count
    phase_id: int
    working_scale: float     # memory pressure multiplier for this interval
    num_instrs: int

    def bbv(self, block_order: List[int], weight_by_len: bool = True,
            block_lens: Dict[int, int] = None) -> np.ndarray:
        """Classic BBV: per-block execution counts (optionally × block size),
        in a fixed block order, L1-normalized."""
        v = np.zeros(len(block_order), dtype=np.float64)
        idx = {b: i for i, b in enumerate(block_order)}
        for bid, c in self.counts.items():
            if bid in idx:
                w = c * (block_lens[bid] if (weight_by_len and block_lens) else 1)
                v[idx[bid]] = w
        s = v.sum()
        return v / s if s > 0 else v


def trace_program(program: Program, n_intervals: int,
                  interval_instrs: int = INTERVAL_INSTRS,
                  seed: int = 0) -> List[Interval]:
    """Synthesize the interval statistics of a long execution."""
    blocks = {b.bid: b for lp in program.loops for b in lp.blocks}
    intervals: List[Interval] = []
    # unroll the phase schedule cyclically over n_intervals
    schedule: List[int] = []
    while len(schedule) < n_intervals:
        for pi, ph in enumerate(program.phases):
            schedule.extend([pi] * ph.duration)
    schedule = schedule[:n_intervals]

    for it in range(n_intervals):
        rng = np.random.RandomState(stable_hash("ivl", program.pid, seed, it))
        pi = schedule[it]
        phase = program.phases[pi]
        # jitter the loop mixture a little within a phase (real phases drift)
        mix = phase.loop_mix + rng.dirichlet(np.ones(len(program.loops))) * 0.08
        mix = mix / mix.sum()
        counts: Dict[int, int] = {}
        total = 0
        for li, lp in enumerate(program.loops):
            loop_budget = mix[li] * interval_instrs
            if loop_budget < 1:
                continue
            per_block = lp.weights * loop_budget
            for b, w in zip(lp.blocks, per_block):
                c = int(w / max(1, b.num_instrs))
                if c > 0:
                    counts[b.bid] = counts.get(b.bid, 0) + c
                    total += c * b.num_instrs
        intervals.append(Interval(
            program=program.name, index=it, counts=counts, phase_id=pi,
            working_scale=float(phase.working_scale * 2 ** rng.uniform(-0.15, 0.15)),
            num_instrs=total,
        ))
    return intervals


def block_table(programs: List[Program]) -> Dict[int, BasicBlock]:
    """Union of unique blocks across programs (the Stage-1 encoding set)."""
    table: Dict[int, BasicBlock] = {}
    for p in programs:
        for b in p.unique_blocks:
            table[b.bid] = b
    return table
