"""Execution tracing at the basic-block level: the interval record.

The paper partitions dynamic execution into 10M-instruction intervals and
records per-interval basic-block frequencies (the BBV). The benchmark's
generators (`world.trace`, `programs.trace`) synthesize the block-level
statistics of such a trace directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

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
