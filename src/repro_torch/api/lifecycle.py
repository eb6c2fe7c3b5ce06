"""Store lifecycle policies: TTL/LRU eviction and the vacuum pass (port of
`repro.api.lifecycle`).

  `EvictionPolicy`   typed config: TTL (evict rows idle for more than
                     `ttl` logical ticks) and/or LRU (when live rows
                     exceed `max_rows`, evict the least recently used
                     overflow). Both off by default.
  `select_victims`   pure policy evaluation -> row ids to evict.
  `vacuum`           evict per policy, compact when worthwhile, and
                     re-pin the KnowledgeBase through the remap; returns
                     a `VacuumReport`.

The clock is LOGICAL (one tick per store add/touch), not wall time: age
counts ingest and query traffic, and runs replay deterministically.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.api.knowledge import KnowledgeBase
from repro_torch.api.store import SignatureStore


@dataclasses.dataclass(frozen=True)
class EvictionPolicy:
    """What `vacuum()` evicts. The default evicts nothing (compaction of
    rows already tombstoned still runs).

    ttl               evict rows whose `last_used` is more than this many
                      logical ticks behind the store clock.
    max_rows          LRU high-water mark: when live rows exceed it, evict
                      the least recently used overflow (ties to the lower
                      row, the older insertion).
    compact_dead_fraction
                      `vacuum()` compacts only when dead / total row slots
                      reach this fraction (0.0: whenever a row is dead).
    """
    ttl: Optional[int] = None
    max_rows: Optional[int] = None
    compact_dead_fraction: float = 0.0

    def __post_init__(self):
        if self.ttl is not None and self.ttl < 0:
            raise ValueError(f"ttl must be >= 0, got {self.ttl}")
        if self.max_rows is not None and self.max_rows < 0:
            raise ValueError(f"max_rows must be >= 0, got {self.max_rows}")
        if not 0.0 <= self.compact_dead_fraction <= 1.0:
            raise ValueError("compact_dead_fraction must be in [0, 1], "
                             f"got {self.compact_dead_fraction}")


@dataclasses.dataclass(frozen=True)
class VacuumReport:
    """What one `vacuum()` pass did."""
    evicted: int                 # rows newly tombstoned by the policy
    dead_before: int             # tombstones going into the pass
    compacted: bool
    repinned: int                # representatives moved to live rows
    rows_before: int             # row slots before (tombstones included)
    rows_after: int
    capacity_before: int
    capacity_after: int


def select_victims(store: SignatureStore,
                   policy: EvictionPolicy) -> np.ndarray:
    """Row ids the policy evicts (live rows only, ascending)."""
    alive = store.alive_rows
    if alive.size == 0:
        return np.zeros(0, np.int64)
    victims = np.zeros(len(store), bool)
    if policy.ttl is not None:
        age = store.clock - store.last_used[alive]
        victims[alive[age > policy.ttl]] = True
    if policy.max_rows is not None:
        survivors = alive[~victims[alive]]
        overflow = survivors.size - policy.max_rows
        if overflow > 0:
            # least recently used first; ties -> lowest row id (oldest)
            order = np.lexsort((survivors, store.last_used[survivors]))
            victims[survivors[order[:overflow]]] = True
    return np.flatnonzero(victims).astype(np.int64)


def vacuum(store: SignatureStore, kb: Optional[KnowledgeBase] = None,
           policy: EvictionPolicy = EvictionPolicy()) -> VacuumReport:
    """One maintenance pass: policy eviction -> (maybe) compaction ->
    KnowledgeBase remap. A pass with nothing to do mutates nothing."""
    rows_before = len(store)
    cap_before = store.capacity
    dead_before = rows_before - store.n_alive
    evicted = store.evict(select_victims(store, policy))

    dead = len(store) - store.n_alive
    threshold = policy.compact_dead_fraction * max(len(store), 1)
    compacted = False
    repinned = 0
    if dead > 0 and dead >= threshold:
        remap = store.compact()
        compacted = True
        if kb is not None and kb.built:
            repinned = kb.apply_remap(remap)
    return VacuumReport(
        evicted=evicted, dead_before=dead_before, compacted=compacted,
        repinned=repinned, rows_before=rows_before,
        rows_after=len(store), capacity_before=cap_before,
        capacity_after=store.capacity)
