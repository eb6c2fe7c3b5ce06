"""`SemanticBBVService`: the one-object public surface (port of
`repro.api.service`).

    pipeline   blocks -> BBEs -> interval signatures (Stage 1 + 2)
    store      signature store, matrix resident on the device
    knowledge  archetypes + fingerprint / estimate queries

Typical flow:

    svc = SemanticBBVService.create(ServiceConfig(), device="cuda")
    svc.ingest_blocks(unique_blocks)
    svc.ingest_intervals("gcc", intervals, cpis=ground_truth)   # x N
    svc.build()                       # k-means once -> 14 archetypes
    svc.ingest_intervals("new", ...)  # later, unseen program
    est = svc.estimate("new")         # attach (no re-clustering) + CPI

Everything runs on one device, "cuda" unless the caller asks for "cpu";
the kernels run there, and the plain PyTorch versions on the CPU. The
JAX package's backend switches (`impl`, `assign_impl`, `build_impl`) do
not exist here. `save`/`load` write and read the JAX package's layout
(`store/`, `knowledge/`, `summary.json`), so a service saved by either
package reloads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.api.knowledge import CPIEstimate, KnowledgeBase
from repro_torch.api.lifecycle import EvictionPolicy, VacuumReport, vacuum
from repro_torch.api.store import SignatureStore
from repro_torch.core.bbe import BBEConfig
from repro_torch.core.pipeline import SemanticBBVPipeline
from repro_torch.core.signature import SignatureConfig
from repro_torch.data.isa import BasicBlock
from repro_torch.device import Device
from repro_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Everything a service instance needs, typed. `bbe`/`sig` default
    to the module defaults when None."""
    seed: int = 0
    bbe: Optional[BBEConfig] = None
    sig: Optional[SignatureConfig] = None
    k: int = 14                       # universal archetypes (paper: 14)
    kmeans_seed: int = 0
    encode_batch: int = 256           # Stage-1 block batch
    signature_batch: int = 512        # Stage-2 interval batch
    store_min_capacity: int = 64      # pad-and-grow floor
    # store lifecycle: what vacuum() evicts (TTL/LRU over the store's
    # logical clock; the default evicts nothing, compaction only)
    eviction: EvictionPolicy = EvictionPolicy()


class SemanticBBVService:
    """Facade over pipeline + SignatureStore + KnowledgeBase, all on the
    pipeline's device."""

    def __init__(self, pipeline: SemanticBBVPipeline,
                 cfg: Optional[ServiceConfig] = None,
                 store: Optional[SignatureStore] = None,
                 kb: Optional[KnowledgeBase] = None):
        self.pipe = pipeline
        self.cfg = cfg or ServiceConfig(bbe=pipeline.bbe_cfg,
                                        sig=pipeline.sig_cfg)
        self.bbe_table: Dict[int, np.ndarray] = {}
        self.store = store if store is not None else SignatureStore(
            pipeline.sig_cfg.sig_dim,
            min_capacity=self.cfg.store_min_capacity, device=pipeline.device)
        self.kb = kb if kb is not None else KnowledgeBase(self.store)

    # ------------------------------------------------------------ factory
    @classmethod
    def create(cls, cfg: ServiceConfig = ServiceConfig(),
               device: Device = "cuda") -> "SemanticBBVService":
        """Fresh (untrained) pipeline from one typed config; raises if
        `device` is "cuda" and there is no card."""
        pipe = SemanticBBVPipeline.create(cfg.seed, cfg.bbe, cfg.sig, device)
        return cls(pipe, cfg)

    @classmethod
    def from_pipeline(cls, pipeline: SemanticBBVPipeline,
                      cfg: Optional[ServiceConfig] = None
                      ) -> "SemanticBBVService":
        """Wrap an existing (e.g. bridged, trained) pipeline."""
        return cls(pipeline, cfg)

    # ------------------------------------------------------------- ingest
    def ingest_blocks(self, blocks: Sequence[BasicBlock]) -> int:
        """Stage-1 encode basic blocks into the service's BBE table;
        returns the table size."""
        with spans.span("service.ingest_blocks"):
            self.bbe_table.update(
                self.pipe.encode_blocks(list(blocks), self.cfg.encode_batch))
            return len(self.bbe_table)

    def ingest_intervals(self, program: str, intervals: Sequence,
                         cpis: Optional[Sequence[float]] = None
                         ) -> np.ndarray:
        """Signature every interval and append to the store; returns the
        new store rows. Interval instruction counts become the weights.
        Blocks referenced by the intervals must have been ingested."""
        with spans.span("service.ingest_intervals"):
            sigs = self.pipe.interval_signatures(
                list(intervals), self.bbe_table, self.cfg.signature_batch)
            weights = [iv.num_instrs for iv in intervals]
            with spans.span("stage2.store"):
                return self.store.add(program, sigs, weights, cpis)

    # ------------------------------------------------------------ queries
    def build(self, k: Optional[int] = None, seed: Optional[int] = None,
              init_centroids=None) -> KnowledgeBase:
        """Universal clustering over everything ingested so far."""
        return self.kb.build(
            k=self.cfg.k if k is None else k,
            seed=self.cfg.kmeans_seed if seed is None else seed,
            init_centroids=init_centroids)

    def attach(self, program: str) -> np.ndarray:
        """Fingerprint an ingested program against the frozen archetypes."""
        return self.kb.attach(program)

    def attach_many(self, programs,
                    cpis: Optional[Dict[str, Sequence[float]]] = None
                    ) -> Dict[str, np.ndarray]:
        """Fingerprint MANY programs with one whole-store assignment.

        `programs` is a sequence of ingested program names, or a mapping
        {program: intervals} to ingest and attach: signatures for all of
        them come from one batch stream, the rows land through one
        `add_many`, then one assignment covers the store."""
        if isinstance(programs, Mapping):
            # fail BEFORE mutating the store, so a retry cannot ingest twice
            self.kb._require_built()
            by_prog = {p: list(ivs) for p, ivs in programs.items()}
            sigs = self.pipe.interval_signatures_many(
                by_prog, self.bbe_table, self.cfg.signature_batch)
            self.store.add_many([
                (p, sigs[p], [iv.num_instrs for iv in ivs],
                 None if cpis is None else cpis.get(p))
                for p, ivs in by_prog.items()])
            names = list(by_prog)
        else:
            names = list(programs)
        return self.kb.attach_many(names)

    def attach_intervals(self, program: str, intervals: Sequence
                         ) -> np.ndarray:
        """One-shot fingerprint WITHOUT ingesting into the store: a pure
        query that records nothing in the knowledge base (ingest and
        `estimate` to make a program estimable)."""
        sigs = self.pipe.interval_signatures(
            list(intervals), self.bbe_table, self.cfg.signature_batch)
        return self.kb.attach(program, signatures=sigs,
                              weights=[iv.num_instrs for iv in intervals])

    def estimate(self, program: str) -> CPIEstimate:
        with spans.span("service.estimate"):
            est = self.kb.estimate(program)
            # recency stamp after the query (touch never bumps `version`)
            self.store.touch(self.store.rows_for(program))
            return est

    # ---------------------------------------------------- store lifecycle
    def evict(self, program: str) -> int:
        """Tombstone every live interval row of `program` (reclaimed at
        the next `vacuum`); returns the number of rows evicted."""
        return self.store.evict_program(program)

    def vacuum(self, policy: Optional[EvictionPolicy] = None
               ) -> VacuumReport:
        """One store-maintenance pass: evict per the policy (default:
        `ServiceConfig.eviction`), compact the tombstones out of the
        padded device matrix (one gather; capacity shrinks to a power of
        two), and re-pin the knowledge base through the row remap.
        Estimates of untouched programs are bit-identical across it."""
        return vacuum(self.store, self.kb,
                      self.cfg.eviction if policy is None else policy)

    # -------------------------------------------------------- persistence
    def save(self, directory: str) -> str:
        """Persist store + knowledge base (+ a readable summary.json)
        under `directory` through the atomic checkpoints."""
        os.makedirs(directory, exist_ok=True)
        self.store.save(os.path.join(directory, "store"))
        summary = {"programs": self.store.programs,
                   "intervals": len(self.store),
                   "live_intervals": self.store.n_alive,
                   "built": self.kb.built}
        if self.kb.built:
            # estimate() BEFORE kb.save(): it re-attaches every program
            # whose live rows changed since its fingerprint, so the saved
            # base and the summary agree (the reload contract). Fully
            # evicted programs, not yet compacted, have nothing to estimate.
            ests = {p: self.kb.estimate(p) for p in self.store.programs
                    if self.store.rows_for(p).size}
            self.kb.save(os.path.join(directory, "knowledge"))
            summary.update(
                k=self.kb.k,
                avg_accuracy=self.kb.avg_accuracy,
                speedup=next(iter(ests.values())).speedup if ests else None,
                estimates={p: {"est_cpi": e.est_cpi, "true_cpi": e.true_cpi,
                               "accuracy": e.accuracy}
                           for p, e in ests.items()})
        with open(os.path.join(directory, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
        return directory

    @classmethod
    def load(cls, directory: str, pipeline: SemanticBBVPipeline,
             cfg: Optional[ServiceConfig] = None) -> "SemanticBBVService":
        """Rehydrate a saved service around a (trained) pipeline; the
        store goes to the pipeline's device."""
        store = SignatureStore.load(os.path.join(directory, "store"),
                                    device=pipeline.device)
        kb_dir = os.path.join(directory, "knowledge")
        kb = (KnowledgeBase.load(kb_dir, store)
              if os.path.isdir(kb_dir) else None)
        return cls(pipeline, cfg, store=store, kb=kb)
