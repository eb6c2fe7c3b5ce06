"""`KnowledgeBase`: cross-program estimation over a `SignatureStore`
(port of `repro.api.knowledge`).

  build(k)    k-means the WHOLE store into k universal behavioral
              archetypes on the device (`kmeans_device` over the store's
              padded `device_matrix`), pick one representative interval
              each, and record the representatives' ground-truth CPI.
  attach(p)   fingerprint a program against the FROZEN archetypes:
              nearest-centroid assignment through the `kmeans_assign`
              kernel, no re-clustering.
  estimate(p) typed `CPIEstimate`: fingerprint x representative-CPI,
              clamped accuracy where ground truth is known, and the
              weight-aware speedup.

There is one build path and one assignment path, both on the store's
device; which kernel or plain version runs follows from that device.
`apply_remap` keeps the base valid across the store's `compact()`, and
`save`/`load` use the JAX package's on-disk format, so a knowledge base
saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.store import SignatureStore
from repro_torch.core.clustering import kmeans_device, representatives
from repro_torch.core.crossprog import (
    CrossProgramResult, cpi_accuracy, speedup,
)
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.train.checkpoint import (
    in_jax_key_order, latest_checkpoint, read_manifest, restore_checkpoint,
    save_checkpoint,
)

# The JAX reader requires these two meta keys. They name its backends;
# these two compute the same functions as this port on any JAX backend.
_JAX_ASSIGN_IMPL = "reference"
_JAX_BUILD_IMPL = "device"


def assign_signatures(signatures: torch.Tensor, centroids: torch.Tensor
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched nearest-centroid over tensors on one device: host
    (assign (N,) int32, dist2 (N,) f32)."""
    a, d2 = kmeans_assign(signatures.float().contiguous(),
                          centroids.float().contiguous())
    return a.cpu().numpy(), d2.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class CPIEstimate:
    """Typed answer to an `estimate` query.

    `accuracy` is the paper's 1 - |est-true|/true with the divisor
    clamped away from zero and the result clipped to [0, 1]; None when
    the program has no ground-truth CPI. `speedup` is weight-aware:
    (total instructions represented by the knowledge base) /
    (instructions in the k simulated representative intervals).
    """
    program: str
    est_cpi: float
    true_cpi: Optional[float]
    accuracy: Optional[float]
    speedup: float
    fingerprint: np.ndarray          # (k,) archetype occupancy, sums to 1
    k: int
    simulated_weight: float
    total_weight: float


class KnowledgeBase:
    """Archetype knowledge over a `SignatureStore` (build once, attach
    and estimate many). Holds only the k centroids and representative
    metadata."""

    def __init__(self, store: SignatureStore):
        self.store = store
        self.k = 0
        self.seed = 0
        self.archetypes: Optional[np.ndarray] = None   # (k, d)
        self._archetypes_dev: Optional[torch.Tensor] = None
        self.rep_global_idx = np.zeros(0, np.int64)    # rows into the store
        self.rep_uid = np.zeros(0, np.int64)
        self.rep_program: List[str] = []
        self.rep_cpi = np.zeros(0, np.float32)
        self.rep_weight = np.zeros(0, np.float32)
        self.fingerprints: Dict[str, np.ndarray] = {}
        self.est_cpi: Dict[str, float] = {}
        self.true_cpi: Dict[str, Optional[float]] = {}
        self._built_version: Optional[int] = None
        # (store.version, per-row assignment) for the whole-store query
        self._row_assign_cache: Optional[Tuple[int, np.ndarray]] = None
        # rows_for(p) size when p was last fingerprinted
        self._attached_nrows: Dict[str, int] = {}

    @property
    def built(self) -> bool:
        return self.archetypes is not None

    def _require_built(self):
        if not self.built:
            raise RuntimeError("KnowledgeBase.build(k) must run before "
                               "attach/estimate queries")

    # -------------------------------------------------------------- build
    def build(self, k: int = 14, seed: int = 0, *,
              init_centroids=None) -> "KnowledgeBase":
        """Universal clustering over every live row of the store, on the
        store's device. `init_centroids` ((restarts, k, d)) replaces the
        kmeans++ seeding of each restart (see `kmeans_device`)."""
        if self.store.n_alive == 0:
            raise RuntimeError("cannot build a KnowledgeBase over an "
                               "empty SignatureStore (no live rows)")
        x = np.asarray(self.store.signatures, np.float32)
        if not self.store.has_tombstones:
            cents, assign, _ = kmeans_device(
                self.store.device_matrix, k, seed=seed,
                n_valid=len(self.store), init_centroids=init_centroids)
            reps = representatives(x, cents, assign)
        else:
            # dead rows get zero mass through the device validity mask
            alive = self.store.alive_rows
            cents, assign, _ = kmeans_device(
                self.store.device_matrix, k, seed=seed,
                n_valid=len(self.store), valid_mask=self.store.device_valid,
                init_centroids=init_centroids)
            reps = alive[representatives(x[alive], cents, assign[alive])]
        self.k = int(cents.shape[0])
        self.seed = seed
        self.archetypes = cents.astype(np.float32)
        self._archetypes_dev = torch.tensor(self.archetypes,
                                            device=self.store.device)
        self.rep_global_idx = np.asarray(reps, np.int64)
        self.rep_uid = np.asarray(self.store.uids[reps], np.int64)
        self.rep_program = [self.store.program_of_row[i] for i in reps]
        self.rep_cpi = self.store.cpis[reps].astype(np.float32)
        self.rep_weight = self.store.weights[reps].astype(np.float32)
        if np.isnan(self.rep_cpi).any():
            raise ValueError(
                "representative intervals lack ground-truth CPI; ingest "
                "intervals with cpis= before build()")
        self.fingerprints.clear()
        self.est_cpi.clear()
        self.true_cpi.clear()
        self._attached_nrows.clear()
        self._row_assign_cache = None
        for p in self.store.programs:
            rows = self.store.rows_for(p)
            if rows.size == 0:          # fully evicted: nothing to record
                continue
            self._record(p, assign[rows])
        self._built_version = self.store.version
        return self

    def _fingerprint(self, row_assign: np.ndarray, weights: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(fingerprint (k,), normalized weights) from assignments."""
        w = np.asarray(weights, np.float64)
        wp = w / max(w.sum(), 1e-30)
        f = np.zeros(self.k)
        np.add.at(f, np.asarray(row_assign, np.int64), wp)
        return f, wp

    def _record(self, program: str, row_assign: np.ndarray) -> np.ndarray:
        """Fingerprint + CPI bookkeeping for a STORED program."""
        rows = self.store.rows_for(program)
        if rows.size == 0:
            raise ValueError(
                f"program {program!r} has no live rows in the store "
                "(every interval was evicted) — cannot fingerprint")
        weights = self.store.weights[rows]
        cpis = self.store.cpis[rows]
        f, wp = self._fingerprint(row_assign, weights)
        self.fingerprints[program] = f
        self.est_cpi[program] = float(
            (f * self.rep_cpi.astype(np.float64)).sum())
        if not np.isnan(np.asarray(cpis)).any():
            self.true_cpi[program] = float(
                (wp * np.asarray(cpis, np.float64)).sum())
        else:
            self.true_cpi[program] = None
        self._attached_nrows[program] = len(rows)
        return f

    # ------------------------------------------------------------ queries
    def assign(self, signatures: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Nearest-archetype assignment for ad-hoc signatures."""
        self._require_built()
        x = torch.tensor(np.asarray(signatures, np.float32),
                         device=self.store.device)
        return assign_signatures(x, self._archetypes_dev)

    def attach(self, program: str,
               signatures: Optional[np.ndarray] = None,
               weights: Optional[np.ndarray] = None) -> np.ndarray:
        """Fingerprint a program against the frozen archetypes; returns
        the (k,) fingerprint.

        Without `signatures`, the program's rows are read from the store:
        the whole store is assigned in ONE kernel call (cached per store
        version). With explicit `signatures` this is a pure query:
        nothing is recorded into the knowledge base."""
        self._require_built()
        if signatures is None:
            rows = self.store.rows_for(program)
            return self._record(program, self._all_row_assign()[rows])
        a, _ = self.assign(signatures)
        f, _ = self._fingerprint(
            a, np.ones(len(a)) if weights is None else weights)
        return f

    def attach_many(self, programs: Sequence[str]
                    ) -> Dict[str, np.ndarray]:
        """Fingerprint MANY stored programs from one whole-store
        assignment; equal to calling `attach(p)` per program."""
        self._require_built()
        row_assign = self._all_row_assign()
        return {p: self._record(p, row_assign[self.store.rows_for(p)])
                for p in programs}

    def _all_row_assign(self) -> np.ndarray:
        """Assignment of every store row, over the padded device matrix."""
        cached = self._row_assign_cache
        if cached is not None and cached[0] == self.store.version:
            return cached[1]
        a, _ = assign_signatures(self.store.device_matrix,
                                 self._archetypes_dev)
        a = a[:len(self.store)]
        self._row_assign_cache = (self.store.version, a)
        return a

    def estimate(self, program: str) -> CPIEstimate:
        """Typed CPI estimate; (re-)attaches the program on demand if it
        was ingested, or gained or lost rows, after its last fingerprint."""
        self._require_built()
        if (program not in self.fingerprints or
                (program in self.store and
                 self._attached_nrows.get(program)
                 != len(self.store.rows_for(program)))):
            self.attach(program)
        f = self.fingerprints[program]
        est = self.est_cpi[program]
        true = self.true_cpi[program]
        sim_w = float(self.rep_weight.astype(np.float64).sum())
        total_w = self.store.total_weight
        return CPIEstimate(
            program=program, est_cpi=est, true_cpi=true,
            accuracy=None if true is None else cpi_accuracy(est, true),
            speedup=speedup(total_w, sim_w),
            fingerprint=f, k=self.k,
            simulated_weight=sim_w, total_weight=total_w)

    @property
    def avg_accuracy(self) -> float:
        accs = [cpi_accuracy(self.est_cpi[p], t)
                for p, t in self.true_cpi.items() if t is not None]
        return float(np.mean(accs)) if accs else float("nan")

    # ----------------------------------------------------- store lifecycle
    def apply_remap(self, remap: np.ndarray) -> int:
        """Consume a `SignatureStore.compact()` old -> new row remap:
        representatives move to their new rows, fingerprints of programs
        the compaction dropped are pruned, and representatives whose rows
        were evicted are re-pinned to the nearest live member of their
        archetype through ONE whole-store assignment.

        `rep_cpi`/`rep_weight` are KEPT when re-pinning: they are the
        results of the one-time archetype simulation, so `estimate()` on
        untouched programs is bit-identical across a vacuum. Returns the
        number of representatives re-pinned."""
        self._require_built()
        remap = np.asarray(remap, np.int64)
        old = self.rep_global_idx
        safe = np.clip(old, 0, max(remap.shape[0] - 1, 0))
        self.rep_global_idx = np.where(
            (old >= 0) & (old < remap.shape[0]), remap[safe], -1)
        self._row_assign_cache = None
        for p in list(self.fingerprints):
            if p not in self.store:        # compaction dropped the program
                del self.fingerprints[p]
                self.est_cpi.pop(p, None)
                self.true_cpi.pop(p, None)
                self._attached_nrows.pop(p, None)
        return self._repin_dead_reps()

    def _repin_dead_reps(self) -> int:
        """Re-pin every representative whose row is gone (index -1) to the
        nearest LIVE member of its archetype: one whole-store assignment
        (`_all_row_assign`) and one segment-reduce (`representatives`)
        shared by all of them. A store with no live row leaves them at -1
        (the next build replaces them)."""
        dead = np.flatnonzero(self.rep_global_idx < 0)
        if dead.size == 0:
            return 0
        alive = self.store.alive_rows
        if alive.size == 0:
            return 0
        x = np.asarray(self.store.signatures, np.float32)
        row_assign = self._all_row_assign()
        reps = alive[representatives(x[alive], self.archetypes,
                                     row_assign[alive])]
        self.rep_global_idx[dead] = reps[dead]
        self.rep_uid[dead] = self.store.uids[reps[dead]]
        for j in dead:
            self.rep_program[j] = self.store.program_of_row[
                self.rep_global_idx[j]]
        return int(dead.size)

    # -------------------------------------------------------- persistence
    def save(self, directory: str) -> str:
        """Checkpoint at step `built_version` in the JAX package's format.
        Its reader requires `assign_impl` and `build_impl`: written as
        "reference" and "device", which compute this port's functions on
        any JAX backend. `load` ignores both."""
        self._require_built()
        tree = {
            "archetypes": self.archetypes,
            "rep_cpi": self.rep_cpi,
            "rep_weight": self.rep_weight,
            "rep_global_idx": self.rep_global_idx,
            "rep_uid": self.rep_uid,
        }
        built = self._built_version
        meta = {
            "k": int(self.k), "seed": int(self.seed),
            "assign_impl": _JAX_ASSIGN_IMPL,
            "build_impl": _JAX_BUILD_IMPL,
            "rep_program": list(self.rep_program),
            "built_version": None if built is None else int(built),
            "fingerprints": {p: np.asarray(f).tolist()
                             for p, f in self.fingerprints.items()},
            "est_cpi": {p: float(v) for p, v in self.est_cpi.items()},
            "true_cpi": {p: None if v is None else float(v)
                         for p, v in self.true_cpi.items()},
        }
        return save_checkpoint(directory, int(built or 0),
                               in_jax_key_order(tree), meta=meta)

    @classmethod
    def load(cls, directory: str, store: SignatureStore) -> "KnowledgeBase":
        """The newest knowledge-base checkpoint under `directory`, over
        `store` (its archetypes on the store's device). Representatives
        re-resolve through their uids, so a base saved before the store
        was compacted stays valid; those whose rows are gone re-pin.
        Checkpoints written before `rep_uid` existed take the uids of
        their saved rows."""
        path = latest_checkpoint(directory)
        if path is None:
            raise FileNotFoundError(f"no KB checkpoint under {directory}")
        manifest = read_manifest(path)
        keys = ["archetypes", "rep_cpi", "rep_weight", "rep_global_idx"]
        if "rep_uid" in manifest["shapes"]:   # absent before the lifecycle
            keys.append("rep_uid")
        template = {k: np.zeros(manifest["shapes"][k],
                                np.dtype(manifest["dtypes"][k]))
                    for k in keys}
        tree, _, meta = restore_checkpoint(path, template)
        kb = cls(store)
        kb.k = int(meta["k"])
        kb.seed = int(meta["seed"])
        kb.archetypes = np.asarray(tree["archetypes"], np.float32)
        kb._archetypes_dev = torch.tensor(kb.archetypes, device=store.device)
        kb.rep_cpi = np.asarray(tree["rep_cpi"], np.float32)
        kb.rep_weight = np.asarray(tree["rep_weight"], np.float32)
        kb.rep_global_idx = np.asarray(tree["rep_global_idx"], np.int64)
        kb.rep_program = list(meta["rep_program"])
        if "rep_uid" in tree:
            kb.rep_uid = np.asarray(tree["rep_uid"], np.int64)
            kb.rep_global_idx = store.rows_of_uids(kb.rep_uid)
        else:
            ok = ((kb.rep_global_idx >= 0)
                  & (kb.rep_global_idx < len(store)))
            kb.rep_uid = np.where(
                ok, store.uids[np.clip(kb.rep_global_idx, 0,
                                       max(len(store) - 1, 0))], -1)
        if (kb.rep_global_idx < 0).any():
            kb._repin_dead_reps()
        kb._built_version = meta["built_version"]
        kb.fingerprints = {p: np.asarray(f, np.float64)
                           for p, f in meta["fingerprints"].items()}
        kb.est_cpi = {p: float(v) for p, v in meta["est_cpi"].items()}
        kb.true_cpi = {p: (None if v is None else float(v))
                       for p, v in meta["true_cpi"].items()}
        # fingerprints are current for the co-saved store; a store that
        # changed since re-attaches on the next estimate
        kb._attached_nrows = {p: len(store.rows_for(p))
                              for p in kb.fingerprints if p in store}
        return kb

    def as_cross_program_result(self) -> CrossProgramResult:
        """`CrossProgramResult` view of the base (the JAX package's
        one-shot result type)."""
        self._require_built()
        return CrossProgramResult(
            k=self.k,
            rep_global_idx=self.rep_global_idx,
            rep_program=list(self.rep_program),
            rep_cpi=self.rep_cpi,
            fingerprints={p: np.asarray(f)
                          for p, f in self.fingerprints.items()},
            est_cpi=dict(self.est_cpi),
            true_cpi={p: v for p, v in self.true_cpi.items()
                      if v is not None})
