"""`SignatureStore`: interval signatures plus per-interval metadata, with
the signature matrix resident on the device. Port of `repro.api.store`.

  PAD-AND-GROW. Host arrays are allocated at power-of-two capacity and
  doubled on overflow, and `device_matrix` exposes the WHOLE capacity
  buffer (rows past `len(store)` are zero) as one device tensor, so the
  batched consumers (k-means build, whole-store assignment) see
  O(log N) distinct shapes over the store's life.

  STABLE ROW IDS. Row positions hold between compactions, and each row
  carries a monotonically increasing `uid` that survives `compact()`: the
  handle a saved KnowledgeBase re-resolves its representatives through.
  `version` increments per mutation (`add`/`add_many`/`evict`/`compact`),
  so consumers cache derived state on it.

  LIFECYCLE. `evict(rows)` marks rows dead in a host bitmap that is
  folded into the `device_valid` mask, so the device build skips them;
  `compact()` rebuilds the padded matrix from the survivors in ONE device
  gather, shrinks capacity back to the smallest power of two and returns
  the old -> new row remap. Per-row `inserted_at`/`last_used` stamps count
  a logical `clock` (the TTL/LRU policies of `repro_torch.api.lifecycle`).

Persistence is the JAX package's on-disk format (`train/checkpoint.py`):
the same leaves, meta keys and step, so a store saved by either package
loads in the other, tombstones, uids and stamps included.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.train.checkpoint import (
    in_jax_key_order, latest_checkpoint, read_manifest, restore_checkpoint,
    save_checkpoint,
)

_MIN_CAPACITY = 64


def _capacity_for(n: int, minimum: int = _MIN_CAPACITY) -> int:
    cap = max(minimum, 1)
    while cap < n:
        cap *= 2
    return cap


class SignatureStore:
    """Device-resident store of interval signatures with row lifecycle.

    Rows carry (signature (d,), weight, cpi, program). `weight` is the
    interval's instruction count (1.0 when unknown); `cpi` is the
    ground-truth CPI, NaN when unknown. `len(store)` counts row slots,
    tombstoned rows included; `n_alive` counts live rows.
    """

    def __init__(self, sig_dim: int, min_capacity: int = _MIN_CAPACITY,
                 device: Device = "cuda"):
        if sig_dim <= 0:
            raise ValueError(f"sig_dim must be positive, got {sig_dim}")
        self.sig_dim = int(sig_dim)
        self.min_capacity = int(min_capacity)
        self.device = resolve_device(device)
        self.version = 0
        self._n = 0
        self._n_dead = 0
        self._clock = 0          # logical time: one tick per add/touch
        self._next_uid = 0
        cap = _capacity_for(0, self.min_capacity)
        self._sigs = np.zeros((cap, self.sig_dim), np.float32)
        self._weights = np.zeros((cap,), np.float32)
        self._cpis = np.full((cap,), np.nan, np.float32)
        self._alive = np.zeros((cap,), bool)
        self._uids = np.zeros((cap,), np.int64)
        self._inserted_at = np.zeros((cap,), np.int64)
        self._last_used = np.zeros((cap,), np.int64)
        self._program_of_row: List[str] = []
        self._program_rows: Dict[str, List[int]] = {}
        self._device: Optional[torch.Tensor] = None
        self._device_valid: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- shape
    def __len__(self) -> int:
        return self._n

    @property
    def n_alive(self) -> int:
        return self._n - self._n_dead

    @property
    def has_tombstones(self) -> bool:
        return self._n_dead > 0

    @property
    def capacity(self) -> int:
        return self._sigs.shape[0]

    @property
    def clock(self) -> int:
        return self._clock

    @property
    def programs(self) -> List[str]:
        """Program names in first-insertion order."""
        return list(self._program_rows)

    def __contains__(self, program: str) -> bool:
        return program in self._program_rows

    # ------------------------------------------------------------ ingest
    # host arrays and the value of their padded tail
    _HOST_ARRAYS = (("_sigs", 0), ("_weights", 0), ("_cpis", np.nan),
                    ("_alive", False), ("_uids", 0), ("_inserted_at", 0),
                    ("_last_used", 0))

    def _resize_host(self, cap: int, rows) -> None:
        """Reallocate every host array at capacity `cap`, holding the old
        arrays' `rows` (a slice or an index array) at its head and its
        fill value past them."""
        for name, fill in self._HOST_ARRAYS:
            arr = getattr(self, name)
            out = np.full((cap,) + arr.shape[1:], fill, arr.dtype)
            head = arr[rows]
            out[:head.shape[0]] = head
            setattr(self, name, out)

    def _grow_to(self, n: int):
        cap = _capacity_for(n, self.min_capacity)
        if cap == self.capacity:
            return
        self._resize_host(cap, slice(0, self._n))
        self._invalidate()

    def _invalidate(self):
        self._device = None
        self._device_valid = None

    def _validate(self, signatures, weights, cpis):
        sigs = np.asarray(signatures, np.float32)
        if sigs.ndim != 2 or sigs.shape[1] != self.sig_dim:
            raise ValueError(
                f"signatures must be (N, {self.sig_dim}), got {sigs.shape}")
        b = sigs.shape[0]
        w = (np.ones(b, np.float32) if weights is None
             else np.asarray(weights, np.float32))
        c = (np.full(b, np.nan, np.float32) if cpis is None
             else np.asarray(cpis, np.float32))
        if w.shape != (b,) or c.shape != (b,):
            raise ValueError("weights/cpis must be 1-D of len(signatures)")
        return sigs, w, c

    def _append(self, program, sigs, w, c) -> np.ndarray:
        """Write validated rows into already-grown buffers (no version
        bump: callers batch that)."""
        b = sigs.shape[0]
        rows = np.arange(self._n, self._n + b)
        self._sigs[rows] = sigs
        self._weights[rows] = w
        self._cpis[rows] = c
        self._alive[rows] = True
        self._uids[rows] = np.arange(self._next_uid, self._next_uid + b)
        self._inserted_at[rows] = self._clock
        self._last_used[rows] = self._clock
        self._next_uid += b
        self._program_of_row.extend([program] * b)
        self._program_rows.setdefault(program, []).extend(rows.tolist())
        self._n += b
        return rows

    def _bump(self):
        self.version += 1
        self._clock += 1
        self._invalidate()

    def add(self, program: str, signatures: np.ndarray,
            weights: Optional[Sequence[float]] = None,
            cpis: Optional[Sequence[float]] = None) -> np.ndarray:
        """Append one program's interval rows; returns their row indices.
        A program may be added in several calls; rows accumulate."""
        sigs, w, c = self._validate(signatures, weights, cpis)
        self._grow_to(self._n + sigs.shape[0])
        rows = self._append(program, sigs, w, c)
        self._bump()
        return rows

    def add_many(self, items: Sequence[Tuple]) -> Dict[str, np.ndarray]:
        """Batched ingest of (program, signatures[, weights[, cpis]])
        tuples: everything is validated first, capacity grows once and
        `version` bumps once. Returns {program: new row indices}."""
        validated = []
        for item in items:
            program, sigs = item[0], item[1]
            weights = item[2] if len(item) > 2 else None
            cpis = item[3] if len(item) > 3 else None
            validated.append((program, *self._validate(sigs, weights, cpis)))
        if not validated:
            return {}
        self._grow_to(self._n + sum(v[1].shape[0] for v in validated))
        out: Dict[str, np.ndarray] = {}
        for program, sigs, w, c in validated:
            rows = self._append(program, sigs, w, c)
            out[program] = (rows if program not in out
                            else np.concatenate([out[program], rows]))
        self._bump()
        return out

    # --------------------------------------------------------- lifecycle
    def touch(self, rows: np.ndarray) -> None:
        """Stamp `rows` as used now (LRU recency). No version bump, so
        derived-state caches stay warm across reads."""
        r = np.asarray(rows, np.int64)
        if r.size == 0:
            return
        if r.min() < 0 or r.max() >= self._n:
            raise IndexError(f"touch rows out of range [0, {self._n})")
        self._last_used[r] = self._clock
        self._clock += 1

    def evict(self, rows: np.ndarray) -> int:
        """Tombstone `rows`: they keep their slot but leave `device_valid`,
        `rows_for` and `total_weight`. Already-dead rows are ignored.
        Returns the number newly evicted (bumps `version` when > 0)."""
        r = np.asarray(rows, np.int64)
        if r.size == 0:
            return 0
        if r.min() < 0 or r.max() >= self._n:
            raise IndexError(f"evict rows out of range [0, {self._n})")
        newly = np.unique(r[self._alive[r]])
        if newly.size == 0:
            return 0
        self._alive[newly] = False
        self._n_dead += int(newly.size)
        self.version += 1
        self._device_valid = None
        return int(newly.size)

    def evict_program(self, program: str) -> int:
        """Tombstone every live row of `program` (it stays registered
        until the next `compact()`)."""
        return self.evict(self.rows_for(program))

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows and shrink capacity back to the smallest
        power of two. The padded device matrix, when resident, is rebuilt
        from the survivors by ONE gather (order-preserving, tail rows
        zero: bitwise the matrix a fresh upload of the live rows gives);
        host metadata by fancy indexing; fully evicted programs leave the
        registry.

        Returns the old -> new row remap: (old_len,) int64, -1 for rows
        that no longer exist. Uids survive. Bumps `version` only when
        something changed."""
        old_n = self._n
        keep = np.flatnonzero(self._alive[:old_n]).astype(np.int64)
        m = int(keep.size)
        new_cap = _capacity_for(m, self.min_capacity)
        remap = np.full(old_n, -1, np.int64)
        remap[keep] = np.arange(m)
        if not self.has_tombstones and new_cap == self.capacity:
            return remap                      # nothing to do; no bump

        if self._device is not None:
            dev = self._device.new_zeros((new_cap, self.sig_dim))
            dev[:m] = torch.index_select(
                self._device, 0, torch.from_numpy(keep).to(self.device))
            self._device = dev

        self._resize_host(new_cap, keep)

        self._program_of_row = np.asarray(self._program_of_row,
                                          object)[keep].tolist()
        new_rows: Dict[str, List[int]] = {}
        for p, old_rows in self._program_rows.items():
            nr = remap[np.asarray(old_rows, np.int64)]
            nr = nr[nr >= 0]
            if nr.size:
                new_rows[p] = nr.tolist()
        self._program_rows = new_rows
        self._n = m
        self._n_dead = 0
        self.version += 1
        self._device_valid = None
        return remap

    # ------------------------------------------------------------- views
    def rows_for(self, program: str) -> np.ndarray:
        """LIVE rows of `program`; KeyError for an unknown program."""
        if program not in self._program_rows:
            raise KeyError(f"program {program!r} not in store "
                           f"(have {self.programs})")
        r = np.asarray(self._program_rows[program], np.int64)
        return r[self._alive[r]] if self._n_dead else r

    def _view(self, arr: np.ndarray) -> np.ndarray:
        v = arr[:self._n]
        v.flags.writeable = False
        return v

    @property
    def signatures(self) -> np.ndarray:
        """(N, d) row-slot view, tombstoned rows included (read-only)."""
        return self._view(self._sigs)

    @property
    def weights(self) -> np.ndarray:
        return self._view(self._weights)

    @property
    def cpis(self) -> np.ndarray:
        return self._view(self._cpis)

    @property
    def alive_mask(self) -> np.ndarray:
        """(N,) bool: True where the row slot is live."""
        return self._view(self._alive)

    @property
    def alive_rows(self) -> np.ndarray:
        return np.flatnonzero(self._alive[:self._n]).astype(np.int64)

    @property
    def uids(self) -> np.ndarray:
        """(N,) stable per-row uids (strictly increasing in row order;
        survive `compact`)."""
        return self._view(self._uids)

    @property
    def last_used(self) -> np.ndarray:
        return self._view(self._last_used)

    @property
    def inserted_at(self) -> np.ndarray:
        return self._view(self._inserted_at)

    def rows_of_uids(self, uids: np.ndarray) -> np.ndarray:
        """Current row of each uid; -1 where its row was evicted (or never
        existed). Uids increase in row order: one searchsorted."""
        u = np.asarray(uids, np.int64)
        if self._n == 0 or u.size == 0:
            return np.full(u.shape, -1, np.int64)
        stored = self._uids[:self._n]
        pos = np.searchsorted(stored, u)
        clamped = np.minimum(pos, self._n - 1)
        found = ((pos < self._n) & (stored[clamped] == u)
                 & self._alive[clamped])
        return np.where(found, clamped, -1)

    @property
    def program_of_row(self) -> List[str]:
        return list(self._program_of_row)

    @property
    def total_weight(self) -> float:
        """Total instruction weight of the LIVE rows."""
        w = self._weights[:self._n].astype(np.float64)
        if self._n_dead:
            w = w[self._alive[:self._n]]
        return float(w.sum())

    @property
    def device_matrix(self) -> torch.Tensor:
        """(capacity, d) fp32 tensor on the store's device; rows past
        len(self) are zero, tombstoned rows keep their values (consumers
        mask them with `device_valid`). Uploaded lazily, once per
        mutation."""
        if self._device is None:
            self._device = torch.tensor(self._sigs, device=self.device)
        return self._device

    @property
    def device_valid(self) -> torch.Tensor:
        """(capacity,) fp32 0/1 mask on the device: 1 at live rows."""
        if self._device_valid is None:
            mask = np.zeros(self.capacity, np.float32)
            mask[:self._n] = self._alive[:self._n]
            self._device_valid = torch.tensor(mask, device=self.device)
        return self._device_valid

    # ------------------------------------------------------- persistence
    def save(self, directory: str) -> str:
        """Checkpoint the store at step `version` (atomic; bit-identical on
        reload, tombstones, uids and LRU/TTL stamps included)."""
        tree = {
            "signatures": self._sigs[:self._n].copy(),
            "weights": self._weights[:self._n].copy(),
            "cpis": self._cpis[:self._n].copy(),
            "alive": self._alive[:self._n].copy(),
            "uids": self._uids[:self._n].copy(),
            "inserted_at": self._inserted_at[:self._n].copy(),
            "last_used": self._last_used[:self._n].copy(),
        }
        meta = {
            "sig_dim": int(self.sig_dim),
            "min_capacity": int(self.min_capacity),
            "program_of_row": list(self._program_of_row),
            "clock": int(self._clock),
            "next_uid": int(self._next_uid),
        }
        return save_checkpoint(directory, int(self.version),
                               in_jax_key_order(tree), meta=meta)

    @classmethod
    def load(cls, directory: str, device: Device = "cuda"
             ) -> "SignatureStore":
        """The newest store checkpoint under `directory`, its matrix on
        `device`. Checkpoints written before the lifecycle fields existed
        load with every row alive, uids 0..N-1 and both stamps at the
        clock (age 0, so a TTL vacuum does not evict everything)."""
        device = resolve_device(device)
        path = latest_checkpoint(directory)
        if path is None:
            raise FileNotFoundError(f"no store checkpoint under {directory}")
        manifest = read_manifest(path)
        keys = ["signatures", "weights", "cpis"] + [
            k for k in ("alive", "uids", "inserted_at", "last_used")
            if k in manifest["shapes"]]
        template = {k: np.zeros(manifest["shapes"][k],
                                np.dtype(manifest["dtypes"][k]))
                    for k in keys}
        tree, version, meta = restore_checkpoint(path, template)
        store = cls(int(meta["sig_dim"]),
                    min_capacity=int(meta["min_capacity"]), device=device)
        sigs = tree["signatures"]
        n = sigs.shape[0]
        store._grow_to(n)
        store._sigs[:n] = sigs
        store._weights[:n] = tree["weights"]
        store._cpis[:n] = tree["cpis"]
        clock = int(meta.get("clock", version))
        store._alive[:n] = tree["alive"] if "alive" in tree else True
        store._uids[:n] = tree["uids"] if "uids" in tree else np.arange(n)
        store._inserted_at[:n] = tree.get("inserted_at", clock)
        store._last_used[:n] = tree.get("last_used", clock)
        store._program_of_row = list(meta["program_of_row"])
        for i, p in enumerate(store._program_of_row):
            store._program_rows.setdefault(p, []).append(i)
        store._n = n
        store._n_dead = int(n - store._alive[:n].sum())
        store._clock = clock
        store._next_uid = int(meta.get(
            "next_uid", (store._uids[:n].max() + 1) if n else 0))
        store.version = int(version)
        return store

    # ------------------------------------------------------------- misc
    def grouped_rows(self) -> Dict[str, np.ndarray]:
        return {p: self.rows_for(p) for p in self.programs}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SignatureStore(n={self._n}, alive={self.n_alive}, "
                f"capacity={self.capacity}, sig_dim={self.sig_dim}, "
                f"device={self.device}, programs={len(self.programs)})")
