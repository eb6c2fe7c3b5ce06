"""End-to-end SemanticBBV pipeline (Fig. 2): tokenizer, Stage-1 encoder,
Stage-2 aggregator. Port of `repro.core.pipeline`.

Typical flow:
    pipe = SemanticBBVPipeline.create(device="cuda")
    bbe_table = pipe.encode_blocks(unique_blocks)       # Stage 1, batched
    sigs = pipe.interval_signatures(intervals, bbe_table)
    cpi = pipe.predict_interval_cpi(intervals, bbe_table)

Host-side batching is vectorized as in the JAX package: `encode_blocks`
memoizes BBEs in an LRU cache keyed by block content, batches keep one
static shape (partial chunks are padded), and interval sets are
assembled through `BBEIndex`: the BBE matrix goes to the device once per
table, each batch ships only (row_ids, freqs, mask), and the
(B, N, bbe_dim) gather happens on the device.

The models live on one device, chosen when the pipeline is made. It is
"cuda" unless the caller asks for "cpu"; without a card, asking for
"cuda" raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bbe import BBEConfig, BBEEncoder
from repro_torch.core.signature import SignatureConfig, SignatureModel
from repro_torch.core.tokenizer import MultiDimTokenizer, default_tokenizer
from repro_torch.data.isa import BasicBlock
from repro_torch.device import Device, resolve_device

_BBE_CACHE_SIZE = 1 << 16

class BBEIndex:
    """bid -> row lookup over one contiguous BBE matrix.

    Built once per signature call from a {bid: vector} table; afterwards
    every interval-set assembly is integer work plus one gather. Row V
    of `ext` is an all-zero sentinel: padded set slots gather it, so a
    single `take` materializes a whole padded batch."""

    def __init__(self, bbe_table: Dict[int, np.ndarray]):
        n = len(bbe_table)
        bids = np.fromiter(bbe_table.keys(), np.int64, count=n)
        order = np.argsort(bids, kind="stable")
        self.sorted_bids = bids[order]
        self.num_rows = n
        if n:
            self.matrix = np.asarray(list(bbe_table.values()),
                                     np.float32)[order]
        else:
            self.matrix = np.zeros((0, 0), np.float32)
        self._ext: Optional[np.ndarray] = None
        # dense bid->row table when ids are compact (they are for the
        # synthetic substrate); sparse ids fall back to searchsorted
        self._lut: Optional[np.ndarray] = None
        if n and 0 <= int(self.sorted_bids[0]) and \
                int(self.sorted_bids[-1]) < max(4 * n, 1 << 20):
            self._lut = np.full(int(self.sorted_bids[-1]) + 1, -1, np.int64)
            self._lut[self.sorted_bids] = np.arange(n)

    @property
    def sentinel(self) -> int:
        return self.num_rows

    @property
    def ext(self) -> np.ndarray:
        """(V+1, D) matrix with the zero sentinel row appended."""
        if self._ext is None:
            self._ext = np.concatenate(
                [self.matrix, np.zeros((1, self.matrix.shape[1]),
                                       np.float32)])
        return self._ext

    def rows(self, bids: np.ndarray) -> np.ndarray:
        """Row indices for `bids`; KeyError on unknown ids (matching the
        dict-lookup behaviour of the old per-interval loop)."""
        bids = np.asarray(bids, np.int64)
        if self.num_rows == 0:
            if bids.size:
                raise KeyError(f"block ids not in BBE table: "
                               f"{np.unique(bids)[:5].tolist()}")
            return np.zeros(0, np.int64)
        if self._lut is not None:
            clipped = np.clip(bids, 0, self._lut.size - 1)
            idx = self._lut[clipped]
            bad = (idx < 0) | (clipped != bids)
        else:
            idx = np.searchsorted(self.sorted_bids, bids)
            bad = idx >= self.num_rows
            idx = np.where(bad, 0, idx)
            bad |= self.sorted_bids[idx] != bids
        if bad.any():
            raise KeyError(f"block ids not in BBE table: "
                           f"{np.unique(bids[bad])[:5].tolist()}")
        return idx


def _topk_order(seg: np.ndarray, cnts: np.ndarray) -> np.ndarray:
    """Stable order: segment ascending, count descending — identical to
    per-segment `sorted(..., key=lambda kv: -kv[1])`. Integral counts use
    one radix-sortable composite int64 key (~7x faster than lexsort)."""
    ci = cnts.astype(np.int64)
    if (seg.size == 0 or
            ((ci == cnts).all() and int(np.abs(ci).max(initial=0)) < 1 << 40
             and int(seg[-1]) < 1 << 20)):
        return np.argsort(seg * (1 << 41) - ci, kind="stable")
    return np.lexsort((-cnts, seg))


def batch_set_ids(intervals, index: BBEIndex, max_set: int):
    """Vectorized interval-set assembly WITHOUT the BBE payload: one
    stable sort selects each interval's top-`max_set` blocks by count
    (same order and tie-breaking as the per-interval loop), one lookup
    maps bids to matrix rows. Shared by inference batching (pipeline)
    and Stage-2 training batches (repro.train.stage2).

    Returns (row_ids (B,N) int32 — `index.sentinel` in empty slots,
    freqs (B,N) f32, mask (B,N) bool)."""
    B = len(intervals)
    N = max_set
    row_ids = np.full((B, N), index.sentinel, np.int32)
    freqs = np.zeros((B, N), np.float32)
    mask = np.zeros((B, N), bool)
    lens = np.fromiter((len(iv.counts) for iv in intervals), np.int64,
                       count=B)
    total = int(lens.sum())
    if total == 0:
        return row_ids, freqs, mask
    bids = np.empty(total, np.int64)
    cnts = np.empty(total, np.float64)
    off = 0
    for iv in intervals:
        c = iv.counts
        n = len(c)
        bids[off:off + n] = np.fromiter(c.keys(), np.int64, count=n)
        cnts[off:off + n] = np.fromiter(c.values(), np.float64, count=n)
        off += n
    seg = np.repeat(np.arange(B), lens)
    order = _topk_order(seg, cnts)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    pos = np.arange(total) - np.repeat(starts, lens)
    keep = pos < N
    rows = index.rows(bids[order][keep])
    b_idx, n_idx = seg[keep], pos[keep]   # seg[order] == seg (grouped)
    row_ids[b_idx, n_idx] = rows
    freqs[b_idx, n_idx] = cnts[order][keep]
    mask[b_idx, n_idx] = True
    return row_ids, freqs, mask


class SemanticBBVPipeline:
    """Stage 1 + Stage 2 on one device, in inference mode."""

    def __init__(self, encoder: BBEEncoder, sig_model: SignatureModel,
                 device: Device = "cuda",
                 tok: Optional[MultiDimTokenizer] = None):
        self.device = resolve_device(device)
        self.tok = tok or default_tokenizer()
        self.bbe_cfg: BBEConfig = encoder.cfg
        self.sig_cfg: SignatureConfig = sig_model.cfg
        if self.sig_cfg.bbe_dim != self.bbe_cfg.bbe_dim:
            raise ValueError("signature model bbe_dim does not match the "
                             "encoder's bbe_dim")
        self.encoder = encoder.to(self.device).eval()
        self.sig_model = sig_model.to(self.device).eval()
        self._bbe_lru: "collections.OrderedDict[str, np.ndarray]" = \
            collections.OrderedDict()
        self._index_cache: dict = {}

    # ------------------------------------------------------------- factory
    @classmethod
    def create(cls, seed: int = 0, bbe_cfg: Optional[BBEConfig] = None,
               sig_cfg: Optional[SignatureConfig] = None,
               device: Device = "cuda") -> "SemanticBBVPipeline":
        """Fresh (untrained) models from `seed`, drawn on the CPU and moved
        to `device`, so a seed gives the same weights on every device.
        None configs are the defaults, the signature input width tied to
        the BBE output width."""
        dev = resolve_device(device)
        bbe_cfg = bbe_cfg or BBEConfig()
        sig_cfg = sig_cfg or SignatureConfig(bbe_dim=bbe_cfg.bbe_dim)
        return cls(BBEEncoder(bbe_cfg, seed=2 * seed),
                   SignatureModel(sig_cfg, seed=2 * seed + 1), dev)

    # ------------------------------------------------------------- stage 1
    @torch.inference_mode()
    def encode_tokens(self, tokens: np.ndarray, batch: int = 256
                      ) -> np.ndarray:
        """tokens: (N, L, 6) -> BBEs (N, bbe_dim), in batches of `batch`.

        Every chunk, including the last partial one, is padded to the
        static (batch, L, 6) shape, as the JAX pipeline does."""
        n = tokens.shape[0]
        outs = []
        for i in range(0, n, batch):
            chunk = tokens[i:i + batch]
            got = chunk.shape[0]
            if got < batch:
                chunk = np.pad(chunk, ((0, batch - got), (0, 0), (0, 0)))
            tok = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                self.device, torch.long)
            outs.append(self.encoder(tok)[:got])
        if not outs:
            return np.zeros((0, self.bbe_cfg.bbe_dim), np.float32)
        return torch.cat(outs).cpu().numpy()

    def encode_blocks(self, blocks: Sequence[BasicBlock], batch: int = 256
                      ) -> Dict[int, np.ndarray]:
        """Stage 1 over blocks, with an LRU cache keyed by block content
        so repeated calls only encode blocks they have not seen."""
        lru = self._bbe_lru
        keys = [b.render() for b in blocks]
        fresh, fresh_keys, seen = [], [], set()
        for b, key in zip(blocks, keys):
            if key not in lru and key not in seen:
                fresh.append(b)
                fresh_keys.append(key)
                seen.add(key)
        if fresh:
            toks = self.tok.encode_blocks(fresh, self.bbe_cfg.max_len)
            for key, vec in zip(fresh_keys, self.encode_tokens(toks, batch)):
                lru[key] = vec.copy()   # detach from the batch array
        out = {}
        for b, key in zip(blocks, keys):
            lru.move_to_end(key)
            # copies: callers may mutate the returned table
            out[b.bid] = lru[key].copy()
        # evict only after serving: every key of this call was just
        # move_to_end'd, so eviction can't touch entries still in use
        while len(lru) > _BBE_CACHE_SIZE:
            lru.popitem(last=False)
        return out

    # ------------------------------------------------------------- stage 2
    def _table_index(self, bbe_table) -> Tuple[BBEIndex, torch.Tensor]:
        """(BBEIndex, device matrix with the zero sentinel row), cached on
        table identity and length (growing a table in place invalidates;
        replacing vectors under the same bids needs a new dict)."""
        state = self._index_cache
        if state.get("table") is not bbe_table or \
                state.get("n") != len(bbe_table):
            index = BBEIndex(bbe_table)
            if index.num_rows:
                matrix = torch.from_numpy(index.ext).to(self.device)
            else:
                matrix = torch.zeros((1, self.sig_cfg.bbe_dim),
                                     device=self.device)
            state.update(table=bbe_table, n=len(bbe_table), index=index,
                         matrix=matrix)
        return state["index"], state["matrix"]

    @torch.inference_mode()
    def _run_signature(self, intervals, bbe_table, batch: int):
        """Batched Stage 2 -> (sigs (B,sig_dim), logcpi (B,)).

        Each batch ships integer row ids + freqs + mask; the BBE rows are
        gathered on the device. The last partial batch is padded to the
        static `batch` shape with fully masked rows, whose outputs are
        dropped."""
        index, matrix = self._table_index(bbe_table)
        sigs, cpis = [], []
        for i in range(0, len(intervals), batch):
            row_ids, freqs, mask = batch_set_ids(
                intervals[i:i + batch], index, self.sig_cfg.max_set)
            got = row_ids.shape[0]
            if got < batch:
                pad = batch - got
                row_ids = np.pad(row_ids, ((0, pad), (0, 0)),
                                 constant_values=index.sentinel)
                freqs = np.pad(freqs, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            rows = torch.from_numpy(row_ids).to(self.device, torch.long)
            bbes = matrix[rows]                       # device-side gather
            sig, logcpi = self.sig_model(
                bbes, torch.from_numpy(freqs).to(self.device),
                torch.from_numpy(mask).to(self.device))
            sigs.append(sig[:got])
            cpis.append(logcpi[:got])
        if not sigs:
            return (np.zeros((0, self.sig_cfg.sig_dim), np.float32),
                    np.zeros((0,), np.float32))
        return torch.cat(sigs).cpu().numpy(), torch.cat(cpis).cpu().numpy()

    def interval_signatures(self, intervals, bbe_table, batch: int = 512
                            ) -> np.ndarray:
        """(len(intervals), sig_dim) unit-norm signatures."""
        sigs, _ = self._run_signature(intervals, bbe_table, batch)
        return sigs

    def interval_signatures_many(self, intervals_by_program, bbe_table,
                                 batch: int = 512) -> Dict[str, np.ndarray]:
        """Signatures for SEVERAL programs in one batch stream (the partial
        batch is paid once). Returns {program: (n_p, sig_dim)} in input
        order; equal to per-program `interval_signatures` calls."""
        names = list(intervals_by_program)
        flat = [iv for n in names for iv in intervals_by_program[n]]
        sigs = self.interval_signatures(flat, bbe_table, batch)
        out, off = {}, 0
        for n in names:
            count = len(intervals_by_program[n])
            out[n] = sigs[off:off + count]
            off += count
        return out

    def predict_interval_cpi(self, intervals, bbe_table, batch: int = 512
                             ) -> np.ndarray:
        _, logcpi = self._run_signature(intervals, bbe_table, batch)
        return np.expm1(logcpi)
