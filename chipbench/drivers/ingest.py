"""Traffic kind "ingest": one client in a closed loop signs programs the
service has not seen and reads each one's CPI estimate off the frozen
archetypes, through `SemanticBBVService.ingest_blocks` ->
`ingest_intervals` -> `estimate`.

Set-up: both stages' weights drawn from the seed on the card; the base
world (`traffic.world`: the SPEC-like programs of `base_suites`,
`base_intervals` intervals each, ground-truth CPIs) ingested and built
into `k` archetypes; an instruction stream the same for every seed, the
seed drawing the blocks cut from it; the library of `library_blocks`
blocks encoded; the first `programs_made` programs of the seed
(`traffic.programs`) made, and a small one of `warm_up` (blocks,
intervals) sent through the whole path. The window then sends the
made programs one at a time until the time is up (a program made
inside the window, should it run out, is timed under the span
"client"); a request is timed from sending its blocks to its
`CPIEstimate`.

The check, after the window: a seeded sample of `check_programs` of the
programs sent, the one with the most intervals among them. For each,
every block's BBE, every interval's signature and the estimate are
compared with the plain reference's, which tokenizes the blocks, encodes
them and signs the intervals itself from the same weights and traffic.
The reference also signs the whole base world, and judges the knowledge
base the set-up built from it: that each representative is the row
nearest its archetype, and that its CPI is the ground truth of its
interval. The archetypes themselves are the system's (see `PERF.md`).
"""
from __future__ import annotations

import time
import types
from typing import Dict

import numpy as np
import torch

from chipbench import bench
from chipbench.drivers import port
from chipbench.reference import knowledge, stage1, stage2, tokenizer
from chipbench.reference.precision import Precision, exact_float32
from chipbench.traffic import programs as traffic
from chipbench.traffic import world
from chipbench.traffic.isa import stable_hash


class Job:
    def __init__(self, cell: bench.Cell, seed: int, device, spans):
        from repro_torch.api import SemanticBBVService, ServiceConfig
        from repro_torch.core.pipeline import SemanticBBVPipeline
        cfg, mix = cell.config, cell.mix
        self.cell, self.seed, self.spans = cell, seed, spans
        bcfg, scfg = port.stage_configs(cfg)
        enc, self.w1 = port.encoder(cfg, seed, device)
        sig, self.w2 = port.signature_model(cfg, seed, device)
        sc = cfg["service"]
        self.svc = SemanticBBVService(
            SemanticBBVPipeline(enc, sig, device=device),
            ServiceConfig(bbe=bcfg, sig=scfg, k=sc["k"],
                          kmeans_seed=sc["kmeans_seed"],
                          encode_batch=sc["encode_batch"],
                          signature_batch=sc["signature_batch"],
                          store_min_capacity=sc["store_min_capacity"]))

        base, blocks, intervals, self.base_cpis = world.base_world(
            mix["base_intervals"], seed, mix["base_suites"])
        self.conv = port.Blocks()
        self.svc.ingest_blocks([self.conv.block(b.bid, self.conv.instructions(
            b.instrs)) for b in blocks.values()])
        for p in base:
            self.svc.ingest_intervals(p.name, intervals[p.name],
                                      cpis=self.base_cpis[p.name])
        self.svc.build(k=sc["k"], seed=sc["kmeans_seed"])
        # the base world as the store holds it, for the reference
        self.base = ({b: blocks[b].instrs for b in blocks},
                     [(p.name, intervals[p.name]) for p in base])

        # one stream for every seed: the seed draws the blocks cut from it
        self.stream = traffic.instruction_stream(mix["pool_functions"],
                                                 mix["stream_seed"])
        self.port_stream = self.conv.instructions(self.stream.instrs)
        per_ins = np.asarray([2 + len(i.operands) for i in self.stream.instrs])
        self.tok_cum = np.concatenate([[0], np.cumsum(per_ins)])
        maker = traffic.BlockMaker(self.stream,
                                   {b.render() for b in blocks.values()})
        self.library = traffic.library(maker, mix["library_blocks"], seed)
        self.library_port = [self.port_block(b) for b in self.library]
        self.svc.ingest_blocks(self.library_port)
        warm = traffic.ProgramSource(mix, stable_hash("warm-up", seed), maker,
                                     self.library, prefix="w")
        self.source = traffic.ProgramSource(mix, seed, maker, self.library)
        self.made = [self.request(self.source.program(i))
                     for i in range(mix["programs_made"])]
        self.send(*self.request(warm.program(0, mix["warm_up"])))
        self.sent, self.latency, self.window_s = [], [], 0.0
        self.made_in_window = 0
        self.totals = dict.fromkeys(("intervals", "new_blocks",
                                     "stage1_tokens", "set_elements"), 0)

    def port_block(self, b: traffic.Block):
        return self.conv.block(b.bid, self.port_stream[b.start:b.start
                                                       + b.length])

    def request(self, prog: traffic.Program):
        """A program and its blocks as the system's, ready to send."""
        return prog, [self.port_block(b) for b in prog.new] + \
            [self.library_port[j] for j in prog.library]

    def send(self, prog: traffic.Program, blocks: list):
        t0 = time.perf_counter()
        with self.spans("ingest_blocks"):
            self.svc.ingest_blocks(blocks)
        with self.spans("ingest_intervals"):
            self.svc.ingest_intervals(prog.name, prog.intervals)
        with self.spans("estimate"):
            est = self.svc.estimate(prog.name)
        return time.perf_counter() - t0, est

    def window(self, seconds: float):
        """Sends programs until `seconds` have passed; each is kept as
        arrays once its estimate is back, so the harness holds few
        objects however long the window."""
        max_len = self.cell.config["stage1"]["max_len"]
        max_set = self.cell.config["stage2"]["max_set"]
        tot = self.totals
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            i = len(self.sent)
            if i < len(self.made):
                req, self.made[i] = self.made[i], None
            else:
                with self.spans("client"):
                    req = self.request(self.source.program(i))
                self.made_in_window += 1
            dt, est = self.send(*req)
            self.latency.append(dt)
            pk = req[0].packed
            del req
            self.sent.append((pk, est.est_cpi, np.asarray(est.fingerprint)))
            tot["intervals"] += len(pk.ends)
            tot["new_blocks"] += len(pk.new)
            tot["set_elements"] += int(np.minimum(
                np.diff(pk.ends, prepend=0), max_set).sum())
            start, length = pk.new[:, 1], pk.new[:, 2]
            tot["stage1_tokens"] += int(np.minimum(max_len, 2 + (
                self.tok_cum[start + length] - self.tok_cum[start])).sum())
        self.window_s = time.perf_counter() - t0
        self.made = None

    def counts(self) -> Dict[str, float]:
        return {
            "attempted": len(self.sent), "failed": 0,
            "window_s": self.window_s, **self.totals,
            "intervals_per_s": self.totals["intervals"] / self.window_s,
        }

    def notes(self):
        ms = [1e3 * x for x in self.latency]
        return [f"{len(ms)} programs, {self.totals['intervals']} intervals, "
                f"{self.totals['new_blocks']} new blocks in the window; "
                f"{self.made_in_window} of the programs made inside it; a "
                f"program {min(ms):.1f} / {bench.quantile(ms, 0.5):.1f} / "
                f"{max(ms):.1f} ms (least / median / most)"]

    def sample(self):
        rng = np.random.RandomState(stable_hash("check", self.seed))
        n = len(self.sent)
        longest = max(range(n), key=lambda i: len(self.sent[i][0].ends))
        rest = [i for i in range(n) if i != longest]
        k = min(self.cell.mix["check_programs"] - 1, len(rest))
        picked = rng.choice(len(rest), k, replace=False) if k else []
        return [longest] + [rest[j] for j in sorted(picked)]

    def outputs(self) -> dict:
        """What the timed path produced for the sampled programs, and the
        knowledge base it was judged against, on the host."""
        self._picked = self.sample()
        store, kb = self.svc.store, self.svc.kb
        out = {"bbe": {}, "sig": {}, "est": {}, "fingerprint": {}}
        for i in self._picked:
            pk, est, fingerprint = self.sent[i]
            for bid in pk.new[:, 0].tolist():
                out["bbe"][bid] = self.svc.bbe_table[bid].copy()
            for j in pk.library:
                bid = self.library[j].bid
                out["bbe"][bid] = self.svc.bbe_table[bid].copy()
            out["sig"][pk.name] = np.asarray(
                store.signatures[store.rows_for(pk.name)], np.float32)
            out["est"][pk.name] = est
            out["fingerprint"][pk.name] = fingerprint
        owner = store.program_of_row
        reps = [(int(r), owner[int(r)]) for r in kb.rep_global_idx]
        out["archetypes"] = np.asarray(kb.archetypes, np.float32)
        out["reps"] = np.asarray(kb.rep_global_idx, np.int64)
        out["rep_cpi"] = np.asarray(kb.rep_cpi, np.float64)
        # a base program's rows were added in one call, in its order
        out["rep_truth"] = np.asarray([
            self.base_cpis[p][r - int(store.rows_for(p)[0])]
            for r, p in reps], np.float64)
        n_base = sum(len(ivs) for _, ivs in self.base[1])
        out["base_sig"] = np.asarray(store.signatures[:n_base], np.float32)
        for bid in self.base[0]:
            out["bbe"][bid] = self.svc.bbe_table[bid].copy()
        return out

    def inputs(self) -> dict:
        """What the reference is given: the weights, the configuration,
        the sampled programs' blocks (the benchmark's own instructions)
        and intervals."""
        progs = []
        for i in self._picked:
            pk = self.sent[i][0]
            blocks = {b.bid: self.stream.instrs[b.start:b.start + b.length]
                      for b in pk.blocks() + [self.library[j]
                                              for j in pk.library]}
            progs.append((pk.name, blocks, pk.intervals()))
        return {"w1": self.w1, "w2": self.w2, "config": self.cell.config,
                "programs": progs, "base": self.base}

    def release(self):
        self.svc = None


def _encode(w1, s1, blocks: dict, out: dict, device, P, batch: int):
    """The reference's BBE of each block of `blocks` ({bid: instructions})
    not yet in `out`."""
    bids = [b for b in blocks if b not in out]
    toks = tokenizer.encode_blocks(
        [types.SimpleNamespace(instrs=blocks[b]) for b in bids], s1["max_len"])
    for lo in range(0, len(bids), batch):
        t = torch.from_numpy(toks[lo:lo + batch]).to(device).long()
        out.update(zip(bids[lo:lo + batch], stage1.encode(w1, s1, t, P).cpu()
                       .numpy()))


def _sign(w2, s2, bbe: dict, intervals, device, P, batch: int) -> np.ndarray:
    """The reference's signature of each interval, its set's BBEs looked
    up in `bbe` ({bid: vector})."""
    set_ids, freqs, mask = stage2.interval_sets(
        [iv.counts for iv in intervals], s2["max_set"])
    keys = np.fromiter(bbe, np.int64, len(bbe))
    order = np.argsort(keys)
    keys = keys[order]
    table = torch.from_numpy(np.stack([bbe[int(b)] for b in keys])).to(device)
    rows = torch.from_numpy(np.searchsorted(
        keys, np.where(mask, set_ids, keys[0]))).to(device)
    sigs = []
    for lo in range(0, len(intervals), batch):
        m = torch.from_numpy(mask[lo:lo + batch]).to(device)
        sig, _ = stage2.signature(
            w2, s2, table[rows[lo:lo + batch]] * m[..., None],
            torch.from_numpy(freqs[lo:lo + batch]).to(device), m, P)
        sigs.append(sig.cpu().numpy())
    return np.concatenate(sigs)


def reference(cell: bench.Cell, inputs: dict, precision: str,
              batch: int = 512) -> dict:
    """The reference's BBEs and signatures of the sampled programs and of
    the base world."""
    P = Precision(precision)
    cfg = inputs["config"]
    s1, s2 = cfg["stage1"], cfg["stage2"]
    w1 = {k: v.float() for k, v in inputs["w1"].items()}
    w2 = {k: v.float() for k, v in inputs["w2"].items()}
    device = next(iter(w1.values())).device
    out = {"bbe": {}, "sig": {}, "weights": {}}
    with torch.no_grad(), exact_float32():
        for name, blocks, intervals in inputs["programs"]:
            _encode(w1, s1, blocks, out["bbe"], device, P, batch)
            out["sig"][name] = _sign(w2, s2, out["bbe"], intervals, device, P,
                                     batch)
            out["weights"][name] = np.asarray(
                [iv.num_instrs for iv in intervals], np.float64)
        base_blocks, base = inputs["base"]
        _encode(w1, s1, base_blocks, out["bbe"], device, P, batch)
        out["base_sig"] = _sign(w2, s2, out["bbe"],
                                [iv for _, ivs in base for iv in ivs],
                                device, P, batch)
    return out


def compare(got: dict, ref: dict) -> Dict[str, float]:
    """The numbers the check compares, each against its limit:

    bbe_gap  the largest L2 distance of a block's BBE from the reference's
             (both unit-norm), over the sampled programs' blocks and the
             base world's;
    sig_gap  the largest L2 distance of an interval's signature from the
             reference's, over the sampled programs and the base world;
    fingerprint_gap  the largest L1 distance of a program's fingerprint
             from the reference's, beyond twice the weight share of the
             intervals that may go to either of two archetypes (their
             two nearest lie closer than twice the signature's distance
             from the reference's);
    estimate_gap  the largest relative gap of a program's CPI estimate
             from the reference's, beyond what those intervals can move;
    rep_gap  how much nearer its archetype than its representative a
             row that may belong to it lies, beyond the signatures' gaps
             (`knowledge.representative_gap`);
    rep_cpi_gap  the largest relative gap of a representative's CPI from
             the ground truth of its interval."""
    bbe = max(float(np.linalg.norm(got["bbe"][b] - v))
              for b, v in ref["bbe"].items())
    sig = fp = est = 0.0
    for name, s_ref in ref["sig"].items():
        s_got = got["sig"][name]
        slack = np.linalg.norm(s_got.astype(np.float64) - s_ref, axis=1)
        sig = max(sig, float(slack.max()))
        f, e, share, move = knowledge.estimate(
            s_ref, ref["weights"][name], got["archetypes"], got["rep_cpi"],
            slack)
        fp = max(fp, max(0.0, float(np.abs(got["fingerprint"][name] - f).sum())
                         - 2.0 * share))
        est = max(est, max(0.0, abs(got["est"][name] - e) - move) / abs(e))
    base = np.linalg.norm(got["base_sig"].astype(np.float64)
                          - ref["base_sig"], axis=1)
    sig = max(sig, float(base.max()))
    rep = float(np.max(np.abs(got["rep_cpi"] - got["rep_truth"])
                       / np.abs(got["rep_truth"])))
    return {"bbe_gap": bbe, "sig_gap": sig, "fingerprint_gap": fp,
            "estimate_gap": est,
            "rep_gap": knowledge.representative_gap(
                ref["base_sig"], base, got["archetypes"], got["reps"]),
            "rep_cpi_gap": rep}


def as_outputs(got: dict, low: dict) -> dict:
    """The reference run at a lower precision, in the place of the
    system's outputs (the control): its BBEs and signatures, and the
    estimates its signatures give on the system's knowledge base."""
    out = dict(got, bbe=low["bbe"], sig=low["sig"], base_sig=low["base_sig"],
               est={}, fingerprint={})
    for name, sig in low["sig"].items():
        f, e, _, _ = knowledge.estimate(sig, low["weights"][name],
                                        got["archetypes"], got["rep_cpi"],
                                        np.zeros(len(sig)))
        out["est"][name], out["fingerprint"][name] = e, f
    return out


def faulty(cell: bench.Cell, got: dict, inputs: dict, ref: dict,
           fault: str) -> dict:
    """The system's outputs with a fault of its knowledge base planted:
    "half", each archetype the mean of the first half of its rows
    alone; "rep", each representative another row of its archetype,
    drawn from the seed of the cell's name."""
    a, _, _ = knowledge.nearest(got["base_sig"], got["archetypes"])
    if fault == "half":
        cents = np.array(got["archetypes"], np.float64)
        for j in range(len(cents)):
            rows = np.flatnonzero(a == j)
            if len(rows) >= 2:
                cents[j] = got["base_sig"][rows[:len(rows) // 2]].mean(0)
        return dict(got, archetypes=cents.astype(np.float32))
    if fault == "rep":
        rng = np.random.RandomState(stable_hash("rep", cell.name))
        reps = np.array(got["reps"])
        for j, r in enumerate(reps):
            rows = np.flatnonzero((a == j) & (np.arange(len(a)) != r))
            if len(rows):
                reps[j] = rng.choice(rows)
        return dict(got, reps=reps)
    raise ValueError(f"no fault {fault!r}")
