"""The generator of the signing service's traffic: programs the service
has not seen, each a set of basic blocks and a trace of 10M-instruction
intervals over them. One general generator; a traffic mix
(`chipbench/workloads/<name>.json`) gives its parameters.

Blocks are made cheaply: an instruction stream is drawn once by the
benchmark's copy of `asmgen` (`pool_functions` functions at the five
optimization levels, their blocks laid end to end), and a block is a run
of that stream at a length drawn from the generator's own block lengths.
Each block is checked to be new by its rendered text against every block
the run has made or loaded before; a repeat is drawn again.

Program sizes: `sizes_per_cycle` pairs of (unique blocks, intervals),
log-uniform over the mix's ranges and taken at the same quantile of
both (a program with more intervals has more blocks), are fixed for
every seed; each cycle of that many programs sends all of them, in an
order drawn from the seed. The seed draws the order and the content,
not the amount of work.

A program's blocks are `new_share` new ones and the rest from the
library, a pool of blocks the service has encoded in set-up. Its trace
has `phases` phases, each over a hot set of about half its blocks; an
interval touches a run of 16-128 blocks (log-uniform) of its phase's
hot set, with heavy-tailed counts scaled to the interval's instructions.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from chipbench.traffic.asmgen import OPT_LEVELS, PROFILES, gen_function
from chipbench.traffic.isa import stable_hash
from chipbench.traffic.trace import INTERVAL_INSTRS, Interval

# block ids of the traffic's blocks start here, above the 31-bit ids of
# the generator's own blocks
FIRST_BID = 1 << 40


@dataclasses.dataclass
class Stream:
    """The instruction stream blocks are cut from."""
    instrs: list            # instructions of the benchmark's ISA copy
    text: List[str]         # each instruction rendered
    lengths: np.ndarray     # the generator's block lengths, to draw from


def instruction_stream(n_functions: int, seed: int) -> Stream:
    names = sorted(PROFILES)
    rng = np.random.RandomState(stable_hash("stream", seed))
    fids = rng.randint(1 << 30, size=n_functions)
    instrs, lengths = [], []
    for i, fid in enumerate(fids):
        f = gen_function(int(fid), OPT_LEVELS[i % len(OPT_LEVELS)],
                         names[rng.randint(len(names))])
        for b in f.blocks:
            instrs.extend(b.instrs)
            lengths.append(len(b.instrs))
    return Stream(instrs, [ins.render() for ins in instrs],
                  np.asarray(lengths, np.int64))


@dataclasses.dataclass
class Block:
    """A block of the traffic: a run of the stream."""
    bid: int
    start: int
    length: int


class BlockMaker:
    """Cuts new blocks from a stream; `seen` holds the rendered text of
    every block the run knows, and grows with each block made. Block ids
    count up from FIRST_BID."""

    def __init__(self, stream: Stream, seen: set):
        self.stream = stream
        self.seen = seen
        self.next_bid = FIRST_BID

    def text(self, start: int, length: int) -> str:
        return "\n".join(self.stream.text[start:start + length])

    def make(self, rng: np.random.RandomState, n: int) -> List[Block]:
        out: List[Block] = []
        lengths = self.stream.lengths
        total = len(self.stream.instrs)
        while len(out) < n:
            want = n - len(out)
            length = lengths[rng.randint(len(lengths), size=want)]
            start = np.floor(rng.uniform(size=want) * (total - length + 1)
                             ).astype(np.int64)
            for a, k in zip(start.tolist(), length.tolist()):
                key = self.text(a, k)
                if key not in self.seen:
                    self.seen.add(key)
                    out.append(Block(self.next_bid, a, k))
                    self.next_bid += 1
        return out


@dataclasses.dataclass
class Packed:
    """A program kept after it was sent, as arrays: its new blocks
    (bid, start, length), its library blocks, and its intervals' block
    ids and counts laid end to end (interval t ends at ends[t])."""
    name: str
    new: np.ndarray
    library: np.ndarray
    bids: np.ndarray
    counts: np.ndarray
    ends: np.ndarray
    instrs: np.ndarray

    def blocks(self) -> List[Block]:
        return [Block(*map(int, row)) for row in self.new]

    def intervals(self) -> List[Interval]:
        ids, cl = self.bids.tolist(), self.counts.tolist()
        lo = np.concatenate([[0], self.ends[:-1]]).tolist()
        return [Interval(self.name, t, dict(zip(ids[a:b], cl[a:b])), 0, 1.0,
                         int(n)) for t, (a, b, n) in enumerate(
                             zip(lo, self.ends.tolist(), self.instrs.tolist()))]


@dataclasses.dataclass
class Program:
    name: str
    new: List[Block]
    library: np.ndarray          # indices into the library
    intervals: List[Interval]
    packed: Packed


def _loguniform(rng, lo, hi, size=None):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), size=size))


class ProgramSource:
    """The seeded sequence of programs of one run (`program(i)`)."""

    def __init__(self, mix: dict, seed: int, maker: BlockMaker,
                 library: List[Block], prefix: str = "p"):
        self.mix = mix
        self.seed = seed
        self.prefix = prefix
        self.maker = maker
        self.library = library
        fixed = np.random.RandomState(stable_hash("sizes", mix["name"]))
        n = mix["sizes_per_cycle"]
        strata = (np.arange(n) + fixed.uniform(size=n)) / n
        lo, hi = mix["blocks_per_program"]
        blocks = np.exp(np.log(lo) + strata * (np.log(hi) - np.log(lo)))
        lo, hi = mix["intervals_per_program"]
        ivs = np.exp(np.log(lo) + strata * (np.log(hi) - np.log(lo)))
        self.sizes = np.stack([np.round(blocks), np.round(ivs)], 1
                              ).astype(np.int64)

    def size(self, i: int):
        n = len(self.sizes)
        order = np.random.RandomState(
            stable_hash("order", self.seed, i // n)).permutation(n)
        return self.sizes[order[i % n]]

    def program(self, i: int, size=None) -> Program:
        """Program i of the run, of `size` (unique blocks, intervals) or
        its own: made in turn (its new blocks must not repeat any made
        before)."""
        mix = self.mix
        n_blocks, n_ivs = (int(x) for x in (
            self.size(i) if size is None else size))
        rng = np.random.RandomState(stable_hash("program", self.seed, i))
        n_new = int(round(mix["new_share"] * n_blocks))
        new = self.maker.make(rng, n_new)
        lib = rng.choice(len(self.library), n_blocks - n_new, replace=False)
        bids = np.concatenate([[b.bid for b in new],
                               [self.library[j].bid for j in lib]])
        lens = np.concatenate([[b.length for b in new],
                               [self.library[j].length for j in lib]])
        name = f"{self.prefix}{i:05d}"
        intervals, arrays = trace(rng, bids, lens, n_ivs, mix, name)
        packed = Packed(name, np.asarray([(b.bid, b.start, b.length)
                                          for b in new], np.int64).reshape(-1, 3),
                        lib, *arrays)
        return Program(name, new, lib, intervals, packed)


def trace(rng, bids: np.ndarray, lens: np.ndarray, n_ivs: int, mix: dict,
          name: str):
    """The program's intervals over its blocks (bids, with their lengths
    in instructions), as objects and as arrays (block ids, counts, each
    interval's end, instructions)."""
    n = len(bids)
    P = mix["phases"]
    order = rng.permutation(n)
    chunks = np.array_split(order, P)
    hot = [np.concatenate([chunks[p], chunks[(p + 1) % P]]) for p in range(P)]
    width = max(len(h) for h in hot)
    table = np.zeros((P, width), np.int64)
    sizes = np.asarray([len(h) for h in hot])
    for p, h in enumerate(hot):
        table[p, :len(h)] = h
    schedule: List[int] = []
    lo, hi = mix["phase_intervals"]
    p = 0
    while len(schedule) < n_ivs:
        schedule.extend([p] * int(rng.randint(lo, hi + 1)))
        p = (p + 1) % P
    phase = np.asarray(schedule[:n_ivs])
    lo, hi = mix["blocks_per_interval"]
    m = np.minimum(np.floor(_loguniform(rng, lo, hi + 1, n_ivs)).astype(
        np.int64), sizes[phase])
    # the intervals' entries laid end to end: interval t holds m[t]
    # consecutive blocks of its phase's hot set from a random offset
    ends = np.cumsum(m)
    row = np.repeat(np.arange(n_ivs), m)
    col = np.arange(ends[-1]) - np.repeat(ends - m, m)
    pos = (rng.randint(1 << 30, size=n_ivs)[row] + col) % sizes[phase][row]
    member = table[phase[row], pos]
    # heavy-tailed shares (gamma of shape 1/2: half a squared normal)
    w = np.square(rng.standard_normal(len(row)))
    share = w / np.bincount(row, w, n_ivs)[row]
    counts = np.floor(share * INTERVAL_INSTRS / lens[member]).astype(
        np.int64) + 1
    instrs = np.bincount(row, counts * lens[member], n_ivs)
    ids = bids[member].tolist()
    cl = counts.tolist()
    lo_ = (ends - m).tolist()
    objs = [Interval(name, t, dict(zip(ids[a:b], cl[a:b])), ph, 1.0, int(n))
            for t, (a, b, ph, n) in enumerate(zip(
                lo_, ends.tolist(), phase.tolist(), instrs.tolist()))]
    return objs, (bids[member], counts, ends, instrs.astype(np.int64))


def library(maker: BlockMaker, n: int, seed: int) -> List[Block]:
    return maker.make(np.random.RandomState(stable_hash("library", seed)), n)
