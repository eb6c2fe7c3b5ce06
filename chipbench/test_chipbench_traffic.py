"""The traffic generators repeat exactly by seed, and the vectorised
forms agree with the loops they stand for."""
import json

import numpy as np

from chipbench.bench import HERE
from chipbench.traffic import corpus, world
from chipbench.traffic import programs as traffic
from chipbench.traffic.asmgen import spec_programs
from chipbench.traffic.perfmodel import interval_cpi


def _mix(**small):
    mix = json.load(open(HERE / "workloads" / "ingest-new.json"))
    mix.update(name="ingest-new", **small)
    return mix


def _programs(seed, n=6):
    mix = _mix(blocks_per_program=[8, 64], intervals_per_program=[10, 60])
    stream = traffic.instruction_stream(10, seed)
    maker = traffic.BlockMaker(stream, set())
    lib = traffic.library(maker, 32, seed)
    src = traffic.ProgramSource(mix, seed, maker, lib)
    return stream, [src.program(i) for i in range(n)]


def _digest(progs):
    return [(p.name, [(b.bid, b.start, b.length) for b in p.new],
             p.library.tolist(),
             [(iv.counts, iv.num_instrs, iv.phase_id) for iv in p.intervals])
            for p in progs]


def test_programs_repeat_by_seed_and_blocks_are_new():
    s1, a = _programs(2 ** 31 + 5)
    s2, b = _programs(2 ** 31 + 5)
    _, c = _programs(11)
    assert _digest(a) == _digest(b) and _digest(a) != _digest(c)
    text = ["\n".join(s1.text[x.start:x.start + x.length])
            for p in a for x in p.new]
    assert len(set(text)) == len(text)
    for p in a:
        for iv in p.intervals:
            assert 1 <= len(iv.counts) <= 128
            assert iv.num_instrs >= 9_000_000
        kept = p.packed
        assert [(iv.counts, iv.num_instrs) for iv in kept.intervals()] == \
            [(iv.counts, iv.num_instrs) for iv in p.intervals]
        assert [(b.bid, b.start, b.length) for b in kept.blocks()] == \
            [(b.bid, b.start, b.length) for b in p.new]


def test_sizes_are_fixed_and_the_seed_orders_them():
    mix = _mix()
    maker = traffic.BlockMaker(traffic.instruction_stream(4, 0), set())
    one = traffic.ProgramSource(mix, 1, maker, [])
    two = traffic.ProgramSource(mix, 2, maker, [])
    n = mix["sizes_per_cycle"]
    first = sorted(map(tuple, (one.size(i) for i in range(n))))
    assert first == sorted(map(tuple, (two.size(i) for i in range(n))))
    assert first == sorted(map(tuple, one.sizes))


def test_world_repeats_and_its_cpis_are_the_loops():
    programs = spec_programs("int")[:2]
    blocks = {b.bid: b for p in programs for b in p.unique_blocks}
    a = world.trace(programs[0], 30, 7)
    b = world.trace(programs[0], 30, 7)
    assert [iv.counts for iv in a] == [iv.counts for iv in b]
    got = world.interval_cpis(a, blocks)
    want = [interval_cpi(iv, blocks) for iv in a]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_pretrain_pool_repeats_and_rows_differ():
    a = corpus.pretrain_pool(corpus.SyntheticBinaryCorp(8, 64, seed=3))
    b = corpus.pretrain_pool(corpus.SyntheticBinaryCorp(8, 64, seed=3))
    np.testing.assert_array_equal(a, b)
    assert len(np.unique(a.reshape(len(a), -1), axis=0)) == len(a)
