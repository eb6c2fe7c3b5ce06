"""The port's store lifecycle and persistence against the JAX package, on
the CPU: a counterpart of every scenario of tests/test_store_lifecycle.py
(tombstones, compaction, TTL/LRU policies, KnowledgeBase remap and
re-pinning, vacuum, save/load), at its sizes, with the JAX package's
kmeans++ seeds injected wherever a build is compared with JAX's
(build_impl="device", assign_impl="reference"); then the on-disk format
across the two packages: byte-equal manifests, and stores, knowledge
bases and services saved by either package reloading in the other with
bitwise the same estimates."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core.clustering import (  # noqa: E402
    kmeans_pp_init_masked, kmeans_pp_init_weighted,
)
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.api import (  # noqa: E402
    EvictionPolicy, KnowledgeBase, SemanticBBVService, ServiceConfig,
    SignatureStore, select_victims, vacuum,
)
from repro_torch.api.store import _capacity_for  # noqa: E402
from repro_torch.core.bbe import BBEConfig  # noqa: E402
from repro_torch.core.crossprog import CrossProgramResult  # noqa: E402
from repro_torch.core.pipeline import SemanticBBVPipeline  # noqa: E402
from repro_torch.core.signature import SignatureConfig  # noqa: E402
from repro_torch.kernels.kmeans_assign import (  # noqa: E402
    kmeans_assign, kmeans_update,
)
from repro_torch.train import checkpoint as ckpt  # noqa: E402

TINY_BBE = dict(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2, num_heads=2,
                bbe_dim=32, max_len=64)
TINY_SIG = dict(bbe_dim=32, d_model=32, sig_dim=16, max_set=48, num_heads=2)


def _blob_program(seed, centers, n_per=25, noise=0.05):
    rng = np.random.RandomState(seed)
    sigs, cpis = [], []
    for ph, c in enumerate(centers):
        sigs.append(c + rng.randn(n_per, centers.shape[1]) * noise)
        cpis.append(np.full(n_per, 1.0 + 2.0 * ph))
    return (np.concatenate(sigs).astype(np.float32),
            np.concatenate(cpis).astype(np.float32))


@pytest.fixture(scope="module")
def blob_centers():
    return (np.random.RandomState(7).randn(3, 8) * 6).astype(np.float32)


def _filled_store(blob_centers, names, cls=SignatureStore):
    store = (cls(8, min_capacity=16) if cls is japi.SignatureStore
             else cls(8, min_capacity=16, device="cpu"))
    for i, name in enumerate(names):
        s, c = _blob_program(i, blob_centers)
        store.add(name, s, weights=np.arange(len(s)) + 1.0, cpis=c)
    return store


def _jax_seeds(jstore, k=3, seed=0, restarts=3):
    """The JAX device build's kmeans++ seeds of every restart: the prefix
    seeding on a dense store, the weighted one over tombstones."""
    keys = [jax.random.PRNGKey(seed * 1000 + r) for r in range(restarts)]
    if jstore.has_tombstones:
        return np.stack([np.asarray(kmeans_pp_init_weighted(
            key, jstore.device_matrix, k, jstore.device_valid))
            for key in keys])
    return np.stack([np.asarray(kmeans_pp_init_masked(
        key, jstore.device_matrix, k, len(jstore))) for key in keys])


def _built_pair(jstore, store, k=3):
    """JAX (build_impl="device") and port bases over stores holding the
    same rows, the port's build seeded with JAX's seeds."""
    jkb = japi.KnowledgeBase(jstore, build_impl="device").build(k=k, seed=0)
    kb = KnowledgeBase(store).build(k=k, seed=0,
                                    init_centroids=_jax_seeds(jstore, k))
    np.testing.assert_allclose(kb.archetypes, jkb.archetypes, atol=1e-5)
    np.testing.assert_array_equal(kb.rep_global_idx, jkb.rep_global_idx)
    return jkb, kb


def _pair(blob_centers, names):
    jstore = _filled_store(blob_centers, names, japi.SignatureStore)
    store = _filled_store(blob_centers, names)
    return (jstore, store) + _built_pair(jstore, store)


def _same_estimate(a, b):
    assert a.est_cpi == b.est_cpi
    assert a.true_cpi == b.true_cpi
    assert a.accuracy == b.accuracy
    np.testing.assert_array_equal(a.fingerprint, b.fingerprint)


def _bits(t):
    return t.detach().cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------- eviction

def test_evict_tombstones_not_renumbering(blob_centers):
    store = _filled_store(blob_centers, ["A", "B"])
    n, v = len(store), store.version
    w_total = store.total_weight
    rows_b = store.rows_for("B")
    assert store.evict(rows_b[:10]) == 10
    assert len(store) == n
    assert store.n_alive == n - 10
    assert store.has_tombstones
    assert store.version == v + 1
    np.testing.assert_array_equal(store.rows_for("B"), rows_b[10:])
    np.testing.assert_array_equal(store.rows_for("A"), np.arange(75))
    gone = store.weights[rows_b[:10]].astype(np.float64).sum()
    assert store.total_weight == pytest.approx(w_total - gone)
    v2 = store.version
    assert store.evict(rows_b[:10]) == 0
    assert store.version == v2
    mask = store.device_valid.numpy()
    assert mask.shape == (store.capacity,)
    np.testing.assert_array_equal(mask[:n], store.alive_mask)
    np.testing.assert_array_equal(mask[n:], 0.0)
    with pytest.raises(IndexError):
        store.evict(np.array([len(store)]))


def test_evict_all_rows_of_a_program(blob_centers):
    store = _filled_store(blob_centers, ["A", "B"])
    kb = KnowledgeBase(store).build(k=3, seed=0)
    assert store.evict_program("B") == 75
    assert "B" in store and store.rows_for("B").shape == (0,)
    with pytest.raises(ValueError, match="no live rows"):
        kb.attach("B")
    with pytest.raises(ValueError, match="no live rows"):
        kb.estimate("B")
    assert np.isfinite(kb.estimate("A").est_cpi)
    store.compact()
    assert "B" not in store
    with pytest.raises(KeyError):
        store.rows_for("B")


def test_touch_is_metadata_only(blob_centers):
    store = _filled_store(blob_centers, ["A"])
    v, clock = store.version, store.clock
    store.touch(np.arange(5))
    assert store.version == v
    assert store.clock == clock + 1
    np.testing.assert_array_equal(store.last_used[:5], clock)
    store.touch(np.zeros(0, np.int64))
    assert store.clock == clock + 1


# -------------------------------------------------------------- compaction

def test_compact_bit_identical_to_fresh_store(blob_centers):
    """The gather over the resident device matrix gives bitwise the
    matrix a fresh upload of the live rows gives (zero tail rows with
    positive sign included), and the remap is JAX's."""
    store = _filled_store(blob_centers, ["A", "B", "C"])
    jstore = _filled_store(blob_centers, ["A", "B", "C"], japi.SignatureStore)
    n = len(store)
    _ = store.device_matrix
    rng = np.random.RandomState(0)
    dead = rng.choice(n, size=n // 2, replace=False)
    keep = np.setdiff1d(np.arange(n), dead)
    live_sigs = store.signatures[keep].copy()
    live_uids = store.uids[keep].copy()
    store.evict(dead)
    jstore.evict(dead)
    remap = store.compact()
    np.testing.assert_array_equal(remap, jstore.compact())
    assert remap.shape == (n,)
    np.testing.assert_array_equal(remap[dead], -1)
    np.testing.assert_array_equal(remap[keep], np.arange(keep.size))
    assert len(store) == store.n_alive == keep.size
    assert not store.has_tombstones
    assert store.capacity == _capacity_for(keep.size, 16) == jstore.capacity
    assert store.version == jstore.version
    np.testing.assert_array_equal(store.signatures, live_sigs)
    fresh = np.concatenate([live_sigs, np.zeros(
        (store.capacity - keep.size, 8), np.float32)])
    np.testing.assert_array_equal(_bits(store.device_matrix),
                                  fresh.view(np.uint32))
    np.testing.assert_array_equal(store.uids, live_uids)
    np.testing.assert_array_equal(store.rows_of_uids(live_uids),
                                  np.arange(keep.size))
    assert (store.rows_of_uids(np.asarray([10**9])) == -1).all()
    assert store.grouped_rows().keys() == {"A", "B", "C"}


def test_compact_noop_without_tombstones(blob_centers):
    store = _filled_store(blob_centers, ["A"])
    v = store.version
    remap = store.compact()
    np.testing.assert_array_equal(remap, np.arange(75))
    assert store.version == v


def test_save_load_roundtrips_tombstones_bit_identically(
        tmp_path, blob_centers):
    store = _filled_store(blob_centers, ["A", "B"])
    store.touch(np.arange(30, 40))
    store.evict(np.arange(10, 50))
    store.save(str(tmp_path / "store"))
    loaded = SignatureStore.load(str(tmp_path / "store"), device="cpu")
    assert len(loaded) == len(store)
    assert loaded.n_alive == store.n_alive
    assert loaded.clock == store.clock
    assert loaded.version == store.version
    np.testing.assert_array_equal(loaded.alive_mask, store.alive_mask)
    np.testing.assert_array_equal(loaded.uids, store.uids)
    np.testing.assert_array_equal(loaded.last_used, store.last_used)
    np.testing.assert_array_equal(loaded.inserted_at, store.inserted_at)
    np.testing.assert_array_equal(loaded.signatures, store.signatures)
    np.testing.assert_array_equal(loaded.rows_for("A"),
                                  store.rows_for("A"))
    r1, r2 = store.compact(), loaded.compact()
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(loaded.signatures, store.signatures)


def _save_pre_lifecycle(save, tmp_path, store, kb):
    """The formats written before the lifecycle fields existed (no alive/
    uids/stamps, no rep_uid), by either package's `save_checkpoint`."""
    save(str(tmp_path / "store"), store.version, {
        "signatures": store.signatures.copy(),
        "weights": store.weights.copy(),
        "cpis": store.cpis.copy(),
    }, meta={"sig_dim": 8, "min_capacity": 16,
             "program_of_row": store.program_of_row})
    save(str(tmp_path / "kb"), 1, {
        "archetypes": kb.archetypes, "rep_cpi": kb.rep_cpi,
        "rep_weight": kb.rep_weight, "rep_global_idx": kb.rep_global_idx,
    }, meta={"k": kb.k, "seed": 0, "assign_impl": "reference",
             "build_impl": "host", "rep_program": kb.rep_program,
             "built_version": store.version,
             "fingerprints": {p: np.asarray(f).tolist()
                              for p, f in kb.fingerprints.items()},
             "est_cpi": kb.est_cpi, "true_cpi": kb.true_cpi})


def test_load_pre_lifecycle_checkpoint(tmp_path, blob_centers):
    store = _filled_store(blob_centers, ["A", "B"])
    kb = KnowledgeBase(store).build(k=3, seed=0)
    _save_pre_lifecycle(ckpt.save_checkpoint, tmp_path, store, kb)
    loaded = SignatureStore.load(str(tmp_path / "store"), device="cpu")
    assert loaded.n_alive == len(loaded) == len(store)
    np.testing.assert_array_equal(loaded.uids, np.arange(len(store)))
    np.testing.assert_array_equal(loaded.last_used, loaded.clock)
    np.testing.assert_array_equal(loaded.inserted_at, loaded.clock)
    assert select_victims(loaded, EvictionPolicy(ttl=1)).size == 0
    kb2 = KnowledgeBase.load(str(tmp_path / "kb"), loaded)
    np.testing.assert_array_equal(kb2.rep_global_idx, kb.rep_global_idx)
    np.testing.assert_array_equal(kb2.rep_uid,
                                  loaded.uids[kb.rep_global_idx])
    for p in ("A", "B"):
        assert kb2.estimate(p).est_cpi == kb.estimate(p).est_cpi


# -------------------------------------------------- masked device build

@pytest.mark.parametrize("seeding", ["own", "jax"])
def test_build_skips_tombstones(blob_centers, seeding):
    """A build over a tombstoned store: dead rows get zero mass, reps sit
    on live rows, the blob centres are recovered; from JAX's seeds it is
    JAX's device build."""
    store = _filled_store(blob_centers, ["A", "B"])
    dead = np.random.RandomState(1).choice(len(store), size=40,
                                           replace=False)
    store.evict(dead)
    if seeding == "own":
        kb = KnowledgeBase(store).build(k=3, seed=0)
    else:
        jstore = _filled_store(blob_centers, ["A", "B"], japi.SignatureStore)
        jstore.evict(dead)
        _, kb = _built_pair(jstore, store)
    assert store.alive_mask[kb.rep_global_idx].all()
    for p in ("A", "B"):
        np.testing.assert_allclose(kb.fingerprints[p].sum(), 1.0,
                                   atol=1e-12)
    perm, d2 = kb.assign(blob_centers)
    assert sorted(perm.tolist()) == [0, 1, 2]
    assert (d2 < 0.1).all()


def _compacted_and_fresh(blob_centers, cls):
    store = _filled_store(blob_centers, ["A", "B"], cls)
    dead = np.arange(0, 150, 3)
    store.evict(dead)
    store.compact()
    fresh = (cls(8, min_capacity=16) if cls is japi.SignatureStore
             else cls(8, min_capacity=16, device="cpu"))
    keep = np.setdiff1d(np.arange(150), dead)
    for name, lo, hi in (("A", 0, 75), ("B", 75, 150)):
        sel = keep[(keep >= lo) & (keep < hi)]
        s, c = _blob_program(0 if name == "A" else 1, blob_centers)
        w = np.arange(75) + 1.0
        fresh.add(name, s[sel - lo], weights=w[sel - lo], cpis=c[sel - lo])
    return store, fresh


def test_postcompact_build_matches_fresh_store_bitwise(blob_centers):
    """After compact(), a build over the compacted store is bitwise a
    build over a fresh store of the live rows (same matrix, same seeds),
    and from JAX's seeds it is JAX's post-compact build."""
    store, fresh = _compacted_and_fresh(blob_centers, SignatureStore)
    np.testing.assert_array_equal(store.signatures, fresh.signatures)
    assert store.capacity == fresh.capacity
    kb1 = KnowledgeBase(store).build(k=3, seed=0)
    kb2 = KnowledgeBase(fresh).build(k=3, seed=0)
    np.testing.assert_array_equal(kb1.archetypes, kb2.archetypes)
    np.testing.assert_array_equal(kb1.rep_global_idx, kb2.rep_global_idx)
    for p in ("A", "B"):
        np.testing.assert_array_equal(kb1.fingerprints[p],
                                      kb2.fingerprints[p])
        assert kb1.estimate(p).est_cpi == kb2.estimate(p).est_cpi
    jstore, _ = _compacted_and_fresh(blob_centers, japi.SignatureStore)
    jkb, kb = _built_pair(jstore, store)
    for p in ("A", "B"):
        np.testing.assert_array_equal(kb.fingerprints[p], jkb.fingerprints[p])


# ----------------------------------------------------- KnowledgeBase remap

def test_apply_remap_moves_and_repins_representatives(blob_centers):
    jstore, store, jkb, kb = _pair(blob_centers, ["A", "B"])
    rep_cpi = kb.rep_cpi.copy()
    rep_weight = kb.rep_weight.copy()
    victim_rep = int(kb.rep_global_idx[0])
    victim_uid = int(kb.rep_uid[0])
    for s in (store, jstore):
        s.evict(np.asarray([victim_rep]))
    remap = store.compact()
    repinned = kb.apply_remap(remap)
    assert repinned == 1 == jkb.apply_remap(jstore.compact())
    assert (kb.rep_global_idx >= 0).all()
    assert store.alive_mask[kb.rep_global_idx].all()
    np.testing.assert_array_equal(store.uids[kb.rep_global_idx], kb.rep_uid)
    assert kb.rep_uid[0] != victim_uid
    np.testing.assert_array_equal(kb.rep_global_idx[1:],
                                  store.rows_of_uids(kb.rep_uid[1:]))
    np.testing.assert_array_equal(kb.rep_cpi, rep_cpi)
    np.testing.assert_array_equal(kb.rep_weight, rep_weight)
    assert kb._all_row_assign()[kb.rep_global_idx[0]] == 0
    # the re-pinned representative is JAX's
    np.testing.assert_array_equal(kb.rep_global_idx, jkb.rep_global_idx)
    np.testing.assert_array_equal(kb.rep_uid, jkb.rep_uid)
    assert kb.rep_program == jkb.rep_program


def test_compact_then_load_old_kb_remaps_via_uids(tmp_path, blob_centers):
    store = _filled_store(blob_centers, ["A", "B"])
    kb = KnowledgeBase(store).build(k=3, seed=0)
    kb.save(str(tmp_path / "kb"))
    before = {p: kb.estimate(p) for p in ("A", "B")}
    rep_uids = kb.rep_uid.copy()
    victim = int(kb.rep_global_idx[1])
    store.evict(np.concatenate([[victim], store.rows_for("A")[:5]]))
    store.compact()
    kb2 = KnowledgeBase.load(str(tmp_path / "kb"), store)
    assert (kb2.rep_global_idx >= 0).all()
    assert store.alive_mask[kb2.rep_global_idx].all()
    same = rep_uids != rep_uids[1]
    np.testing.assert_array_equal(kb2.rep_uid[same], rep_uids[same])
    assert kb2.rep_uid[1] != rep_uids[1]
    _same_estimate(kb2.estimate("B"), before["B"])


def test_eviction_during_attach_many(blob_centers):
    store = _filled_store(blob_centers, ["A", "B"])
    kb = KnowledgeBase(store).build(k=3, seed=0)
    items = []
    for j, n in enumerate(["P", "Q"]):
        s, c = _blob_program(40 + j, blob_centers)
        items.append((n, s, np.arange(len(s)) + 1.0, c))
    rows = store.add_many(items)
    store.evict(rows["P"][::2])
    many = kb.attach_many(["P", "Q"])
    live = store.rows_for("P")
    np.testing.assert_array_equal(live, rows["P"][1::2])
    a, _ = kb.assign(store.signatures[live])
    w = store.weights[live].astype(np.float64)
    f_exp = np.zeros(3)
    np.add.at(f_exp, a.astype(np.int64), w / w.sum())
    np.testing.assert_allclose(many["P"], f_exp, atol=1e-12)
    np.testing.assert_allclose(many["P"].sum(), 1.0, atol=1e-12)
    store.evict_program("Q")
    with pytest.raises(ValueError, match="no live rows"):
        kb.attach_many(["Q"])


# ------------------------------------------------------------ policies

def _stamped_store(cls=SignatureStore):
    """4 rows; the clock ticks once per add, then touches refresh rows 2
    and 3: last_used [0, 1, 4, 5], clock 6."""
    store = (cls(2, min_capacity=4) if cls is japi.SignatureStore
             else cls(2, min_capacity=4, device="cpu"))
    for i in range(4):
        store.add(f"p{i}", np.full((1, 2), float(i), np.float32))
    store.touch(np.asarray([2]))
    store.touch(np.asarray([3]))
    return store


def test_select_victims_ttl():
    store, jstore = _stamped_store(), _stamped_store(japi.SignatureStore)
    assert store.clock == 6
    for ttl, want in ((4, [0, 1]), (100, []), (0, [0, 1, 2, 3])):
        got = select_victims(store, EvictionPolicy(ttl=ttl))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, japi.select_victims(jstore, japi.EvictionPolicy(ttl=ttl)))


def test_select_victims_lru():
    store, jstore = _stamped_store(), _stamped_store(japi.SignatureStore)
    for kw, want in ((dict(max_rows=2), [0, 1]), (dict(max_rows=4), []),
                     (dict(ttl=4, max_rows=1), [0, 1, 2])):
        got = select_victims(store, EvictionPolicy(**kw))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, japi.select_victims(jstore, japi.EvictionPolicy(**kw)))
    with pytest.raises(ValueError):
        EvictionPolicy(ttl=-1)
    with pytest.raises(ValueError):
        EvictionPolicy(max_rows=-1)
    with pytest.raises(ValueError):
        EvictionPolicy(compact_dead_fraction=2.0)


def test_vacuum_end_to_end_estimates_bit_identical(blob_centers):
    """vacuum() that evicts program B leaves estimate() on untouched A
    bit-identical; the report and the estimates are JAX's."""
    jstore, store, jkb, kb = _pair(blob_centers, ["A", "B"])
    eA = kb.estimate("A")
    for s in (store, jstore):
        s.evict_program("B")
    report = vacuum(store, kb, EvictionPolicy())
    assert dataclasses.asdict(report) == dataclasses.asdict(
        japi.vacuum(jstore, jkb, japi.EvictionPolicy()))
    assert report.compacted and report.evicted == 0
    assert report.rows_after == 75
    assert report.capacity_after == 128
    assert (kb.rep_global_idx >= 0).all()
    eA2 = kb.estimate("A")
    _same_estimate(eA2, eA)
    _same_estimate(eA2, jkb.estimate("A"))
    assert "B" not in kb.fingerprints and "B" not in kb.est_cpi
    assert eA2.simulated_weight == eA.simulated_weight
    assert eA2.total_weight < eA.total_weight


def test_vacuum_that_empties_the_store_does_not_crash(blob_centers):
    store = _filled_store(blob_centers, ["A", "B"])
    kb = KnowledgeBase(store).build(k=3, seed=0)
    store.evict_program("A")
    store.evict_program("B")
    report = vacuum(store, kb, EvictionPolicy())
    assert report.compacted and report.repinned == 0
    assert len(store) == 0 and store.capacity == 16
    assert (kb.rep_global_idx == -1).all()
    assert kb.fingerprints == {}
    with pytest.raises(KeyError):
        kb.estimate("A")
    s, c = _blob_program(3, blob_centers)
    store.add("C", s, cpis=c)
    kb.build(k=3, seed=0)
    assert store.alive_mask[kb.rep_global_idx].all()
    assert np.isfinite(kb.estimate("C").est_cpi)


def test_service_save_after_eviction_reloads_bit_identical(tmp_path):
    """service.save() refreshes estimates before the KB is written, so a
    reload gives the summary's estimates even when rows were evicted
    between the last attach and save()."""
    from repro_torch.data.asmgen import spec_programs
    from repro_torch.data.perfmodel import INORDER_CPU, interval_cpi
    from repro_torch.data.trace import block_table, trace_program

    progs = spec_programs("int")[:2]
    bt = block_table(progs)
    cfg = ServiceConfig(bbe=BBEConfig(**TINY_BBE),
                        sig=SignatureConfig(**TINY_SIG), k=3,
                        store_min_capacity=16)
    svc = SemanticBBVService.create(cfg, device="cpu")
    svc.ingest_blocks(list(bt.values()))
    for p in progs:
        ivs = trace_program(p, 8)
        svc.ingest_intervals(
            p.name, ivs,
            cpis=[interval_cpi(iv, bt, INORDER_CPU) for iv in ivs])
    svc.build()
    victim = progs[0].name
    svc.estimate(victim)
    svc.store.evict(svc.store.rows_for(victim)[:4])
    out = str(tmp_path / "svc")
    svc.save(out)
    with open(f"{out}/summary.json") as f:
        summary = json.load(f)
    svc2 = SemanticBBVService.load(out, svc.pipe)
    assert svc2.store.device == svc.pipe.device
    for name, want in summary["estimates"].items():
        assert svc2.estimate(name).est_cpi == want["est_cpi"], name


def test_vacuum_compact_threshold(blob_centers):
    store = _filled_store(blob_centers, ["A", "B"])
    store.evict(np.arange(10))
    report = vacuum(store, None, EvictionPolicy(compact_dead_fraction=0.25))
    assert not report.compacted
    assert store.has_tombstones
    report = vacuum(store, None, EvictionPolicy(compact_dead_fraction=0.05))
    assert report.compacted
    assert not store.has_tombstones
    v = store.version
    report = vacuum(store, None, EvictionPolicy())
    assert report.evicted == 0 and not report.compacted
    assert store.version == v


# ------------------------------------------------ across the two packages

def _manifest_bytes(path):
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        return f.read()


def _same_arrays(path_a, path_b):
    with np.load(os.path.join(path_a, "arrays.npz")) as a, \
            np.load(os.path.join(path_b, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_manifests_byte_equal_to_jax(tmp_path, blob_centers):
    """The same adds, touches, evictions and compaction in both packages:
    the port writes the store's and the knowledge base's manifest.msgpack
    byte for byte as JAX does (step, leaf order, meta keys and values),
    and arrays.npz arrays equal to JAX's (the base's archetypes within
    the build's bound)."""
    jstore, store, jkb, kb = _pair(blob_centers, ["A", "B", "C"])
    for s in (store, jstore):
        s.touch(np.arange(20, 30))
        s.evict(np.arange(40, 90))
    assert kb.apply_remap(store.compact()) == jkb.apply_remap(
        jstore.compact())
    for s in (store, jstore):
        s.add("D", *_blob_program(9, blob_centers))
    for s, k in ((store, kb), (jstore, jkb)):
        for p in ("A", "B", "C", "D"):
            k.estimate(p)
    paths = {}
    for tag, s, k in (("port", store, kb), ("jax", jstore, jkb)):
        paths[tag] = (s.save(str(tmp_path / tag / "store")),
                      k.save(str(tmp_path / tag / "kb")))
    (ps, pk), (js, jk) = paths["port"], paths["jax"]
    assert os.path.basename(ps) == os.path.basename(js)
    assert _manifest_bytes(ps) == _manifest_bytes(js)
    _same_arrays(ps, js)
    assert os.path.basename(pk) == os.path.basename(jk)
    assert _manifest_bytes(pk) == _manifest_bytes(jk)
    with np.load(os.path.join(pk, "arrays.npz")) as a, \
            np.load(os.path.join(jk, "arrays.npz")) as b:
        for key in ("rep_cpi", "rep_weight", "rep_global_idx", "rep_uid"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        np.testing.assert_allclose(a["archetypes"], b["archetypes"],
                                   atol=1e-5)


@pytest.fixture(scope="module")
def tiny_pipeline():
    return SemanticBBVPipeline.create(0, BBEConfig(**TINY_BBE),
                                      SignatureConfig(**TINY_SIG),
                                      device="cpu")


def _estimates(kb, programs):
    return {p: kb.estimate(p) for p in programs}


@pytest.mark.parametrize("era", ["lifecycle", "pre_lifecycle"])
def test_jax_saved_service_loads_in_port(tmp_path, blob_centers,
                                         tiny_pipeline, era):
    """A store and knowledge base saved by the JAX package (a service's
    layout, or the pre-lifecycle format) load in the port: every
    estimate is bitwise JAX's (summary.json's, or its own reload's), and
    the store's arrays are JAX's."""
    jstore = _filled_store(blob_centers, ["A", "B", "C"], japi.SignatureStore)
    jkb = japi.KnowledgeBase(jstore, build_impl="device").build(k=3)
    jstore.evict(np.arange(5, 30))
    out = str(tmp_path / "svc")
    if era == "lifecycle":
        japi.SemanticBBVService(None, japi.ServiceConfig(), store=jstore,
                                kb=jkb).save(out)
        with open(os.path.join(out, "summary.json")) as f:
            want = {p: (e["est_cpi"], e["true_cpi"], e["accuracy"])
                    for p, e in json.load(f)["estimates"].items()}
        svc = SemanticBBVService.load(out, tiny_pipeline)
        store, kb = svc.store, svc.kb
    else:
        _save_pre_lifecycle(jckpt.save_checkpoint, tmp_path, jstore, jkb)
        jloaded = japi.SignatureStore.load(str(tmp_path / "store"))
        jkb2 = japi.KnowledgeBase.load(str(tmp_path / "kb"), jloaded)
        want = {p: (e.est_cpi, e.true_cpi, e.accuracy)
                for p, e in _estimates(jkb2, "ABC").items()}
        store = SignatureStore.load(str(tmp_path / "store"), device="cpu")
        kb = KnowledgeBase.load(str(tmp_path / "kb"), store)
        np.testing.assert_array_equal(kb.rep_uid, jkb2.rep_uid)
        jstore = jloaded
    assert sorted(want) == ["A", "B", "C"]
    for p, e in _estimates(kb, want).items():
        assert (e.est_cpi, e.true_cpi, e.accuracy) == want[p], p
    for name in ("signatures", "weights", "cpis", "alive_mask", "uids",
                 "inserted_at", "last_used"):
        np.testing.assert_array_equal(getattr(store, name),
                                      getattr(jstore, name), err_msg=name)
    assert (store.clock, store.version, store.program_of_row) == \
        (jstore.clock, jstore.version, jstore.program_of_row)


def test_port_saved_service_loads_in_jax(tmp_path, blob_centers,
                                         tiny_pipeline):
    """A service saved by the port (built, vacuumed, rows evicted after
    the last estimate) loads in the JAX package: JAX's estimates are
    bitwise the port's summary.json, and its store's arrays the port's."""
    store = _filled_store(blob_centers, ["A", "B", "C"])
    svc = SemanticBBVService(tiny_pipeline, None, store=store)
    svc.build(k=3)
    svc.store.evict_program("B")
    assert svc.vacuum().compacted
    svc.estimate("A")
    svc.store.evict(svc.store.rows_for("A")[:7])
    out = str(tmp_path / "svc")
    svc.save(out)
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert sorted(summary["estimates"]) == ["A", "C"]
    jstore = japi.SignatureStore.load(os.path.join(out, "store"))
    jkb = japi.KnowledgeBase.load(os.path.join(out, "knowledge"), jstore)
    for p, want in summary["estimates"].items():
        e = jkb.estimate(p)
        assert {"est_cpi": e.est_cpi, "true_cpi": e.true_cpi,
                "accuracy": e.accuracy} == want, p
    for name in ("signatures", "weights", "cpis", "alive_mask", "uids",
                 "inserted_at", "last_used"):
        np.testing.assert_array_equal(getattr(jstore, name),
                                      getattr(svc.store, name), err_msg=name)
    np.testing.assert_array_equal(jkb.rep_global_idx, svc.kb.rep_global_idx)
    np.testing.assert_array_equal(jkb.archetypes, svc.kb.archetypes)


def test_jax_kb_resaved_by_port_is_byte_equal(tmp_path, blob_centers):
    """A JAX store and base, loaded by the port and saved again, give
    manifests byte-equal to JAX's and arrays equal to JAX's."""
    jstore = _filled_store(blob_centers, ["A", "B"], japi.SignatureStore)
    jkb = japi.KnowledgeBase(jstore, build_impl="device").build(k=3)
    js = jstore.save(str(tmp_path / "jax" / "store"))
    jk = jkb.save(str(tmp_path / "jax" / "kb"))
    store = SignatureStore.load(str(tmp_path / "jax" / "store"),
                                device="cpu")
    kb = KnowledgeBase.load(str(tmp_path / "jax" / "kb"), store)
    ps = store.save(str(tmp_path / "port" / "store"))
    pk = kb.save(str(tmp_path / "port" / "kb"))
    for a, b in ((ps, js), (pk, jk)):
        assert os.path.basename(a) == os.path.basename(b)
        assert _manifest_bytes(a) == _manifest_bytes(b)
        _same_arrays(a, b)


def test_compact_then_load_old_jax_kb_remaps_via_uids(tmp_path,
                                                      blob_centers):
    """A JAX base saved before the store was compacted loads against the
    port's compacted store through the uids, re-pinning the evicted
    representative as JAX does against its own compacted store."""
    jstore = _filled_store(blob_centers, ["A", "B"], japi.SignatureStore)
    jkb = japi.KnowledgeBase(jstore, build_impl="device").build(k=3)
    jkb.save(str(tmp_path / "kb"))
    jstore.save(str(tmp_path / "store"))
    store = SignatureStore.load(str(tmp_path / "store"), device="cpu")
    gone = np.concatenate([[jkb.rep_global_idx[1]], jstore.rows_for("A")[:5]])
    for s in (store, jstore):
        s.evict(gone)
        s.compact()
    kb = KnowledgeBase.load(str(tmp_path / "kb"), store)
    jkb2 = japi.KnowledgeBase.load(str(tmp_path / "kb"), jstore)
    assert store.alive_mask[kb.rep_global_idx].all()
    np.testing.assert_array_equal(kb.rep_global_idx, jkb2.rep_global_idx)
    np.testing.assert_array_equal(kb.rep_uid, jkb2.rep_uid)
    assert kb.rep_uid[1] != jkb.rep_uid[1]
    assert kb.rep_program == jkb2.rep_program
    for p in ("A", "B"):
        _same_estimate(kb.estimate(p), jkb2.estimate(p))


def test_meta_values_are_plain_python(tmp_path, blob_centers):
    """The checkpoint codec rejects numpy integer and bool scalars as
    msgpack does; the store and the base write plain values even when
    handed numpy integers."""
    import msgpack
    for bad in (np.int64(3), np.bool_(True), np.int32(1)):
        with pytest.raises(TypeError):
            ckpt.packb({"k": bad})
        with pytest.raises(TypeError):
            msgpack.packb({"k": bad})
    store = SignatureStore(np.int64(8), min_capacity=np.int64(16),
                           device="cpu")
    s, c = _blob_program(0, blob_centers)
    store.add("A", s, cpis=c)
    kb = KnowledgeBase(store).build(k=np.int64(3))
    kb.seed = np.int64(0)
    for path in (store.save(str(tmp_path / "s")),
                 kb.save(str(tmp_path / "k"))):
        meta = ckpt.read_manifest(path)["meta"]
        for key, v in meta.items():
            assert type(v) in (int, float, str, list, dict, type(None)), key
    assert KnowledgeBase.load(str(tmp_path / "k"), store).seed == 0


def test_cross_program_result_view(blob_centers):
    jstore, store, jkb, kb = _pair(blob_centers, ["A", "B"])
    r, jr = kb.as_cross_program_result(), jkb.as_cross_program_result()
    assert isinstance(r, CrossProgramResult)
    assert (r.k, r.rep_program, r.est_cpi, r.true_cpi) == \
        (jr.k, jr.rep_program, jr.est_cpi, jr.true_cpi)
    np.testing.assert_array_equal(r.rep_global_idx, jr.rep_global_idx)
    np.testing.assert_array_equal(r.rep_cpi, jr.rep_cpi)
    for p in ("A", "B"):
        np.testing.assert_array_equal(r.fingerprints[p], jr.fingerprints[p])
        assert r.accuracy(p) == jr.accuracy(p)
    assert r.avg_accuracy == jr.avg_accuracy


def test_cpu_lifecycle_launches_no_kernel_and_load_refuses_cuda(
        tmp_path, blob_centers):
    """Vacuum, re-pin, save and load on the CPU run the plain versions
    only; loading onto "cuda" without a card raises."""
    before = (kmeans_assign.launches, kmeans_update.launches)
    store = _filled_store(blob_centers, ["A", "B"])
    kb = KnowledgeBase(store).build(k=3)
    store.evict(np.asarray([kb.rep_global_idx[0]]))
    assert vacuum(store, kb).repinned == 1
    store.save(str(tmp_path / "store"))
    kb.save(str(tmp_path / "kb"))
    KnowledgeBase.load(str(tmp_path / "kb"),
                       SignatureStore.load(str(tmp_path / "store"),
                                           device="cpu"))
    assert (kmeans_assign.launches, kmeans_update.launches) == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SignatureStore.load(str(tmp_path / "store"))
