"""The port's serving slice against the JAX package on one tiny world
(3 programs x 24 intervals of spec_programs("int") plus one held-out
program, bridged weights, CPU), the data copies, and the package's rules:
no jax and nothing of `repro` imported, no silent CPU fallback, no
kernel launch on the CPU."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import SemanticBBVService as JaxService  # noqa: E402
from repro.api import ServiceConfig as JaxServiceConfig  # noqa: E402
from repro.core import bbe as jbbe  # noqa: E402
from repro.core import signature as jsig  # noqa: E402
from repro.core.clustering import (  # noqa: E402
    kmeans_pp_init_masked, kmeans_pp_init_weighted,
)
from repro.core.pipeline import SemanticBBVPipeline as JaxPipeline  # noqa: E402
from repro.data import asmgen as jasmgen  # noqa: E402
from repro.data import perfmodel as jperfmodel  # noqa: E402
from repro.data import trace as jtrace  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import SemanticBBVService, ServiceConfig  # noqa: E402
from repro_torch.api.store import SignatureStore  # noqa: E402
from repro_torch.api.knowledge import KnowledgeBase  # noqa: E402
from repro_torch.core.bbe import BBEConfig  # noqa: E402
from repro_torch.core.pipeline import SemanticBBVPipeline  # noqa: E402
from repro_torch.core.signature import SignatureConfig  # noqa: E402
from repro_torch.data import asmgen, perfmodel, trace  # noqa: E402
from repro_torch.kernels.kmeans_assign import (  # noqa: E402
    kmeans_assign, kmeans_update,
)
from repro_torch.kernels.set_attention import masked_set_attention  # noqa: E402
from repro_torch.kernels.wkv import wkv  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY_BBE = dict(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2, num_heads=2,
                bbe_dim=32, max_len=64)
TINY_SIG = dict(bbe_dim=32, d_model=32, sig_dim=16, max_set=48, num_heads=2)
K = 4
N_IV = 24
BATCHES = dict(encode_batch=64, signature_batch=32)


def _world(asm, tr, pm):
    programs = asm.spec_programs("int")[:4]
    blocks = {b.bid: b for p in programs for b in p.unique_blocks}
    ivs = {p.name: tr.trace_program(p, N_IV, seed=0) for p in programs}
    cpis = {n: [pm.interval_cpi(iv, blocks) for iv in v]
            for n, v in ivs.items()}
    return programs, blocks, ivs, cpis


@pytest.fixture(scope="module")
def worlds():
    return (_world(asmgen, trace, perfmodel),
            _world(jasmgen, jtrace, jperfmodel))


@pytest.fixture(scope="module")
def pipelines():
    jpipe = JaxPipeline.create(jax.random.PRNGKey(0),
                               jbbe.BBEConfig(**TINY_BBE),
                               jsig.SignatureConfig(**TINY_SIG))
    tree = jax.tree_util.tree_map(np.asarray, jpipe.bbe_params)
    enc = bridge.bbe_params_from_jax(tree, BBEConfig(**TINY_BBE))
    sig = bridge.signature_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jpipe.sig_params),
        SignatureConfig(**TINY_SIG))
    return jpipe, SemanticBBVPipeline(enc, sig, device="cpu")


def _jax_seeds(matrix, k, n_valid, restarts=3, seed=0):
    """The JAX device build's kmeans++ seeds of every restart."""
    return np.stack([np.asarray(kmeans_pp_init_masked(
        jax.random.PRNGKey(seed * 1000 + r), matrix, k, n_valid))
        for r in range(restarts)])


@pytest.fixture(scope="module")
def services(worlds, pipelines):
    """JAX (build_impl="device") and port services over the same world:
    three programs ingested and built with the JAX seeds, the fourth
    attached later."""
    (programs, blocks, ivs, cpis), (_, jblocks, jivs, _) = worlds
    jpipe, tpipe = pipelines
    jsvc = JaxService.from_pipeline(jpipe, JaxServiceConfig(
        bbe=jpipe.bbe_cfg, sig=jpipe.sig_cfg, k=K, build_impl="device",
        **BATCHES))
    tsvc = SemanticBBVService.from_pipeline(tpipe, ServiceConfig(
        bbe=tpipe.bbe_cfg, sig=tpipe.sig_cfg, k=K, **BATCHES))
    jsvc.ingest_blocks(list(jblocks.values()))
    tsvc.ingest_blocks(list(blocks.values()))
    names = [p.name for p in programs]
    for n in names[:3]:
        jsvc.ingest_intervals(n, jivs[n], cpis=cpis[n])
        tsvc.ingest_intervals(n, ivs[n], cpis=cpis[n])
    seeds = _jax_seeds(jsvc.store.device_matrix, K, len(jsvc.store))
    jsvc.build()
    tsvc.build(init_centroids=seeds)
    return jsvc, tsvc, names, seeds


# ---------------------------------------------------------------------------
# data copies
# ---------------------------------------------------------------------------

def test_data_copies_match_jax(worlds):
    (programs, blocks, ivs, cpis), (jprograms, jblocks, jivs, jcpis) = worlds
    assert [p.name for p in programs] == [p.name for p in jprograms]
    assert list(blocks) == list(jblocks)
    assert [b.render() for b in blocks.values()] == \
        [b.render() for b in jblocks.values()]
    for n in ivs:
        assert [iv.counts for iv in ivs[n]] == [iv.counts for iv in jivs[n]]
        assert [iv.num_instrs for iv in ivs[n]] == \
            [iv.num_instrs for iv in jivs[n]]
        assert cpis[n] == jcpis[n]


# ---------------------------------------------------------------------------
# the slice against JAX
# ---------------------------------------------------------------------------

def test_encode_blocks_matches_jax(services):
    jsvc, tsvc, _, _ = services
    assert list(tsvc.bbe_table) == list(jsvc.bbe_table)
    got = np.stack(list(tsvc.bbe_table.values()))
    want = np.stack(list(jsvc.bbe_table.values()))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_interval_signatures_match_jax(services):
    jsvc, tsvc, _, _ = services
    np.testing.assert_allclose(np.asarray(tsvc.store.signatures),
                               np.asarray(jsvc.store.signatures), atol=1e-4)
    assert tsvc.store.capacity == jsvc.store.capacity


def test_build_with_jax_seeds_matches_jax(services):
    jsvc, tsvc, names, _ = services
    np.testing.assert_allclose(tsvc.kb.archetypes, jsvc.kb.archetypes,
                               atol=1e-5)
    np.testing.assert_array_equal(tsvc.kb.rep_global_idx,
                                  jsvc.kb.rep_global_idx)
    assert tsvc.kb.rep_program == jsvc.kb.rep_program
    for n in names[:3]:
        np.testing.assert_array_equal(tsvc.kb.fingerprints[n],
                                      jsvc.kb.fingerprints[n])


def test_build_over_jax_signatures_matches_jax(worlds, services):
    """Same signatures in, same clusters out: a port store holding the JAX
    signatures, built from the JAX seeds, gives the JAX archetypes,
    assignments and representatives; a held-out program's JAX signatures
    get the JAX fingerprint."""
    jsvc, _, names, seeds = services
    jstore = jsvc.store
    store = SignatureStore(jstore.sig_dim, device="cpu")
    for n in names[:3]:
        rows = jstore.rows_for(n)
        store.add(n, jstore.signatures[rows], jstore.weights[rows],
                  jstore.cpis[rows])
    kb = KnowledgeBase(store).build(k=K, init_centroids=seeds)
    np.testing.assert_allclose(kb.archetypes, jsvc.kb.archetypes, atol=1e-5)
    np.testing.assert_array_equal(kb.rep_global_idx, jsvc.kb.rep_global_idx)
    for n in names[:3]:
        np.testing.assert_array_equal(kb.fingerprints[n],
                                      jsvc.kb.fingerprints[n])
    x = np.asarray(jstore.signatures)
    np.testing.assert_array_equal(kb.assign(x)[0],
                                  jsvc.kb.assign(x)[0])
    held = names[3]
    jivs = worlds[1][2][held]
    sigs = jsvc.pipe.interval_signatures(jivs, jsvc.bbe_table)
    weights = [iv.num_instrs for iv in jivs]
    f = kb.attach(held, signatures=sigs, weights=weights)
    np.testing.assert_allclose(
        f, jsvc.kb.attach(held, signatures=sigs, weights=weights),
        rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(kb.rep_cpi, jsvc.kb.rep_cpi)
    assert held not in kb.fingerprints        # a pure query records nothing


def test_attach_and_estimate_match_jax(worlds, services):
    (_, _, ivs, cpis), (_, _, jivs, _) = worlds
    jsvc, tsvc, names, _ = services
    held = names[3]
    if held not in tsvc.store:
        jsvc.attach_many({held: jivs[held]}, cpis={held: cpis[held]})
        tsvc.attach_many({held: ivs[held]}, cpis={held: cpis[held]})
    for n in names:
        got, want = tsvc.estimate(n), jsvc.estimate(n)
        np.testing.assert_allclose(got.fingerprint, want.fingerprint,
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(got.est_cpi, want.est_cpi, rtol=1e-6)
        np.testing.assert_allclose(got.true_cpi, want.true_cpi, rtol=1e-6)
        assert 0.0 <= got.accuracy <= 1.0
        np.testing.assert_allclose(got.speedup, want.speedup, rtol=1e-6)
    assert np.isclose(tsvc.kb.avg_accuracy, jsvc.kb.avg_accuracy,
                      rtol=1e-6)


def test_end_to_end_estimates_match_jax(worlds, pipelines):
    """The port's own signatures all the way: a fresh port service and a
    fresh JAX service over the same world, the port's build seeded from
    JAX's, give every program's est_cpi within 1e-3 relative."""
    (programs, blocks, ivs, cpis), (_, jblocks, jivs, _) = worlds
    jpipe, tpipe = pipelines
    jsvc = JaxService.from_pipeline(jpipe, JaxServiceConfig(
        bbe=jpipe.bbe_cfg, sig=jpipe.sig_cfg, k=K, build_impl="device",
        **BATCHES))
    tsvc = SemanticBBVService.from_pipeline(tpipe, ServiceConfig(
        bbe=tpipe.bbe_cfg, sig=tpipe.sig_cfg, k=K, **BATCHES))
    names = [p.name for p in programs]
    jsvc.ingest_blocks(list(jblocks.values()))
    tsvc.ingest_blocks(list(blocks.values()))
    for n in names:
        jsvc.ingest_intervals(n, jivs[n], cpis=cpis[n])
        tsvc.ingest_intervals(n, ivs[n], cpis=cpis[n])
    jsvc.build()
    tsvc.build(init_centroids=_jax_seeds(jsvc.store.device_matrix, K,
                                         len(jsvc.store)))
    for n in names:
        np.testing.assert_allclose(tsvc.estimate(n).est_cpi,
                                   jsvc.estimate(n).est_cpi, rtol=1e-3)


def test_tombstoned_build_matches_jax(services):
    """Evicting a program: the build runs over the store's device validity
    mask (kmeans++ over arbitrary holes), and the representatives land on
    live rows — as the JAX device build does, from the same seeds."""
    jsvc, _, names, _ = services
    jstore = jsvc.store
    store = SignatureStore(jstore.sig_dim, device="cpu")
    jax_store = type(jstore)(jstore.sig_dim)
    for n in names[:3]:
        rows = jstore.rows_for(n)
        for s in (store, jax_store):
            s.add(n, jstore.signatures[rows], jstore.weights[rows],
                  jstore.cpis[rows])
    assert store.evict_program(names[1]) == jax_store.evict_program(names[1])
    np.testing.assert_array_equal(store.device_valid.numpy(),
                                  np.asarray(jax_store.device_valid))
    seeds = np.stack([np.asarray(kmeans_pp_init_weighted(
        jax.random.PRNGKey(r), jax_store.device_matrix, K,
        jax_store.device_valid)) for r in range(3)])
    from repro.api import KnowledgeBase as JaxKnowledgeBase
    jkb = JaxKnowledgeBase(jax_store, build_impl="device").build(k=K)
    kb = KnowledgeBase(store).build(k=K, init_centroids=seeds)
    np.testing.assert_allclose(kb.archetypes, jkb.archetypes, atol=1e-5)
    np.testing.assert_array_equal(kb.rep_global_idx, jkb.rep_global_idx)
    assert set(kb.rep_global_idx) <= set(store.alive_rows)
    assert names[1] not in kb.fingerprints
    for n in (names[0], names[2]):
        np.testing.assert_allclose(kb.estimate(n).est_cpi,
                                   jkb.estimate(n).est_cpi, rtol=1e-6)


def test_own_seeding_builds_and_estimates():
    """Without injected seeds the port seeds from torch.Generators: the
    build is reproducible and every estimate is finite, in [0, 1]."""
    rng = np.random.RandomState(0)
    centres = rng.randn(5, 8)
    x = (centres[rng.randint(5, size=200)] + 0.05 * rng.randn(200, 8))
    out = []
    for _ in range(2):
        store = SignatureStore(8, device="cpu")
        store.add("a", x[:120], cpis=rng.uniform(1, 3, 120))
        store.add("b", x[120:], cpis=rng.uniform(1, 3, 80))
        kb = KnowledgeBase(store).build(k=5, seed=3)
        out.append(kb.archetypes)
        est = kb.estimate("b")
        assert np.isfinite(est.est_cpi) and 0.0 <= est.accuracy <= 1.0
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.parametrize("mode", ["all", "prefix", "holes"])
def test_kmeans_pp_seedings_pick_valid_rows(mode):
    """Each kmeans++ seeding picks k distinct rows of x, never a padded or
    dead row, and repeats itself from the same seed."""
    from repro_torch.core.clustering import (
        kmeans_pp_init, kmeans_pp_init_masked, kmeans_pp_init_weighted,
    )
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(60, 4).astype(np.float32))
    valid = torch.ones(60)
    if mode == "prefix":
        valid[45:] = 0
        x[45:] = 0
    elif mode == "holes":
        valid = torch.from_numpy((rng.rand(60) < 0.5).astype(np.float32))

    def seed(s):
        gen = torch.Generator().manual_seed(s)
        if mode == "all":
            return kmeans_pp_init(gen, x, 6)
        if mode == "prefix":
            return kmeans_pp_init_masked(gen, x, 6, 45)
        return kmeans_pp_init_weighted(gen, x, 6, valid)

    cents = seed(7)
    rows = [int(torch.nonzero((x == c).all(-1))[0]) for c in cents]
    assert len(set(rows)) == 6
    assert all(valid[r] > 0 for r in rows)
    assert torch.equal(cents, seed(7))


# ---------------------------------------------------------------------------
# the package's rules
# ---------------------------------------------------------------------------

def _port_files():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax_and_nothing_of_repro():
    banned = {"jax", "jaxlib", "repro"}
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, f"{path}: {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.api, repro_torch.bridge; "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot show")
    cfg = ServiceConfig(bbe=BBEConfig(**TINY_BBE), sig=SignatureConfig(
        **TINY_SIG))
    with pytest.raises(RuntimeError, match="CUDA"):
        SemanticBBVService.create(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SemanticBBVPipeline.create(bbe_cfg=BBEConfig(**TINY_BBE),
                                   sig_cfg=SignatureConfig(**TINY_SIG))
    with pytest.raises(RuntimeError, match="CUDA"):
        SignatureStore(8)


def test_cpu_service_launches_no_kernel(worlds):
    """A whole CPU run (create, ingest, build, attach, estimate, evict)
    goes through the plain versions only: every launch counter stays 0."""
    programs, blocks, ivs, cpis = worlds[0]
    wrappers = (wkv, masked_set_attention, kmeans_assign, kmeans_update)
    before = [w.launches for w in wrappers]
    svc = SemanticBBVService.create(ServiceConfig(
        bbe=BBEConfig(**TINY_BBE), sig=SignatureConfig(**TINY_SIG), k=K,
        **BATCHES), device="cpu")
    svc.ingest_blocks(list(blocks.values()))
    names = [p.name for p in programs]
    for n in names[:3]:
        svc.ingest_intervals(n, ivs[n], cpis=cpis[n])
    svc.build()
    svc.attach_many({names[3]: ivs[names[3]]}, cpis={names[3]: cpis[names[3]]})
    for n in names:
        est = svc.estimate(n)
        assert np.isfinite(est.est_cpi)
    assert svc.evict(names[0]) == N_IV
    svc.build()
    assert [w.launches for w in wrappers] == before == [0, 0, 0, 0]
