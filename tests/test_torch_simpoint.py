"""The port's SimPoint baseline (core/simpoint.py) and host k-means
(core/clustering.py `kmeans`, `kmeans_fit`) against the JAX package, on
the CPU. The JAX package seeds each restart from `jax.random`, which
torch cannot reproduce: parity runs on the JAX seeds handed in as
`init_centroids`, and the port's own seeding is held cluster-aligned."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clustering as jclustering  # noqa: E402
from repro.core import simpoint as jsimpoint  # noqa: E402
from repro.data import asmgen as jasmgen  # noqa: E402
from repro.data import trace as jtrace  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SimPointResult, kmeans, representatives, run_simpoint,
)
from repro_torch.core import simpoint as tsimpoint  # noqa: E402
from repro_torch.core.clustering import kmeans_fit  # noqa: E402
from repro_torch.core.simpoint import random_projection  # noqa: E402
from repro_torch.data import asmgen, trace  # noqa: E402
from repro_torch.kernels.kmeans_assign import (  # noqa: E402
    kmeans_assign, kmeans_update,
)


def _jax_seeds(x, k, seed=0, restarts=3):
    """The JAX host kmeans' kmeans++ seeds of every restart."""
    xj = jnp.asarray(np.asarray(x, np.float32))
    return np.stack([np.asarray(jclustering.kmeans_pp_init(
        jax.random.PRNGKey(seed * 1000 + r), xj, k))
        for r in range(restarts)])


def _blobs(seed=0, k=4, d=8, n_per=50, scale=6.0, noise=0.05):
    """tests/test_core.py's blob worlds."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * scale
    return np.concatenate([c + rng.randn(n_per, d) * noise
                           for c in centers]).astype(np.float32)


def _toy_phase_data(n_per=30, k=3, d=10, seed=0):
    """Synthetic program with k phases; CPI correlates with the phase
    (tests/test_core.py's)."""
    rng = np.random.RandomState(seed)
    sigs, cpis = [], []
    for ph in range(k):
        center = rng.randn(d) * 5
        sigs.append(center + rng.randn(n_per, d) * 0.1)
        cpis.append(np.full(n_per, 1.0 + 2.0 * ph) + rng.randn(n_per) * 0.02)
    return np.concatenate(sigs).astype(np.float32), np.concatenate(cpis)


@pytest.fixture(scope="module")
def bbv_world():
    """Two FP-like programs x 60 intervals as Fig. 4 takes them: classic
    BBVs over every block of the suite, instruction weights, and CPIs,
    from the port's data copies and from the JAX package's."""
    out = []
    for asm, tr in ((asmgen, trace), (jasmgen, jtrace)):
        programs = asm.spec_programs("fp")
        bt = tr.block_table(programs)
        order = sorted(bt)
        lens = {b: blk.num_instrs for b, blk in bt.items()}
        progs = {}
        for p in programs[:2]:
            ivs = tr.trace_program(p, 60, seed=0)
            progs[p.name] = (ivs, order, lens)
        out.append(progs)
    return out


def _bbv(progs, name, module):
    ivs, order, lens = progs[name]
    return module.classic_bbv_matrix(ivs, order, lens)


def test_random_projection_is_jax_bitwise():
    x = np.random.RandomState(0).rand(40, 515)
    for seed in (0, 3):
        got = random_projection(x, 15, seed)
        assert got.shape == (40, 15)
        np.testing.assert_array_equal(
            got, jsimpoint.random_projection(x, 15, seed))
    narrow = x[:, :15]
    assert random_projection(narrow, 15) is narrow


def test_classic_bbv_matrix_matches_jax(bbv_world):
    port, jax_side = bbv_world
    for name in port:
        got = _bbv(port, name, tsimpoint)
        want = _bbv(jax_side, name, jsimpoint)
        assert got.shape == want.shape and got.shape[0] == 60
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)


def _datasets(bbv_world):
    port, _ = bbv_world
    name = next(iter(port))
    bbv = random_projection(_bbv(port, name, tsimpoint).astype(np.float64),
                            15, 0).astype(np.float32)
    return {
        "blobs": (_blobs(), 4, 1),
        "wide_blobs": (_blobs(0, 4, 8, 50, 10.0, 0.3), 4, 1),
        "random": (np.random.RandomState(1).randn(100, 4).astype(np.float32),
                   5, 0),
        "projected_bbv": (bbv, 10, 0),
    }


def _inertia_atol(x):
    """Inertia sums d2 = |x|^2 - 2 x.c + |c|^2 in fp32: each term is
    off by about eps32 (|x|^2 + |c|^2) whatever the summation order."""
    return 4 * np.finfo(np.float32).eps * float(
        (np.asarray(x, np.float64) ** 2).sum())


@pytest.mark.parametrize("data", ["blobs", "wide_blobs", "random",
                                  "projected_bbv"])
def test_kmeans_with_jax_seeds_matches_jax(bbv_world, data):
    """From JAX's seeds the port's host k-means gives JAX's labels
    exactly, its centroids within 1e-5, and picks the same restart."""
    x, k, seed = _datasets(bbv_world)[data]
    seeds = _jax_seeds(x, k, seed)
    c, a, inertia = kmeans(x, k, seed=seed, device="cpu",
                           init_centroids=seeds)
    jc, ja, jinertia = jclustering.kmeans(x, k, seed=seed)
    np.testing.assert_array_equal(a, np.asarray(ja))
    assert a.dtype == np.int32
    np.testing.assert_allclose(c, np.asarray(jc), atol=1e-5)
    atol = _inertia_atol(x)
    np.testing.assert_allclose(inertia, jinertia, rtol=0, atol=atol)
    # restart by restart: the same labels and inertias, so the same best
    # restart (the first of equal inertias, as the strict `<` picks)
    xt = torch.from_numpy(x)
    ours, theirs = [], []
    for r, s in enumerate(seeds):
        _, a_r, i_r = kmeans_fit(0, xt, k, init_centroids=torch.from_numpy(s))
        _, ja_r, ji_r = jclustering.kmeans_fit(
            jax.random.PRNGKey(seed * 1000 + r), jnp.asarray(x), k)
        np.testing.assert_array_equal(a_r.numpy(), np.asarray(ja_r))
        ours.append(float(i_r))
        theirs.append(float(ji_r))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=atol)
    assert int(np.argmin(ours)) == int(np.argmin(theirs))
    np.testing.assert_array_equal(c, kmeans_fit(
        0, xt, k, init_centroids=torch.from_numpy(
            seeds[int(np.argmin(ours))]))[0].numpy())


@pytest.mark.parametrize("what", ["bbv", "phases"])
def test_run_simpoint_with_jax_seeds_matches_jax(bbv_world, what):
    """Fig. 4's two flows: a classic BBV projected to 15 dims (k 10,
    instruction weights), and signature-like phases (k 3, uniform): from
    JAX's seeds, the same assignment and representatives, and est/true
    CPI within 1e-12 relative."""
    if what == "bbv":
        port, _ = bbv_world
        name = next(iter(port))
        sigs = _bbv(port, name, tsimpoint)
        ivs = port[name][0]
        w = np.array([iv.num_instrs for iv in ivs], np.float64)
        cpis = np.random.RandomState(1).uniform(0.8, 3.0, len(ivs))
        kw = dict(k=10, seed=0, project_to=15)
        x = random_projection(sigs.astype(np.float64), 15, 0)
    else:
        sigs, cpis = _toy_phase_data()
        w = None
        kw = dict(k=3, seed=0)
        x = sigs.astype(np.float64)
    seeds = _jax_seeds(x.astype(np.float32), kw["k"])
    res = run_simpoint(sigs, cpis, w, device="cpu", init_centroids=seeds,
                       **kw)
    want = jsimpoint.run_simpoint(sigs, cpis, w, **kw)
    assert isinstance(res, SimPointResult) and res.k == want.k
    np.testing.assert_array_equal(res.assign, np.asarray(want.assign))
    np.testing.assert_array_equal(res.rep_indices, want.rep_indices)
    np.testing.assert_allclose(res.weights, want.weights, rtol=1e-12)
    np.testing.assert_allclose(res.est_cpi, want.est_cpi, rtol=1e-12)
    np.testing.assert_allclose(res.true_cpi, want.true_cpi, rtol=1e-12)
    np.testing.assert_allclose(res.accuracy, want.accuracy, rtol=1e-9)


def test_own_seeding_is_cluster_aligned_with_jax():
    """Without injected seeds the port seeds from torch.Generators: on
    tests/test_core.py's blobs its clusters are JAX's up to a relabel."""
    for x, k, seed in ((_blobs(), 4, 1),
                       (_blobs(0, 4, 8, 50, 10.0, 0.3), 4, 1)):
        c, a, inertia = kmeans(x, k, seed=seed, device="cpu")
        jc, ja, jinertia = jclustering.kmeans(x, k, seed=seed)
        jc, ja = np.asarray(jc), np.asarray(ja)
        perm = ((c[:, None, :] - jc[None, :, :]) ** 2).sum(-1).argmin(1)
        assert sorted(perm.tolist()) == list(range(k))
        np.testing.assert_array_equal(perm[a], ja)
        np.testing.assert_allclose(c, jc[perm], atol=1e-4)
        np.testing.assert_allclose(inertia, jinertia, rtol=0,
                                   atol=_inertia_atol(x))
        for b in range(k):
            assert len(set(a[b * 50:(b + 1) * 50].tolist())) == 1
    again = kmeans(_blobs(), 4, seed=1, device="cpu")
    np.testing.assert_array_equal(again[0], kmeans(_blobs(), 4, seed=1,
                                                   device="cpu")[0])


def test_representatives_are_members():
    x = np.random.RandomState(1).randn(100, 4).astype(np.float32)
    cents, assign, _ = kmeans(x, 5, seed=0, device="cpu")
    for c, r in enumerate(representatives(x, cents, assign)):
        if (assign == c).any():
            assert assign[r] == c


def test_simpoint_on_clean_phases_and_only_representatives():
    sigs, cpis = _toy_phase_data()
    res = run_simpoint(sigs, cpis, k=3, seed=0, device="cpu")
    assert res.accuracy > 0.98
    assert res.weights.sum() == pytest.approx(1.0, abs=1e-6)
    est = float((res.weights * cpis[res.rep_indices]).sum())
    assert est == pytest.approx(res.est_cpi)


def test_simpoint_accuracy_is_not_clamped():
    """SimPointResult.accuracy is the paper's raw 1 - |est - true| / true
    (negative when the estimate is off by more than the truth), not the
    knowledge base's clamped `cpi_accuracy`."""
    for est, true in ((3.0, 1.0), (0.5, 1.0), (1.0, 1.0)):
        kw = dict(k=1, assign=np.zeros(1), rep_indices=np.zeros(1),
                  weights=np.ones(1), est_cpi=est, true_cpi=true)
        got = SimPointResult(**kw).accuracy
        assert got == jsimpoint.SimPointResult(**kw).accuracy
        assert got == 1.0 - abs(est - true) / true
    assert SimPointResult(1, None, None, None, 3.0, 1.0).accuracy == -1.0


def test_cpu_runs_launch_no_kernel_and_cuda_is_refused():
    before = (kmeans_assign.launches, kmeans_update.launches)
    sigs, cpis = _toy_phase_data()
    run_simpoint(sigs, cpis, k=3, device="cpu")
    assert (kmeans_assign.launches, kmeans_update.launches) == before
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot show")
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans(sigs, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_simpoint(sigs, cpis, k=3)
