"""The port's CUDA kernels against their plain PyTorch versions on the
card. Needs a CUDA card and no JAX: every test here skips without one.
On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_backward_reference, attention_reference, flash_attention,
    flash_attention_backward, flash_forward,
)
from repro_torch.kernels.kmeans_assign import (  # noqa: E402
    kmeans_assign, kmeans_assign_reference, kmeans_update,
    kmeans_update_reference,
)
from repro_torch.kernels.set_attention import (  # noqa: E402
    masked_set_attention, set_attention_backward,
    set_attention_backward_reference, set_attention_reference,
)
from repro_torch.kernels.wkv import wkv, wkv_reference  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, with TF32 off so the plain versions are true fp32; skips
    without one (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("B,S,H,dh", [(2, 64, 3, 16), (3, 37, 2, 44),
                                      (4, 128, 6, 64), (1, 5, 1, 8),
                                      (2, 129, 2, 128), (2, 1, 3, 64),
                                      (3, 200, 2, 64), (2, 17, 2, 7)])
def test_wkv_kernel_matches_plain(cuda, B, S, H, dh):
    g = _gen(cuda, S)
    r, k, v = (torch.randn((B, S, H, dh), generator=g, device=cuda)
               for _ in range(3))
    k = k / k.norm(dim=-1, keepdim=True)
    w = 0.7 + 0.3 * torch.rand((B, S, H, dh), generator=g, device=cuda)
    beta = torch.rand((B, S, H), generator=g, device=cuda)
    s0 = 0.1 * torch.randn((B, H, dh, dh), generator=g, device=cuda)
    before = wkv.launches
    y, sf = wkv(r, k, v, w, beta, s0)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    y_ref, sf_ref = wkv_reference(r, k, v, w, beta, s0)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(sf, sf_ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("B,H,N,M,dh,empty", [
    (8, 4, 64, 64, 64, 2), (8, 4, 1, 64, 64, 2), (2, 2, 5, 13, 16, 1),
    (3, 2, 7, 13, 44, 0), (2, 2, 7, 130, 16, 0)])
def test_set_attention_kernel_matches_plain(cuda, B, H, N, M, dh, empty):
    g = _gen(cuda, N + M)
    q = torch.randn((B, H, N, dh), generator=g, device=cuda)
    k = torch.randn((B, H, M, dh), generator=g, device=cuda)
    v = torch.randn((B, H, M, dh), generator=g, device=cuda)
    bias = torch.rand((B, M), generator=g, device=cuda)
    mask = torch.rand((B, M), generator=g, device=cuda) < 0.5
    mask[:, 0] = True
    mask[B - empty:] = False
    o = masked_set_attention(q, k, v, bias, mask)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, set_attention_reference(q, k, v, bias,
                                                          mask),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,H,N,M,dh,empty", [
    (64, 4, 64, 64, 64, 2), (64, 4, 1, 64, 64, 2), (2, 2, 5, 13, 16, 1),
    (3, 2, 7, 13, 44, 1), (2, 3, 1, 33, 44, 0), (2, 2, 7, 130, 16, 0),
    (3, 2, 4, 64, 64, 1), (3, 2, 5, 64, 64, 1), (2, 2, 65, 65, 64, 1),
    (2, 2, 130, 130, 44, 1), (2, 2, 9, 21, 8, 1), (2, 2, 70, 13, 128, 1),
    (2, 2, 3, 130, 128, 1), (2, 2, 1, 300, 44, 1), (2, 2, 9, 30, 256, 1),
    (2, 2, 9, 21, 7, 1)])
def test_set_attention_backward_kernel_matches_plain(cuda, B, H, N, M, dh,
                                                     empty):
    """The backward kernel against the plain backward (atol 1e-4 + rtol
    1e-3, the JAX suite's gradient bound); masked keys of rows with a
    valid key get exactly 0; two launches give the same bits."""
    g = _gen(cuda, 7 * N + M)
    q = torch.randn((B, H, N, dh), generator=g, device=cuda)
    k = torch.randn((B, H, M, dh), generator=g, device=cuda)
    v = torch.randn((B, H, M, dh), generator=g, device=cuda)
    do = torch.randn((B, H, N, dh), generator=g, device=cuda)
    bias = torch.rand((B, M), generator=g, device=cuda)
    mask = torch.rand((B, M), generator=g, device=cuda) < 0.5
    mask[:, 0] = True
    mask[B - empty:] = False
    before = set_attention_backward.launches
    out = set_attention_backward(q, k, v, bias, mask, do)
    torch.cuda.synchronize()
    assert set_attention_backward.launches == before + 1
    ref = set_attention_backward_reference(q, k, v, bias, mask, do)
    for name, a, b in zip(("dq", "dk", "dv", "db"), out, ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=name)
    dead = ~mask & mask.any(dim=1, keepdim=True)       # (B, M)
    assert (out[1].permute(0, 2, 1, 3)[dead] == 0).all()
    assert (out[2].permute(0, 2, 1, 3)[dead] == 0).all()
    assert (out[3].permute(0, 2, 1)[dead] == 0).all()
    again = set_attention_backward(q, k, v, bias, mask, do)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("N", [1, 2, 4])
def test_set_attention_backward_routes_agree(cuda, N):
    """At N <= 4 the small-N kernel against the tiled one: the tiled
    kernel takes the same rows padded to 5 with rows whose output
    cotangent is 0, which add exactly nothing to dk, dv and db (its dS row is 0)
    and leaves the other rows' dq as they are; within the gradient
    bound."""
    from repro_torch.kernels.set_attention.ops import backward_plan
    B, H, M, dh = 8, 4, 64, 64
    assert backward_plan(N, M, dh)["route"] == "small_n"
    assert backward_plan(5, M, dh)["route"] == "tiled"
    g = _gen(cuda, 11 * N)
    q = torch.randn((B, H, 5, dh), generator=g, device=cuda)
    k = torch.randn((B, H, M, dh), generator=g, device=cuda)
    v = torch.randn((B, H, M, dh), generator=g, device=cuda)
    do = torch.randn((B, H, 5, dh), generator=g, device=cuda)
    do[:, :, N:] = 0
    bias = torch.rand((B, M), generator=g, device=cuda)
    mask = torch.rand((B, M), generator=g, device=cuda) < 0.5
    mask[:, 0] = True
    small = set_attention_backward(q[:, :, :N].contiguous(), k, v, bias, mask,
                                   do[:, :, :N].contiguous())
    tiled = set_attention_backward(q, k, v, bias, mask, do)
    torch.testing.assert_close(small[0], tiled[0][:, :, :N], atol=1e-4,
                               rtol=1e-3)
    for name, a, b in zip(("dk", "dv", "db"), small[1:], tiled[1:]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=name)


def test_set_attention_autograd_runs_the_backward_kernel(cuda):
    """On CUDA inputs that require grad, `masked_set_attention` goes
    through the autograd Function: one forward and one backward launch,
    gradients for q, k, v and the bias (summed over heads) equal to the
    plain backward's."""
    g = _gen(cuda, 3)
    B, H, N, M, dh = 4, 4, 9, 21, 32
    q, k, v = (torch.randn((B, H, n, dh), generator=g, device=cuda,
                           requires_grad=True) for n in (N, M, M))
    bias = torch.rand((B, M), generator=g, device=cuda, requires_grad=True)
    mask = torch.rand((B, M), generator=g, device=cuda) < 0.6
    mask[:, 0] = True
    do = torch.randn((B, H, N, dh), generator=g, device=cuda)
    fwd, bwd = masked_set_attention.launches, set_attention_backward.launches
    out = masked_set_attention(q, k, v, bias, mask)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v, bias), do)
    assert (masked_set_attention.launches, set_attention_backward.launches) \
        == (fwd + 1, bwd + 1)
    dq, dk, dv, db = set_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), bias.detach(), mask, do)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads,
                          (dq, dk, dv, db.sum(1))):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=name)


@pytest.mark.parametrize("B,S,H,dh,state", [(4, 128, 6, 64, True),
                                            (2, 1, 3, 64, True),
                                            (3, 13, 2, 48, False),
                                            (2, 37, 2, 16, True),
                                            (2, 9, 2, 128, True),
                                            (2, 17, 2, 7, True)])
def test_wkv_grads_match_plain(cuda, B, S, H, dh, state):
    """With inputs that require grad, wkv launches the forward kernel
    (writing the states) and, in the backward, the backward kernel: every
    gradient within the plain backward's bound, the forward's y bitwise
    the serving kernel's, two backward launches bitwise equal."""
    from repro_torch.kernels.wkv import wkv_backward, wkv_backward_reference
    g = _gen(cuda, S + dh)
    r, k, v = (torch.randn((B, S, H, dh), generator=g, device=cuda)
               for _ in range(3))
    k = k / k.norm(dim=-1, keepdim=True)
    w = 0.7 + 0.3 * torch.rand((B, S, H, dh), generator=g, device=cuda)
    beta = torch.rand((B, S, H), generator=g, device=cuda)
    s0 = (0.1 * torch.randn((B, H, dh, dh), generator=g, device=cuda)
          if state else None)
    dy = torch.randn((B, S, H, dh), generator=g, device=cuda)
    dsf = torch.randn((B, H, dh, dh), generator=g, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, beta)]
    if state:
        leaves.append(s0.clone().requires_grad_(True))
    before = wkv.launches, wkv_backward.launches
    y, sf = wkv(*leaves[:5], leaves[5] if state else None)
    grads = torch.autograd.grad((y * dy).sum() + (sf * dsf).sum(), leaves)
    torch.cuda.synchronize()
    assert (wkv.launches, wkv_backward.launches) == (before[0] + 1,
                                                     before[1] + 1)
    with torch.no_grad():
        y_serve, _ = wkv(r, k, v, w, beta, s0)
    assert torch.equal(y.detach(), y_serve)
    want = wkv_backward_reference(r, k, v, w, beta, s0, dy, dsf)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "dbeta", "dstate"),
                          grads, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=name)
    again = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(
            wkv(*leaves[:5], leaves[5] if state else None), (dy, dsf))),
        leaves)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_cuda_stage1_grads_match_cpu(cuda, tmp_path):
    """Stage-1 pre-training and triplet gradients on the card (both wkv
    kernels) equal the CPU's (plain versions) on every parameter; then a
    CUDA Trainer takes a pre-training step through the kernels."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.bbe import (
        BBEConfig, BBEEncoder, finetune_triplet_loss, pretrain_loss,
    )
    from repro_torch.data.corpus import SyntheticBinaryCorp
    from repro_torch.kernels.wkv import wkv_backward
    from repro_torch.train import Trainer
    cfg = BBEConfig(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2,
                    num_heads=2, bbe_dim=32, max_len=64)
    corp = SyntheticBinaryCorp(n_functions=40, max_len=cfg.max_len)
    batches = {"pretrain": {"tokens": corp.pretrain_batch(0, 4)["tokens"]},
               "triplet": corp.triplet_batch(0, 3)}
    for what, loss_fn in (("pretrain", pretrain_loss),
                          ("triplet", finetune_triplet_loss)):
        grads = {}
        for dev in ("cpu", cuda):
            model = BBEEncoder(cfg, seed=1).to(dev)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batches[what].items()}
            loss, _ = loss_fn(model, batch)
            named = dict(model.named_parameters())
            gs = torch.autograd.grad(loss, list(named.values()),
                                     allow_unused=True,
                                     materialize_grads=True)
            grads[str(dev)] = {n: x.cpu() for n, x in zip(named, gs)}
        for n, want in grads["cpu"].items():
            torch.testing.assert_close(grads["cuda"][n], want, atol=1e-4,
                                       rtol=1e-3, msg=f"{what} {n}")
    tr = Trainer(pretrain_loss, BBEEncoder(cfg, seed=1).to(cuda),
                 TrainConfig(learning_rate=2e-3, total_steps=2,
                             warmup_steps=1, checkpoint_every=0,
                             checkpoint_dir=str(tmp_path)))
    before = wkv.launches, wkv_backward.launches
    m = tr.step({"tokens": torch.from_numpy(
        batches["pretrain"]["tokens"]).to(cuda)})
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert (wkv.launches - before[0], wkv_backward.launches - before[1]) \
        == (cfg.num_layers, cfg.num_layers)


def test_cuda_stage2_grads_match_cpu(cuda, tmp_path):
    """Stage-2 loss gradients on the card (both set-attention kernels)
    equal the CPU's (plain versions) on every parameter: no parameter is
    left without a gradient. Then a CUDA Stage2Engine takes a step."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.signature import (
        SignatureConfig, SignatureModel, stage2_loss_from_rows,
    )
    from repro_torch.train import Stage2Engine
    cfg = SignatureConfig(bbe_dim=32, d_model=32, sig_dim=16, max_set=48,
                          num_heads=2)
    rng = np.random.RandomState(0)
    V, B, N = 50, 6, cfg.max_set
    matrix = np.concatenate([rng.randn(V, cfg.bbe_dim),
                             np.zeros((1, cfg.bbe_dim))]).astype(np.float32)
    batch = {"cpi": rng.uniform(0.5, 4.0, B).astype(np.float32)}
    for role in ("anchor", "positive", "negative"):
        mask = rng.rand(B, N) > 0.5
        mask[:, 0] = True
        batch[role] = {"rows": np.where(mask, rng.randint(V, size=(B, N)), V),
                       "freqs": np.where(mask, rng.uniform(1, 500, (B, N)),
                                         0).astype(np.float32),
                       "mask": mask}

    def on(dev):
        def move(t):
            return ({k: move(x) for k, x in t.items()} if isinstance(t, dict)
                    else torch.from_numpy(np.asarray(t)).to(dev))
        return move(batch)

    grads = {}
    for dev in ("cpu", cuda):
        model = SignatureModel(cfg, seed=1).to(dev)
        loss, _ = stage2_loss_from_rows(model, cfg,
                                        torch.from_numpy(matrix).to(dev),
                                        on(dev))
        names = [n for n, _ in model.named_parameters()]
        gs = torch.autograd.grad(loss, list(model.parameters()),
                                 allow_unused=True)
        assert all(x is not None for x in gs)
        grads[str(dev)] = {n: x.cpu() for n, x in zip(names, gs)}
    for n, want in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][n], want, atol=1e-4,
                                   rtol=1e-3, msg=n)
    eng = Stage2Engine(cfg, SignatureModel(cfg, seed=1).to(cuda), matrix,
                       TrainConfig(learning_rate=1e-3, total_steps=2,
                                   warmup_steps=1, checkpoint_every=0,
                                   checkpoint_dir=str(tmp_path)))
    before = set_attention_backward.launches
    m = eng.step(on(cuda))
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert set_attention_backward.launches == before + 9


def _km_clustered(dev, g, N, d, K):
    centres = torch.randn((K, d), generator=g, device=dev)
    x = centres[torch.randint(K, (N,), generator=g, device=dev)]
    x = (x + 0.05 * torch.randn((N, d), generator=g, device=dev)).contiguous()
    c = (centres + 0.01 * torch.randn((K, d), generator=g,
                                      device=dev)).contiguous()
    return x, c


def _km_valid(dev, g, N, mask):
    if mask == "prefix":
        return (torch.arange(N, device=dev) < (3 * N) // 4 + 1).float()
    return (torch.rand((N,), generator=g, device=dev) < 0.7).float()


@pytest.mark.parametrize("mask", ["holes", "prefix"])
@pytest.mark.parametrize("N,d,K", [(32768, 128, 14), (1000, 64, 14),
                                   (513, 32, 30), (77, 200, 5),
                                   (77, 200, 30), (300, 7, 9),
                                   (1000, 15, 10)])
def test_kmeans_kernels_match_plain(cuda, N, d, K, mask):
    g = _gen(cuda, N)
    x, c = _km_clustered(cuda, g, N, d, K)
    a, d2 = kmeans_assign(x, c)
    a_ref, d2_ref = kmeans_assign_reference(x, c)
    assert torch.equal(a, a_ref)
    torch.testing.assert_close(d2, d2_ref, atol=1e-3, rtol=0)
    valid = _km_valid(cuda, g, N, mask)
    out = kmeans_update(x, c, valid)
    s_ref, n_ref, i_ref = kmeans_update_reference(x, c, valid)
    assert torch.equal(out[1], n_ref)
    torch.testing.assert_close(out[0], s_ref, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(out[2], i_ref[0], atol=1e-3, rtol=1e-4)
    again = kmeans_update(x, c, valid)
    assert all(torch.equal(p, q) for p, q in zip(out, again))
    # valid=None (no weights read): every row weighs 1
    s1, n1, i1 = kmeans_update(x, c)
    s_ref, n_ref, i_ref = kmeans_update_reference(
        x, c, torch.ones((N,), device=cuda))
    assert torch.equal(n1, n_ref)
    torch.testing.assert_close(s1, s_ref, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(i1, i_ref[0], atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("mask", ["holes", "prefix"])
def test_kmeans_update_is_blind_to_dead_rows(cuda, mask):
    """Sums, counts and inertia depend only on the live rows and their
    indices, bit for bit: other finite values in the dead rows, and the
    capacity doubled (32,768 -> 65,536 rows, the new ones dead)."""
    N, d, K = 32768, 128, 14
    g = _gen(cuda, 5)
    x, c = _km_clustered(cuda, g, N, d, K)
    valid = (_km_valid(cuda, g, N, "holes") if mask == "holes" else
             (torch.arange(N, device=cuda) < 18000).float())
    want = kmeans_update(x, c, valid)
    dead = valid == 0
    x_other = x.clone()
    x_other[dead] = 10.0 * torch.randn((int(dead.sum()), d), generator=g,
                                       device=cuda)
    x_big = torch.cat([x, torch.randn((N, d), generator=g, device=cuda)])
    v_big = torch.cat([valid, torch.zeros((N,), device=cuda)])
    for args in ((x_other, c, valid), (x_big, c, v_big)):
        got = kmeans_update(*args)
        assert all(torch.equal(p, q) for p, q in zip(got, want))


@pytest.mark.parametrize("N,d,K", [(256, 16, 5), (32768, 128, 14),
                                   (1000, 13, 9), (777, 20, 30),
                                   (300, 200, 4)])
def test_kmeans_bf16_instances_bitwise_fp32(cuda, N, d, K):
    """bf16 rows (16-byte and element routes, ragged N): labels, d2, sums,
    counts and inertia bitwise the fp32 instances' on the upcast rows;
    against the plain version at JAX's bf16 bounds (labels exact, d2
    atol 1.0 / rtol 1e-2); bf16 centroids are widened first."""
    g = _gen(cuda, N)
    x32, c = _km_clustered(cuda, g, N, d, K)
    x = x32.to(torch.bfloat16)
    up = x.float()
    valid = _km_valid(cuda, g, N, "holes")
    n0 = kmeans_assign.launches_bf16
    a, d2 = kmeans_assign(x, c)
    a32, d232 = kmeans_assign(up, c)
    assert kmeans_assign.launches_bf16 == n0 + 1
    assert torch.equal(a, a32) and torch.equal(d2, d232)
    a_ref, d2_ref = kmeans_assign_reference(x, c)
    assert torch.equal(a, a_ref)
    torch.testing.assert_close(d2, d2_ref, atol=1.0, rtol=1e-2)
    out, out32 = kmeans_update(x, c, valid), kmeans_update(up, c, valid)
    assert all(torch.equal(p, q) for p, q in zip(out, out32))
    cb = c.to(torch.bfloat16)
    assert all(torch.equal(p, q) for p, q in zip(
        kmeans_update(x, cb, valid), kmeans_update(up, cb.float(), valid)))


@pytest.mark.parametrize("d,K", [(128, 14), (200, 30), (8, 4), (64, 8),
                                 (7, 5), (256, 9)])
def test_kmeans_plan_matches_the_kernels(cuda, d, K):
    """kmeans_plan's shared bytes are what each kernel's launch asks for,
    fp32 and bf16 instances (cudaFuncGetAttributes through
    rt_kmeans_*_attributes)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.kmeans_assign.ops import kmeans_plan
    for entry in ("rt_kmeans_assign_attributes",
                  "rt_kmeans_update_attributes"):
        for dtype in (torch.float32, torch.bfloat16):
            a = _lib.kernel_attributes(entry, int(dtype == torch.bfloat16),
                                       d, K)
            assert a["static_smem"] == 0, entry
            assert a["dynamic_smem"] == \
                kmeans_plan(1, d, K, dtype)["shared_bytes"], (entry, dtype)


def test_wrappers_check_their_inputs(cuda):
    x = torch.zeros((8, 4), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        kmeans_assign(x, torch.zeros((2, 4), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        kmeans_assign(torch.zeros((8, 4), device=cuda), torch.zeros((2, 4)))
    q = torch.zeros((1, 1, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        masked_set_attention(q, q.transpose(2, 3), q)


def test_service_on_card_matches_cpu(cuda):
    """A tiny service run on the card (kernels) and on the CPU (plain
    versions) from one seed: same signatures, same estimates when the
    build starts from the same centroids."""
    from repro_torch.api import SemanticBBVService, ServiceConfig
    from repro_torch.core.bbe import BBEConfig
    from repro_torch.core.signature import SignatureConfig
    from repro_torch.data.asmgen import spec_programs
    from repro_torch.data.perfmodel import interval_cpi
    from repro_torch.data.trace import trace_program
    programs = spec_programs("int")[:4]
    blocks = {b.bid: b for p in programs for b in p.unique_blocks}
    ivs = {p.name: trace_program(p, 24) for p in programs}
    cfg = ServiceConfig(
        bbe=BBEConfig(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2,
                      num_heads=2, bbe_dim=32, max_len=64),
        sig=SignatureConfig(bbe_dim=32, d_model=32, sig_dim=16, max_set=48,
                            num_heads=2), k=4)
    runs = {}
    init = None
    for dev in ("cpu", "cuda"):
        svc = SemanticBBVService.create(cfg, device=dev)
        svc.ingest_blocks(list(blocks.values()))
        for n, v in ivs.items():
            svc.ingest_intervals(n, v, cpis=[interval_cpi(iv, blocks)
                                             for iv in v])
        if init is None:
            x = svc.store.signatures
            init = np.stack([x[[0, 30, 60, 90]]] * 3)
        svc.build(init_centroids=init)
        runs[dev] = (np.asarray(svc.store.signatures),
                     {n: svc.estimate(n).est_cpi for n in ivs})
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4)
    for n in ivs:
        np.testing.assert_allclose(runs["cuda"][1][n], runs["cpu"][1][n],
                                   rtol=1e-3)


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,dtype", [
    (2, 130, 130, 4, 2, 64, True, 0, "float32"),
    (1, 200, 300, 4, 2, 100, False, 0, "float32"),
    (1, 1000, 1000, 4, 1, 64, True, 0, "float32"),
    (1, 80, 48, 2, 2, 16, True, 40, "float32"),
    (1, 512, 512, 9, 3, 64, True, 128, "bfloat16"),
    (1, 448, 1500, 6, 6, 64, False, 0, "bfloat16"),
    (1, 256, 256, 32, 8, 128, True, 0, "bfloat16"),
    (1, 300, 300, 8, 1, 256, False, 0, "bfloat16")])
def test_flash_kernel_matches_plain(cuda, B, S, T, H, K, D, causal, window,
                                    dtype):
    g = _gen(cuda, S + T)
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(dt)
    k = torch.randn((B, T, K, D), generator=g, device=cuda).to(dt)
    v = torch.randn((B, T, K, D), generator=g, device=cuda).to(dt)
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert o.dtype == dt and o.shape == q.shape
    atol = 2e-5 if dtype == "float32" else 3e-2     # the JAX suite's bounds
    torch.testing.assert_close(o.float(), attention_reference(
        q, k, v, causal=causal, window=window).float(), atol=atol, rtol=1e-2)


def test_flash_kernel_reads_strides_in_place(cuda):
    """q, k, v as views of one fused projection (head and sequence strides
    that are not the contiguous ones) give the contiguous copies' result."""
    g = _gen(cuda, 5)
    B, S, H, K, D = 2, 100, 4, 2, 32
    qkv = torch.randn((B, S, (H + 2 * K) * D), generator=g, device=cuda)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + K) * D].view(B, S, K, D)
    v = qkv[..., (H + K) * D:].view(B, S, K, D)
    assert not q.is_contiguous()
    o = flash_attention(q, k, v)
    torch.testing.assert_close(o, flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous()), atol=0, rtol=0)
    torch.testing.assert_close(o, attention_reference(q, k, v), atol=2e-5,
                               rtol=1e-2)


def test_flash_raises_on_grad_fp16_and_wide_heads(cuda):
    """An input that requires a gradient now runs the forward's `LSE`
    instance and, in the backward, the backward kernel (it used to
    raise); fp16, head dims past 256 and a non-unit head-dim stride still
    raise."""
    q = torch.randn((1, 8, 2, 16), device=cuda, requires_grad=True)
    kv = torch.randn((1, 8, 1, 16), device=cuda)
    before = (flash_attention.launches, flash_attention_backward.launches)
    flash_attention(q, kv, kv).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (before[0] + 1, before[1] + 1)
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    with torch.no_grad():
        flash_attention(q, kv, kv)
    h = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(h, h[:, :, :1], h[:, :, :1])
    w = torch.zeros((1, 8, 2, 264), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(w, w[:, :, :1], w[:, :, :1])
    with pytest.raises(ValueError):
        flash_attention(q.detach()[:, :, :, :8].transpose(2, 3), kv, kv)


# (B, S, T, H, K, D, causal, window, prefix_len): causal, full, window,
# prefix (cutting a key tile, with a window), S != T, ragged T, GQA, D 80;
# the last row: D 256 (two warpgroups splitting the columns in bf16) over
# 8 query heads and a ragged cross T
FLASH_BWD_CASES = [
    (2, 130, 130, 4, 2, 64, True, 0, 0),
    (1, 200, 300, 4, 2, 100, False, 0, 0),
    (1, 257, 257, 6, 3, 64, True, 100, 0),
    (1, 96, 1500, 6, 6, 64, False, 0, 0),
    (1, 300, 300, 8, 1, 256, True, 0, 100),
    (1, 300, 300, 8, 2, 80, True, 64, 150),
    (1, 200, 200, 4, 4, 128, True, 0, 0),
    (1, 150, 150, 4, 1, 256, False, 0, 0),
    (1, 130, 333, 8, 1, 256, False, 0, 0)]


def _bwd_inputs(dev, B, S, T, H, K, D, dt, seed):
    g = _gen(dev, seed)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, T, K, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, T, K, D), generator=g, device=dev).to(dt)
    do = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    return q, k, v, do


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,P", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda, B, S, T, H, K, D, causal,
                                             window, P, dtype):
    """The forward's log-sum-exp against the plain one, and the backward
    kernel against `attention_backward_reference` on the same q, k, v, o,
    dO and lse: fp32 within the wkv backward's 1e-4 + 1e-3; bf16 (both
    compute in fp32 and round once) within 1e-2 + 1e-2 and a relative L2
    error of 1e-2."""
    dt = getattr(torch, dtype)
    q, k, v, do = _bwd_inputs(cuda, B, S, T, H, K, D, dt, S + T + D)
    kw = dict(causal=causal, window=window, prefix_len=P)
    o, lse = flash_forward(q, k, v, return_lse=True, **kw)
    _, lse_ref = attention_reference(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4 if dtype ==
                               "float32" else 2e-2, rtol=1e-4)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    want = attention_backward_reference(q, k, v, o, do, lse, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dt and a.shape == b.shape, name
        if dtype == "float32":
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=name)
        else:
            torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                       rtol=1e-2, msg=name)
            assert _rel_l2(a, b) <= 1e-2, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_autograd_runs_the_backward_kernel(cuda, dtype):
    """Autograd through flash on the card: one `LSE` forward and one
    backward launch, gradients of views of a fused projection against
    autograd of the plain version (fp32 1e-4 + 1e-3; bf16 a relative L2
    error of 1e-2: the kernel rounds P before P V and takes delta from
    the stored o), and two runs give the same bits."""
    dt = getattr(torch, dtype)
    B, S, H, K, D = 2, 300, 6, 2, 64
    g = _gen(cuda, 11)
    qkv0 = torch.randn((B, S, (H + 2 * K) * D), generator=g, device=cuda)
    do = torch.randn((B, S, H, D), generator=g, device=cuda).to(dt)

    def grads(fn):
        qkv = qkv0.to(dt).requires_grad_()
        q = qkv[..., :H * D].view(B, S, H, D)
        k = qkv[..., H * D:(H + K) * D].view(B, S, K, D)
        v = qkv[..., (H + K) * D:].view(B, S, K, D)
        (fn(q, k, v, prefix_len=40) * do).sum().backward()
        return qkv.grad

    before = (flash_attention.launches, flash_attention_backward.launches)
    got = grads(flash_attention)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, grads(flash_attention))
    want = grads(attention_reference)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    else:
        assert _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,P", [(64, 0), (128, 0), (256, 0), (64, 100),
                                 (256, 100)])
def test_flash_lse_instances_keep_the_output_and_repeat(cuda, D, P, dtype):
    """The `LSE` instance's output is bitwise the flagged-off one's, and
    two backward launches give the same bits."""
    dt = getattr(torch, dtype)
    q, k, v, do = _bwd_inputs(cuda, 2, 333, 333, 4, 2, D, dt, D + P)
    o, lse = flash_forward(q, k, v, prefix_len=P, return_lse=True)
    assert torch.equal(o, flash_forward(q, k, v, prefix_len=P))
    first = flash_attention_backward(q, k, v, o, do, lse, prefix_len=P)
    again = flash_attention_backward(q, k, v, o, do, lse, prefix_len=P)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("D", [64, 256])
def test_flash_backward_load_routes_are_bitwise(cuda, D):
    """The bf16 backward's three ways of loading a tile give the same bits:
    TMA (contiguous rows), 16-byte cp.async (a head-major view, whose
    strides do not grow with its dims: no tensor map) and element loads
    (q at an odd offset)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 200, 200, 4, 2, D, torch.bfloat16, D)
    o, lse = flash_forward(q, k, v, prefix_len=40, return_lse=True)
    want = flash_attention_backward(q, k, v, o, do, lse, prefix_len=40)
    heads = q.transpose(1, 2).contiguous().transpose(1, 2)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    odd = buf[1:].view(q.shape)
    odd.copy_(q)
    for name, view in (("head-major", heads), ("odd offset", odd)):
        assert torch.equal(view, q)
        got = flash_attention_backward(view, k, v, o, do, lse, prefix_len=40)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name


def test_flash_backward_resources_fit_a_block(cuda):
    """Each backward instance's dynamic shared bytes, as its attributes
    entry reports them, fit a block of the H100 (232,448 bytes), and no
    bf16 (wgmma) instance spills; registers and spills are printed."""
    from repro_torch.kernels import _lib
    for bf16 in (0, 1):
        for D in (64, 128, 256):
            for prefix in (0, 1):
                for kernel in (1, 2):
                    a = _lib.kernel_attributes(
                        "rt_flash_attention_backward_attributes", bf16, D,
                        prefix, kernel)
                    print(bf16, D, prefix, kernel, a)
                    assert 0 < a["dynamic_smem"] <= 232448
                    if bf16:
                        assert a["local_bytes"] == 0, (D, prefix, kernel)
            for lse in (0, 1):
                a = _lib.kernel_attributes("rt_flash_attention_attributes",
                                           bf16, D, 0, lse)
                print("forward", bf16, D, lse, a)


@pytest.mark.parametrize("arch", ["smollm_135m", "whisper_tiny",
                                  "paligemma_3b", "semanticbbv_encoder"])
def test_zoo_loss_grads_on_card_match_cpu(cuda, arch):
    """`Model.loss` and every parameter's gradient of a scaled-down arch
    (fp32), on the card (flash forward and backward kernels; wkv for the
    encoder) against the CPU, per leaf within 1e-4 max(1, max|g|)."""
    import dataclasses
    from repro_torch.config import get_arch, scaled_down
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models.model_zoo import build_model
    cfg = dataclasses.replace(scaled_down(get_arch(arch)), dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, device=dev)
        batch = lm_batch_fn(cfg.vocab_size, 2, 96, cfg, dev)(3)
        before = flash_attention_backward.launches
        loss, _ = model.loss(params, batch)
        names, leaves = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        runs[dev] = (float(loss), {n: g.cpu() for n, g in zip(names, grads)},
                     flash_attention_backward.launches - before)
    n_attn = sum(k == "attn" for k in cfg.blocks()) * (
        2 if cfg.cross_attention else 1) + cfg.encoder_layers
    assert runs["cpu"][2] == 0 and runs["cuda"][2] == n_attn
    assert abs(runs["cpu"][0] - runs["cuda"][0]) <= 1e-4 * max(
        1.0, abs(runs["cpu"][0]))
    for name, want in runs["cpu"][1].items():
        got = runs["cuda"][1][name]
        bound = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= bound, name


def test_zoo_on_card_matches_cpu(cuda):
    """A small dense decoder (fp32) on the card and on the CPU from one
    seed: the same hidden states (one flash launch a layer), and the same
    greedy tokens from the ServeEngine."""
    from repro_torch.config import get_arch, scaled_down
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = scaled_down(get_arch("qwen3_4b"), num_layers=3, d_model=128,
                      num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
    model = build_model(cfg)
    tokens = np.random.RandomState(0).randint(0, 512, (2, 150))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, device=dev)
        before = flash_attention.launches
        hidden, _ = model.prefill(params, {"tokens": tokens})
        launches = flash_attention.launches - before
        eng = ServeEngine(model, params, num_slots=2, max_seq=64, device=dev)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=list(tokens[0, :5 + 7 * i]),
                               max_new=8))
        runs[dev] = (hidden.cpu(), launches,
                     {r: q.out for r, q in eng.run().items()})
    assert runs["cpu"][1] == 0 and runs["cuda"][1] == cfg.num_layers
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], atol=1e-4,
                               rtol=1e-3)
    assert runs["cuda"][2] == runs["cpu"][2]


@pytest.mark.parametrize("B,H,N,M,dh,empty", [
    (3, 3, 1, 130, 64, 1),     # the PMA's one query, past one key tile
    (5, 3, 2, 40, 64, 1),      # 15 (b, h): a block of 8 warps half full
    (3, 3, 4, 13, 44, 0),      # the largest N of the warp-per-(b, h) kernel
    (2, 2, 70, 150, 64, 1),    # two query tiles, three key tiles
    (2, 2, 9, 21, 128, 1),     # dh 128 and 200: two and four column blocks
    (2, 2, 5, 13, 200, 1),
    (2, 2, 3, 13, 7, 1)])      # dh % 4 != 0: scalar loads
def test_set_attention_forward_kernels_match_plain(cuda, B, H, N, M, dh,
                                                   empty):
    """Both forward kernels (register tiles for N > 4, a warp per (b, h)
    for N <= 4) against the plain version at 1e-5; two launches give the
    same bits."""
    g = _gen(cuda, 3 * N + M + dh)
    q = torch.randn((B, H, N, dh), generator=g, device=cuda)
    k = torch.randn((B, H, M, dh), generator=g, device=cuda)
    v = torch.randn((B, H, M, dh), generator=g, device=cuda)
    bias = torch.rand((B, M), generator=g, device=cuda)
    mask = torch.rand((B, M), generator=g, device=cuda) < 0.5
    mask[:, 0] = True
    mask[B - empty:] = False
    before = masked_set_attention.launches
    o = masked_set_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert masked_set_attention.launches == before + 1
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, set_attention_reference(q, k, v, bias,
                                                          mask),
                               atol=1e-5, rtol=0)
    assert torch.equal(o, masked_set_attention(q, k, v, bias, mask))


def test_set_attention_forward_unaligned_rows(cuda):
    """q at an odd element offset takes the scalar loads and gives the
    bits of the aligned copy."""
    g = _gen(cuda, 11)
    B, H, N, M, dh = 4, 2, 64, 64, 64
    q, k, v = (torch.randn((B, H, n, dh), generator=g, device=cuda)
               for n in (N, M, M))
    bias = torch.rand((B, M), generator=g, device=cuda)
    buf = torch.empty(q.numel() + 1, device=cuda)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    assert q_odd.is_contiguous() and q_odd.data_ptr() % 16
    assert torch.equal(masked_set_attention(q_odd, k, v, bias),
                       masked_set_attention(q, k, v, bias))


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", [
    (2, 300, 300, 4, 2, 64, True, 0),
    (1, 200, 333, 4, 4, 80, False, 0),     # D 80, S != T, ragged T
    (1, 257, 257, 8, 2, 128, True, 96),    # windowed, ragged
    (1, 130, 190, 4, 1, 256, True, 0),     # D 256: one warpgroup a block
    (1, 64, 64, 2, 1, 16, True, 0),
    (1, 90, 90, 2, 1, 36, True, 0)])       # D % 8 != 0: element loads
def test_flash_bf16_wgmma_kernel_matches_plain(cuda, B, S, T, H, K, D,
                                               causal, window):
    """The bf16 (wgmma) kernel against the plain version at the JAX
    suite's bf16 bound; two launches give the same bits."""
    g = _gen(cuda, S + T + D)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, T, K, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, T, K, D), generator=g, device=cuda).bfloat16()
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    torch.testing.assert_close(o.float(), attention_reference(
        q, k, v, causal=causal, window=window).float(), atol=3e-2, rtol=1e-2)
    assert torch.equal(o, flash_attention(q, k, v, causal=causal,
                                          window=window))


def test_flash_bf16_fused_projection_view_is_bitwise(cuda):
    """bf16 q, k, v as views of one fused projection (16-byte loads
    through the strides) give the contiguous copies' bits."""
    from repro_torch.kernels._lib import rows_aligned_16
    g = _gen(cuda, 9)
    B, S, H, K, D = 2, 333, 9, 3, 64
    qkv = torch.randn((B, S, (H + 2 * K) * D), generator=g,
                      device=cuda).bfloat16()
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + K) * D].view(B, S, K, D)
    v = qkv[..., (H + K) * D:].view(B, S, K, D)
    assert rows_aligned_16(q, k, v) and not q.is_contiguous()
    assert torch.equal(flash_attention(q, k, v), flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous()))


# ------------------------------------------ store lifecycle and SimPoint

def _unit_rows(dev, g, n, d, k=6):
    centres = torch.randn((k, d), generator=g, device=dev)
    idx = torch.randint(k, (n,), generator=g, device=dev)
    x = centres[idx] + 0.1 * torch.randn((n, d), generator=g, device=dev)
    return (x / x.norm(dim=-1, keepdim=True)).cpu().numpy()


def _lifecycle_stores(dev, evict=True):
    """A store on `dev` with 3 programs x 400 rows of 128 (capacity
    2,048), 40% of its rows evicted and compacted, and a fresh store of
    the same live rows."""
    from repro_torch.api import SignatureStore
    g = _gen(dev, 11)
    x = _unit_rows(dev, g, 1200, 128)
    cpis = np.linspace(0.8, 3.0, 1200).astype(np.float32)
    w = np.arange(1200, dtype=np.float32) + 1.0
    store = SignatureStore(128, device=dev)
    for p in range(3):
        rows = slice(400 * p, 400 * (p + 1))
        store.add(f"p{p}", x[rows], w[rows], cpis[rows])
    _ = store.device_matrix
    dead = np.random.RandomState(0).rand(1200) < 0.4
    if evict:
        store.evict(np.flatnonzero(dead))
        store.compact()
    fresh = SignatureStore(128, device=dev)
    for p in range(3):
        keep = np.flatnonzero(~dead[400 * p:400 * (p + 1)]) + 400 * p
        fresh.add(f"p{p}", x[keep], w[keep], cpis[keep])
    return store, fresh


def test_compact_gather_is_a_fresh_upload_bitwise(cuda):
    store, fresh = _lifecycle_stores(cuda)
    assert store.capacity == fresh.capacity == 1024
    got = store.device_matrix
    assert got.device.type == "cuda"
    want = torch.tensor(fresh.signatures.copy(), device=cuda)
    want = torch.cat([want, torch.zeros((1024 - len(fresh), 128),
                                        device=cuda)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32),
                       fresh.device_matrix.view(torch.int32))


def test_postcompact_build_is_a_fresh_stores_bitwise(cuda):
    """The same live rows, the same capacity, the same seeds and
    kmeans_update without atomics: a build over the compacted store is
    bitwise a build over the fresh one, 75 + 4 launches each."""
    from repro_torch.api import KnowledgeBase
    kbs = []
    for store in _lifecycle_stores(cuda):
        u0, a0 = kmeans_update.launches, kmeans_assign.launches
        kbs.append(KnowledgeBase(store).build(k=14, seed=0))
        assert (kmeans_update.launches - u0, kmeans_assign.launches - a0) \
            == (75, 4)
    kb1, kb2 = kbs
    np.testing.assert_array_equal(kb1.archetypes, kb2.archetypes)
    np.testing.assert_array_equal(kb1.rep_global_idx, kb2.rep_global_idx)
    np.testing.assert_array_equal(kb1._all_row_assign(),
                                  kb2._all_row_assign())
    for p in kb1.fingerprints:
        np.testing.assert_array_equal(kb1.fingerprints[p],
                                      kb2.fingerprints[p])


def test_vacuum_save_load_round_trip_on_the_card(cuda, tmp_path):
    """Vacuum (LRU) re-pins on the card; the store and base saved there
    reload there with bitwise the same estimates and arrays, and the
    archetypes back on the card."""
    from repro_torch.api import (
        EvictionPolicy, KnowledgeBase, SignatureStore, vacuum,
    )
    store, _ = _lifecycle_stores(cuda, evict=False)
    kb = KnowledgeBase(store).build(k=14, seed=0)
    for p in ("p1", "p2"):
        store.touch(store.rows_for(p))
    rep_cpi = kb.rep_cpi.copy()
    on_p0 = sum(p == "p0" for p in kb.rep_program)
    before = {p: kb.estimate(p) for p in ("p1", "p2")}
    report = vacuum(store, kb, EvictionPolicy(max_rows=800))
    assert (report.evicted, report.rows_after, report.capacity_after) == \
        (400, 800, 1024)
    assert report.repinned == on_p0 and "p0" not in kb.rep_program
    np.testing.assert_array_equal(kb.rep_cpi, rep_cpi)
    assert store.alive_mask[kb.rep_global_idx].all()
    for p, e in before.items():
        assert kb.estimate(p).est_cpi == e.est_cpi
    store.save(str(tmp_path / "store"))
    kb.save(str(tmp_path / "kb"))
    store2 = SignatureStore.load(str(tmp_path / "store"))
    kb2 = KnowledgeBase.load(str(tmp_path / "kb"), store2)
    assert kb2._archetypes_dev.device.type == "cuda"
    assert torch.equal(store2.device_matrix.view(torch.int32),
                       store.device_matrix.view(torch.int32))
    np.testing.assert_array_equal(kb2.rep_global_idx, kb.rep_global_idx)
    for p in ("p1", "p2"):
        a, b = kb2.estimate(p), kb.estimate(p)
        assert (a.est_cpi, a.true_cpi, a.accuracy) == \
            (b.est_cpi, b.true_cpi, b.accuracy)
    sigs = store.signatures[:50]
    np.testing.assert_array_equal(kb2.attach("q", signatures=sigs),
                                  kb.attach("q", signatures=sigs))


def _labels_agree(x, c, got, want, tie=1e-5):
    """Labels equal except at rows whose two nearest centroids (of `c`)
    are within `tie` in squared distance."""
    x = np.asarray(x, np.float64)
    c = np.asarray(c, np.float64)
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    differ = got != want
    return bool((two[differ, 1] - two[differ, 0] <= tie).all())


@pytest.mark.parametrize("n,d,k", [(1000, 15, 10), (1000, 128, 10)])
def test_kmeans_on_card_matches_cpu(cuda, n, d, k):
    """The host k-means of SimPoint on the card (kernels) and on the CPU
    (plain versions) from the same seeds: the same labels (ties within
    1e-5 aside), representatives and best restart, centroids within 1e-4,
    and 3 x 25 kmeans_update and 3 kmeans_assign launches."""
    from repro_torch.core.clustering import kmeans, kmeans_pp_init
    from repro_torch.core.simpoint import run_simpoint
    x = _unit_rows(cuda, _gen(cuda, d), n, d)
    xt = torch.from_numpy(x)
    init = torch.stack([kmeans_pp_init(torch.Generator().manual_seed(r),
                                       xt, k) for r in range(3)])
    u0, a0 = kmeans_update.launches, kmeans_assign.launches
    c_dev, a_dev, i_dev = kmeans(x, k, device="cuda", init_centroids=init)
    assert (kmeans_update.launches - u0, kmeans_assign.launches - a0) == \
        (75, 3)
    c_cpu, a_cpu, i_cpu = kmeans(x, k, device="cpu", init_centroids=init)
    assert _labels_agree(x, c_cpu, a_dev, a_cpu)
    np.testing.assert_allclose(c_dev, c_cpu, atol=1e-4)
    np.testing.assert_allclose(i_dev, i_cpu, rtol=1e-4)
    cpis = np.linspace(1.0, 2.0, n)
    r_dev = run_simpoint(x, cpis, k=k, device="cuda", init_centroids=init)
    r_cpu = run_simpoint(x, cpis, k=k, device="cpu", init_centroids=init)
    np.testing.assert_array_equal(r_dev.rep_indices, r_cpu.rep_indices)
    assert np.isfinite(r_dev.accuracy)


def test_wkv_decode_step_reads_a_cache_view(cuda):
    """The encoder's decode shape on 8 slots (S 1, H 6, dh 64), the state
    a view of a stacked cache at layer 1: y and the final state against
    the plain version, one launch, and the cache left as it was."""
    B, H, dh = 8, 6, 64
    g = _gen(cuda, 1)
    r, k, v = (torch.randn((B, 1, H, dh), generator=g, device=cuda)
               for _ in range(3))
    k = k / k.norm(dim=-1, keepdim=True)
    w = 0.7 + 0.3 * torch.rand((B, 1, H, dh), generator=g, device=cuda)
    beta = torch.rand((B, 1, H), generator=g, device=cuda)
    cache = 0.1 * torch.randn((3, B, H, dh, dh), generator=g, device=cuda)
    kept = cache.clone()
    before = wkv.launches
    y, sf = wkv(r, k, v, w, beta, cache[1])
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    assert torch.equal(cache, kept)
    y_ref, sf_ref = wkv_reference(r, k, v, w, beta, cache[1])
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(sf, sf_ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ["semanticbbv_encoder", "xlstm_1_3b"])
def test_recurrent_zoo_on_card_matches_cpu(cuda, arch):
    """A small encoder / xLSTM (fp32) on the card and on the CPU from one
    seed: prefill hidden states, then 4 decode steps with row 1 masked
    out (`write`): the same logits and cache leaves, row 1's state still
    zero; the encoder launches wkv once a layer a call on the card, never
    on the CPU."""
    from repro_torch.config import get_arch, scaled_down
    from repro_torch.models.model_zoo import build_model
    cfg = scaled_down(get_arch(arch), num_layers=4, d_model=128,
                      num_heads=2, vocab_size=256)
    model = build_model(cfg)
    tokens = np.random.RandomState(0).randint(0, 256, (3, 40))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = model.init(0, device=dev)
        before = wkv.launches
        hidden, _ = model.prefill(params, {"tokens": tokens})
        cache = model.init_cache(3, 16, torch.float32, device=dev)
        write = torch.tensor([True, False, True], device=dev)
        logits = []
        for t in range(4):
            lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          t, write=write)
            logits.append(lg.cpu())
        runs[dev] = (hidden.cpu(), torch.cat(logits, 1),
                     {(n, k): v.cpu() for n, lv in cache.items()
                      for k, v in lv.items()}, wkv.launches - before)
    n_wkv = cfg.num_layers if arch == "semanticbbv_encoder" else 0
    assert runs["cpu"][3] == 0 and runs["cuda"][3] == 5 * n_wkv
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], atol=1e-4,
                               rtol=1e-3)
    torch.testing.assert_close(runs["cuda"][1], runs["cpu"][1], atol=1e-4,
                               rtol=1e-3)
    for key, leaf in runs["cpu"][2].items():
        assert not leaf[:, 1].any(), key
        torch.testing.assert_close(runs["cuda"][2][key], leaf, atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("gated", [True, False])
def test_moe_apply_on_card_matches_cpu(cuda, gated):
    """`moe_apply` (fp32) on the card against the CPU on the same weights,
    routing first: no difference but flips at near ties (`compare_routing`)
    and the slots they move; then the output on the groups without a
    difference. Capacity factor 1.0: pairs are dropped."""
    from repro_torch.models import moe
    mod = moe.MoE(torch.Generator().manual_seed(0), 256, 384, 16,
                  torch.float32, gated=gated)
    x = torch.randn((4, 200, 256), generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", cuda):
        mod = mod.to(dev)
        with torch.inference_mode():
            r = moe.route(mod.router, x.to(dev), 4, 1.0)
            out, aux = mod(x.to(dev), top_k=4, capacity_factor=1.0)
        runs.append((r, out.cpu(), aux.cpu()))
    (r_cpu, o_cpu, a_cpu), (r_dev, o_dev, a_dev) = runs
    cmp = moe.compare_routing(r_cpu, r_dev)
    assert cmp["n_unexplained"] == 0, cmp
    assert int((~r_cpu.kept).sum()) > 0
    clean = cmp["clean_groups"]
    assert bool(clean.any())
    g = r_cpu.idx.shape[1]
    torch.testing.assert_close(o_dev.reshape(-1, g, 256)[clean],
                               o_cpu.reshape(-1, g, 256)[clean], atol=1e-4,
                               rtol=1e-3)
    if cmp["n_flips"] == 0:
        torch.testing.assert_close(a_dev, a_cpu, atol=0, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b",
                                  "jamba_1_5_large_398b"])
def test_moe_zoo_on_card_matches_cpu(cuda, arch):
    """A small MoE model (fp32) on the card and on the CPU from one seed,
    routing first in every MoE layer (no difference but flips at near
    ties); then the prefill's hidden states on the groups that no layer
    flipped, the aux loss, one flash launch an attention layer, and 4
    decode steps' logits up to the first step that flips."""
    from repro_torch.config import get_arch, scaled_down
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    cfg = scaled_down(get_arch(arch), num_layers=8 if "jamba" in arch else 2,
                      d_model=128, num_heads=4, d_ff=256, vocab_size=512,
                      num_experts=8)
    model = build_model(cfg)
    tokens = np.random.RandomState(0).randint(0, 512, (2, 40))
    runs = []
    for dev in ("cpu", cuda):
        params = model.init(0, device=dev)
        before = flash_attention.launches
        with moe.record_routing(params) as prefill_routes:
            hidden, aux = model.prefill(params, {"tokens": tokens})
        launches = flash_attention.launches - before
        cache = model.init_cache(2, 16, torch.float32, device=dev)
        logits = []
        with moe.record_routing(params) as decode_routes:
            for t in range(4):
                lg, cache = model.decode_step(params, cache,
                                              tokens[:, t:t + 1], t)
                logits.append(lg.cpu())
        runs.append((hidden.cpu(), aux.cpu(), launches, prefill_routes,
                     decode_routes, logits))
    cpu, card = runs
    n_attn = sum(kind == "attn" for kind in cfg.blocks())
    assert cpu[2] == 0 and card[2] == n_attn
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert len(cpu[3]) == len(card[3]) == n_moe
    clean = torch.ones(1, dtype=torch.bool)
    for a, b in zip(cpu[3], card[3]):
        cmp = moe.compare_routing(a, b)
        assert cmp["n_unexplained"] == 0, cmp
        clean = clean & cmp["clean_groups"]
    g = cpu[3][0].idx.shape[1]
    torch.testing.assert_close(card[0].reshape(-1, g, cfg.d_model)[clean],
                               cpu[0].reshape(-1, g, cfg.d_model)[clean],
                               atol=1e-4, rtol=1e-3)
    if bool(clean.all()):
        torch.testing.assert_close(card[1], cpu[1], atol=0, rtol=1e-5)
    for t in range(4):
        step = [moe.compare_routing(a, b) for a, b in
                zip(cpu[4][t * n_moe:(t + 1) * n_moe],
                    card[4][t * n_moe:(t + 1) * n_moe])]
        assert all(c["n_unexplained"] == 0 for c in step), step
        if any(c["n_flips"] for c in step):
            break
        torch.testing.assert_close(card[5][t], cpu[5][t], atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("B,S,T,H,K,D,P,window,dtype", [
    (1, 200, 200, 8, 1, 64, 100, 0, "bfloat16"),   # cuts a key tile and a
    (1, 200, 200, 8, 1, 64, 100, 0, "float32"),    # 128-row query tile
    (2, 300, 300, 8, 1, 256, 200, 64, "bfloat16"),  # D 256, a window
    (1, 300, 300, 8, 1, 256, 200, 64, "float32"),
    (1, 150, 150, 4, 2, 128, 256, 0, "bfloat16"),   # P >= S: every key
    (1, 150, 150, 4, 2, 128, 256, 0, "float32"),
    (1, 320, 320, 8, 1, 256, 128, 0, "bfloat16"),   # a multiple of 64
    (1, 90, 130, 2, 1, 36, 70, 0, "bfloat16")])     # S != T, element loads
def test_flash_prefix_kernels_match_plain(cuda, B, S, T, H, K, D, P, window,
                                          dtype):
    """Both flash kernels with the prefix rule against the plain version
    at the JAX suite's bounds; two launches give the same bits; P >= T
    gives the full mask's bits."""
    g = _gen(cuda, S + T + P)
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(dt)
    k = torch.randn((B, T, K, D), generator=g, device=cuda).to(dt)
    v = torch.randn((B, T, K, D), generator=g, device=cuda).to(dt)
    before = flash_attention.launches
    o = flash_attention(q, k, v, window=window, prefix_len=P)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    atol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(o.float(), attention_reference(
        q, k, v, window=window, prefix_len=P).float(), atol=atol, rtol=1e-2)
    assert torch.equal(o, flash_attention(q, k, v, window=window,
                                          prefix_len=P))
    if P >= T and window == 0:
        assert torch.equal(o, flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D,window", [(64, 0), (128, 96), (256, 0)])
def test_flash_prefix_zero_is_bitwise_causal(cuda, dtype, D, window):
    """prefix_len 0 runs the tiles of the causal call and gives its bits."""
    g = _gen(cuda, D + window)
    dt = getattr(torch, dtype)
    q = torch.randn((2, 257, 8, D), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((2, 257, 2, D), generator=g, device=cuda).to(dt)
            for _ in range(2))
    assert torch.equal(flash_attention(q, k, v, window=window, prefix_len=0),
                       flash_attention(q, k, v, window=window))


@pytest.mark.parametrize("arch", ["whisper_tiny", "paligemma_3b"])
def test_modal_zoo_on_card_matches_cpu(cuda, arch):
    """A small encoder-decoder (frames) and prefix-LM (patches) in fp32
    on the card and on the CPU from one seed: prefill hidden states, the
    flash launches a call (encoder, decoder and cross layers; every
    prefix-LM layer), 4 decode steps over a cache whose cross part is
    filled from the encoder, and the same greedy tokens from the
    ServeEngine."""
    from repro_torch.config import get_arch, scaled_down
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = scaled_down(get_arch(arch), num_layers=2, d_model=128,
                      num_heads=4, d_ff=256, vocab_size=512)
    model = build_model(cfg)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 512, (2, 70))
    batch = {"tokens": tokens}
    if cfg.encoder_layers:
        batch["frames"] = rng.randn(2, 150, 128).astype(np.float32)
    else:
        batch["patches"] = rng.randn(2, 16, 128).astype(np.float32)
    want_launches = 2 * cfg.num_layers + cfg.encoder_layers \
        if cfg.encoder_layers else cfg.num_layers
    runs = []
    for dev in ("cpu", cuda):
        params = model.init(0, device=dev)
        before = flash_attention.launches
        hidden, _ = model.prefill(params, batch)
        launches = flash_attention.launches - before
        cache = model.init_cache(2, 16, torch.float32, device=dev,
                                 enc_len=150)
        if cfg.encoder_layers:
            with torch.no_grad():
                mem = tfm.encoder_apply(params, cfg, torch.as_tensor(
                    batch["frames"], device=dev))
                for i, block in enumerate(params.layers):
                    cache["p0"]["ck"][i] = (mem @ block.cross.wk).view(
                        2, 150, cfg.num_kv_heads, -1)
                    cache["p0"]["cv"][i] = (mem @ block.cross.wv).view(
                        2, 150, cfg.num_kv_heads, -1)
        logits = []
        for t in range(4):
            lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          t)
            logits.append(lg.cpu())
        eng = ServeEngine(model, params, num_slots=2, max_seq=64, device=dev)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=list(tokens[0, :5 + 7 * i]),
                               max_new=8))
        runs.append((hidden.cpu(), launches, torch.cat(logits, 1),
                     {r: q.out for r, q in eng.run().items()}))
    cpu, card = runs
    assert cpu[1] == 0 and card[1] == want_launches
    torch.testing.assert_close(card[0], cpu[0], atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(card[2], cpu[2], atol=1e-4, rtol=1e-3)
    assert card[3] == cpu[3]


# ---------------------------------------------------------------------------
# bf16 instances of wkv and set attention
# ---------------------------------------------------------------------------

def _same_bits(got, want32):
    """A bf16 instance's output equals the fp32 instance's on the upcast
    inputs, rounded once to the output's dtype (fp32 outputs as they are)."""
    assert torch.equal(got, want32.to(got.dtype))


def _wkv_bf16_inputs(dev, B, S, H, dh, seed):
    g = _gen(dev, seed)
    r, k, v, dy = (torch.randn((B, S, H, dh), generator=g, device=dev)
                   for _ in range(4))
    k = k / k.norm(dim=-1, keepdim=True)
    w = 0.7 + 0.3 * torch.rand((B, S, H, dh), generator=g, device=dev)
    beta = torch.rand((B, S, H), generator=g, device=dev)
    s0, dsf = (0.1 * torch.randn((B, H, dh, dh), generator=g, device=dev)
               for _ in range(2))
    return (tuple(t.bfloat16() for t in (r, k, v)), w, beta, s0, dy, dsf)


@pytest.mark.parametrize("B,S,H,dh", [(4, 128, 6, 64), (3, 37, 2, 44),
                                      (2, 33, 2, 40), (2, 17, 2, 7),
                                      (2, 129, 2, 128), (2, 1, 3, 64)])
def test_wkv_bf16_instances_bitwise_the_fp32_instances(cuda, B, S, H, dh):
    """bf16 r, k, v (the 16-byte route at dh % 8 == 0, element loads
    else): y, the final state and the states the forward saves equal the
    fp32 instance's on the upcast inputs; dr, dk, dv (bf16) and dw,
    dbeta, dS_0 (fp32) equal the fp32 backward's, rounded. Both counters
    move once a launch."""
    from repro_torch.kernels.wkv import wkv_backward
    from repro_torch.kernels.wkv.ops import _forward
    rkv, w, beta, s0, dy, dsf = _wkv_bf16_inputs(cuda, B, S, H, dh, S + dh)
    rkv32 = tuple(t.float() for t in rkv)
    n0 = (wkv.launches, wkv.launches_bf16)
    y, sf, states = _forward(*rkv, w, beta, s0, save=True)
    assert (wkv.launches, wkv.launches_bf16) == (n0[0] + 1, n0[1] + 1)
    assert y.dtype == sf.dtype == states.dtype == torch.float32
    y32, sf32, states32 = _forward(*rkv32, w, beta, s0, save=True)
    assert wkv.launches_bf16 == n0[1] + 1          # fp32: the other instance
    for a, b in ((y, y32), (sf, sf32), (states, states32)):
        _same_bits(a, b)
    n0 = (wkv_backward.launches, wkv_backward.launches_bf16)
    got = wkv_backward(*rkv, w, beta, s0, states, dy, dsf)
    assert (wkv_backward.launches, wkv_backward.launches_bf16) == (
        n0[0] + 1, n0[1] + 1)
    want = wkv_backward(*rkv32, w, beta, s0, states32, dy, dsf)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == (torch.bfloat16 if i < 3 else torch.float32)
        _same_bits(a, b)


@pytest.mark.parametrize("B,H,N,M,dh", [(8, 4, 64, 64, 64), (8, 4, 1, 64, 64),
                                        (3, 2, 7, 13, 44), (2, 3, 5, 33, 37),
                                        (2, 2, 7, 130, 16),
                                        (2, 2, 130, 70, 36),
                                        (2, 2, 1, 300, 44),
                                        (2, 2, 70, 13, 128)])
def test_set_attention_bf16_instances_bitwise_the_fp32_instances(
        cuda, B, H, N, M, dh):
    """bf16 q, k, v, dO (8-byte loads at dh % 4 == 0, element loads else;
    N or M past one tile takes the backward's fp32 scratch): the output
    and dq, dk, dv (bf16) and db (fp32) equal the fp32 instances' on the
    upcast inputs, rounded once. Both counters move once a launch."""
    g = _gen(cuda, N * M + dh)
    q, do = (torch.randn((B, H, N, dh), generator=g, device=cuda).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((B, H, M, dh), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    bias = torch.rand((B, M), generator=g, device=cuda)
    mask = torch.rand((B, M), generator=g, device=cuda) < 0.5
    mask[:, 0] = True
    mask[-1] = False
    n0 = (masked_set_attention.launches, masked_set_attention.launches_bf16)
    o = masked_set_attention(q, k, v, bias, mask)
    assert (masked_set_attention.launches,
            masked_set_attention.launches_bf16) == (n0[0] + 1, n0[1] + 1)
    assert o.dtype == torch.bfloat16
    _same_bits(o, masked_set_attention(q.float(), k.float(), v.float(), bias,
                                       mask))
    n0 = (set_attention_backward.launches,
          set_attention_backward.launches_bf16)
    got = set_attention_backward(q, k, v, bias, mask, do)
    assert (set_attention_backward.launches,
            set_attention_backward.launches_bf16) == (n0[0] + 1, n0[1] + 1)
    want = set_attention_backward(q.float(), k.float(), v.float(), bias, mask,
                                  do.float())
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == (torch.float32 if i == 3 else torch.bfloat16)
        _same_bits(a, b)


def test_bf16_autograd_runs_the_bf16_instances(cuda):
    """Autograd through both wrappers on bf16 inputs launches only the
    bf16 instances, forward and backward, and gives gradients in the
    inputs' dtypes."""
    from repro_torch.kernels.wkv import wkv_backward
    rkv, w, beta, _, _, _ = _wkv_bf16_inputs(cuda, 2, 16, 2, 64, 1)
    leaves = [t.clone().requires_grad_(True) for t in (*rkv, w, beta)]
    counters = (wkv, wkv_backward, masked_set_attention,
                set_attention_backward)
    n0 = [(c.launches, c.launches_bf16) for c in counters]
    y, _ = wkv(*leaves)
    grads = torch.autograd.grad(y.sum(), leaves)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32] * 2
    g = _gen(cuda, 2)
    q, k, v = (torch.randn((2, 2, 9, 32), generator=g, device=cuda).bfloat16()
               .requires_grad_(True) for _ in range(3))
    o = masked_set_attention(q, k, v)
    grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert all(t.dtype == torch.bfloat16 for t in grads)
    for c, (a, b) in zip(counters, n0):
        assert c.launches - a == c.launches_bf16 - b == 1, c.__name__


@pytest.mark.parametrize("dh", [16, 64, 100, 128])
def test_wkv_bf16_attributes_match_the_plans(cuda, dh):
    from repro_torch.kernels import _lib
    from repro_torch.kernels.wkv.ops import backward_plan, kernel_plan
    for bf16, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        a = _lib.kernel_attributes("rt_wkv_attributes", bf16, dh)
        assert a["static_smem"] == kernel_plan(dh, dtype)["shared_bytes"]
        b = _lib.kernel_attributes("rt_wkv_backward_attributes", bf16, dh)
        assert b["dynamic_smem"] == backward_plan(dh, dtype)["shared_bytes"]


@pytest.mark.parametrize("N,M,dh", [(64, 64, 64), (1, 64, 64), (5, 13, 16),
                                    (130, 130, 44)])
def test_set_attention_bf16_attributes_match_the_plan(cuda, N, M, dh):
    from repro_torch.kernels import _lib
    from repro_torch.kernels.set_attention.ops import backward_plan
    for bf16, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        a = _lib.kernel_attributes("rt_set_attention_backward_attributes",
                                   bf16, N, M, dh)
        assert a["dynamic_smem"] == backward_plan(N, M, dh,
                                                  dtype)["shared_bytes"]


def test_cuda_calls_never_take_the_meta_route(cuda):
    """Every wrapper, forward and backward, on CUDA tensors launches its
    kernel (its `launches` count rises by one a call), so it never takes
    the meta route; under a step count each is one kernel record, as on
    meta."""
    from repro_torch.analysis.counting import StepCount
    from repro_torch.kernels.wkv import wkv_backward
    g = _gen(cuda, 7)

    def t(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    B, S, H, dh = 2, 5, 2, 8
    r, k, v, w, dy = (t(B, S, H, dh) for _ in range(5))
    beta = torch.rand((B, S, H), generator=g, device=cuda)
    st, dsf, states = t(B, H, dh, dh), t(B, H, dh, dh), t(B, S, H, dh, dh)
    q4, k4, v4, do4 = t(2, 2, 3, 8), t(2, 2, 4, 8), t(2, 2, 4, 8), \
        t(2, 2, 3, 8)
    bias = t(2, 4)
    mask = torch.ones((2, 4), dtype=torch.bool, device=cuda)
    fq, fk, fv = (x.bfloat16() for x in (t(2, 6, 4, 8), t(2, 6, 2, 8),
                                         t(2, 6, 2, 8)))
    fo, lse = flash_forward(fq, fk, fv, return_lse=True)
    fdo = t(2, 6, 4, 8).bfloat16()
    x, c = t(10, 8), t(3, 8)
    calls = [(wkv, lambda: wkv(r, k, v, w, beta, st)),
             (wkv_backward,
              lambda: wkv_backward(r, k, v, w, beta, st, states, dy, dsf)),
             (masked_set_attention,
              lambda: masked_set_attention(q4, k4, v4, bias, mask)),
             (set_attention_backward,
              lambda: set_attention_backward(q4, k4, v4, bias, mask, do4)),
             (flash_attention,
              lambda: flash_forward(fq, fk, fv, return_lse=True)),
             (flash_attention_backward,
              lambda: flash_attention_backward(fq, fk, fv, fo, fdo, lse)),
             (kmeans_assign, lambda: kmeans_assign(x, c)),
             (kmeans_update, lambda: kmeans_update(x, c))]
    for wrapper, fn in calls:
        before = wrapper.launches
        fn()
        with StepCount() as count:
            fn()
        assert wrapper.launches == before + 2
        assert len(count.records) == 1 and count.records[0].kind == "kernel"
    torch.cuda.synchronize()


@pytest.mark.parametrize("M", [2, 4])
def test_tensor_parallel_attention_shares_launch_flash_at_local_heads(
        cuda, M):
    """A bf16 attention layer split over a "model" axis of M ranks, each
    rank's share computed alone on the card (`transformer.rank_shares`):
    flash forward and backward launch once a rank at H / M query and
    K / M kv heads, and the outputs and input gradients summed in rank
    order meet flash's bf16 bounds against the unsharded layer."""
    from repro_torch.config import get_arch, scaled_down
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    cfg = scaled_down(get_arch("qwen3_4b"), num_heads=8, num_kv_heads=4,
                      d_model=256)
    mod = attn.Attention(torch.Generator().manual_seed(0), cfg.d_model,
                         cfg.num_heads, cfg.num_kv_heads,
                         cfg.resolved_head_dim, torch.bfloat16,
                         qk_norm=True).to(cuda)
    ak = tfm._attn_kwargs(cfg)
    g = _gen(cuda, M)
    x = torch.randn((2, 256, cfg.d_model), generator=g, device=cuda
                    ).bfloat16().requires_grad_()
    dy = (torch.randn((2, 256, cfg.d_model), generator=g, device=cuda)
          / 16).bfloat16()
    ref = attn.attn_apply(mod, x, mask_mode="causal", **ak)
    dx_ref, = torch.autograd.grad(ref, [x], dy)
    heads = []

    def recorded(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return flash_attention(q, k, v, **kw)

    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    out = dx = 0
    attn.flash_attention = recorded
    try:
        for share in tfm.rank_shares(mod, attn.attn_specs(False, True),
                                     cfg, M):
            o = attn.attn_apply(share, x, mask_mode="causal", **ak)
            out = out + o.float()
            dx = dx + torch.autograd.grad(o, [x], dy)[0].float()
    finally:
        attn.flash_attention = flash_attention
    torch.cuda.synchronize()
    assert heads == [(8 // M, 4 // M)] * M
    assert flash_attention.launches - fwd == M
    assert flash_attention_backward.launches - bwd == M
    for got, want in ((out, ref.float()), (dx, dx_ref.float())):
        diff = (got - want).abs()
        assert bool((diff <= 1e-2 + 1e-2 * want.abs()).all())
        assert float((got - want).norm() / want.norm()) <= 1e-2


@pytest.mark.parametrize("M", [2, 4])
def test_tensor_parallel_rwkv_shares_launch_wkv_at_local_heads(cuda, M):
    """The Stage-1 RWKV block (6 heads) over a "model" axis of M ranks run
    as threads on the card (`rank_shares(mode="thread")`): at M 2 the wkv
    forward and backward launch once a rank at 3 heads, at M 4 (which 6
    does not divide) at all 6; the output and the input gradient, the
    same on every rank, meet the fp32 bounds against the unsharded
    block."""
    from repro_torch.distributed.collectives import rank_shares, run_threads
    from repro_torch.kernels import wkv as wkv_mod
    from repro_torch.models import rwkv as rwkv_mod
    d, H = 384, 6
    block = rwkv_mod.RWKVBlock(torch.Generator().manual_seed(0), d, H
                               ).to(cuda)
    g = _gen(cuda, M)
    x = torch.randn((8, 64, d), generator=g, device=cuda)
    dy = torch.randn((8, 64, d), generator=g, device=cuda)
    xr = x.clone().requires_grad_()
    ref = block(xr)
    dx_ref, = torch.autograd.grad(ref, [xr], dy)
    heads = []
    real = rwkv_mod.wkv

    def recorded(r, *args):
        heads.append(r.shape[2])
        return real(r, *args)

    shares = rank_shares(block, rwkv_mod.rwkv_block_specs(), None, M,
                         mode="thread")

    def one(rank):
        xs = x.clone().requires_grad_()
        out = shares[rank](xs)
        return out.detach(), torch.autograd.grad(out, [xs], dy)[0]

    fwd = wkv_mod.wkv.launches
    bwd = wkv_mod.wkv_backward.launches
    rwkv_mod.wkv = recorded
    try:
        res = run_threads(one, M, shares[0].tp.comm.room)
    finally:
        rwkv_mod.wkv = real
    torch.cuda.synchronize()
    local = H // M if H % M == 0 else H
    assert heads == [local] * M
    assert wkv_mod.wkv.launches - fwd == M
    assert wkv_mod.wkv_backward.launches - bwd == M
    for out, dx in res:
        assert torch.equal(out, res[0][0]) and torch.equal(dx, res[0][1])
    for got, want in ((res[0][0], ref.detach()), (res[0][1], dx_ref)):
        assert float((got - want).norm() / want.norm()) <= 1e-5


@pytest.mark.parametrize("M", [2, 4])
def test_tensor_parallel_set_attention_shares_at_local_heads(cuda, M):
    """A Stage-2 SAB (d 256, 4 heads) over M ranks run as threads on the
    card: the set-attention forward and backward launch once a rank at
    4 / M heads, and the output and input gradient meet the fp32 bounds
    against the unsharded MAB."""
    from repro_torch.distributed.collectives import rank_shares, run_threads
    from repro_torch.models import set_transformer as st
    mab = st.MAB(torch.Generator().manual_seed(0), 256, 4, 512).to(cuda)
    g = _gen(cuda, M)
    x = torch.randn((64, 48, 256), generator=g, device=cuda)
    dy = torch.randn((64, 48, 256), generator=g, device=cuda)
    bias = torch.rand((64, 48), generator=g, device=cuda)
    mask = torch.rand((64, 48), generator=g, device=cuda) > 0.2
    xr = x.clone().requires_grad_()
    ref = mab(xr, xr, bias, mask)
    dx_ref, = torch.autograd.grad(ref, [xr], dy)
    shares = rank_shares(mab, st.mab_specs(), None, M, mode="thread")

    def one(rank):
        xs = x.clone().requires_grad_()
        out = shares[rank](xs, xs, bias, mask)
        return out.detach(), torch.autograd.grad(out, [xs], dy)[0]

    fwd = masked_set_attention.launches
    bwd = set_attention_backward.launches
    res = run_threads(one, M, shares[0].tp.comm.room)
    torch.cuda.synchronize()
    assert shares[0].mha.wq.shape == (256, 256 // M)
    assert masked_set_attention.launches - fwd == M
    assert set_attention_backward.launches - bwd == M
    for got, want in ((res[0][0], ref.detach()), (res[0][1], dx_ref)):
        assert float((got - want).norm() / want.norm()) <= 1e-5
