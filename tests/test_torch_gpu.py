"""The port's CUDA kernels against their plain PyTorch versions on the
card. Needs a CUDA card and no JAX: every test here skips without one.
On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.kmeans_assign import (  # noqa: E402
    kmeans_assign, kmeans_assign_reference, kmeans_update,
    kmeans_update_reference,
)
from repro_torch.kernels.set_attention import (  # noqa: E402
    masked_set_attention, set_attention_reference,
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
                                      (4, 128, 6, 64), (1, 5, 1, 8)])
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


@pytest.mark.parametrize("N,d,K", [(32768, 128, 14), (1000, 64, 14),
                                   (513, 32, 30), (77, 200, 5)])
def test_kmeans_kernels_match_plain(cuda, N, d, K):
    g = _gen(cuda, N)
    centres = torch.randn((K, d), generator=g, device=cuda)
    x = centres[torch.randint(K, (N,), generator=g, device=cuda)]
    x = (x + 0.05 * torch.randn((N, d), generator=g, device=cuda)).contiguous()
    c = (centres + 0.01 * torch.randn((K, d), generator=g,
                                      device=cuda)).contiguous()
    a, d2 = kmeans_assign(x, c)
    a_ref, d2_ref = kmeans_assign_reference(x, c)
    assert torch.equal(a, a_ref)
    torch.testing.assert_close(d2, d2_ref, atol=1e-3, rtol=0)
    valid = (torch.rand((N,), generator=g, device=cuda) < 0.7).float()
    out = kmeans_update(x, c, valid)
    s_ref, n_ref, i_ref = kmeans_update_reference(x, c, valid)
    assert torch.equal(out[1], n_ref)
    torch.testing.assert_close(out[0], s_ref, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(out[2], i_ref[0], atol=1e-3, rtol=1e-4)
    again = kmeans_update(x, c, valid)
    assert all(torch.equal(p, q) for p, q in zip(out, again))


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
