"""Tensor-parallel compute of the zoo's attention LMs on the CPU, held
against the unsharded port and JAX:

  (a) one process, no process group: for M in {2, 4}, each rank's share
      computed alone (`transformer.rank_shares`, a "local" MeshComm), its
      partials summed in rank order against the unsharded layer and
      JAX's: attention with M | K, with the kv heads gathered (M | H,
      M not dividing K) and with M not dividing H (smollm's 9 heads); the
      MLP (gated and GELU); the MoE by experts and by expert_ff; the
      vocab-parallel embed and loss; decode's sequence-split attention;
      and the compute split of the eight attention archs at M 16;
  (b) two spawns of gloo ranks (each within SPAWN_TIMEOUT_S): world 2 on
      a (1, 2) mesh, scaled-down qwen3-4b, qwen3-moe and grok-1 (its
      expert_ff override), one step each with AdamW and Adafactor, the
      gradients, prefill logits and 3 decode steps under the decode rules
      (the cache split along its sequence); world 4 on a (2, 2) mesh,
      whisper-tiny and paligemma-3b, one step and a checkpoint restored
      unsharded. Each rank's module holds only its blocks;
  (c) the dry-run of a tiny attention LM on meta tensors at M 16.

The ranks import the port only (JAX is imported inside the tests); they
build their blocks from JAX's tree through `bridge.lm_params_from_jax`.
The parameters after a step are held at relative L2 1e-4 a leaf, the
step's clipped gradients at the JAX suite's gradient bound (1e-4 x
max(1, max|g|)), but for whisper's kv biases (`bk`), held by their
gradients alone: under RoPE most of a key bias moves every score of a
query alike, which softmax ignores, so elements of its gradient reach
4e-8 (scaled-down whisper-tiny and qwen2-7b, seed 3), near AdamW's eps
of 1e-8, where the step lr g / (|g| + eps) turns summation-order
differences into differences of the step (relative L2 1.7e-4 on a (2, 2)
mesh).
"""
import datetime
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.dryrun import rules_for  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

SPAWN_TIMEOUT_S = 110
MS = (2, 4)
B, S = 2, 24
DECODE_T, DECODE_POS = 8, (1, 3)


def _cfg(arch, **kw):
    return tconfig.scaled_down(tconfig.get_arch(arch), **kw)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _close(got, want, what, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


def _jnp_tree(module):
    import jax.numpy as jnp
    return {n.replace(".", "/"): jnp.asarray(p.detach().numpy())
            for n, p in module.named_parameters()}


def _x(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


_JAX = {}


def _once(key, fn):
    """fn()'s value, computed once a test run (JAX's side of a case, which
    does not depend on M)."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _perturbed(module, seed):
    """Nonzero biases and norm scales (they init at 0 and 1)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)
                                    * 0.05))
    return module


# ---------------------------------------------------------------------------
# (a) each rank's share, one process
# ---------------------------------------------------------------------------

# (name, scaled_down kwargs): M | K; M | H with the kv heads gathered
# (K 2 at M 4, K 1 as paligemma's); M not dividing H (smollm's 9 heads)
ATTN_CASES = [("kv_split", dict(num_heads=8, num_kv_heads=4, d_model=64)),
              ("kv_gathered", dict(num_heads=8, num_kv_heads=1, d_model=64)),
              ("heads_whole", dict(num_heads=9, num_kv_heads=3, d_model=72))]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("case,kw", ATTN_CASES, ids=[c[0] for c in
                                                     ATTN_CASES])
def test_attention_shares(case, kw, M):
    """q, k, v of a rank's query heads and the kv heads they read, flash on
    them, its rows of wo: the outputs and input gradients summed in rank
    order equal the unsharded layer's and JAX's; each rank's gradients of
    its wq and wo blocks are the blocks of the unsharded ones."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    cfg = _cfg("qwen3_4b", **kw)
    mod = _perturbed(attn.Attention(torch.Generator().manual_seed(1),
                                    cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.resolved_head_dim,
                                    torch.float32, qk_norm=True), 2)
    ak = tfm._attn_kwargs(cfg)
    x = _x(3, B, S, cfg.d_model).requires_grad_()
    dy = _x(4, B, S, cfg.d_model)
    ref = attn.attn_apply(mod, x, mask_mode="causal", **ak)
    ref_g = torch.autograd.grad(ref, [x, mod.wq, mod.wo], dy)

    @jax.jit
    def jax_ref(p, xx, dyy):
        jout, jvjp = jax.vjp(lambda z: jattn.attn_apply(
            p, z, mask_mode="causal", impl="ref", **ak), xx)
        return jout, jvjp(dyy)[0]

    jout, jdx = _once(("attention", case), lambda: jax_ref(
        _jnp_tree(mod), jnp.asarray(x.detach().numpy()),
        jnp.asarray(dy.numpy())))
    _close(ref.detach(), jout, "unsharded vs JAX")
    shares = tfm.rank_shares(mod, attn.attn_specs(False, True), cfg, M)
    split = shares[0].tp.split
    assert split.heads == (case != "heads_whole")
    assert split.kv_heads == (case == "kv_split" and cfg.num_kv_heads % M
                              == 0)
    outs, dxs = [], []
    for r, share in enumerate(shares):
        out = attn.attn_apply(share, x, mask_mode="causal", **ak)
        g = torch.autograd.grad(out, [x, share.wq, share.wo], dy)
        outs.append(out.detach())
        dxs.append(g[0])
        if split.heads:     # this rank's blocks of wq's and wo's gradients
            for p, gp, want in zip((share.wq, share.wo), g[1:], ref_g[1:]):
                _close(gp, sharding.local_block(want, p.tp_spec, {
                    "model": M}, {"model": r}), f"rank {r} block grad",
                    atol=1e-5)
    if split.heads:
        got, dx = sum(outs), sum(dxs)
    else:               # every rank computes every head
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
        got, dx = outs[0], dxs[0]
    _close(got, ref.detach(), f"{case} M {M} output")
    _close(got, jout, f"{case} M {M} output vs JAX")
    _close(dx, ref_g[0], f"{case} M {M} dx", atol=1e-4)
    _close(dx, jdx, f"{case} M {M} dx vs JAX", atol=1e-4)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_mlp_shares(gated, M):
    """wi / wg by columns, wo by rows: the partials summed equal the MLP
    and JAX's `mlp_apply`; each rank's gradients are its blocks."""
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    cfg = _cfg("whisper_tiny" if not gated else "qwen3_4b", d_ff=128)
    mlp = _perturbed(layers.MLP(torch.Generator().manual_seed(5),
                                cfg.d_model, cfg.d_ff, torch.float32,
                                gated=gated), 6)
    x = _x(7, B, S, cfg.d_model).requires_grad_()
    dy = _x(8, B, S, cfg.d_model)
    ref = mlp(x)
    leaves = ["wi", "wo"] + (["wg"] if gated else ["bi"])
    ref_g = torch.autograd.grad(ref, [x] + [getattr(mlp, n) for n in leaves],
                                dy)
    want = jlayers.mlp_apply(_jnp_tree(mlp), jnp.asarray(x.detach().numpy()),
                             gated=gated)
    shares = tfm.rank_shares(mlp, layers.mlp_specs(gated), cfg, M)
    assert shares[0].tp.split.ff
    got = dx = 0
    for r, share in enumerate(shares):
        part = share(x)
        if not gated:   # bo is added after the reduce-out, on every rank
            part = part - share.bo
        g = torch.autograd.grad(part, [x] + [getattr(share, n)
                                             for n in leaves], dy)
        got, dx = got + part.detach(), dx + g[0]
        for n, gp, w in zip(leaves, g[1:], ref_g[1:]):
            _close(gp, sharding.local_block(w, getattr(share, n).tp_spec, {
                "model": M}, {"model": r}), f"rank {r} d{n}")
    if not gated:
        got = got + mlp.bo.detach()
    _close(got, ref.detach(), f"MLP M {M}")
    _close(got, want, f"MLP M {M} vs JAX")
    _close(dx, ref_g[0], f"MLP M {M} dx", atol=1e-4)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "grok_1_314b"])
def test_moe_shares(arch, M):
    """qwen3-moe's experts split over "model" (E / M a rank), grok-1's
    expert_ff (every expert, d_ff / M columns a rank): the routing and
    the aux bitwise the unsharded layer's on every rank, the combine's
    partial sums summed equal to the layer and JAX's `moe_apply`, and the
    input's and router's gradients summed over the ranks."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    cfg = _cfg(arch, num_experts=8, d_ff=64)
    m = cfg.moe
    mod = moe_mod.MoE(torch.Generator().manual_seed(9), cfg.d_model, m.d_ff,
                      m.num_experts, torch.float32, gated=cfg.mlp_gated)
    kw = dict(top_k=m.top_k, capacity_factor=m.capacity_factor,
              gated=cfg.mlp_gated)
    x = _x(10, B, S, cfg.d_model).requires_grad_()
    dy = _x(11, B, S, cfg.d_model)
    ref, aux = moe_mod.moe_apply(mod, x, **kw)
    ref_g = torch.autograd.grad(ref, [x, mod.router], dy)
    jout, jaux = _once(("moe", arch), lambda: jax.jit(
        lambda p, xx: jmoe.moe_apply(p, xx, **kw))(
        _jnp_tree(mod), jnp.asarray(x.detach().numpy())))
    shares = tfm.rank_shares(mod, moe_mod.moe_specs(cfg.mlp_gated), cfg, M)
    split = shares[0].tp.split
    assert (split.experts, split.expert_ff) == ((True, False)
                                                if arch.startswith("qwen")
                                                else (False, True))
    got = dx = drouter = 0
    for share in shares:
        part, aux_r = moe_mod.moe_apply(share, x, **kw)
        assert torch.equal(aux_r, aux)
        g = torch.autograd.grad(part, [x, share.router], dy)
        got, dx, drouter = got + part.detach(), dx + g[0], drouter + g[1]
    _close(got, ref.detach(), f"{arch} M {M}")
    _close(got, jout, f"{arch} M {M} vs JAX")
    _close(aux.detach(), jaux, "aux vs JAX")
    _close(dx, ref_g[0], f"{arch} M {M} dx", atol=1e-4)
    _close(drouter, ref_g[1], f"{arch} M {M} drouter", atol=1e-4)


@pytest.mark.parametrize("M", MS)
def test_vocab_parallel_embed_and_loss(M):
    """The lookup of a rank's vocab rows (others 0), summed, is the table's
    (exactly: one row is nonzero); the loss from the ranks' partials
    (`vocab_partials`, `combine_vocab`) and its gradients of the rows and
    of each rank's table rows equal `chunked_xent`'s and JAX's, with and
    without label smoothing."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    from repro.models import transformer as jtfm
    cfg = _cfg("qwen3_4b", vocab_size=96)
    emb = layers.Embed(torch.Generator().manual_seed(12), cfg.vocab_size,
                       cfg.d_model, torch.float32)
    ids = torch.from_numpy(np.random.RandomState(13).randint(
        -3, cfg.vocab_size + 3, (B, S)))            # clamped as JAX's clip
    shares = tfm.rank_shares(emb, layers.embed_specs(), cfg, M)
    looked = sum(layers.vocab_embed(s, ids, cfg.vocab_size, True)
                 for s in shares)
    assert torch.equal(looked, layers.embed(emb.table, ids))
    np.testing.assert_array_equal(
        looked.detach().numpy(),
        jlayers.embed_apply(_jnp_tree(emb), jnp.asarray(ids.numpy())))
    V = cfg.vocab_size
    h = _x(14, B, S, cfg.d_model).requires_grad_()
    table = emb.table.detach().clone().requires_grad_()
    tgt = torch.from_numpy(np.random.RandomState(15).randint(0, V, (B, S)))
    valid = torch.from_numpy((np.random.RandomState(16).rand(B, S) > 0.2)
                             .astype(np.float32))
    for ls in (0.0, 0.1):
        ref = tfm.chunked_xent(h, table, tgt, valid, chunk=8,
                               label_smoothing=ls)
        ref_g = torch.autograd.grad(ref, [h, table])
        jref, jg = _once(("xent", ls), lambda: jax.jit(jax.value_and_grad(
            lambda hh, *rest: jtfm.chunked_xent(
                hh, *rest, chunk=8, label_smoothing=ls)))(
            *(jnp.asarray(t.detach().numpy()) for t in
              (h, table, tgt, valid))))
        n = V // M
        blocks = [table.detach()[r * n:(r + 1) * n].clone().requires_grad_()
                  for r in range(M)]
        parts = [tfm.vocab_partials(h, b, tgt, r * n)
                 for r, b in enumerate(blocks)]
        m, s, t, z = (torch.stack(p) for p in zip(*parts))
        nll = tfm.combine_vocab(m, s, t, z, V, ls, max_fn=lambda a: a.amax(0),
                                sum_fn=lambda a: a.sum(0))
        loss = (nll * valid).sum() / valid.sum()
        g = torch.autograd.grad(loss, [h] + blocks)
        _close(loss.item(), ref.item(), f"loss M {M} ls {ls}")
        _close(loss.item(), float(jref), f"loss M {M} ls {ls} vs JAX")
        _close(g[0], ref_g[0], "dh", atol=1e-6)
        _close(torch.cat(g[1:]), ref_g[1], "dtable", atol=1e-6)
        _close(g[0], jg, "dh vs JAX", atol=1e-6)


@pytest.mark.parametrize("M", MS)
def test_decode_sequence_split(M):
    """A decode step's attention over a cache split along its positions:
    the ranks' maxima, sums and PV partials combined equal the unsharded
    step's attention and JAX's, rows at different positions (a rank may
    hold none of a row's keys)."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    H, K, D, T = 8, 2, 16, 32
    q = _x(17, 3, 1, H, D)
    ck, cv = _x(18, 3, T, K, D), _x(19, 3, T, K, D)
    pos = torch.tensor([0, 13, T - 1])
    valid = torch.arange(T)[None, :] <= pos[:, None]
    bias = torch.zeros((1, T))
    ref = attn._ref_attention(q, ck, cv, bias, kv_valid=valid)[:, 0]
    jref = jax.jit(jattn._ref_attention)(*(jnp.asarray(t.numpy()) for t in
                                           (q, ck, cv, bias, valid)))[:, 0]
    n = T // M
    parts = [attn._partial_attention(q, ck[:, r * n:(r + 1) * n],
                                     cv[:, r * n:(r + 1) * n],
                                     valid[:, r * n:(r + 1) * n])
             for r in range(M)]
    m, l, o = (torch.stack(p) for p in zip(*parts))
    got = attn.combine_partials(m, l, o, max_fn=lambda a: a.amax(0),
                                sum_fn=lambda a: a.sum(0))
    _close(got, ref, f"M {M}")
    _close(got, jref, f"M {M} vs JAX")


# the eight attention archs at M 16: (heads, kv_heads, ff, experts,
# expert_ff, vocab, in_vocab)
SPLITS_16 = {
    "smollm_135m": (False, False, True, False, False, True, True),
    "qwen2_7b": (False, False, True, False, False, True, False),
    "qwen3_4b": (True, False, True, False, False, True, True),
    "granite_3_2b": (True, False, True, False, False, False, False),
    "qwen3_moe_235b_a22b": (True, False, True, True, False, True, False),
    "grok_1_314b": (True, False, True, False, True, True, False),
    "whisper_tiny": (False, False, True, False, False, False, False),
    "paligemma_3b": (False, False, True, False, False, True, True),
}


@pytest.mark.parametrize("arch", sorted(SPLITS_16))
def test_compute_split_at_model_16(arch):
    """Whole heads only where 16 divides them, though the stored spec
    splits the flattened columns (qwen2's 28 x 128, smollm's 9 x 64);
    grok-1's override puts expert_ff on "model"; M 1 splits nothing."""
    cfg = tconfig.get_arch(arch)
    rules = sharding.arch_rules(cfg)
    sizes = {"data": 16, "model": 16}
    got = sharding.compute_split(cfg, sizes, rules)
    assert got.M == 16 and tuple(got)[1:] == SPLITS_16[arch]
    if arch in ("smollm_135m", "qwen2_7b"):     # stored split, heads whole
        spec = sharding.pruned_spec(
            ("embed", "heads"),
            (cfg.d_model, cfg.num_heads * cfg.resolved_head_dim), sizes,
            rules)
        assert spec[1] == "model"
    assert not any(tuple(sharding.compute_split(
        cfg, {"data": 16, "model": 1}, rules))[1:])


def test_local_block_tiles_the_tensor():
    """A dim split over two axes, the first major: the blocks of the ranks
    in row-major order concatenate to the tensor."""
    full = torch.arange(48.).reshape(8, 6)
    sizes = {"pod": 2, "data": 2, "model": 3}
    spec = (("pod", "data"), "model")
    rows = []
    for p in range(2):
        for d in range(2):
            rows.append(torch.cat([sharding.local_block(
                full, spec, sizes, {"pod": p, "data": d, "model": m})
                for m in range(3)], 1))
    assert torch.equal(torch.cat(rows), full)
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_block(full, (None, ("data", "pod")), sizes, {})


# ---------------------------------------------------------------------------
# (b) gloo ranks
# ---------------------------------------------------------------------------

# (arch, scaled_down kwargs): qwen3-moe's kv heads gathered (K 1 at M 2,
# as its K 4 at M 16); whisper's kv heads as its query heads
SPAWN_ARCHS = {
    "qwen3_4b": dict(num_heads=4),
    "qwen3_moe_235b_a22b": dict(num_heads=4, num_kv_heads=1, num_experts=4),
    "grok_1_314b": dict(num_heads=4),
    "whisper_tiny": dict(num_heads=4, num_kv_heads=4),
    "paligemma_3b": dict(num_heads=4, num_kv_heads=1),
}
SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=96)
WORLD2 = ("qwen3_4b", "qwen3_moe_235b_a22b", "grok_1_314b")
WORLD4 = ("whisper_tiny", "paligemma_3b")


def _rank_main(rank, fn, world, init_file, out):
    assert "jax" not in sys.modules, "a rank imported JAX"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        fn(rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, out):
    """fn(rank, out) in `world` gloo ranks (init by file, a fresh store);
    a rank that fails or outlives SPAWN_TIMEOUT_S fails the spawn."""
    init_file = os.path.join(out, f"pg_{fn.__name__}")
    ctx = mp.start_processes(_rank_main, args=(fn, world, init_file, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"{world} spawned ranks outlived {SPAWN_TIMEOUT_S} s")


def _tc(opt_name, ckpt_dir="/nonexistent"):
    # lr 1e-4, as tests/test_torch_mesh.py: Adam's lr g / (|g| + 1e-8)
    return TrainConfig(learning_rate=1e-4, total_steps=8, warmup_steps=2,
                       checkpoint_every=0, checkpoint_dir=ckpt_dir,
                       optimizer=opt_name)


def _weights(out, arch):
    return torch.load(os.path.join(out, f"weights_{arch}.pt"),
                      weights_only=False)


def _batches(cfg):
    return launch_train.lm_batch_fn(cfg.vocab_size, B, S, cfg, "cpu")


def _whole(params, grads):
    """{name: the whole tensor} of a sharded LM's blocks `grads`, gathered
    over the axes that split each (every rank enters)."""
    out = {}
    comm = params.tp.comm
    for name, p in params.named_parameters():
        g = grads[name]
        for d, axes in enumerate(p.tp_spec):
            axes = comm.live((axes,) if isinstance(axes, str)
                             else tuple(axes or ()))
            g = comm.all_gather(g, axes, d)
        out[name.replace(".", "/")] = g.detach().clone()
    return out


def _decode(model, params, cfg, batches):
    """3 decode steps from DECODE_POS (rows crossing the ranks' slices),
    the second row not written."""
    cache = model.init_cache(B, DECODE_T, torch.float32, "cpu",
                             params=params)
    toks = batches(3)["tokens"]
    pos, write = torch.tensor(DECODE_POS), torch.tensor([True, False])
    logits = []
    for t in range(3):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                      pos + t, write)
        logits.append(lg)
    return logits


class _Capture(Trainer):
    """A Trainer that keeps the clipped gradients of its last step."""

    def _update(self, grads, lr):
        self.grads = {k: v.detach().clone() for k, v in grads.items()}
        return super()._update(grads, lr)

    def whole_grads(self):
        if self._tp is None:
            return self.grads
        return {k: self._gather(g, self._split[k])
                for k, g in self.grads.items()}


def _run(arch, opt_name, mesh, out=None):
    """One step of `arch` (JAX's weights) on `mesh` (or whole) and, with
    AdamW, the loss's gradients first, the prefill logits and the decode
    steps under the decode rules (the cache split along its sequence)."""
    cfg, tree = _weights(out, arch)
    rules = sharding.arch_rules(cfg)
    model = build_model(cfg)
    params = bridge.lm_params_from_jax(tree, cfg, mesh=mesh, rules=rules)
    batches = _batches(cfg)
    res = {"shapes": {n: tuple(p.shape)
                      for n, p in params.named_parameters()}}
    if opt_name == "adamw":
        loss, _ = model.loss(params, batches(0))
        names, leaves = zip(*params.named_parameters())
        g = torch.autograd.grad(loss, leaves)
        grads = dict(zip(names, g))
        res["grads"] = (loss.item(), _whole(params, grads) if mesh is not None
                        else {n.replace(".", "/"): t
                              for n, t in grads.items()})
        with torch.no_grad():
            b = batches(2)
            res["logits"] = tfm.lm_apply(
                params, cfg, b["tokens"], prefix_embeds=b.get("patches"),
                enc_memory=(tfm.encoder_apply(params, cfg, b["frames"])
                            if cfg.encoder_layers else None))[0]
        dparams = bridge.lm_params_from_jax(
            tree, cfg, mesh=mesh, rules=rules_for("decode_32k", cfg))
        res["decode"] = _decode(model, dparams, cfg, batches)
    tr = _Capture(lambda p, bb: model.loss(p, bb), params, _tc(opt_name),
                  mesh=mesh)
    res["metrics"] = tr.step(batches(0))
    res["step_grads"] = tr.whole_grads()
    res["params"] = {k: v.detach().clone()
                     for k, v in tr._live_tree()["params"].items()}
    return res


def _world2(rank, out):
    mesh = launch_mesh.make_mesh((1, 2), ("data", "model"))
    for arch in WORLD2:
        for opt_name in ("adamw", "adafactor"):
            res = _run(arch, opt_name, mesh, out)
            torch.save(res, os.path.join(out, f"w2_{arch}_{opt_name}_r{rank}"
                                         ".pt"))


def _world4(rank, out):
    mesh = launch_mesh.make_mesh((2, 2), ("data", "model"))
    for arch in WORLD4:
        cfg, tree = _weights(out, arch)
        model = build_model(cfg)
        params = bridge.lm_params_from_jax(tree, cfg, mesh=mesh,
                                           rules=sharding.arch_rules(cfg))
        tr = _Capture(lambda p, bb: model.loss(p, bb), params,
                      _tc("adamw", os.path.join(out, f"ckpt_{arch}")),
                      mesh=mesh)
        metrics = tr.step(_batches(cfg)(0))
        tr.maybe_checkpoint(force=True)
        # the unsharded run's checkpoint (written by the test) restored on
        # this mesh
        back = Trainer(lambda p, bb: model.loss(p, bb),
                       bridge.lm_params_from_jax(tree, cfg, mesh=mesh),
                       _tc("adamw", os.path.join(out, f"whole_{arch}")),
                       mesh=mesh)
        assert back.restore() and back.state.step == 1
        torch.save({"shapes": {n: tuple(p.shape)
                               for n, p in params.named_parameters()},
                    "restored": {k: v.detach().clone() for k, v in
                                 ckpt._flatten(back._live_tree()).items()},
                    "metrics": metrics, "step_grads": tr.whole_grads(),
                    "state": {k: v.detach().clone() for k, v in
                              ckpt._flatten(tr._live_tree()).items()}},
                   os.path.join(out, f"w4_{arch}_r{rank}.pt"))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX trees of the scaled-down archs (JAX's names, shapes and
    dtypes), then both spawns."""
    from test_torch_lm_train import _seeded
    out = str(tmp_path_factory.mktemp("tp"))
    seeded = {}
    for arch, kw in SPAWN_ARCHS.items():
        jcfg, tcfg, lm, tree = _seeded(arch, **dict(SMALL, **kw))
        seeded[arch] = (jcfg, tcfg, tree)
        torch.save((tcfg, tree), os.path.join(out, f"weights_{arch}.pt"))
        if arch in WORLD4:      # an unsharded checkpoint for the mesh
            model = build_model(tcfg)
            tr = Trainer(lambda p, bb: model.loss(p, bb),
                         bridge.lm_params_from_jax(tree, tcfg),
                         _tc("adamw", os.path.join(out, f"whole_{arch}")))
            tr.step(_batches(tcfg)(1))
            tr.maybe_checkpoint(force=True)
            torch.save({k: v.detach().clone() for k, v in
                        ckpt._flatten(tr._live_tree()).items()},
                       os.path.join(out, f"whole_{arch}.pt"))
    _spawn(_world2, 2, out)
    _spawn(_world4, 4, out)
    return out, seeded


def _load(out, name):
    return torch.load(os.path.join(out, name + ".pt"), weights_only=False)


def _grads_held(got, want, what):
    """Gradients leaf by leaf within 1e-4 x max(1, max|g|)."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        _close(got[k], w, f"{what}: {k}", atol=tol, rtol=0)


def _held(got, want, what, skip=()):
    """Parameters after a step, leaf by leaf at relative L2 1e-4 (`skip`:
    leaves held by their gradients alone, see the module doc)."""
    assert sorted(got) == sorted(want), what
    for k in want:
        if k.rsplit("/", 1)[-1] in skip:
            continue
        assert _rel(got[k], want[k]) <= 1e-4, f"{what}: {k} " \
            f"{_rel(got[k], want[k]):.3g}"


def _blocks_only(shapes, cfg, sizes, world):
    """Each rank holds its blocks: local shapes from the pruned specs, and
    the ranks' numels summing to the whole tensor's times its replicas."""
    specs = tfm.lm_param_specs(cfg)
    rules = sharding.arch_rules(cfg)
    whole = {n: tuple(p.shape) for n, p in
             build_model(cfg).init(0, "cpu").named_parameters()}
    for name, full in whole.items():
        spec = sharding.pruned_spec(specs[name.replace(".", "/")], full,
                                    sizes, rules)
        split = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                split *= sizes[a]
        local = [s[name] for s in shapes]
        assert all(np.prod(shp) * split == np.prod(full) for shp in local), \
            (name, local, full, spec)
        assert sum(np.prod(shp) for shp in local) == \
            np.prod(full) * world // split, name
    return True


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", WORLD2)
def test_world2_step_matches_unsharded_and_jax(spawned, arch, opt_name):
    """One step on a (1, 2) mesh: the metrics, the step's clipped
    gradients and the parameters after it against the unsharded port;
    with AdamW also the loss and every gradient against `jax.grad` and
    the step against JAX's (its Trainer's body on those gradients:
    `global_norm_clip`, `lr_schedule`, `adamw_update`)."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jax_build_model
    from repro.train import optimizer as jopt
    from test_torch_lm_train import _assert_grads, _flat_jax
    out, seeded = spawned
    got = _load(out, f"w2_{arch}_{opt_name}_r0")
    want = _run(arch, opt_name, None, out)
    for k in ("loss", "nll", "aux", "grad_norm"):
        _close(got["metrics"][k], want["metrics"][k], k, atol=1e-7)
    _grads_held(got["step_grads"], want["step_grads"], f"{arch} {opt_name}")
    _held(got["params"], want["params"], f"{arch} {opt_name}")
    if opt_name != "adamw":
        return
    jcfg, tcfg, tree = seeded[arch]
    jmodel = jax_build_model(jcfg)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batches(tcfg)(0).items()}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, impl="ref"), has_aux=True))(jtree,
                                                                   batch)
    _close(got["grads"][0], float(jloss), "loss vs JAX")
    _assert_grads(tcfg, got["grads"][1], jgrads)
    tc = _tc("adamw")

    @jax.jit
    def jax_step(g, p):
        clipped, gnorm = jopt.global_norm_clip(g, tc.grad_clip)
        lr = jopt.lr_schedule(0, base_lr=tc.learning_rate,
                              warmup_steps=tc.warmup_steps,
                              total_steps=tc.total_steps)
        return jopt.adamw_update(clipped, jopt.adamw_init(p), p, lr=lr,
                                 weight_decay=tc.weight_decay)[0], gnorm

    jparams, gnorm = jax_step(jgrads, jtree)
    _close(got["metrics"]["grad_norm"], float(gnorm), "grad_norm vs JAX",
           rtol=1e-4)
    flat = _flat_jax(jparams)
    for name, v in got["params"].items():
        at = tfm.stacked_key(tcfg, name)
        jv = flat[name] if at is None else flat[at[0]][at[1]]
        assert _rel(v, jv) <= 1e-4, f"{name} vs JAX"


@pytest.mark.parametrize("arch", WORLD2)
def test_world2_prefill_and_decode(spawned, arch):
    """Vocab-parallel prefill logits, gathered whole, against the
    unsharded port and JAX's `lm_apply`; 3 decode steps on caches split
    along their sequence (rows crossing the ranks' slices, one row not
    written) against the unsharded port."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jtfm
    out, seeded = spawned
    got = _load(out, f"w2_{arch}_adamw_r0")
    want = _run(arch, "adamw", None, out)
    _close(got["logits"], want["logits"], "prefill logits")
    jcfg, tcfg, tree = seeded[arch]
    toks = _batches(tcfg)(2)["tokens"].numpy()
    jlogits, _ = jax.jit(lambda p, t: jtfm.lm_apply(p, jcfg, t, impl="ref"))(
        tree, jnp.asarray(toks))
    _close(got["logits"], jlogits, "prefill logits vs JAX", atol=1e-4)
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _close(g, w, f"decode step {t}")


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_only_their_blocks(spawned, world):
    out, _ = spawned
    sizes = {"data": 1, "model": 2} if world == 2 else {"data": 2,
                                                        "model": 2}
    for arch in (WORLD2 if world == 2 else WORLD4):
        cfg, _ = _weights(out, arch)
        name = (f"w2_{arch}_adamw_r{{}}" if world == 2 else
                f"w4_{arch}_r{{}}")
        shapes = [_load(out, name.format(r))["shapes"] for r in range(world)]
        assert _blocks_only(shapes, cfg, sizes, world)


@pytest.mark.parametrize("arch", WORLD4)
def test_world4_step_matches_unsharded(spawned, arch):
    """One AdamW step on a (2, 2) mesh (rows over "data", FSDP's gathers,
    heads, ff columns and vocab rows over "model"; whisper's encoder and
    cross-attention, paligemma's prefix) against the unsharded port."""
    out, _ = spawned
    got = _load(out, f"w4_{arch}_r0")
    cfg, tree = _weights(out, arch)
    model = build_model(cfg)
    tr = _Capture(lambda p, bb: model.loss(p, bb),
                  bridge.lm_params_from_jax(tree, cfg), _tc("adamw"))
    metrics = tr.step(_batches(cfg)(0))
    for k in ("loss", "nll", "grad_norm"):
        _close(got["metrics"][k], metrics[k], k, atol=1e-7)
    _grads_held(got["step_grads"], tr.grads, arch)
    params = {k[len("params/"):]: v for k, v in got["state"].items()
              if k.startswith("params/")}
    _held(params, {k: v.detach() for k, v in tr.state.params.items()},
          arch, skip=("bk",))


@pytest.mark.parametrize("arch", WORLD4)
def test_unsharded_checkpoint_restores_on_2x2(spawned, arch):
    """An unsharded Trainer's checkpoint restores on the (2, 2) mesh: each
    rank takes its blocks, which gather back bitwise to the whole state."""
    out, _ = spawned
    got = _load(out, f"w4_{arch}_r0")["restored"]
    want = _load(out, f"whole_{arch}")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_checkpoint_on_2x2_restores_unsharded(spawned):
    """whisper's checkpoint written on the (2, 2) mesh (full tensors,
    global rank 0) restores bitwise into an unsharded Trainer."""
    out, _ = spawned
    arch = "whisper_tiny"
    got = _load(out, f"w4_{arch}_r0")
    cfg, tree = _weights(out, arch)
    model = build_model(cfg)
    tr = Trainer(lambda p, bb: model.loss(p, bb),
                 build_model(cfg).init(5, "cpu"),
                 _tc("adamw", os.path.join(out, f"ckpt_{arch}")))
    assert tr.restore() and tr.state.step == 1
    state = {k: v.detach() for k, v in ckpt._flatten(tr._live_tree()).items()}
    assert sorted(state) == sorted(got["state"])
    for k, v in got["state"].items():
        assert torch.equal(state[k], v), k


# ---------------------------------------------------------------------------
# (c) the dry-run
# ---------------------------------------------------------------------------

def test_dryrun_counts_the_rank_blocks(tmp_path, monkeypatch):
    """A scaled-down qwen3-4b x train_4k on the 16 x 16 mesh, on meta:
    the held bytes are the blocks and their optimizer state (no whole
    parameters), and the step's own collectives over "model" are
    counted."""
    from repro_torch.launch import dryrun
    small = _cfg("qwen3_4b", num_heads=16, num_kv_heads=16, d_model=256,
                 d_ff=512, vocab_size=1024)
    monkeypatch.setattr(dryrun, "get_arch", lambda name: small)
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    d = dryrun.run_cell("qwen3_4b", "train_4k", False)
    assert d["status"] == "OK"
    held = d["held_bytes"]
    assert "params_full" not in held and set(held) == {"params", "inputs",
                                                       "opt"}
    n = sum(p.numel() for p in tfm.LM(small).parameters())
    assert held["params"] < 4 * n / 16
    coll = d["count"]["collective_bytes"]
    assert coll["model all-reduce"] > 0 and "model all-gather" not in coll
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert "tensor-parallel" in d["model_axis"]
    t = d["roofline"]
    assert t["model_link_bw"] > 0 and t["link_bw"] > 0
