"""Tensor-parallel compute of the recurrent and hybrid LMs (RWKV, Mamba,
mLSTM, sLSTM) and of Stage 1 and Stage 2 on the CPU, held against the
unsharded port and JAX:

  (a) one process, no process group: for M in {2, 4} the ranks of a
      "model" axis run as threads (`collectives.rank_shares(mode=
      "thread")`, `run_threads`), every collective of the forward and
      the backward meeting the other ranks' in-process, the sums in rank
      order; each rank's output and gradients against the unsharded
      module's and JAX's: the RWKV time-mix (M dividing H, and not) and
      channel-mix, Mamba (and a mutation: the naive contiguous split of
      in_proj's output fails), the mLSTM (its heads, and every head from
      its channels), the sLSTM (its heads; the FFN split at M 2, whole at
      M 4), the Stage-1 tables, pool and NTP/NIP heads, Stage 2's SAB,
      PMA and CPI head, each recurrent decode step from a rank's cache,
      and the gradient through each model-axis all-sum (a mutation: an
      all-reduce forward with the identity backward gets it wrong);
  (b) two spawns of gloo ranks (each within SPAWN_TIMEOUT_S): world 2 on
      a (1, 2) mesh, scaled-down xlstm and semanticbbv-encoder (a step,
      prefill logits and 3 decode steps), a Stage-1 pre-training step and
      a `Stage2Engine` step; world 4 on a (2, 2) mesh, a scaled-down
      jamba (Mamba, attention, MoE) step and a Stage-2 checkpoint
      restored unsharded. Each rank holds only its blocks;
  (c) the dry-run of tiny jamba and xlstm cells on meta at M 16.

The ranks import the port only (JAX is imported inside the tests).
Outputs, losses and logits are held at relative 1e-5, gradients at
1e-4 x max(1, max|g|), parameters after a step at relative L2 1e-4 a
leaf (AdamW at lr 1e-4, as tests/test_torch_mesh.py: its step lr g /
(|g| + 1e-8) turns summation-order differences near |g| ~ 1e-8 into
differences of the step).
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
from repro_torch.core import bbe as tbbe  # noqa: E402
from repro_torch.core import signature as tsig  # noqa: E402
from repro_torch.core.tokenizer import default_tokenizer  # noqa: E402
from repro_torch.distributed import collectives, sharding  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    ModelShard, rank_shares, run_threads,
)
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.stage2 import Stage2Engine  # noqa: E402

SPAWN_TIMEOUT_S = 110
MS = (2, 4)
B, S = 2, 16
DECODE_STEPS = 3


def _x(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _out_close(got, want, what):
    """Outputs, losses, logits: relative L2 1e-5."""
    assert _rel(got, want) <= 1e-5, f"{what}: relative {_rel(got, want):.3g}"


def _grad_close(got, want, what):
    """Gradients: 1e-4 x max(1, max|g|) elementwise."""
    want = np.asarray(want, np.float64)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=tol,
                               rtol=0, err_msg=what)


def _perturbed(module, seed):
    """Nonzero biases and norm scales (they init at 0 and 1)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)
                                    * 0.05).to(p.dtype))
    return module


def _jnp_tree(module, flat=None):
    """The module's parameters (or `flat`, {"/"- or "."-joined name:
    array}) as JAX's nested tree of their names, a node whose keys are
    all indices as a list."""
    import jax.numpy as jnp
    if flat is None:
        flat = {n: p.detach().float().numpy()
                for n, p in module.named_parameters()}
    tree = {}
    for name, a in flat.items():
        *path, leaf = name.replace("/", ".").split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a.detach().float().numpy()
                                 if isinstance(a, torch.Tensor) else a)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _on_model(p) -> bool:
    return any("model" in sharding.axes_of(e) for e in p.tp_spec)


def _shares(module, specs, M, fn, inputs, cot, cfg=None):
    """Every rank of a "model" axis of M in a thread: out = fn(share,
    *xs) on fresh leaves xs of `inputs`, and the gradients of xs and of
    the share's blocks for the cotangent `cot`. Returns [(out, [dx],
    {name: grad}, share)] in rank order."""
    shares = rank_shares(module, specs, cfg, M, mode="thread")

    def one(r):
        xs = [t.clone().requires_grad_() for t in inputs]
        out = fn(shares[r], *xs)
        params = dict(shares[r].named_parameters())
        g = torch.autograd.grad(out, xs + list(params.values()), cot,
                                allow_unused=True, materialize_grads=True)
        return out.detach(), g[:len(xs)], dict(zip(params, g[len(xs):])), \
            shares[r]

    return run_threads(one, M, shares[0].tp.comm.room)


def _hold(res, module, fn, inputs, cot, M, what, jout=None):
    """The ranks' outputs and input gradients are the same on every rank
    and the unsharded module's (and `jout`, JAX's output); each rank's
    gradient of a block split over "model" is its block of the unsharded
    gradient, of a replicated leaf the whole one."""
    xs = [t.clone().requires_grad_() for t in inputs]
    ref = fn(module, *xs)
    params = dict(module.named_parameters())
    g = torch.autograd.grad(ref, xs + list(params.values()), cot,
                            allow_unused=True, materialize_grads=True)
    out0, dx0 = res[0][0], res[0][1]
    for out, dx, _, _ in res[1:]:
        assert torch.equal(out, out0), f"{what}: outputs differ by rank"
        for a, b in zip(dx, dx0):
            assert torch.equal(a, b), f"{what}: input grads differ by rank"
    _out_close(out0, ref.detach(), f"{what} output")
    if jout is not None:
        _out_close(out0, jout, f"{what} output vs JAX")
    for i, (a, b) in enumerate(zip(dx0, g[:len(xs)])):
        _grad_close(a, b, f"{what} input {i} grad")
    want = dict(zip(params, g[len(xs):]))
    for r, (_, _, grads, share) in enumerate(res):
        for n, gp in grads.items():
            p = dict(share.named_parameters())[n]
            w = (sharding.local_block(want[n], p.tp_spec, {"model": M},
                                      {"model": r})
                 if _on_model(p) else want[n])
            _grad_close(gp, w, f"{what} rank {r} d{n}")


_JAX = {}


def _once(key, fn):
    """fn()'s value, computed once a test run (JAX's side of a case, which
    does not depend on M)."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


# ---------------------------------------------------------------------------
# (a) each rank's share, ranks as threads of one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("H", [4, 6], ids=["H4", "H6"])
def test_timemix_shares(H, M):
    """wkv on the rank's H/M heads, ln_x's sum of squares summed over
    "model", its rows of wo, where M divides H; every head from the
    gathered weights where it does not (6 heads at M 4, bitwise)."""
    import jax
    import jax.numpy as jnp
    from repro.models import rwkv as jrwkv
    d = 48
    mod = _perturbed(trwkv.TimeMix(torch.Generator().manual_seed(1), d, H),
                     2)
    x, dy = _x(3, B, S, d), _x(4, B, S, d)
    jout = _once(("timemix", H), lambda: jax.jit(
        lambda p, z: jrwkv.timemix_apply(p, z, H))(
        _jnp_tree(mod), jnp.asarray(x.numpy())))
    res = _shares(mod, trwkv.timemix_specs(), M, lambda m, z: m(z), [x], dy)
    assert res[0][3].heads_split() == (H % M == 0)
    if H % M:
        assert torch.equal(res[0][0], mod(x).detach())
    _hold(res, mod, lambda m, z: m(z), [x], dy, M, f"timemix H{H} M{M}",
          jout)


@pytest.mark.parametrize("M", MS)
def test_channelmix_shares(M):
    import jax
    import jax.numpy as jnp
    from repro.models import rwkv as jrwkv
    d = 48
    mod = _perturbed(trwkv.ChannelMix(torch.Generator().manual_seed(5), d), 6)
    x, dy = _x(7, B, S, d), _x(8, B, S, d)
    jout = _once("channelmix", lambda: jax.jit(jrwkv.channelmix_apply)(
        _jnp_tree(mod), jnp.asarray(x.numpy())))
    res = _shares(mod, trwkv.channelmix_specs(), M, lambda m, z: m(z), [x],
                  dy)
    assert res[0][3].wk.shape == (d, 4 * d // M)
    _hold(res, mod, lambda m, z: m(z), [x], dy, M, f"channelmix M{M}", jout)


def _mamba(d=64, d_state=8):
    return _perturbed(tssm.Mamba(torch.Generator().manual_seed(9), d,
                                 d_state, 4, torch.float32), 10)


@pytest.mark.parametrize("M", MS)
def test_mamba_shares(M):
    """The rank's DI/M inner channels: in_proj's block exchanged into its
    channels of xi and z, x_proj's partial summed both ways, the scan on
    its channels, its rows of out_proj."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    mod = _mamba()
    x, dy = _x(11, B, S, 64), _x(12, B, S, 64)

    def fn(m, z):
        return tssm.mamba_apply(m, z, 8)

    jout = _once("mamba", lambda: jax.jit(
        lambda p, z: jssm.mamba_apply(p, z, 8))(_jnp_tree(mod),
                                               jnp.asarray(x.numpy())))
    res = _shares(mod, tssm.mamba_specs(), M, fn, [x], dy)
    assert res[0][3].conv_w.shape == (4, 128 // M)
    _hold(res, mod, fn, [x], dy, M, f"mamba M{M}", jout)


@pytest.mark.parametrize("M", MS)
def test_mamba_naive_split_fails(M, monkeypatch):
    """Mutation: a rank that cuts its own block of in_proj's output into
    two contiguous halves (rank 0 then holds only xi's channels, rank 1
    only z's) computes something else."""
    mod = _mamba()
    x, dy = _x(11, B, S, 64), _x(12, B, S, 64)
    ref = tssm.mamba_apply(mod, x, 8)
    monkeypatch.setattr(ModelShard, "exchange_halves",
                        lambda self, p: p.chunk(2, dim=-1))
    res = _shares(mod, tssm.mamba_specs(), M,
                  lambda m, z: tssm.mamba_apply(m, z, 8), [x], dy)
    assert _rel(res[0][0], ref.detach()) > 1e-2


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("H", [4, 2], ids=["heads", "every_head"])
def test_mlstm_shares(H, M):
    """Its channels and, where M divides H, its heads; at H 2 on M 4 the
    rank's q, k, v channels are gathered and every head computed, its
    channels of h kept."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    d = 64
    mod = _perturbed(tssm.MLSTM(torch.Generator().manual_seed(13), d, H, 4,
                                torch.float32), 14)
    x, dy = _x(15, B, S, d), _x(16, B, S, d)

    def fn(m, z):
        return tssm.mlstm_apply(m, z, H, chunk=8)

    jout = _once(("mlstm", H), lambda: jax.jit(
        lambda p, z: jssm.mlstm_apply(p, z, H, chunk=8))(
        _jnp_tree(mod), jnp.asarray(x.numpy())))
    res = _shares(mod, tssm.mlstm_specs(), M, fn, [x], dy)
    assert tssm._mlstm_split(res[0][3], H) == (True, H % M == 0)
    _hold(res, mod, fn, [x], dy, M, f"mlstm H{H} M{M}", jout)


@pytest.mark.parametrize("M", MS)
def test_slstm_shares(M):
    """The rank's heads' recurrence, h gathered once; the FFN (d_ff 58 of
    d 44) split at M 2 (a, b exchanged), whole at M 4, where `up` (116
    columns) is stored split but its halves are not whole blocks, as
    xlstm-1.3b's 2730 at M 4."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    d, H = 44, 4
    mod = _perturbed(tssm.SLSTM(torch.Generator().manual_seed(17), d, H, 4,
                                torch.float32), 18)
    x, dy = _x(19, B, S, d), _x(20, B, S, d)

    def fn(m, z):
        return tssm.slstm_apply(m, z, H)

    jout = _once("slstm", lambda: jax.jit(
        lambda p, z: jssm.slstm_apply(p, z, H))(_jnp_tree(mod),
                                               jnp.asarray(x.numpy())))
    res = _shares(mod, tssm.slstm_specs(), M, fn, [x], dy)
    share = res[0][3]
    assert tssm._slstm_split(share, H)
    assert share.up.shape == (d, 116 // M)
    assert share.down.shape == ((58 // M, d) if M == 2 else (58, d))
    _hold(res, mod, fn, [x], dy, M, f"slstm M{M}", jout)


SUMS = {"mamba": "x_proj", "mlstm": "w_if", "timemix": "ln_x"}


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("mixer", sorted(SUMS))
def test_all_sum_gradient(mixer, M, monkeypatch):
    """The sum that rank-local compute consumes is summed over "model" in
    both directions (the shares' tests hold the gradient through it):
    with an all-reduce forward and the identity backward (a reduce-out)
    in its place, the forward is the same but the gradients into the
    rank's channels are partial, and wrong."""
    d = 64 if mixer != "timemix" else 48
    if mixer == "mamba":
        mod = _mamba()
        fn = lambda m, z: tssm.mamba_apply(m, z, 8)  # noqa: E731
        specs = tssm.mamba_specs()
    elif mixer == "mlstm":
        mod = _perturbed(tssm.MLSTM(torch.Generator().manual_seed(13), d, 4,
                                    4, torch.float32), 14)
        fn = lambda m, z: tssm.mlstm_apply(m, z, 4, chunk=8)  # noqa: E731
        specs = tssm.mlstm_specs()
    else:
        mod = _perturbed(trwkv.TimeMix(torch.Generator().manual_seed(1), d,
                                       4), 2)
        fn = lambda m, z: m(z)  # noqa: E731
        specs = trwkv.timemix_specs()
    x, dy = _x(21, B, S, d), _x(22, B, S, d)
    xx = x.clone().requires_grad_()
    ref = fn(mod, xx)
    dx, = torch.autograd.grad(ref, xx, dy)
    monkeypatch.setattr(ModelShard, "all_sum", ModelShard.reduce_out)
    bad = _shares(mod, specs, M, fn, [x], dy)
    _out_close(bad[0][0], ref.detach(), f"{mixer} forward")
    assert _rel(bad[0][1][0], dx) > 1e-3, \
        f"{mixer}: a one-way sum left dx right"


def _state_blocks(kind, state, M, r):
    """Rank r's blocks of a mixer's decode state (`transformer.
    _STATE_SPECS`, pruned)."""
    specs = tfm._STATE_SPECS[kind]
    out = {}
    for k, t in state.items():
        spec = sharding.pruned_spec(specs[k], t.shape, {"model": M})
        out[k] = sharding.local_block(t, spec, {"model": M},
                                      {"model": r}).clone()
    return out


DECODE = {
    "rwkv": (48, 4), "mamba": (64, 0), "mlstm": (64, 4), "slstm": (44, 4),
}


def _decoder(kind, mod, H):
    """(share or module, x, state) -> (out, new state) of one token."""
    if kind == "rwkv":
        def step(m, x, st):
            out, shift, S_ = trwkv.timemix_decode(m, x, st["tm_shift"],
                                                  st["S"])
            return out, {"tm_shift": shift, "S": S_}
        return step
    fn = {"mamba": lambda m, x, st: tssm.mamba_decode(m, x, st, 8),
          "mlstm": lambda m, x, st: tssm.mlstm_decode(m, x, st, H),
          "slstm": lambda m, x, st: tssm.slstm_decode(m, x, st, H)}
    return fn[kind]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("kind", sorted(DECODE))
def test_decode_step_shares(kind, M):
    """One token from a nonzero state: each rank steps from its blocks of
    the state (its heads of S and C, its channels of Mamba's and the
    mLSTM's conv context), its new blocks are the blocks of the
    unsharded new state, the output is the unsharded step's and JAX's,
    and the states the specs keep whole (the token shift, the sLSTM's
    h, c, n, m) are bitwise the same on every rank."""
    import jax
    import jax.numpy as jnp
    from repro.models import rwkv as jrwkv
    from repro.models import ssm as jssm
    d, H = DECODE[kind]
    gen = torch.Generator().manual_seed(23)
    if kind == "rwkv":
        mod = trwkv.TimeMix(gen, d, H)
        state = {"tm_shift": _x(24, B, d), "S": 0.1 * _x(25, B, H, d // H,
                                                         d // H)}
        specs = trwkv.timemix_specs()
    elif kind == "mamba":
        mod = tssm.Mamba(gen, d, 8, 4, torch.float32)
        state = {"conv": _x(24, B, 3, 2 * d), "ssm": 0.1 * _x(25, B, 2 * d,
                                                              8)}
        specs = tssm.mamba_specs()
    elif kind == "mlstm":
        mod = tssm.MLSTM(gen, d, H, 4, torch.float32)
        dh = 2 * d // H
        state = {"conv": _x(24, B, 3, 2 * d),
                 "C": 0.1 * _x(25, B, H, dh, dh), "n": _x(26, B, H, dh),
                 "m": _x(27, B, H)}
        specs = tssm.mlstm_specs()
    else:
        mod = tssm.SLSTM(gen, d, H, 4, torch.float32)
        state = {k: _x(24 + i, B, d) for i, k in enumerate("hcnm")}
        state["n"] = state["n"].abs() + 1.0
        state["conv"] = _x(28, B, 3, d)
        specs = tssm.slstm_specs()
    _perturbed(mod, 29)
    step = _decoder(kind, mod, H)
    x = _x(30, B, 1, d)
    with torch.no_grad():
        ref, new = step(mod, x, dict(state))
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}

    def jax_step():
        p, xx = _jnp_tree(mod), jnp.asarray(x.numpy())
        if kind == "rwkv":
            return jax.jit(lambda p, z, a, b: jrwkv.timemix_decode(
                p, z, a, b, H))(p, xx, jstate["tm_shift"], jstate["S"])[0]
        fn = {"mamba": lambda p, z, s: jssm.mamba_decode(p, z, s, 8),
              "mlstm": lambda p, z, s: jssm.mlstm_decode(p, z, s, H),
              "slstm": lambda p, z, s: jssm.slstm_decode(p, z, s, H)}[kind]
        return jax.jit(fn)(p, xx, jstate)[0]

    jout = _once(("decode", kind), jax_step)
    shares = rank_shares(mod, specs, None, M, mode="thread")
    skind = {"rwkv": "rwkv", "mamba": "mamba", "mlstm": "mlstm",
             "slstm": "slstm"}[kind]

    def one(r):
        with torch.no_grad():
            return step(shares[r], x, _state_blocks(skind, state, M, r))

    got = run_threads(one, M, shares[0].tp.comm.room)
    for out, _ in got[1:]:
        assert torch.equal(out, got[0][0])
    _out_close(got[0][0], ref, f"{kind} M{M} decode output")
    _out_close(got[0][0], jout, f"{kind} M{M} decode output vs JAX")
    whole = {"rwkv": ("tm_shift",), "slstm": tuple("hcnm") + ("conv",)}
    for r, (_, st) in enumerate(got):
        want = _state_blocks(skind, new, M, r)
        for k, v in st.items():
            _out_close(v, want[k], f"{kind} M{M} rank {r} state {k}")
            if k in whole.get(kind, ()):
                assert torch.equal(v, got[0][1][k]), \
                    f"{kind} state {k} differs by rank"


# the Stage-1 tables have 352, 16, 6, 5, 4, 4 rows
TINY_BBE = dict(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2, num_heads=4,
                bbe_dim=32, max_len=S)


def _bbe(dtype="float32"):
    """A seeded, perturbed BBEEncoder of TINY_BBE (the same on every
    process)."""
    return _perturbed(tbbe.BBEEncoder(tbbe.BBEConfig(**TINY_BBE,
                                                     dtype=dtype), seed=31),
                      32)


def _bbe_tokens(seed=32):
    rng = np.random.RandomState(seed)
    sizes = default_tokenizer().spec.dim_sizes
    toks = np.stack([rng.randint(-2, n + 2, (B, S)) for n in sizes], -1)
    toks[:, -3:, 0] = 0             # padding
    toks[:, 4, 0] = 3               # an instruction boundary
    return torch.from_numpy(toks)


@pytest.mark.parametrize("M", MS)
def test_stage1_shares(M):
    """The tables whose spec splits them over "model" (352, 16, 4 and 4
    rows at M 4; also 6 at M 2) looked up vocab-parallel, bitwise the
    unsharded lookup; the pool's columns of its logit, reduced out; the
    NTP/NIP heads' hidden columns, their logits reduced out; against
    the unsharded encoder and JAX's pool and heads."""
    import jax
    import jax.numpy as jnp
    from repro.core import bbe as jbbe
    enc = _bbe()
    toks = _bbe_tokens()
    shares = rank_shares(enc, enc.param_specs(), None, M, mode="thread")
    split = [i for i, t in enumerate(shares[0].embeds)
             if _on_model(t)]
    assert split == ([0, 1, 2, 4, 5] if M == 2 else [0, 1, 4, 5])
    looked = run_threads(lambda r: shares[r].embed(toks).detach(), M,
                         shares[0].tp.comm.room)
    want = enc.embed(toks).detach()
    assert all(torch.equal(t, want) for t in looked)
    h = _x(33, B, S, enc.cfg.d_model)
    valid = toks[..., 0] != 0
    for name, fn, jfn in (
            ("pool", lambda m, z: m.pool(z, valid),
             lambda p, z: jbbe.attention_pool(p, z,
                                              jnp.asarray(valid.numpy()))),
            ("ntp_head", lambda m, z: m.ntp_head(z), jbbe._mlp_head),
            ("nip_head", lambda m, z: m.nip_head(z), jbbe._mlp_head)):
        out = fn(enc, h)
        dy = _x(34, *out.shape)
        jout = _once(("stage1", name), lambda: jax.jit(jfn)(
            _jnp_tree(getattr(enc, name)), jnp.asarray(h.numpy())))
        res = _shares(enc, enc.param_specs(), M, fn, [h], dy)
        _hold(res, enc, fn, [h], dy, M, f"stage1 {name} M{M}", jout)


TINY_SIG = dict(bbe_dim=32, d_model=32, sig_dim=16, max_set=12, num_heads=4)


def _sig(dtype="float32"):
    """A seeded, perturbed SignatureModel of TINY_SIG and its config (the
    same on every process)."""
    cfg = tsig.SignatureConfig(**TINY_SIG, dtype=dtype)
    return _perturbed(tsig.SignatureModel(cfg, seed=35), 36), cfg


def _sets(seed, n=12):
    r = np.random.RandomState(seed)
    mask = r.rand(B, n) > 0.25
    mask[:, 0] = True
    return {"bbes": torch.from_numpy(r.randn(B, n, 32).astype(np.float32)),
            "freqs": torch.from_numpy((r.rand(B, n) * 9).astype(np.float32)),
            "mask": torch.from_numpy(mask)}


@pytest.mark.parametrize("M", MS)
def test_stage2_shares(M):
    """A SAB and the PMA on the rank's heads (2 and 1 of 4), their ff1
    columns and ff2 rows (ff2's bias once, after the reduce), and the
    CPI head's hidden columns (b2 once), against the unsharded modules
    and JAX's `_mab_apply`."""
    import jax
    import jax.numpy as jnp
    from repro.models import set_transformer as jst
    model, _ = _sig()
    st = model.set_transformer
    sets = _sets(37)
    logw = torch.log1p(sets["freqs"])
    bias = logw / torch.clamp(logw.amax(-1, keepdim=True), min=1e-6)
    mask = sets["mask"]
    h = _x(38, B, 12, 32)
    seeds = _x(39, B, 1, 32)
    jb, jm = jnp.asarray(bias.numpy()), jnp.asarray(mask.numpy())
    cases = (
        ("sab", st.sabs[0], lambda m, z: m(z, z, bias, mask),
         lambda p, z: jst._mab_apply(p, z, z, 4, jb, jm), [h]),
        ("pma", st.pma, lambda m, q, z: m(q, z, bias, mask),
         lambda p, q, z: jst._mab_apply(p, q, z, 4, jb, jm), [seeds, h]),
        ("cpi_head", model.cpi_head, lambda m, z: m(z),
         lambda p, z: jnp.tanh(z @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"],
         [_x(40, B, 16)]))
    for name, mod, fn, jfn, inputs in cases:
        specs = {k[len(pre):]: v for pre in (
            {"sab": "set_transformer/sabs/0/", "pma": "set_transformer/pma/",
             "cpi_head": "cpi_head/"}[name],)
            for k, v in model.param_specs().items() if k.startswith(pre)}
        out = fn(mod, *inputs)
        dy = _x(41, *out.shape)
        jout = _once(("stage2", name), lambda: jax.jit(jfn)(
            _jnp_tree(mod), *(jnp.asarray(t.numpy()) for t in inputs)))
        if name == "cpi_head":
            jout = jout[..., 0]
        res = _shares(mod, specs, M, fn, inputs, dy)
        if name != "cpi_head":
            assert res[0][3].mha.wq.shape == (32, 32 // M)
        _hold(res, mod, fn, inputs, dy, M, f"stage2 {name} M{M}", jout)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_bf16_losses_on_two_ranks(stage):
    """Stage 1's pre-training loss and Stage 2's loss (on bf16 BBEs) at
    dtype bfloat16, two ranks as threads (bf16 partial sums round once a
    rank). The loss and every gradient leaf are as near the fp32 run of
    the same weights as the unsharded bf16 run is (within 1.5 x its
    error, + 1e-3 relative), and the median leaf is within
    tests/test_torch_bf16.py's GRAD_REL (2e-2, relative L2) of the
    unsharded bf16 gradient: that file's per-leaf bound holds two runs
    that round in the same order, and a leaf summed over few tokens (a
    4-row table) differs by up to 12% between bf16 and fp32 here."""
    import copy
    if stage == "stage1":
        model = _bbe("bfloat16")
        toks = _bbe_tokens()

        def fn(m):
            return tbbe.pretrain_loss(m, {"tokens": toks})[0]
    else:
        model, cfg = _sig("bfloat16")
        batch = {"anchor": _sets(42), "positive": _sets(43),
                 "negative": _sets(44), "cpi": torch.tensor([1.5, 3.0])}
        for role in ("anchor", "positive", "negative"):
            batch[role]["bbes"] = batch[role]["bbes"].to(torch.bfloat16)

        def fn(m):
            return tsig.stage2_loss(m, cfg, batch)[0]

    def grads(m):
        loss = fn(m)
        ps = dict(m.named_parameters())
        return loss.detach(), dict(zip(ps, torch.autograd.grad(
            loss, list(ps.values()), allow_unused=True,
            materialize_grads=True))), ps

    ref, g16, _ = grads(model)
    ref32, g32, _ = grads(copy.deepcopy(model).float())
    shares = rank_shares(model, model.param_specs(), None, 2, mode="thread")
    res = run_threads(lambda r: grads(shares[r]), 2,
                      shares[0].tp.comm.room)
    assert torch.equal(res[0][0], res[1][0])
    l16, l32, got = ref.item(), ref32.item(), res[0][0].item()
    assert abs(got - l32) <= 1.5 * abs(l16 - l32) + 1e-3 * abs(l32)
    errs = []
    for r, (_, got, ps) in enumerate(res):
        for n, gp in got.items():
            def mine(t):
                return (sharding.local_block(t, ps[n].tp_spec, {"model": 2},
                                             {"model": r})
                        if _on_model(ps[n]) else t).float()
            errs.append(_rel(gp.float(), mine(g16[n])))
            assert _rel(gp.float(), mine(g32[n])) <= \
                1.5 * _rel(mine(g16[n]), mine(g32[n])) + 1e-3, (r, n)
    assert float(np.median(errs)) <= 2e-2


def test_thread_ranks_stress():
    """More rank threads than cores, switching often: every all-reduce,
    all-gather and all-to-all of a "thread" MeshComm meets the right
    ranks' values in rank order, and a kernel wrapper's launch count
    (`_lib.counted`, under its lock) loses no update."""
    from repro_torch.kernels import _lib
    n, rounds = 16, 20

    def wrapper():
        pass

    wrapper.launches = 0
    room = collectives.Room(n, timeout=60.0)
    comms = [collectives.MeshComm({"data": 4, "model": 4},
                                  {"data": r // 4, "model": r % 4},
                                  "thread", room=room) for r in range(n)]

    def one(r):
        comm, out = comms[r], []
        for i in range(rounds):
            t = torch.tensor([float(r * rounds + i)])
            out.append((comm.all_reduce(t.clone(), ("model",)).item(),
                        comm.all_gather(t, ("data",), 0).tolist(),
                        comm.all_to_all([t + d for d in range(4)],
                                        list(range(4)), list(range(4)))))
            for _ in range(50):
                _lib.counted(wrapper)
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = run_threads(one, n, room)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n * rounds * 50
    for r, out in enumerate(res):
        d, m = r // 4, r % 4
        for i, (summed, gathered, swapped) in enumerate(out):
            row = [float((d * 4 + k) * rounds + i) for k in range(4)]
            assert summed == sum(row)
            assert gathered == [float((k * 4 + m) * rounds + i)
                                for k in range(4)]
            assert [t.item() for t in swapped] == [v + m for v in row]


def test_a_failing_rank_breaks_the_room():
    """A rank that raises before a collective breaks the Room: the others
    stop waiting at once, and the rank's own exception reaches the
    caller."""
    room = collectives.Room(4, timeout=60.0)
    comms = [collectives.MeshComm({"model": 4}, {"model": r}, "thread",
                                  room=room) for r in range(4)]

    def one(r):
        if r == 2:
            raise KeyError("rank 2")
        return comms[r].all_reduce(torch.ones(1), ("model",))

    t = time.monotonic()
    with pytest.raises(KeyError, match="rank 2"):
        run_threads(one, 4, room)
    assert time.monotonic() - t < 10


# the units xlstm-1.3b and jamba's Mamba split at M 16 (and 2, 4)
UNITS = {
    ("xlstm_1_3b", 16): dict(mlstm=(True, False), slstm=False, ffn=False),
    ("xlstm_1_3b", 4): dict(mlstm=(True, True), slstm=True, ffn=False),
    ("xlstm_1_3b", 2): dict(mlstm=(True, True), slstm=True, ffn=True),
    ("jamba_1_5_large_398b", 16): dict(mamba=True),
}


@pytest.mark.parametrize("arch,M", sorted(UNITS))
def test_recurrent_units_at_full_width(arch, M):
    """From the stored specs of the full-width configs (on meta): xlstm's
    4 heads stay whole on 16 model ranks (the mLSTM gathers its q, k, v
    channels, the sLSTM computes every head), its sLSTM FFN (d_ff 2730)
    splits at M 2 only; jamba's DI 16384 Mamba channels split."""
    cfg = tconfig.get_arch(arch)
    comm = collectives.MeshComm({"data": 16, "model": M},
                                {"data": 0, "model": 0}, "count")
    want = UNITS[(arch, M)]
    d, H = cfg.d_model, cfg.num_heads
    with torch.device("meta"):
        if arch.startswith("jamba"):
            mx = tssm.Mamba(torch.Generator(), d, cfg.ssm_state_dim,
                            cfg.ssm_conv_dim, torch.bfloat16)
            collectives.shard_module(mx, comm, None, tssm.mamba_specs(), cfg)
            assert tssm._mamba_split(mx) == want["mamba"]
            return
        ml = tssm.MLSTM(torch.Generator(), d, H, cfg.ssm_conv_dim,
                        torch.bfloat16)
        sl = tssm.SLSTM(torch.Generator(), d, H, cfg.ssm_conv_dim,
                        torch.bfloat16)
    collectives.shard_module(ml, comm, None, tssm.mlstm_specs(), cfg)
    collectives.shard_module(sl, comm, None, tssm.slstm_specs(), cfg)
    assert tssm._mlstm_split(ml, H) == want["mlstm"]
    assert tssm._slstm_split(sl, H) == want["slstm"]
    assert (sl.tp.splits(sl.up, 1) and sl.tp.splits(sl.down, 0)) == \
        want["ffn"]


@pytest.mark.parametrize("model", ["xlstm_1_3b", "semanticbbv_encoder",
                                   "jamba_1_5_large_398b", "stage1",
                                   "stage2"])
def test_one_rank_mesh_is_bitwise_unsharded(model):
    """Built as the blocks of the one rank of a (1, 1) mesh, each model's
    loss and every gradient are bitwise the unsharded model's."""
    import copy
    comm = collectives.MeshComm({"data": 1, "model": 1},
                                {"data": 0, "model": 0}, "count")
    if model == "stage1":
        whole = _bbe()
        sharded = collectives.shard_module(copy.deepcopy(whole), comm)

        def fn(m):
            return tbbe.pretrain_loss(m, {"tokens": _bbe_tokens()})[0]
    elif model == "stage2":
        whole, cfg = _sig()
        sharded = collectives.shard_module(copy.deepcopy(whole), comm)
        batch = {"anchor": _sets(42), "positive": _sets(43),
                 "negative": _sets(44), "cpi": torch.tensor([1.5, 3.0])}

        def fn(m):
            return tsig.stage2_loss(m, cfg, batch)[0]
    else:
        cfg = tconfig.scaled_down(tconfig.get_arch(model),
                                  **SPAWN_ARCHS[model])
        lm = build_model(cfg)
        whole = lm.init(3, "cpu")
        sharded = lm.init(3, "cpu", mesh=comm)
        batch = launch_train.lm_batch_fn(cfg.vocab_size, B, LM_SEQ, cfg,
                                         "cpu")(0)

        def fn(m):
            return lm.loss(m, batch)[0]
    assert sharded.tp.M == 1
    got, want = fn(sharded), fn(whole)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got, list(sharded.parameters()),
                                        allow_unused=True,
                                        materialize_grads=True),
                    torch.autograd.grad(want, list(whole.parameters()),
                                        allow_unused=True,
                                        materialize_grads=True)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (b) gloo ranks
# ---------------------------------------------------------------------------

# (arch, scaled_down kwargs): xlstm's mLSTM and sLSTM (its FFN, d_ff 85,
# whole at M 2), the encoder's RWKV blocks, jamba's Mamba + MoE layer and
# attention + MLP layer
SPAWN_ARCHS = {
    "xlstm_1_3b": dict(num_layers=2, d_model=64, num_heads=4, d_ff=64,
                       vocab_size=96),
    "semanticbbv_encoder": dict(num_layers=2, d_model=64, num_heads=4,
                                d_ff=64, vocab_size=96),
    "jamba_1_5_large_398b": dict(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=2, d_ff=64, vocab_size=96,
                                 num_experts=4),
}
WORLD2 = ("xlstm_1_3b", "semanticbbv_encoder")
LM_SEQ = 16


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


def _tc(ckpt_dir="/nonexistent"):
    # lr 1e-4, as tests/test_torch_mesh.py: Adam's lr g / (|g| + 1e-8)
    return TrainConfig(learning_rate=1e-4, total_steps=8, warmup_steps=2,
                       checkpoint_every=0, checkpoint_dir=ckpt_dir,
                       optimizer="adamw")


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

    def whole_params(self):
        return {k: v.detach().clone()
                for k, v in self._live_tree()["params"].items()}


def _shapes(module):
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


def _lm_run(arch, mesh, out):
    """`arch` (JAX's weights, bridged; on `mesh` or whole): prefill
    logits; DECODE_STEPS decode steps (the second row not written) and
    the cache after them; one AdamW step (its metrics, clipped gradients
    and the parameters after it, gathered whole)."""
    cfg, tree = torch.load(os.path.join(out, f"weights_{arch}.pt"),
                           weights_only=False)
    model = build_model(cfg)
    params = bridge.lm_params_from_jax(tree, cfg, mesh=mesh)
    batches = launch_train.lm_batch_fn(cfg.vocab_size, B, LM_SEQ, cfg, "cpu")
    res = {"shapes": _shapes(params)}
    with torch.no_grad():
        res["logits"] = tfm.lm_apply(params, cfg, batches(2)["tokens"])[0]
    cache = model.init_cache(B, 8, torch.float32, "cpu", params=params)
    toks, write = batches(3)["tokens"], torch.tensor([True, False])
    res["decode"] = []
    for t in range(DECODE_STEPS):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t,
                                      write)
        res["decode"].append(lg)
    res["cache"] = cache
    tr = _Capture(lambda p, bb: model.loss(p, bb), params, _tc(), mesh=mesh)
    res["metrics"] = tr.step(batches(0))
    res["step_grads"] = tr.whole_grads()
    res["params"] = tr.whole_params()
    return res


def _stage1_run(mesh):
    """One Stage-1 pre-training step of `_bbe()` (on `mesh` or whole)."""
    enc = _bbe()
    if mesh is not None:
        enc = collectives.shard_module(enc, mesh)
    shapes = _shapes(enc)
    tr = _Capture(lambda m, b: tbbe.pretrain_loss(m, b), enc, _tc(),
                  mesh=mesh)
    metrics = tr.step({"tokens": _bbe_tokens()})
    return {"shapes": shapes, "metrics": metrics,
            "step_grads": tr.whole_grads(), "params": tr.whole_params()}


def _row_batch(seed, V, n=12):
    r = np.random.RandomState(seed)
    out = {}
    for i, role in enumerate(("anchor", "positive", "negative")):
        mask = r.rand(B, n) > 0.25
        mask[:, 0] = True
        rows = np.where(mask, r.randint(0, V, (B, n)), V)
        out[role] = {"rows": torch.from_numpy(rows),
                     "freqs": torch.from_numpy(
                         (r.rand(B, n) * 9).astype(np.float32) * mask),
                     "mask": torch.from_numpy(mask)}
    out["cpi"] = torch.from_numpy((1 + r.rand(B) * 3).astype(np.float32))
    return out


def _matrix(V=40):
    m = _x(45, V + 1, 32)
    m[-1] = 0.0
    return m


def _stage2_run(mesh, ckpt_dir="/nonexistent"):
    """One `Stage2Engine` step of `_sig()` (sharded on `mesh`, or whole),
    then a checkpoint when ckpt_dir is given."""
    model, cfg = _sig()
    if mesh is not None:
        model = collectives.shard_module(model, mesh)
    engine = Stage2Engine(cfg, model, _matrix(), _tc(ckpt_dir), mesh=mesh)
    engine.trainer.__class__ = _Capture
    metrics = engine.step(_row_batch(46, 40))
    if ckpt_dir != "/nonexistent":
        engine.maybe_checkpoint(force=True)
    tr = engine.trainer
    return {"shapes": _shapes(engine.model), "metrics": metrics,
            "step_grads": tr.whole_grads(), "params": tr.whole_params(),
            "state": {k: v.detach().clone() for k, v in
                      ckpt._flatten(tr._live_tree()).items()}}


def _world2(rank, out):
    mesh = launch_mesh.make_mesh((1, 2), ("data", "model"))
    res = {arch: _lm_run(arch, mesh, out) for arch in WORLD2}
    res["stage1"] = _stage1_run(mesh)
    res["stage2"] = _stage2_run(mesh)
    torch.save(res, os.path.join(out, f"w2_r{rank}.pt"))


def _world4(rank, out):
    mesh = launch_mesh.make_mesh((2, 2), ("data", "model"))
    res = {"jamba": _lm_run("jamba_1_5_large_398b", mesh, out),
           "stage2": _stage2_run(mesh, os.path.join(out, "ckpt_stage2"))}
    torch.save(res, os.path.join(out, f"w4_r{rank}.pt"))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX trees of the scaled-down archs (JAX's names, shapes and
    dtypes), then both spawns."""
    from test_torch_lm_train import _seeded
    out = str(tmp_path_factory.mktemp("tp_recurrent"))
    seeded = {}
    for arch, kw in SPAWN_ARCHS.items():
        jcfg, tcfg, _, tree = _seeded(arch, **kw)
        seeded[arch] = (jcfg, tcfg, tree)
        torch.save((tcfg, tree), os.path.join(out, f"weights_{arch}.pt"))
    _spawn(_world2, 2, out)
    _spawn(_world4, 4, out)
    return out, seeded


def _load(out, name):
    return torch.load(os.path.join(out, name + ".pt"), weights_only=False)


def _grads_held(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        _grad_close(got[k], w, f"{what}: {k}")


def _params_held(got, want, what):
    """Parameters after a step, leaf by leaf at relative L2 1e-4."""
    assert sorted(got) == sorted(want), what
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-4, \
            f"{what}: {k} {_rel(got[k], want[k]):.3g}"


def _step_held(got, want, what):
    for k in ("loss", "grad_norm"):
        _out_close(got["metrics"][k], want["metrics"][k], f"{what} {k}")
    _grads_held(got["step_grads"], want["step_grads"], what)
    _params_held(got["params"], want["params"], what)


_UNSHARDED = {}


def _unsharded(out, key, fn):
    if key not in _UNSHARDED:
        _UNSHARDED[key] = fn()
    return _UNSHARDED[key]


@pytest.mark.parametrize("arch", WORLD2 + ("jamba_1_5_large_398b",))
def test_lm_step_matches_unsharded_and_jax(spawned, arch):
    """xlstm and the encoder on a (1, 2) mesh, jamba on a (2, 2) one (rows
    over "data"): one AdamW step (metrics, clipped gradients, parameters
    after it) against the unsharded port's, and the loss against JAX's
    on the same weights; for jamba (Mamba, attention and MoE layers) also
    the global norm and every clipped gradient against
    `jax.value_and_grad` of JAX's loss (the unsharded port's gradients
    of all three archs are held to JAX's by tests/test_torch_lm_grads.py,
    their mixers' shares to the unsharded port's by (a))."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jax_build_model
    from repro.train import optimizer as jopt
    from test_torch_lm_train import _assert_grads
    out, seeded = spawned
    got = (_load(out, "w2_r0")[arch] if arch in WORLD2
           else _load(out, "w4_r0")["jamba"])
    want = _unsharded(out, arch, lambda: _lm_run(arch, None, out))
    _step_held(got, want, f"{arch} step")
    jcfg, tcfg, tree = seeded[arch]
    batch = {k: jnp.asarray(v.numpy()) for k, v in
             launch_train.lm_batch_fn(tcfg.vocab_size, B, LM_SEQ, tcfg,
                                      "cpu")(0).items()}
    jmodel = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    if arch in WORLD2:
        jloss, _ = jax.jit(jmodel.loss)(params, batch)
        _out_close(got["metrics"]["loss"], float(jloss),
                   f"{arch} loss vs JAX")
        return

    @jax.jit
    def jax_grads(p, b):
        (loss, _), g = jax.value_and_grad(
            lambda q: jmodel.loss(q, b), has_aux=True)(p)
        return (loss,) + jopt.global_norm_clip(g, _tc().grad_clip)

    jloss, jclipped, jnorm = jax_grads(params, batch)
    _out_close(got["metrics"]["loss"], float(jloss), f"{arch} loss vs JAX")
    _out_close(got["metrics"]["grad_norm"], float(jnorm),
               f"{arch} grad_norm vs JAX")
    _assert_grads(tcfg, got["step_grads"], jclipped)


@pytest.mark.parametrize("arch", WORLD2 + ("jamba_1_5_large_398b",))
def test_lm_prefill_and_decode(spawned, arch):
    """Prefill logits and DECODE_STEPS decode steps (a row not written)
    against the unsharded port (and the prefill against JAX's
    `lm_apply`); each rank's cache is its blocks of the unsharded cache,
    and the states the specs keep whole are bitwise the same on every
    rank of "model"."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as jtfm
    out, seeded = spawned
    world = 2 if arch in WORLD2 else 4
    ranks = ([_load(out, f"w2_r{r}")[arch] for r in range(2)]
             if world == 2 else
             [_load(out, f"w4_r{r}")["jamba"] for r in range(4)])
    want = _unsharded(out, arch, lambda: _lm_run(arch, None, out))
    got = ranks[0]
    _out_close(got["logits"], want["logits"], f"{arch} prefill logits")
    jcfg, tcfg, tree = seeded[arch]
    toks = launch_train.lm_batch_fn(tcfg.vocab_size, B, LM_SEQ, tcfg,
                                    "cpu")(2)["tokens"].numpy()
    jlogits, _ = jax.jit(lambda p, t: jtfm.lm_apply(p, jcfg, t))(
        tree, jnp.asarray(toks))
    _out_close(got["logits"], jlogits, f"{arch} prefill logits vs JAX")
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _out_close(g, w, f"{arch} decode step {t}")
    sizes = ({"data": 1, "model": 2} if world == 2
             else {"data": 2, "model": 2})
    specs = tfm.cache_specs(tcfg)
    for r, res in enumerate(ranks):
        coords = {"data": r // 2, "model": r % 2} if world == 4 else \
            {"data": 0, "model": r}
        for pos, leaves in res["cache"].items():
            for k, v in leaves.items():
                full = want["cache"][pos][k]
                spec = sharding.pruned_spec(specs[pos][k], full.shape,
                                            sizes)
                if world == 4:      # rows gathered by rank: cache is local
                    continue
                block = sharding.local_block(full, spec, sizes, coords)
                _out_close(v, block, f"{arch} rank {r} cache {pos}/{k}")
                if not any("model" in sharding.axes_of(e) for e in spec):
                    assert torch.equal(v, ranks[0]["cache"][pos][k]), \
                        f"{arch} cache {pos}/{k} differs by rank"


def test_stage1_step_on_two_ranks(spawned):
    """One pre-training step of the sharded encoder on a (1, 2) mesh
    against the unsharded Trainer's, and its loss against JAX's
    `pretrain_loss` (impl "scan") on the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.core import bbe as jbbe
    out, _ = spawned
    got = _load(out, "w2_r0")["stage1"]
    want = _unsharded(out, "stage1", lambda: _stage1_run(None))
    _step_held(got, want, "stage1 step")
    enc = _bbe()
    tree = _jnp_tree(None, tbbe.stack_layers(
        {n.replace(".", "/"): p for n, p in enc.named_parameters()},
        enc.cfg.num_layers))
    jloss, _ = jax.jit(lambda p, t: jbbe.pretrain_loss(
        p, jbbe.BBEConfig(**TINY_BBE), t, impl="scan"))(
        tree, jnp.asarray(_bbe_tokens().numpy()))
    _out_close(got["metrics"]["loss"], float(jloss), "stage1 loss vs JAX")


def test_stage2_step_on_two_ranks(spawned):
    """One `Stage2Engine` step of the sharded model on a (1, 2) mesh
    against the unsharded engine's, and its loss against JAX's
    `stage2_loss_from_rows` on the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.core import signature as jsig
    out, _ = spawned
    got = _load(out, "w2_r0")["stage2"]
    want = _unsharded(out, "stage2", lambda: _stage2_run(None))
    _step_held(got, want, "stage2 step")
    model, cfg = _sig()
    jcfg = jsig.SignatureConfig(**TINY_SIG)
    batch = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                   _row_batch(46, 40))
    jloss, _ = jax.jit(lambda p: jsig.stage2_loss_from_rows(
        p, jcfg, jnp.asarray(_matrix().numpy()), batch))(_jnp_tree(model))
    _out_close(got["metrics"]["loss"], float(jloss), "stage2 loss vs JAX")


def test_stage2_checkpoint_on_2x2_restores_unsharded(spawned):
    """The Stage-2 step on a (2, 2) mesh (rows over "data", heads and ff
    columns over "model") matches the unsharded engine's, and its
    checkpoint (full tensors, global rank 0) restores bitwise into an
    unsharded engine."""
    out, _ = spawned
    got = _load(out, "w4_r0")["stage2"]
    want = _unsharded(out, "stage2", lambda: _stage2_run(None))
    _step_held(got, want, "stage2 step on (2, 2)")
    model, cfg = _sig()
    engine = Stage2Engine(cfg, model, _matrix(),
                          _tc(os.path.join(out, "ckpt_stage2")))
    assert engine.restore() and engine.step_count == 1
    state = {k: v.detach() for k, v in
             ckpt._flatten(engine.trainer._live_tree()).items()}
    assert sorted(state) == sorted(got["state"])
    for k, v in got["state"].items():
        assert torch.equal(state[k], v), k


def _blocks_only(shapes, whole, specs, sizes, world):
    """Each rank holds its blocks: the ranks' numels sum to the whole
    tensor's times its replicas."""
    for name, full in whole.items():
        spec = sharding.pruned_spec(specs[name.replace(".", "/")], full,
                                    sizes)
        split = 1
        for entry in spec:
            for a in sharding.axes_of(entry):
                split *= sizes[a]
        local = [s[name] for s in shapes]
        assert all(np.prod(shp) * split == np.prod(full) for shp in local), \
            (name, local, full, spec)
        assert sum(np.prod(shp) for shp in local) == \
            np.prod(full) * world // split, name
    return True


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_only_their_blocks(spawned, world):
    out, _ = spawned
    sizes = {"data": 1, "model": 2} if world == 2 else {"data": 2,
                                                        "model": 2}
    ranks = [_load(out, f"w{world}_r{r}") for r in range(world)]
    keys = (list(WORLD2) + ["stage1", "stage2"] if world == 2
            else ["jamba", "stage2"])
    for key in keys:
        shapes = [r[key]["shapes"] for r in ranks]
        if key == "stage1":
            module = _bbe()
            specs = module.param_specs()
        elif key == "stage2":
            module = _sig()[0]
            specs = module.param_specs()
        else:
            arch = "jamba_1_5_large_398b" if key == "jamba" else key
            cfg, _ = torch.load(os.path.join(out, f"weights_{arch}.pt"),
                                weights_only=False)
            module = build_model(cfg).init(0, "cpu")
            specs = tfm.lm_param_specs(cfg)
        assert _blocks_only(shapes, _shapes(module), specs, sizes, world), \
            key
        if key not in ("stage1",):
            assert any(s != _shapes(module) for s in shapes[:1]), key


# ---------------------------------------------------------------------------
# (c) the dry-run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm_1_3b", "jamba_1_5_large_398b"])
def test_dryrun_counts_recurrent_rank_blocks(arch, tmp_path, monkeypatch):
    """A tiny xlstm or jamba x train_4k on the 16 x 16 mesh, on meta: the
    held bytes are the blocks and their optimizer state (no whole
    parameters), and the step's collectives over "model" include the
    exchange of the halved projections (all-to-all) and the sums both
    ways (all-reduce)."""
    from repro_torch.launch import dryrun
    kw = dict(num_layers=2, d_model=256, num_heads=16, d_ff=512,
              vocab_size=1024)
    if arch.startswith("jamba"):
        kw.update(num_kv_heads=16, num_experts=16)
    small = tconfig.scaled_down(tconfig.get_arch(arch), **kw)
    monkeypatch.setattr(dryrun, "get_arch", lambda name: small)
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    d = dryrun.run_cell(arch, "train_4k", False)
    assert d["status"] == "OK"
    held = d["held_bytes"]
    assert set(held) == {"params", "inputs", "opt"}
    n = sum(p.numel() for p in tfm.LM(small).parameters())
    assert held["params"] < 4 * n / 16
    coll = d["count"]["collective_bytes"]
    assert coll["model all-to-all"] > 0 and coll["model all-reduce"] > 0
    assert "tensor-parallel" in d["model_axis"]
