"""The plain reference against the system at tiny sizes on the CPU: the
tokenizer, Stage 1's BBEs, Stage 2's signatures and log1p-CPI, and the
pre-training loss and gradients. The tolerances are float32 rounding."""
import types

import numpy as np
import torch

from chipbench import weights
from chipbench.reference import knowledge, stage1, stage2, tokenizer
from chipbench.reference import train as ref_train
from chipbench.reference.precision import Precision, round_tf32
from chipbench.traffic import programs as traffic

S1 = {"dim_embeds": [24, 8, 8, 8, 8, 8], "num_layers": 2, "num_heads": 2,
      "bbe_dim": 32, "nip_horizon": 4, "max_len": 32, "dtype": "float32"}
S2 = {"bbe_dim": 32, "d_model": 32, "sig_dim": 16, "num_heads": 2,
      "num_sabs": 2, "num_seeds": 1, "max_set": 16, "w_r": 1.0, "w_c": 0.5,
      "dtype": "float32"}
P = Precision("fp32")


def _blocks(n=24, seed=3):
    stream = traffic.instruction_stream(12, seed)
    maker = traffic.BlockMaker(stream, set())
    made = maker.make(np.random.RandomState(seed), n)
    return [stream.instrs[b.start:b.start + b.length] for b in made]


def _port_encoder():
    from repro_torch.core.bbe import BBEConfig, BBEEncoder
    enc = BBEEncoder(BBEConfig(**dict(S1, dim_embeds=tuple(S1["dim_embeds"]))))
    w = weights.draw(enc.state_dict(), 11, "cpu")
    enc.load_state_dict(w)
    return enc, w


def _port_tokens(blocks):
    from repro_torch.core.tokenizer import default_tokenizer
    from repro_torch.data import isa
    port = [isa.BasicBlock(i, [isa.Instruction(x.opcode, tuple(
        isa.Operand(o.kind, reg=o.reg, index=o.index, value=o.value)
        for o in x.operands)) for x in b]) for i, b in enumerate(blocks)]
    return default_tokenizer().encode_blocks(port, S1["max_len"])


def test_tokenizer_matches_the_system():
    blocks = _blocks()
    ours = tokenizer.encode_blocks(
        [types.SimpleNamespace(instrs=b) for b in blocks], S1["max_len"])
    np.testing.assert_array_equal(ours, _port_tokens(blocks))
    from repro_torch.core.tokenizer import default_tokenizer
    assert tuple(default_tokenizer().spec.dim_sizes) == tokenizer.DIM_SIZES


def test_stage1_bbes_match_the_system():
    enc, w = _port_encoder()
    toks = torch.from_numpy(_port_tokens(_blocks())).long()
    with torch.no_grad():
        got = enc(toks)
        ref = stage1.encode({k: v.float() for k, v in w.items()}, S1, toks, P)
    assert float((got - ref).abs().max()) < 1e-5


def test_stage2_signatures_match_the_system():
    from repro_torch.core.signature import SignatureConfig, SignatureModel
    model = SignatureModel(SignatureConfig(**S2))
    w = weights.draw(model.state_dict(), 12, "cpu")
    model.load_state_dict(w)
    g = torch.Generator().manual_seed(0)
    bbes = torch.randn(6, 16, 32, generator=g)
    freqs = torch.randint(1, 1000, (6, 16), generator=g).float()
    mask = torch.arange(16)[None] < torch.tensor([16, 9, 3, 1, 12, 16])[:, None]
    freqs = freqs * mask
    with torch.no_grad():
        sig, cpi = model(bbes, freqs, mask)
        rsig, rcpi = stage2.signature(w, S2, bbes, freqs, mask, P)
    assert float((sig - rsig).abs().max()) < 1e-5
    assert float((cpi - rcpi).abs().max()) < 1e-5


def test_interval_sets_keep_the_most_executed():
    bids, freqs, mask = stage2.interval_sets(
        [{5: 3, 7: 9, 2: 9, 4: 1}, {}], 3)
    assert bids[0].tolist() == [7, 2, 5] and freqs[0].tolist() == [9, 9, 3]
    assert not mask[1].any()


def test_pretrain_loss_and_gradients_match_the_system():
    from repro_torch.core.bbe import pretrain_loss
    enc, w = _port_encoder()
    toks = torch.from_numpy(_port_tokens(_blocks(12))).long()
    loss, _ = pretrain_loss(enc, {"tokens": toks})
    names = [n for n, _ in enc.named_parameters()]
    grads = torch.autograd.grad(loss, list(enc.parameters()),
                                allow_unused=True, materialize_grads=True)
    rloss, rgrads = ref_train.loss_and_grads(
        {k: v.float() for k, v in w.items()}, S1, toks, P, rows=5)
    assert abs(float(loss.detach()) - rloss) < 1e-5 * abs(rloss)
    for n, g in zip(names, grads):
        assert float((g - rgrads[n]).abs().max()) <= \
            1e-4 * max(1e-3, float(rgrads[n].abs().max())), n


def test_lower_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.0e-3])
    assert round_tf32(x).tolist()[:2] == [1.0, 1.0 + 2 ** -9]
    assert abs(float(round_tf32(x)[2]) - 3.0e-3) <= 3.0e-3 * 2 ** -11


def _clusters(seed=4, k=3, n=60, d=5):
    rng = np.random.RandomState(seed)
    centres = rng.normal(size=(k, d)) * 4
    x = centres[rng.randint(k, size=n)] + rng.normal(size=(n, d)) * 0.3
    cents = centres.copy()
    for _ in range(30):
        a, _, _ = knowledge.nearest(x, cents)
        cents = np.stack([x[a == j].mean(0) for j in range(k)])
    return x, cents


def test_assign_tolerance_bounds_float32_distances():
    rng = np.random.RandomState(9)
    x = rng.normal(size=(4000, 128))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c = x[:14] + rng.normal(size=(14, 128)) * 1e-3
    exact = knowledge.distances(x, c) ** 2
    x32, c32 = x.astype(np.float32), c.astype(np.float32)
    d2 = ((x32 * x32).sum(1, keepdims=True) - 2 * (x32 @ c32.T)
          + (c32 * c32).sum(1)[None])
    tol = knowledge.assign_tolerance(x, c)
    assert (np.abs(d2 - exact) <= tol[:, None] / 2).all()
    # a row the float32 distances may misorder may go to either
    d = np.sqrt(exact)
    may = knowledge.may_assign(d, np.zeros(len(d)), tol)
    flipped = d2.argmin(1) != exact.argmin(1)
    assert may[np.arange(len(d)), d2.argmin(1)].all()
    assert may.sum(1)[flipped].min(initial=2) >= 2


def test_representative_gap_reads_a_row_nearer_than_the_representative():
    x, cents = _clusters()
    d = knowledge.distances(x, cents)
    a = d.argmin(1)
    reps = np.asarray([np.flatnonzero(a == j)[np.argmin(d[a == j, j])]
                       for j in range(len(cents))])
    slack = np.zeros(len(x))
    assert knowledge.representative_gap(x, slack, cents, reps) == 0.0
    far = reps.copy()
    rows = np.flatnonzero(a == 0)
    far[0] = rows[np.argmax(d[rows, 0])]
    want = d[far[0], 0] - d[reps[0], 0]
    assert abs(knowledge.representative_gap(x, slack, cents, far) - want) < 1e-12
    # a gap within the signatures' slack is excused
    assert knowledge.representative_gap(
        x, np.full(len(x), want), cents, far) == 0.0
