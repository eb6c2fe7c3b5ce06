"""The port's `Model.loss` (`transformer.lm_loss`) on the CPU against the
JAX package: the loss and every parameter's gradient against `jax.grad`
of JAX's `lm_loss` (impl "chunked" and "ref") for the scaled-down config
of all eleven archs, fp32, from the port's seeded weights; and the remat
policies' gradients, bitwise equal. Shares its helpers with
test_torch_lm_train.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from test_torch_lm_train import (  # noqa: E402
    ARCHS, NO_ATTENTION, _assert_grads, _batch, _port_grads, _seeded,
)

_LM_CASES = [(a, impl) for a in ARCHS for impl in ("chunked", "ref")
             if not (a in NO_ATTENTION and impl == "ref")]


@pytest.mark.parametrize("arch,impl", _LM_CASES)
def test_lm_loss_and_grads_match_jax(arch, impl):
    """`Model.loss` (nll, aux) and the gradient of every parameter against
    `jax.grad` of JAX's `lm_loss` from the same weights and batch (frames
    for whisper, patches for paligemma, the MoE aux for the MoE archs),
    fp32 within 1e-4 x max(1, max|g|)."""
    jcfg, tcfg, lm, tree = _seeded(arch)
    model, jmodel = build_model(tcfg), jax_build_model(jcfg)
    batch = _batch(tcfg)
    loss, metrics, got = _port_grads(model, lm, batch)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, impl=impl),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key in ("nll", "aux"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    if tcfg.moe is not None:
        assert float(metrics["aux"]) > 0
        routers = [g for n, g in got.items() if n.endswith("moe/router")]
        assert routers and all(float(g.abs().max()) > 0 for g in routers)
    _assert_grads(tcfg, got, jgrads)


@pytest.mark.parametrize("arch", ["smollm_135m", "whisper_tiny",
                                  "jamba_1_5_large_398b",
                                  "semanticbbv_encoder"])
def test_remat_policies_give_the_same_grads(arch):
    """"none", "full" and "dots" give bitwise the same loss and gradients
    on the CPU (whisper's encoder is wrapped too)."""
    _, tcfg, lm, _ = _seeded(arch)
    model = build_model(tcfg)
    batch = _batch(tcfg)
    base_loss, _, base = _port_grads(model, lm, batch)
    for policy in ("full", "dots"):
        loss, _, grads = _port_grads(model, lm, batch, remat=policy)
        assert torch.equal(loss, base_loss), policy
        for name, g in grads.items():
            assert torch.equal(g, base[name]), (policy, name)
    with pytest.raises(ValueError, match="remat"):
        model.loss(lm, batch, remat="some")


