"""The port's dense model against the reference on the CPU: parameter
conversion, the SMOKE loss and its gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gpt2_paper as jgpt2
from repro.models import build
from repro_torch import convert
from repro_torch.configs import gpt2_paper
from repro_torch.models import Model

CFG32 = dict(dtype="float32", emb_dtype="float32")


def _jax_setup(cfg, seed=0):
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    return model, params


def _tokens(cfg, batch=2, seq=24, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def test_params_round_trip():
    jmodel, params = _jax_setup(jgpt2.SMOKE)
    tree = jax.tree.map(np.asarray, params)
    tparams = convert.params_from_jax(tree, gpt2_paper.SMOKE)
    model = Model(gpt2_paper.SMOKE, device="cpu")
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        model.param_shapes()
    model.load_params(tparams)
    back = convert.params_to_jax(dict(model.named_parameters()))
    flat_a, flat_b = convert._flatten(tree), convert._flatten(back)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_b[k],
                                      np.asarray(flat_a[k], np.float32))
    with pytest.raises(KeyError):
        convert.params_from_jax({"embed": tree["embed"]}, gpt2_paper.SMOKE)


def test_axes_and_dtypes_match_reference():
    jmodel, _ = _jax_setup(jgpt2.SMOKE)
    model = Model(gpt2_paper.SMOKE, device="cpu")
    jaxes = convert._flatten(jmodel.logical_axes())
    assert jaxes == model.logical_axes()
    jdt = convert._flatten(jax.tree.map(lambda d: str(d),
                                        jmodel.param_dtypes()))
    assert {k: str(v).replace("torch.", "")
            for k, v in model.param_dtypes().items()} == jdt


def _port(cfg_torch, params):
    model = Model(cfg_torch, device="cpu")
    model.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, params), cfg_torch))
    return model


def test_fp32_loss_and_grads_match_reference():
    jcfg = jgpt2.SMOKE.replace(**CFG32)
    jmodel, params = _jax_setup(jcfg, seed=1)
    toks = _tokens(jcfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(params)
    model = _port(gpt2_paper.SMOKE.replace(**CFG32), params)
    loss, metrics = model.loss({"tokens": torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5,
                               atol=1e-5)
    jflat = convert._flatten(jax.tree.map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jflat[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    logits, _ = model({"tokens": torch.from_numpy(toks)})
    jlogits, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


def test_bf16_loss_matches_reference():
    """Matrices in bf16, norms in fp32 (the SMOKE config's own dtypes).
    The two frameworks round bf16 products at different places, so the
    bound is looser: 1e-2 absolute on a loss near ln(256) = 5.5, about
    two bf16 half-ulps (2^-9) of it."""
    jmodel, params = _jax_setup(jgpt2.SMOKE, seed=2)
    toks = _tokens(jgpt2.SMOKE, seed=2)
    cast = jax.tree.map(lambda x, dt: x.astype(dt), params,
                        jmodel.param_dtypes())
    jloss, _ = jmodel.loss(cast, {"tokens": jnp.asarray(toks)})
    model = _port(gpt2_paper.SMOKE, params)
    loss, _ = model.loss({"tokens": torch.from_numpy(toks)})
    assert abs(float(loss.detach()) - float(jloss)) < 1e-2


def test_unported_families_and_decode_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(gpt2_paper.SMOKE.replace(family="moe"), device="cpu")
    model = Model(gpt2_paper.SMOKE, device="cpu")
    for fn in (model.prefill, model.init_cache, model.decode_step):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()
