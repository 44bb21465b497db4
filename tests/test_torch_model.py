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
import torch_threads  # noqa: F401  (the worker's share of the cores)

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


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_unported_families_and_decode_raise(family):
    """The recurrent families build and take one decode step (their
    parity with the reference is in ``test_torch_recurrent_model.py``);
    the serving methods of the dense model run (their parity with the
    reference is in ``test_torch_decode.py``), with these shapes at
    SMOKE."""
    from repro_torch.configs import get_smoke_config

    arch = {"ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-2b"}[family]
    rec = Model(get_smoke_config(arch), device="cpu")
    assert rec.cfg.family == family
    toks = torch.from_numpy(_tokens(rec.cfg, batch=2, seq=1))
    logits, cache = rec.decode_step(rec.init_cache(2, 16), toks,
                                    torch.zeros((2, 1), dtype=torch.int32))
    assert tuple(logits.shape) == (2, 1, 256)
    assert bool(torch.isfinite(logits).all())
    cfg = gpt2_paper.SMOKE
    model = Model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, batch=2, seq=12))
    assert tuple(model.prefill({"tokens": toks}).shape) == (2, 1, 256)
    cache = model.init_cache(2, 16)
    assert tuple(cache["k"].shape) == (2, 2, 16, 16, 16)  # [L,B,len,KV,Hd]
    assert cache["v"].shape == cache["k"].shape
    assert cache["k"].dtype == torch.bfloat16
    assert tuple(cache["kpos"].shape) == (2, 16)
    logits, cache = model.decode_step(cache, toks[:, :1],
                                      torch.zeros((2, 1), dtype=torch.int32))
    assert tuple(logits.shape) == (2, 1, 256)
    assert logits.dtype == torch.float32
    assert cache["kpos"][:, 0].tolist() == [0, 0]
