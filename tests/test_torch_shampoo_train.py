"""Shampoo in training on the CPU, against the reference: two more steps
with ``precondition_every=2`` from a reference state carried across by
``convert.shampoo_state_from_jax`` (a refresh, then a step served from the
cache), three ``make_train_step`` steps of each configuration, and the
launcher.  Helpers, inputs and tolerances: ``test_torch_shampoo.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gpt2_paper as jgpt2
from repro.models import build
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.state import make_train_step as jmake_train_step
from repro.train.state import master_params
from repro_torch import convert
from repro_torch.configs import gpt2_paper
from repro_torch.launch import train_lm
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.train import make_train_step
from test_torch_prism import JaxKey
from test_torch_shampoo import (FULL_RANK, _grads, _hold, _jax_run, _ocfgs,
                                _port_opt, _port_run, _smoke)


@pytest.mark.parametrize("which", ["warm", "fig5"])
def test_precondition_every_2_from_a_carried_state(which, monkeypatch):
    """Two reference steps, the state carried across by convert, then two
    more steps in each package with precondition_every=2: the first
    (count 2) refreshes the inverse roots, the second (count 3) serves
    them from the state and computes none."""
    jmodel, params = _smoke()
    grads = _grads(params, 4, seed=2, conditioned=which != "warm")
    jcfg, tcfg = _ocfgs(which, precondition_every=2, **FULL_RANK[which])
    jp2, js2 = _jax_run(jcfg, jmodel, params, grads[:2])
    jp, js = _jax_run(jcfg, jmodel, jax.tree.map(np.asarray, jp2),
                      grads[2:3], js=js2, s0=2)
    named, topt = _port_opt(tcfg, jax.tree.map(np.asarray, jp2))
    convert.shampoo_state_from_jax(
        topt, named, jax.tree.map(np.asarray, js2))
    assert topt.count == 2
    _port_run(named, topt, grads[2:3], s0=2)
    _hold(named, topt, jp, js, which, jp2)
    # count 3: no inverse root is computed, the cache is served as it is
    from repro_torch.optim import shampoo

    calls = []
    real = shampoo.inv_root
    monkeypatch.setattr(shampoo, "inv_root",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cached = {k: topt.state[p]["Linv"].clone() for k, p in named
              if "Linv" in topt.state[p]}
    jp3 = jp
    jp, js = _jax_run(jcfg, jmodel, jax.tree.map(np.asarray, jp),
                      grads[3:], js=js, s0=3)
    _port_run(named, topt, grads[3:], s0=3)
    assert calls == []
    for k, p in named:
        if k in cached:
            assert torch.equal(topt.state[p]["Linv"], cached[k])
    _hold(named, topt, jp, js, which, jp3)


# ------------------------------------------------------------ training

CFG32 = dict(dtype="float32", emb_dtype="float32")


@pytest.mark.parametrize("which", ["warm", "fig5"])
def test_three_steps_match_reference(which):
    """make_train_step with Shampoo: the same losses and parameters after
    three steps, the reference's per-step sketch keys through JaxKey."""
    jcfg = jgpt2.SMOKE.replace(**CFG32)
    tcfg = gpt2_paper.SMOKE.replace(**CFG32)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
               for _ in range(3)]
    jocfg, ocfg = _ocfgs(which)

    jmodel = build(jcfg)
    jopt = jmake_optimizer(jocfg, jmodel.logical_axes())
    init = jmodel.init(jax.random.PRNGKey(0))
    jp = master_params(init)
    js = jopt.init(jp)
    jstep = jax.jit(jmake_train_step(jmodel, jopt, jocfg))
    jlosses = []
    for s, b in enumerate(batches):
        jp, js, m = jstep(jp, js, {"tokens": jnp.asarray(b)}, s)
        jlosses.append(float(m["loss"]))

    model = Model(tcfg, device="cpu")
    model.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, init), tcfg))
    opt = make_optimizer(ocfg, model.named_parameters(),
                         model.logical_axes())
    step = make_train_step(model, opt, ocfg,
                           key=JaxKey(jax.random.PRNGKey(0)))
    losses = [float(step({"tokens": torch.from_numpy(b)})["loss"])
              for b in batches]

    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_launcher_runs_shampoo_on_the_cpu(capsys):
    """Fig. 5's fitted PRISM; the second step serves the cached roots."""
    losses = train_lm.main(["--preset", "cpu-small", "--steps", "2",
                            "--device", "cpu", "--optimizer", "shampoo",
                            "--prism", "fig5", "--precondition_every", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(4096)) < 1.5
    assert "shampoo" in capsys.readouterr().out
