"""The port's recurrent families (falcon-mamba-7b [ssm] and
recurrentgemma-2b [hybrid]) against the reference on the CPU at SMOKE
widths: the fp32 loss and gradients, decode against forward, the scan
prefill bitwise a streamed decode loop over ragged lengths and near the
reference's, a decode step from the reference's cache carried by
``convert.cache_from_jax``, frozen lanes, three Muon steps (the hybrid's
``tail`` leaves included), the launchers; and the repairs this needed:
``muon.leaf_order`` orders list indices as integers, ``convert`` carries
the ``tail`` list both ways.

The hybrid SMOKE has 5 layers: one (rec, rec, attn) period and a tail of
two recurrent layers.  Tolerances: 1e-5 on the loss, 1e-4 on gradients,
logits and parameters (``test_torch_model.py``'s fp32 bounds)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.configs import get_smoke_config as jget_smoke
from repro.models import build
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.state import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.models import Model
from repro_torch.models.transformer import cache_leaves
from repro_torch.optim import make_optimizer
from repro_torch.optim.muon import leaf_order
from repro_torch.train import make_train_step
from test_torch_moe import port_cfg
import torch_threads  # noqa: F401  (the worker's share of the cores)

CFG32 = dict(dtype="float32", emb_dtype="float32")
RECURRENT = ("falcon-mamba-7b", "recurrentgemma-2b")
LOSS_TOL, TOL = 1e-5, 1e-4
PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)


def _pair(arch, seed, fp32=True):
    """(reference model, its params as jax arrays, the port's model with
    the same parameters), drawn in the port and carried through
    ``convert``."""
    jcfg = jget_smoke(arch)
    jcfg = jcfg.replace(**CFG32) if fp32 else jcfg
    model = Model(port_cfg(jcfg), device="cpu", seed=seed)
    tree = convert.params_to_jax(dict(model.named_parameters()))
    return build(jcfg), jax.tree.map(jnp.asarray, tree), model


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", RECURRENT)
def test_fp32_loss_and_grads_match_reference(arch):
    """S = 21: the Mamba scan runs a padded second chunk."""
    jmodel, params, model = _pair(arch, seed=21)
    toks = _tokens(model.cfg, 2, 21, 21)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(params)
    loss, m = model.loss({"tokens": torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert float(torch.as_tensor(m["aux"])) == 0.0
    jflat = convert._flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jflat[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    logits, _ = model({"tokens": torch.from_numpy(toks)})
    jlogits, _ = jax.jit(jmodel.forward)(params,
                                         {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_matches_forward(arch):
    """``tests/test_models_smoke.py:110-130``: greedy decode logits equal
    the forward logits at the same positions (fp32; the reference's
    2e-2 there, held here at 1e-4).  The hybrid's window (16) is passed
    by the 20 positions, so the rolling KV buffer wraps."""
    _, _, model = _pair(arch, seed=22)
    B, S = 2, 20
    toks = torch.from_numpy(_tokens(model.cfg, B, S, 22))
    with torch.no_grad():
        full, _ = model({"tokens": toks})
    cache = model.init_cache(B, 32)
    params = model.cast_params()
    for t in range(S):
        lg, cache = model.decode_step(
            cache, toks[:, t:t + 1], torch.full((B, 1), t,
                                                dtype=torch.int32),
            params=params)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=str(t))


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_is_a_streamed_decode_loop(arch):
    """``tests/test_serving.py:283-307``: ragged ``prefill_cache`` is
    bitwise the active-masked streamed decode loop, in the last logits
    and every cache leaf; and near the reference's prefill."""
    jmodel, params, model = _pair(arch, seed=23)
    B, S, clen = 3, 10, 16
    toks_np = _tokens(model.cfg, B, S, 23)
    toks = torch.from_numpy(toks_np)
    lengths = torch.tensor([10, 4, 7], dtype=torch.int32)
    lp, cp = model.prefill_cache({"tokens": toks}, clen, lengths)
    cache = model.init_cache(B, clen)
    tparams = model.cast_params()
    last = torch.zeros_like(lp)
    for t in range(S):
        lg, cache = model.decode_step(
            cache, toks[:, t:t + 1], torch.full((B, 1), t,
                                                dtype=torch.int32),
            active=t < lengths, params=tparams)
        last = torch.where((t == lengths - 1).reshape(B, 1, 1), lg, last)
    assert torch.equal(lp, last)
    a, b = cache_leaves(cp), cache_leaves(cache)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    jl, jc = jax.jit(jmodel.prefill_cache, static_argnums=(2,))(
        params, {"tokens": jnp.asarray(toks_np)}, clen,
        jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    carried = convert.cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for x, y in zip(cache_leaves(carried), cache_leaves(cp)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_step_from_carried_cache(arch):
    """The reference's prefilled cache carried by ``cache_from_jax`` (each
    leaf in its own dtype, the hybrid's ``tail`` a list), then one decode
    step in each package from it: logits and every leaf agree."""
    jmodel, params, model = _pair(arch, seed=24)
    B, S, clen = 2, 9, 16
    toks = _tokens(model.cfg, B, S + 1, 24)
    _, jc = jax.jit(jmodel.prefill_cache, static_argnums=(2,))(
        params, {"tokens": jnp.asarray(toks[:, :S])}, clen)
    cache = convert.cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert type(cache.get("tail", [])) is list
    tok, pos = toks[:, S:], np.full((B, 1), S, np.int32)
    jl, jc2 = jax.jit(jmodel.decode_step)(params, jc, jnp.asarray(tok),
                                          jnp.asarray(pos))
    lg, cache = model.decode_step(cache, torch.from_numpy(tok),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    want = _leaves(jc2)
    got = cache_leaves(convert.cache_from_jax(
        jax.tree.map(np.asarray, jc2)))
    assert [tuple(g.shape) for g in got] == \
        [tuple(g.shape) for g in cache_leaves(cache)]
    for w, g in zip(want, cache_leaves(cache)):
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   rtol=TOL, atol=TOL)


def _with_batch_axis(cache):
    """(leaf, its batch axis) of every leaf of a recurrent cache: the
    stacked states [L or n_periods, B, ...], the hybrid's k/v [n_periods,
    n_attn, B, ...], kpos [B, clen] and the tail's [B, ...]."""
    if "ssm" in cache:
        return [(t, 1) for t in cache_leaves(cache)]
    return ([(t, 1) for t in cache_leaves(cache["rec"])]
            + [(cache["k"], 2), (cache["v"], 2), (cache["kpos"], 0)]
            + [(t, 0) for t in cache_leaves(cache.get("tail", []))])


@pytest.mark.parametrize("arch", RECURRENT)
def test_frozen_lanes(arch):
    """A decode step with lanes 0 and 2 inactive leaves every cache leaf
    of theirs bitwise as it was and moves lane 1's (SMOKE dtypes)."""
    _, _, model = _pair(arch, seed=25, fp32=False)
    B, clen = 3, 16
    toks = torch.from_numpy(_tokens(model.cfg, B, 6, 25))
    _, cache = model.prefill_cache({"tokens": toks}, clen)
    before = [(t.clone(), ax) for t, ax in _with_batch_axis(cache)]
    assert len(before) == len(cache_leaves(cache))
    active = torch.tensor([False, True, False])
    _, cache = model.decode_step(cache, toks[:, :1],
                                 torch.full((B, 1), 6, dtype=torch.int32),
                                 active=active)
    for (old, ax), (new, _) in zip(before, _with_batch_axis(cache)):
        assert old.shape[ax] == B
        for lane in (0, 2):
            assert torch.equal(old.select(ax, lane), new.select(ax, lane))
        assert not torch.equal(old.select(ax, 1), new.select(ax, 1))


@pytest.mark.parametrize("arch", RECURRENT)
def test_three_muon_steps_match_reference(arch):
    """Three Muon PRISM-5 train steps in fp32 against the reference's:
    losses and every parameter (the hybrid's unstacked ``tail`` leaves
    take their place in ``leaf_order`` and in the bucket plan); then the
    reference's state, ``tail`` list and all, carried by
    ``convert.muon_state_from_jax`` leaf for leaf."""
    jmodel, params, model = _pair(arch, seed=26)
    cfg = model.cfg
    batches = [_tokens(cfg, 2, 16, 26 + i) for i in range(3)]
    jocfg = JOpt(name="muon", prism=JPrism(**PRISM5))
    jopt = jmake_optimizer(jocfg, jmodel.logical_axes())
    jp, js = params, jopt.init(params)
    jstep = jax.jit(jmake_train_step(jmodel, jopt, jocfg))
    jlosses = []
    for s, b in enumerate(batches):
        jp, js, m = jstep(jp, js, {"tokens": jnp.asarray(b)}, s)
        jlosses.append(float(m["loss"]))
    ocfg = OptimizerConfig(name="muon", prism=PrismConfig(**PRISM5))
    opt = make_optimizer(ocfg, model.named_parameters(),
                         model.logical_axes())
    step = make_train_step(model, opt, ocfg)
    losses = [float(step({"tokens": torch.from_numpy(b)}, s)["loss"])
              for s, b in enumerate(batches)]
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    # the reference's state, the hybrid's tail list included, carried into
    # a fresh optimizer leaf for leaf
    state = jax.tree.map(np.asarray, js)
    carried = make_optimizer(ocfg, model.named_parameters(),
                             model.logical_axes())
    convert.muon_state_from_jax(carried, model.named_parameters(), state)
    assert carried.count == 3
    leaves = convert._flatten(state["leaves"])
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(carried.state[p]["mom"].numpy(),
                                      leaves[f"{k}.mom"], err_msg=k)


def test_leaf_order_sorts_list_indices_as_integers():
    """``jax.tree`` flattens a list by index: ``tail.10.x`` after
    ``tail.2.x``; dict keys stay strings (``layers.p10`` before
    ``layers.p2``)."""
    names = ["tail.10.x", "tail.2.x", "embed", "tail.1.x", "layers.p2.w",
             "layers.p10.w", "tail.2.a"]
    order = leaf_order(names)
    ranked = [n for _, n in sorted(zip(order, names))]
    assert ranked == ["embed", "layers.p10.w", "layers.p2.w", "tail.1.x",
                      "tail.2.a", "tail.2.x", "tail.10.x"]
    tree = {"embed": 0, "layers": {"p10": {"w": 0}, "p2": {"w": 0}},
            "tail": [0, {"x": 0}, {"a": 0, "x": 0}] + [0] * 7 + [{"x": 0}]}
    flat = [".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    want = [n for n in flat if n in names]
    assert want == ranked


def test_params_to_jax_rebuilds_the_tail_list():
    """``params_to_jax`` rebuilds ``tail`` as a list of layer dicts in
    index order (a pattern of 13 recurrent kinds and one attention over 26
    layers leaves a tail of 12, so "10" and "11" come after "9"), and
    ``params_from_jax`` takes that list back; the names and shapes are
    the reference's."""
    jcfg = jget_smoke("recurrentgemma-2b")
    jcfg = jcfg.replace(num_layers=26, rglru=dataclasses.replace(
        jcfg.rglru, pattern=("recurrent",) * 13 + ("attention",)))
    cfg = port_cfg(jcfg)
    model = Model(cfg, device="cpu")
    assert (model.n_periods, model.n_tail) == (1, 12)
    tree = convert.params_to_jax(dict(model.named_parameters()))
    assert isinstance(tree["tail"], list) and len(tree["tail"]) == 12
    for i, layer in enumerate(tree["tail"]):
        np.testing.assert_array_equal(
            layer["rglru"]["w_a"],
            getattr(model.tail, str(i)).rglru.w_a.detach().numpy())
    back = convert.params_from_jax(tree, cfg)
    for k, p in model.named_parameters():
        assert torch.equal(back[k], p.detach()), k
    jshapes = convert._flatten(build(jcfg).param_shapes())
    assert {k: tuple(v.shape) for k, v in jshapes.items()} == \
        model.param_shapes()


@pytest.mark.parametrize("arch", RECURRENT)
def test_launchers_on_the_cpu(arch, capsys):
    """``launch/train.py --arch ... --smoke --device cpu`` (2 Trainer
    steps, finite losses) and ``launch/serve.py --arch ... --smoke
    --device cpu`` (batch mode: the scan prefill, greedy decode, the
    decode state's bytes exactly those of ``init_cache``)."""
    from repro_torch.launch import serve, train

    losses = train.main(["--arch", arch, "--smoke", "--steps", "2", "--seq",
                         "16", "--batch", "2", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt_len", "5", "--gen_len",
                      "3"])
    assert res["finite"] and res["tokens"].shape == (2, 4)
    model = Model(port_cfg(jget_smoke(arch)), device="cpu")
    want = sum(t.numel() * t.element_size()
               for t in cache_leaves(model.init_cache(2, 8)))
    assert res["cache_bytes"] == want
    assert "losses:" in capsys.readouterr().out
