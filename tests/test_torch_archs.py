"""The port's registry and its moe, vlm, audio and tied-embedding models
against the reference on the CPU: every config field for field, the
parameter layout of every SMOKE and full config, the fp32 SMOKE loss and
gradients, decode against forward and prefill against a streamed decode
(drop-free), the Engine's ssm/hybrid refusal and the family batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_ids as jarch_ids
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import build
from repro.optim import base as jbase
from repro_torch import convert
from repro_torch.configs import arch_ids, get_config, get_smoke_config
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.models import Model, param_specs
from repro_torch.models.inputs import make_decode_inputs, make_train_batch
from repro_torch.optim import base
from test_torch_moe import port_cfg
import torch_threads  # noqa: F401  (the worker's share of the cores)

CFG32 = dict(dtype="float32", emb_dtype="float32")
ALL = arch_ids() + ["gpt2-paper"]
RECURRENT = ("falcon-mamba-7b", "recurrentgemma-2b")
KV_ARCHS = [a for a in ALL if a not in RECURRENT]
# test_torch_model.py's fp32 tolerances
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _dropfree(jcfg):
    if jcfg.moe is None:
        return jcfg
    return jcfg.replace(moe=dataclasses.replace(
        jcfg.moe, capacity_factor=float(jcfg.moe.num_experts)))


# ---------------------------------------------------------------- registry


@pytest.mark.parametrize("arch", ALL)
def test_configs_equal_the_reference(arch):
    assert arch_ids() == jarch_ids()
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert type(mine).__module__.startswith("repro_torch")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt5")


def _layout(jcfg):
    """The reference's name -> (shape, axes, dtype name), abstractly."""
    jmodel = build(jcfg)
    shapes = convert._flatten(jmodel.param_shapes())
    axes = convert._flatten(jmodel.logical_axes())
    return {k: (tuple(s.shape), tuple(axes[k]), str(s.dtype))
            for k, s in shapes.items()}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ALL)
def test_param_specs_equal_the_reference(arch, smoke):
    jcfg = (jget_smoke if smoke else jget_config)(arch)
    specs = param_specs((get_smoke_config if smoke else get_config)(arch))
    assert {k: (tuple(s), tuple(a), d) for k, (s, a, d) in specs.items()} \
        == _layout(jcfg)


def test_granite_params_and_muon_views():
    """granite-moe-1b-a400m: 1,384,989,696 parameters; Muon's matrix
    views 2,352 x [1024, 512] (24 layers x 32 experts x 3, and the 48
    wk/wv), 48 x [1024, 1024] (wq, wo) and 24 x [1024, 32] (the
    routers), by both packages' view rules."""
    specs = param_specs(get_config("granite-moe-1b-a400m"))
    assert sum(int(np.prod(s)) for s, _, _ in specs.values()) \
        == 1_384_989_696
    views = {}
    for name, (shape, axes, _) in specs.items():
        assert base.is_matrix_param(axes, shape) == \
            jbase.is_matrix_param(axes, shape), name
        if base.is_matrix_param(axes, shape):
            dims = base.matrix_view_dims(axes, shape)
            assert dims == jbase.matrix_view_dims(axes, shape)
            lead = int(np.prod(shape)) // (dims[0] * dims[1])
            views[dims] = views.get(dims, 0) + lead
    assert views == {(1024, 512): 2352, (1024, 1024): 48, (1024, 32): 24}


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_families_raise(arch):
    """The recurrent families build and decode (their parity is in
    ``test_torch_recurrent_model.py``), and the Engine refuses them with
    the reference's message, as the reference's Engine does
    (``tests/test_serving.py:243-248``): their caches are not
    slot-installable."""
    from repro.serving import Engine as JEngine
    from repro.serving import EngineConfig as JEngineConfig
    from repro_torch.serving import Engine, EngineConfig

    model = Model(get_smoke_config(arch), device="cpu")
    with pytest.raises(NotImplementedError) as mine:
        Engine(model, None, EngineConfig(slots=2, cache_len=16))
    with pytest.raises(NotImplementedError) as ref:
        JEngine(build(jget_smoke(arch)), None,
                JEngineConfig(slots=2, cache_len=16))
    assert str(mine.value) == str(ref.value)
    assert "not slot-installable" in str(mine.value)


# ------------------------------------------------------- loss and gradients


LOSS_CASES = {
    "granite-moe-1b-a400m": jget_smoke("granite-moe-1b-a400m"),
    "mixtral-8x7b": jget_smoke("mixtral-8x7b"),
    "llava-next-34b": jget_smoke("llava-next-34b"),
    "musicgen-medium": jget_smoke("musicgen-medium"),
    "qwen3-14b-tied": jget_smoke("qwen3-14b").replace(tie_embeddings=True),
}


def _pair(jcfg, seed):
    """(reference model, its params, the port's model with the same
    parameters): the port draws them (``Model`` is fast where the
    reference's eager init is not) and they cross to the reference's tree
    and back through ``convert``."""
    cfg = port_cfg(jcfg)
    model = Model(cfg, device="cpu", seed=seed)
    tree = convert.params_to_jax(dict(model.named_parameters()))
    back = convert.params_from_jax(tree, cfg)
    for k, p in model.named_parameters():
        assert torch.equal(back[k], p.detach()), k
    return build(jcfg), jax.tree.map(jnp.asarray, tree), model


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.num_codebooks, S) if cfg.family == "audio" else (B, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "vlm":
        p = rng.standard_normal((B, cfg.num_patches, cfg.vision_dim))
        out["patches"] = torch.from_numpy(p.astype(np.float32)).to(
            torch.bfloat16).float().numpy()  # bf16 values, as served
    return out


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_fp32_loss_and_grads_match_reference(case):
    """Loss (CE + the MoE aux), its metrics, the logits and every
    parameter's gradient, at the default MoE capacity (drops included)."""
    jcfg = LOSS_CASES[case].replace(**CFG32)
    jmodel, params, model = _pair(jcfg, seed=11)
    nb = _batch(jcfg, 2, 16, 11)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True))(params)
    loss, m = model.loss(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    aux = float(torch.as_tensor(m["aux"]).detach())
    np.testing.assert_allclose(aux, float(jm["aux"]), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert (aux > 0) == (jcfg.family == "moe")
    jflat = convert._flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jflat[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    logits, _ = model(tb)
    jlogits, _ = jax.jit(jmodel.forward)(params, jb)
    assert tuple(logits.shape) == tuple(jlogits.shape)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "musicgen-medium"])
def test_decode_matches_forward_and_prefill(arch):
    """Drop-free capacity (``tests/test_models_smoke.py:110-121``), fp32:
    a streamed decode loop gives the forward logits position by position;
    a ragged ``prefill_cache`` gives the streamed loop's cache (kpos
    bitwise) and last logits, and the reference's prefill logits."""
    jcfg = _dropfree(jget_smoke(arch)).replace(**CFG32)
    jmodel, params, model = _pair(jcfg, seed=12)
    B, S, clen = 2, 8, 16
    nb = _batch(jcfg, B, S, 12)
    toks = torch.from_numpy(nb["tokens"])
    full, _ = model({"tokens": toks})
    cache = model.init_cache(B, clen)
    tparams = model.cast_params()
    lengths = torch.tensor([S, 5], dtype=torch.int32)
    last = None
    for t in range(S):
        lg, cache = model.decode_step(
            cache, toks[..., t:t + 1], torch.full((B, 1), t,
                                                  dtype=torch.int32),
            active=t < lengths, params=tparams)
        np.testing.assert_allclose(lg[0, ..., 0, :].numpy(),
                                   full[0, ..., t, :].detach().numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        hit = (t == lengths - 1).reshape((B,) + (1,) * (lg.ndim - 1))
        last = torch.where(hit, lg, lg if last is None else last)
    lp, cp = model.prefill_cache({"tokens": toks}, clen, lengths)
    assert torch.equal(cp["kpos"], cache["kpos"])
    for name in ("k", "v"):
        np.testing.assert_allclose(cp[name].numpy(), cache[name].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(lp.numpy(), last.numpy(), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    jl, jc = jmodel.prefill_cache(params, {"tokens": jnp.asarray(
        nb["tokens"])}, clen, jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert torch.equal(tc["kpos"], cp["kpos"])


# ----------------------------------------------------------------- batches


@pytest.mark.parametrize("arch", ["musicgen-medium", "llava-next-34b",
                                  "granite-moe-1b-a400m"])
def test_family_batches(arch):
    """``inputs.make_train_batch``/``make_decode_inputs`` and the data
    stream's batches have the reference's shapes and dtypes."""
    cfg = get_smoke_config(arch)
    jcfg = jget_smoke(arch)
    from repro.models.inputs import make_decode_inputs as jdec
    from repro.models.inputs import make_train_batch as jtrain

    gen = torch.Generator()
    gen.manual_seed(0)
    want = jtrain(jax.random.PRNGKey(0), jcfg, 2, 8)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2,
                      markov_rank=4)
    for got in (make_train_batch(gen, cfg, 2, 8),
                make_batch_fn(cfg, dcfg, "cpu")(3)):
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == tuple(want[k].shape), k
            assert (v.dtype == torch.bfloat16) == (k == "patches")
        t = got["tokens"]
        assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
    dec = make_decode_inputs(gen, cfg, 3, 5)
    jd = jdec(jax.random.PRNGKey(0), jcfg, 3, 5)
    assert tuple(dec["tokens"].shape) == tuple(jd["tokens"].shape)
    assert dec["tokens"].dtype == torch.int32
    assert dec["pos"].tolist() == [[5]] * 3


# ---------------------------------------------------------------- launcher


def test_train_launcher_on_the_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.train --arch granite-moe-1b-a400m
    --smoke --device cpu``: two Trainer steps with finite losses; on the
    production mesh the moe model joins the world the environment names
    (none here: ValueError); an ssm model trains too, and on the
    production mesh joins the world as the moe model does (it raised
    item 11h before)."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train

    for k in tmesh.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    argv = ["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "2",
            "--seq", "32", "--batch", "2", "--device", "cpu"]
    losses = train.main(argv)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "losses:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no world in the environment"):
        train.main(argv + ["--mesh", "production"])
    ssm_argv = ["--arch", "falcon-mamba-7b", "--smoke", "--steps", "1",
                "--seq", "32", "--batch", "2", "--device", "cpu"]
    ssm = train.main(ssm_argv)
    assert len(ssm) == 1 and np.isfinite(ssm[0])
    with pytest.raises(ValueError, match="no world in the environment"):
        train.main(ssm_argv + ["--mesh", "production"])


@pytest.mark.parametrize("arch", ["musicgen-medium", "llava-next-34b"])
def test_serve_launcher_batch_mode(arch):
    """``launch/serve.py --arch`` in batch mode: audio decodes its K
    codebooks a step ([B, K, gen + 1] tokens); a vlm prompt's patch prefix
    lengthens the cache (the reference's ``launch/serve.py:126-130``)."""
    from repro_torch.launch import serve

    cfg = get_smoke_config(arch)
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt_len", "4", "--gen_len",
                      "2"])
    assert res["finite"]
    books = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    assert res["tokens"].shape == (2,) + books + (3,)
    clen = 4 + 2 + (cfg.num_patches if cfg.family == "vlm" else 0)
    from repro_torch.models.attention import padded_heads

    kv = cfg.num_layers * 2 * clen * padded_heads(cfg)[1] \
        * cfg.resolved_head_dim * 2
    assert res["cache_bytes"] == 2 * kv + 2 * clen * 4
