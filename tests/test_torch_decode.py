"""The port's serving model path against the reference on the CPU: the
blocked online-softmax attention, the sliding window, the KV-cache
prefill and decode, the frozen inactive lanes, and the one-pass prefill
against a streamed decode loop.

Tolerances: fp32 comparisons hold 1e-5 (attention) and 1e-4 (logits,
as ``test_torch_model.py``); bf16 ones the reference's own bounds for a
flash-vs-direct comparison in bf16: 2e-2 (``tests/test_models_smoke.py::
test_decode_matches_forward``) and 5e-2 for logits after a whole model
(``tests/test_serving.py::test_prefill_cache_matches_streamed_decode``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gpt2_paper as jgpt2
from repro.configs import qwen3_14b as jqwen
from repro.models import attention as jattn
from repro.models import build
from repro_torch import convert
from repro_torch.config import ModelConfig
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
import torch_threads  # noqa: F401  (the worker's share of the cores)

CFG32 = dict(dtype="float32", emb_dtype="float32")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def port_config(jcfg) -> ModelConfig:
    """The port's ModelConfig with every field of the reference's."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def pair(jcfg, seed=0):
    """(reference model, its params, the port's model with the same
    parameters) for ``jcfg``."""
    jmodel = build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    pcfg = port_config(jcfg)
    model = Model(pcfg, device="cpu")
    model.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, params), pcfg))
    return jmodel, params, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _qkv(dtype, B=2, S=24, H=4, KV=2, Hd=16, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, Hd), (B, S, KV, Hd), (B, S, KV, Hd))]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs], jnp.asarray(pos),
            [torch.from_numpy(a).to(tdt) for a in arrs],
            torch.from_numpy(pos))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attend_matches_reference(dtype, window):
    """Three KV blocks of 8 at S = 24 (GQA, 4 heads over 2), with and
    without a sliding window: the running (m, den, acc) carries."""
    (jq, jk, jv), jpos, (q, k, v), pos = _qkv(dtype)
    want = jattn._flash_attend(jq, jk, jv, jpos, jpos, window, 8)
    got = attn._flash_attend(q, k, v, pos, pos, window, 8)
    assert got.dtype == q.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_block_is_the_train_path_bitwise(dtype):
    """Keys within one block: ``_flash_attend`` is bitwise the unblocked
    attention the train path computed before the blocks were ported
    (spelled out here), since exp(NEG_INF - m) = 0 zeroes the carries."""
    _, _, (q, k, v), pos = _qkv(dtype, seed=1)
    got = attn._flash_attend(q, k, v, pos, pos, 0, attn.KV_BLOCK)
    kk, vv = attn._expand_kv(k, 2), attn._expand_kv(v, 2)
    qs = (q.float() * (1.0 / 4.0)).to(q.dtype)
    s = torch.einsum("bshk,bthk->bsht", qs.float(), kk.float())
    s = s + L.causal_mask_bias(pos, pos, 0)[:, :, None, :]
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    acc = torch.einsum("bsht,bthk->bshk", p.to(q.dtype).float(),
                       vv.float())
    want = (acc / torch.clamp(torch.sum(p, dim=-1), min=1e-30)[..., None]
            ).to(q.dtype)
    assert torch.equal(got, want)


def test_attend_sliding_window_matches_reference():
    """``attend`` on a dense SMOKE config with ``sliding_window=8`` (the
    window taken from the config), over KV blocks of 8, on the first
    layer's converted parameters, fp32."""
    jcfg = jqwen.SMOKE.replace(sliding_window=8, **CFG32)
    _, params, model = pair(jcfg, seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    lp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    want, _ = jattn.attend(lp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                           kv_block=8)
    tp = {k[len("layers.attn."):]: v[0]
          for k, v in model.cast_params().items()
          if k.startswith("layers.attn.")}
    got, _ = attn.attend(tp, torch.from_numpy(x), torch.from_numpy(pos),
                         model.cfg, kv_block=8)
    _close(got.detach(), want, TOL["float32"])


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8], ids=["full", "rolling"])
def test_prefill_cache_matches_reference(window, dtype):
    """Ragged lengths, ``cache_len`` 24: a full cache, and a rolling one
    (window 8: each lane keeps its own last 8 real positions).  kpos
    bitwise; k, v and the last real position's logits within tolerance."""
    kw = CFG32 if dtype == "float32" else {}
    jcfg = jqwen.SMOKE.replace(sliding_window=window, **kw)
    jmodel, params, model = pair(jcfg, seed=4)
    toks = _tokens(jcfg, 3, 24, 4)
    lengths = np.asarray([24, 13, 5], np.int32)
    jl, jc = jmodel.prefill_cache(params, {"tokens": jnp.asarray(toks)}, 24,
                                  jnp.asarray(lengths))
    tl, tc = model.prefill_cache({"tokens": torch.from_numpy(toks)}, 24,
                                 torch.from_numpy(lengths))
    assert tc["k"].shape == jc["k"].shape
    assert tc["k"].dtype == getattr(torch, jcfg.dtype)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))
    _close(tc["k"], jc["k"], TOL[dtype], "k")
    _close(tc["v"], jc["v"], TOL[dtype], "v")
    _close(tl, jl, LOGIT_TOL[dtype], "logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_from_a_converted_cache(dtype):
    """Both packages' ``decode_step`` from one cache (the reference's
    ragged prefill, carried by ``convert.cache_from_jax``), four ticks with
    one lane inactive on the second: logits and the new caches."""
    kw = CFG32 if dtype == "float32" else {}
    jcfg = jqwen.SMOKE.replace(**kw)
    jmodel, params, model = pair(jcfg, seed=5)
    toks = _tokens(jcfg, 3, 12, 5)
    lengths = np.asarray([12, 7, 3], np.int32)
    _, jc = jmodel.prefill_cache(params, {"tokens": jnp.asarray(toks)}, 20,
                                 jnp.asarray(lengths))
    cache = convert.cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert cache["k"].dtype == getattr(torch, jcfg.dtype)
    tparams = model.cast_params()
    jstep = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(6)
    for t in range(4):
        tok = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
        pos = (lengths + t).reshape(3, 1).astype(np.int32)
        act = np.asarray([True, t != 1, True])
        jl, jc = jstep(params, jc, jnp.asarray(tok), jnp.asarray(pos),
                       active=jnp.asarray(act))
        tl, cache = model.decode_step(cache, torch.from_numpy(tok),
                                      torch.from_numpy(pos),
                                      active=torch.from_numpy(act),
                                      params=tparams)
        np.testing.assert_array_equal(cache["kpos"].numpy(),
                                      np.asarray(jc["kpos"]))
        _close(cache["k"], jc["k"], TOL[dtype], f"k, tick {t}")
        _close(cache["v"], jc["v"], TOL[dtype], f"v, tick {t}")
        _close(tl[act], np.asarray(jl)[act], LOGIT_TOL[dtype],
               f"logits, tick {t}")


def test_inactive_lanes_bitwise_frozen():
    """A lane inactive through one tick keeps its k, v and kpos rows
    bitwise; the active lanes write (``tests/test_serving.py:176-198``)."""
    model = Model(port_config(jqwen.SMOKE), device="cpu")
    cache = model.init_cache(3, 16)
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32)
    for t in range(3):
        model.decode_step(cache, tok, torch.full((3, 1), t,
                                                 dtype=torch.int32),
                          active=torch.tensor([True, True, True]))
    before = {k: v.clone() for k, v in cache.items()}
    model.decode_step(cache, tok, torch.full((3, 1), 3, dtype=torch.int32),
                      active=torch.tensor([True, False, True]))
    for name in ("k", "v"):
        assert torch.equal(before[name][:, 1], cache[name][:, 1]), name
        assert not torch.equal(before[name][:, 0], cache[name][:, 0])
    assert torch.equal(before["kpos"][1], cache["kpos"][1])
    assert not torch.equal(before["kpos"][0], cache["kpos"][0])


@pytest.mark.parametrize("jcfg", [jqwen.SMOKE,
                                  jqwen.SMOKE.replace(sliding_window=8)],
                         ids=["qwen3-gqa-qknorm", "windowed"])
def test_prefill_cache_matches_streamed_decode(jcfg):
    """One-pass ragged prefill == a streamed active-masked decode loop
    (``tests/test_serving.py:255-279``), kpos bitwise, logits within the
    reference's 5e-2; with window 8 the rolling cache (8 slots) is
    lossless."""
    model = Model(port_config(jcfg), device="cpu", seed=0)
    B, S = 3, 12
    toks = torch.from_numpy(_tokens(jcfg, B, S, 0))
    lengths = torch.tensor([12, 7, 3], dtype=torch.int32)
    lp, cp = model.prefill_cache({"tokens": toks}, 24, lengths)
    cache = model.init_cache(B, 24)
    params = model.cast_params()
    last = torch.zeros_like(lp)
    for t in range(S):
        lg, cache = model.decode_step(
            cache, toks[:, t:t + 1], torch.full((B, 1), t,
                                                dtype=torch.int32),
            active=t < lengths, params=params)
        last = torch.where((t == lengths - 1).reshape(B, 1, 1), lg, last)
    assert torch.equal(cp["kpos"], cache["kpos"])
    _close(lp, last, LOGIT_TOL["bfloat16"])


def test_gpt2_paper_smoke_decode_matches_reference():
    """The served model itself (gpt2-paper SMOKE, MHA with qkv bias,
    GELU), fp32: prefill logits and a greedy decode of 6 tokens from the
    same prompt give the reference's logits and tokens."""
    jcfg = jgpt2.SMOKE.replace(**CFG32)
    jmodel, params, model = pair(jcfg, seed=7)
    toks = _tokens(jcfg, 2, 8, 7)
    jl, jc = jmodel.prefill_cache(params, {"tokens": jnp.asarray(toks)}, 16)
    tl, tc = model.prefill_cache({"tokens": torch.from_numpy(toks)}, 16)
    _close(tl, jl, LOGIT_TOL["float32"], "prefill")
    jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(8, 14):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = np.full((2, 1), t, np.int32)
        jl, jc = jstep(params, jc, jtok.astype(jnp.int32),
                       jnp.asarray(pos))
        tl, tc = model.decode_step(tc, ttok.to(torch.int32),
                                   torch.from_numpy(pos))
        _close(tl, jl, LOGIT_TOL["float32"], f"decode {t}")
        jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
