"""The port's MoE FFN (``repro_torch/models/moe.py``) against the
reference's ``repro/models/moe.py`` on the CPU, at SMOKE widths in fp32:
output and aux loss in both dispatch modes, the dispatch indices exactly,
the top-k tie order, per-sample against global dispatch when drop-free,
per-sample capacity drops, and the gradients of router and experts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import moe as jmoe
from repro_torch import config as tconfig
from repro_torch.models import moe
import torch_threads  # noqa: F401  (the worker's share of the cores)

CFG32 = dict(dtype="float32", emb_dtype="float32")
# tests/test_moe_dispatch.py:23
RTOL, ATOL = 1e-4, 1e-5


def port_cfg(jcfg):
    """The port's ModelConfig with every field of the reference's, nested
    configs as the port's own dataclasses."""
    kw = {}
    for f in dataclasses.fields(tconfig.ModelConfig):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tconfig.ModelConfig(**kw)


def _cfg(arch, **moe_kw):
    jcfg = jsmoke(arch).replace(**CFG32)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
    return jcfg, port_cfg(jcfg)


def _params(jcfg, seed=0):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return p, {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in p.items()}


def _x(cfg, B=2, S=16, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dispatch", ["global", "per_sample"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b"])
def test_moe_ffn_matches_reference(arch, dispatch):
    """Default capacity (1.25): experts overflow on 32 tokens, so the
    drop path runs too."""
    jcfg, cfg = _cfg(arch, dispatch=dispatch)
    jp, tp = _params(jcfg)
    x = _x(cfg)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_per_sample_matches_global_dropfree():
    """tests/test_moe_dispatch.py:12 on the port."""
    E = jsmoke("mixtral-8x7b").moe.num_experts
    _, cg = _cfg("mixtral-8x7b", dispatch="global", capacity_factor=float(E))
    jcfg, cl = _cfg("mixtral-8x7b", dispatch="per_sample",
                    capacity_factor=float(E))
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x(cg, B=3, S=16, seed=2))
    yg, auxg = moe.moe_ffn(tp, x, cg)
    yl, auxl = moe.moe_ffn(tp, x, cl)
    np.testing.assert_allclose(yg.numpy(), yl.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(auxg), float(auxl), rtol=1e-5)


def test_per_sample_capacity_drops_are_per_sample():
    """tests/test_moe_dispatch.py:29 on the port (capacity 0.5), held
    against the reference's output."""
    jcfg, cfg = _cfg("granite-moe-1b-a400m", dispatch="per_sample",
                     capacity_factor=0.5)
    jp, tp = _params(jcfg, seed=3)
    x = _x(cfg, B=2, S=32, seed=3)
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert y.shape == (2, 32, cfg.d_model)
    assert bool(torch.all(torch.isfinite(y)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_dispatch_indices_exactly_equal(lead):
    """Slots, tokens and gates equal the reference's exactly on a skewed
    routing that overflows (expert 0 draws most assignments), for one
    dispatch and for three independent ones (``per_sample``)."""
    rng = np.random.default_rng(4)
    T, K, E, C = 24, 2, 6, 5
    p = np.array([0.5, 0.2, 0.1, 0.1, 0.05, 0.05])
    topi = np.stack([rng.choice(E, size=K, replace=False, p=p)
                     for _ in range(int(np.prod(lead, dtype=int)) * T)])
    topi = topi.reshape(lead + (T, K)).astype(np.int32)
    gates = rng.random(lead + (T, K)).astype(np.float32)
    tok, gate, slot_of = moe._dispatch_indices(
        torch.from_numpy(topi).long(), torch.from_numpy(gates), E, C)
    fn = lambda ti, g: jmoe._dispatch_indices(ti, g, E, C)  # noqa: E731
    for _ in lead:
        fn = jax.vmap(fn)
    jtok, jgate = fn(jnp.asarray(topi), jnp.asarray(gates))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    # overflow happened, and every kept assignment's slot holds it
    assert int((slot_of == E * C).sum()) > 0
    flat_t = np.arange(T * K).reshape(T, K) // K
    for idx in np.ndindex(*lead):
        s = slot_of[idx].numpy()
        kept = s < E * C
        assert np.all(tok[idx].numpy()[s[kept]] == flat_t[kept])


def _reversed_ties(logits, k):
    """A top-k that breaks ties by the HIGHER index."""
    E = logits.shape[-1]
    vals, idx = torch.sort(logits.flip(-1), dim=-1, descending=True,
                           stable=True)
    return vals[..., :k], E - 1 - idx[..., :k]


def test_top_k_ties_go_to_the_lower_index(monkeypatch):
    """Every router column the same, so all E logits tie for every token:
    ``lax.top_k`` picks experts 0..K-1, and so must the port.  A top-k
    that breaks the tie the other way sends the tokens to other experts
    and fails the comparison."""
    jcfg, cfg = _cfg("granite-moe-1b-a400m")
    jp, tp = _params(jcfg, seed=5)
    col = np.asarray(jp["router"])[:, :1]
    jp = dict(jp, router=jnp.asarray(np.repeat(col, cfg.moe.num_experts,
                                               axis=1)))
    tp = dict(tp, router=torch.from_numpy(np.asarray(jp["router"]).copy()))
    logits = torch.zeros(3, 8)
    logits[0, 5] = 1.0
    _, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    np.testing.assert_array_equal(moe.top_k(logits, 2)[1].numpy(),
                                  np.asarray(ji))
    x = _x(cfg, seed=5)
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    y, _ = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    monkeypatch.setattr(moe, "top_k", _reversed_ties)
    y_rev, _ = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert not np.allclose(y_rev.numpy(), np.asarray(jy), rtol=RTOL,
                           atol=ATOL)


@pytest.mark.parametrize("dispatch", ["global", "per_sample"])
def test_gradients_match_reference(dispatch):
    """d(sum(y * r) + aux) with respect to x, the router and the three
    expert tensors, at the default capacity (drops included)."""
    jcfg, cfg = _cfg("granite-moe-1b-a400m", dispatch=dispatch)
    jp, tp = _params(jcfg, seed=6)
    x = _x(cfg, seed=6)
    r = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
