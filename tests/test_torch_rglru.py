"""The port's RG-LRU block (``repro_torch/models/rglru.py``) against the
reference's ``repro/models/rglru.py`` on the CPU, at recurrentgemma-2b's
SMOKE widths (d 64, lru width 64) in fp32: the log-depth ``linear_scan``
against a step-by-step loop and ``lax.associative_scan`` (forward and its
own backward), the block and its gradients, a decode step from a carried
cache, and the cache's shapes and dtypes.

Tolerances: 1e-5 relative and absolute on outputs of unit scale (the scan
combines the same pairs in another order), 1e-4 on gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import rglru as jrglru
from repro_torch.models import rglru
from test_torch_moe import port_cfg
import torch_threads  # noqa: F401  (the worker's share of the cores)

CFG32 = dict(dtype="float32", emb_dtype="float32")
RTOL, ATOL = 1e-5, 1e-5
GRAD_TOL = 1e-4


def _cfgs():
    jcfg = jsmoke("recurrentgemma-2b").replace(**CFG32)
    return jcfg, port_cfg(jcfg)


def _params(cfg, seed=0):
    """Drawn in the port, the fp32 vectors and conv_b perturbed off their
    constant initial values; (torch dict, jax dict)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    p = rglru.init_rglru(gen, cfg, (), torch.float32)
    for k in ("conv_b", "b_a", "b_i", "lam"):
        p[k] = p[k] + 0.3 * torch.randn(p[k].shape, generator=gen)
    return p, {k: jnp.asarray(v.numpy()) for k, v in p.items()}


def _ab(B=2, S=37, W=8, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 1.0, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b


def _loop(a, b):
    h, out = torch.zeros_like(a[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("S", [1, 2, 37, 64])
def test_linear_scan_matches_loop_and_associative_scan(S):
    a, b = _ab(S=S)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(),
                               _loop(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy(),
                               rtol=RTOL, atol=ATOL)

    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_linear_scan_backward():
    """Its own backward (the reverse scan) against autograd through the
    step-by-step loop, and ``gradcheck`` in fp64."""
    a, b = _ab(S=37, seed=1)
    g = np.random.default_rng(2).standard_normal(a.shape).astype(np.float32)
    grads = []
    for fn in (rglru.linear_scan, _loop):
        ta = torch.from_numpy(a).requires_grad_(True)
        tb = torch.from_numpy(b).requires_grad_(True)
        (fn(ta, tb) * torch.from_numpy(g)).sum().backward()
        grads.append((ta.grad.numpy(), tb.grad.numpy()))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)
    a64, b64 = _ab(B=1, S=7, W=3, seed=3)
    assert torch.autograd.gradcheck(
        rglru.linear_scan,
        (torch.from_numpy(a64).double().requires_grad_(True),
         torch.from_numpy(b64).double().requires_grad_(True)))


def test_shapes_and_axes_match_reference():
    jcfg, cfg = _cfgs()
    jp = jrglru.init_rglru(jax.random.PRNGKey(0), jcfg)
    tp = rglru.init_rglru(torch.Generator(), cfg, (), torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert rglru.rglru_axes(cfg) == jrglru.rglru_axes(jcfg)
    for k in ("conv_b", "b_a", "b_i", "lam"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    bf = rglru.init_rglru(torch.Generator(), cfg, (3,), torch.bfloat16)
    for k, v in bf.items():
        want = torch.float32 if k in rglru.FP32 else torch.bfloat16
        assert v.dtype == want and v.shape[0] == 3, k


@pytest.mark.parametrize("S", [21, 32])
def test_rglru_block_matches_reference(S):
    jcfg, cfg = _cfgs()
    tp, jp = _params(cfg)
    x = np.random.default_rng(1).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want = np.asarray(jrglru.rglru_block(jp, jnp.asarray(x), jcfg))
    got = rglru.rglru_block(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_rglru_block_gradients_match_reference():
    jcfg, cfg = _cfgs()
    tp, jp = _params(cfg, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jrglru.rglru_block(p, xx, jcfg) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (rglru.rglru_block(tp, tx, cfg) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgp[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_decode_step_from_carried_cache():
    jcfg, cfg = _cfgs()
    tp, jp = _params(cfg, seed=4)
    rng = np.random.default_rng(5)
    B, w, dc = 3, rglru._width(cfg), cfg.rglru.conv_dim
    cache = {"conv": rng.standard_normal((B, dc - 1, w)).astype(np.float32),
             "h": rng.standard_normal((B, w)).astype(np.float32)}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jy, jc = jrglru.rglru_decode_step(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jcfg)
    ty, tc = rglru.rglru_decode_step(
        tp, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in cache.items()}, cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # three steps from zeros equal the block over three tokens
    x3 = rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)
    c, ys = rglru.init_rglru_cache(cfg, B), []
    for t in range(3):
        y, c = rglru.rglru_decode_step(tp, torch.from_numpy(x3[:, t:t + 1]),
                                       c, cfg)
        ys.append(y)
    full = rglru.rglru_block(tp, torch.from_numpy(x3), cfg)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_shapes_and_dtypes(dtype):
    jcfg, cfg = _cfgs()
    want = jrglru.init_rglru_cache(jcfg, 3, jnp.dtype(dtype))
    got = rglru.init_rglru_cache(cfg, 3, getattr(torch, dtype))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == \
            str(want[k].dtype), k
        assert not got[k].any()
