"""The port's Mamba-1 block (``repro_torch/models/ssm.py``) against the
reference's ``repro/models/ssm.py`` on the CPU, at falcon-mamba-7b's
SMOKE widths (d 64, d_inner 128, state 4) in fp32: the block at a length
that is not a multiple of the scan chunk, its gradients against
``jax.grad``, a decode step from a carried cache, the cache's shapes and
dtypes, and the scan's memory bound (backward keeps no per-step state).

Tolerances: 1e-5 relative and absolute on outputs of unit scale (fp32
rounding of the same products summed in another order), 1e-4 on
gradients (summed over batch and sequence)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import ssm as jssm
from repro_torch.models import ssm
from test_torch_moe import port_cfg
import torch_threads  # noqa: F401  (the worker's share of the cores)

CFG32 = dict(dtype="float32", emb_dtype="float32")
RTOL, ATOL = 1e-5, 1e-5
GRAD_TOL = 1e-4


def _cfgs():
    jcfg = jsmoke("falcon-mamba-7b").replace(**CFG32)
    return jcfg, port_cfg(jcfg)


def _params(cfg, seed=0):
    """Drawn in the port (``init_mamba``) and perturbed so that the fp32
    vectors (dt_bias, A_log, D) and conv_b are not their constant
    initial values; (torch dict, jax dict)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    p = ssm.init_mamba(gen, cfg, (), torch.float32)
    for k in ("conv_b", "dt_bias", "A_log", "D"):
        p[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=gen)
    return p, {k: jnp.asarray(v.numpy()) for k, v in p.items()}


def _x(cfg, B=2, S=21, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def test_shapes_and_axes_match_reference():
    jcfg, cfg = _cfgs()
    jp = jssm.init_mamba(jax.random.PRNGKey(0), jcfg)
    tp = ssm.init_mamba(torch.Generator(), cfg, (), torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert ssm.mamba_axes(cfg) == jssm.mamba_axes(jcfg)
    assert ssm._dt_rank(cfg) == jssm._dt_rank(jcfg) == 4
    # the constant initial values, bitwise
    for k in ("conv_b", "A_log", "D"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    np.testing.assert_allclose(tp["dt_bias"].numpy(),
                               np.asarray(jp["dt_bias"]), rtol=1e-6)
    bf = ssm.init_mamba(torch.Generator(), cfg.replace(dtype="bfloat16"),
                        (3,), torch.bfloat16)
    for k, v in bf.items():
        assert v.shape[0] == 3
        want = torch.float32 if k in ssm.FP32 else torch.bfloat16
        assert v.dtype == want, k
    # at falcon's published width dt_rank is ceil(4096 / 16)
    assert ssm._dt_rank(cfg.replace(d_model=4096)) == 256


@pytest.mark.parametrize("S", [21, 16, 5])
def test_mamba_block_matches_reference(S):
    """Lengths of 1.3 chunks, one chunk and part of one: the padded tail
    (dA = 1, dBx = 0) leaves the state as the reference's does."""
    jcfg, cfg = _cfgs()
    tp, jp = _params(cfg)
    x = _x(cfg, S=S)
    want = np.asarray(jssm.mamba_block(jp, jnp.asarray(x), jcfg))
    got = ssm.mamba_block(tp, torch.from_numpy(x), cfg)
    assert got.shape == (2, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # another chunk size is the same recurrence
    got4 = ssm.mamba_block(tp, torch.from_numpy(x), cfg, chunk=4)
    np.testing.assert_allclose(got4.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mamba_block_gradients_match_reference():
    jcfg, cfg = _cfgs()
    tp, jp = _params(cfg, seed=2)
    x = _x(cfg, S=21, seed=3)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba_block(p, xx, jcfg) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (ssm.mamba_block(tp, tx, cfg) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgp[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_scan_backward_keeps_no_per_step_state():
    """Under autograd no saved tensor holds a [B, S, d_inner, d_state]
    slab: the chunks keep their inputs and boundary states, and recompute
    dA, dBx and the per-step states in backward."""
    _, cfg = _cfgs()
    tp, _ = _params(cfg)
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    B, S = 2, 48
    x = torch.from_numpy(_x(cfg, B=B, S=S))
    di, ds = ssm._d_inner(cfg), cfg.ssm.state_dim
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = ssm.mamba_block(tp, x, cfg)
    big = [s for s in shapes if len(s) == 4 and s[-2:] == (di, ds)]
    assert not big, big
    boundary = [s for s in shapes if s == (B, di, ds)]
    assert len(boundary) >= S // ssm.SCAN_CHUNK - 1
    y.sum().backward()
    assert all(torch.isfinite(v.grad).all() for v in tp.values())


def test_decode_step_from_carried_cache():
    jcfg, cfg = _cfgs()
    tp, jp = _params(cfg, seed=5)
    rng = np.random.default_rng(6)
    B = 3
    di, ds, dc = ssm._d_inner(cfg), cfg.ssm.state_dim, cfg.ssm.conv_dim
    cache = {"conv": rng.standard_normal((B, dc - 1, di)).astype(np.float32),
             "ssm": rng.standard_normal((B, di, ds)).astype(np.float32)}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jy, jc = jssm.mamba_decode_step(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jcfg)
    ty, tc = ssm.mamba_decode_step(
        tp, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in cache.items()}, cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # two steps from zeros equal the block over two tokens
    x2 = rng.standard_normal((B, 2, cfg.d_model)).astype(np.float32)
    c = ssm.init_mamba_cache(cfg, B)
    ys = []
    for t in range(2):
        y, c = ssm.mamba_decode_step(tp, torch.from_numpy(x2[:, t:t + 1]),
                                     c, cfg)
        ys.append(y)
    full = ssm.mamba_block(tp, torch.from_numpy(x2), cfg)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_shapes_and_dtypes(dtype):
    jcfg, cfg = _cfgs()
    want = jssm.init_mamba_cache(jcfg, 3, jnp.dtype(dtype))
    got = ssm.init_mamba_cache(cfg, 3, getattr(torch, dtype))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == \
            str(want[k].dtype), k
        assert not got[k].any()
    lead = ssm.init_mamba_cache(cfg, 3, torch.bfloat16, lead=(2,))
    assert tuple(lead["ssm"].shape) == (2,) + tuple(want["ssm"].shape)
