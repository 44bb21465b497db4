"""Muon's local reshard in a world of 4 ranks on gloo, on a (data 2, model 2)
mesh (counterpart of tests/test_sharded_precond.py:52-123, its views and
configs, with ``muon_local_reshard`` on).

Under the context ``{"opt_layers": "model", "opt_rows": "data"}`` a
bucket built only from layer stacks splits its slices over the model axis
and the rows of its long side over the data axis
(``bucketing.polar_local_rows``): the grid tier's polar runs on the local
rows with one [n, n] Gram SUM all-reduce over the data axis an iteration.
The configs pin the grid tier (``fuse="off"``), since the CPU's small
shapes would take the fused tier, which has no seam for a collective.
The reference's view zoo (``SHAPES``) mixes 2-D views into every bucket,
so its buckets keep the batch engine; ``STACKS`` adds buckets of stacks
only: one whose B = 5 pads to 6 over the model axis, a wide one whose
long side is its columns, and a (48, 44) stack merged into the (48, 48)
bucket through the ``n_real`` correction.  Every polar and the Muon
update are held against one process (no context) at the reference's
sharded-vs-replicated tolerance, 2e-5; the bf16 policy at rtol 0.05,
atol 1.5·2⁻⁸; and one process against the JAX package's polars.  Every
rank launches the single process's kernel-wrapper calls, and the census
shows one Gram all-reduce of the local [B/2, n, n] a grid-tier iteration
and bucket, on the rows' [B/2, m/2, n] blocks.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.optim import bucketing as jbucketing
from repro_torch import collectives
from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.core import newton_schulz
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import bucketing, make_optimizer
from repro_torch.sharding_ctx import activation_sharding
from test_torch_muon import count_ops
from test_torch_prism import JaxKey
import torch_world
import torch_threads  # noqa: F401  (the worker's share of the cores)

WORLD = 4
TOL = 2e-5
BF16_RTOL, BF16_ATOL = 0.05, 1.5 * 2.0 ** -8
RULES = {"opt_layers": "model", "opt_rows": "data"}
SHAPES = [(3, 64, 32), (64, 32), (64, 32), (64, 32), (48, 48), (48, 44)]
STACKS = [(3, 64, 32), (2, 64, 32), (2, 32, 96), (4, 48, 48), (2, 48, 44)]
POLAR = dict(degree=2, iterations=6, warm_alpha_iters=1, sketch_dim=8,
             fuse="off")
UPDATE = dict(degree=2, iterations=5, warm_alpha_iters=1, sketch_dim=8,
              fuse="off")
AXES = {"w": ("layers", "embed", "mlp"), "u": ("layers", "mlp", "embed"),
        "v": ("embed", "mlp"), "b": ("embed",)}


def _cfg(prism=POLAR, **kw):
    return OptimizerConfig(prism=PrismConfig(use_kernels=True, **prism),
                           bucket_pad=True, muon_local_reshard=True, **kw)


def _inputs():
    rng = np.random.default_rng(0)
    zoo = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    stacks = [rng.standard_normal(s).astype(np.float32) for s in STACKS]
    params = {"w": stacks[0], "u": rng.standard_normal((3, 32, 64)).astype(
        np.float32), "v": zoo[4], "b": np.ones((64,), np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    return dict(zoo=zoo, stacks=stacks, params=params, grads=grads)


def _np(t):
    return t.detach().float().numpy()


def _polars(views, cfg, mesh=None):
    """(polars, wrapper calls, collectives) of one polar_bucketed call,
    under the mesh's context when given."""
    ts = [torch.from_numpy(v) for v in views]
    ctx = activation_sharding(mesh, RULES) if mesh is not None else \
        torch.no_grad()
    with ctx, count_ops() as ops_calls, \
            collectives.count_collectives() as calls:
        outs = bucketing.polar_bucketed(ts, cfg, JaxKey(jax.random.PRNGKey(0)))
    return ([_np(o) for o in outs], dict(ops_calls),
            [(c.op, c.kind, c.numel) for c in calls])


def _update(params, grads, mesh=None, **kw):
    cfg = OptimizerConfig(name="muon", learning_rate=0.05,
                          muon_local_reshard=True,
                          prism=PrismConfig(use_kernels=True, **UPDATE), **kw)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in params.items()]
    opt = make_optimizer(cfg, named, AXES)
    for k, p in named:
        p.grad = torch.from_numpy(grads[k].copy())
    ctx = activation_sharding(mesh, RULES) if mesh is not None else \
        torch.no_grad()
    with ctx:
        opt.step(key=JaxKey(jax.random.PRNGKey(0)))
    return {k: _np(p) for k, p in named}


def _cases(inp, mesh=None):
    return {
        "stacks": _polars(inp["stacks"], _cfg(), mesh),
        "zoo": _polars(inp["zoo"], _cfg(), mesh),
        "stacks16": _polars(inp["stacks"], _cfg(matfn_dtype="bfloat16"),
                            mesh),
        "update": _update(inp["params"], inp["grads"], mesh),
    }


def _near_orthogonal():
    """bf16 [2, 64, 16] stacks X = Q + 1e-3 noise: R = I - X^T X is
    O(1e-3) while each half of the rows' partial X^T X is O(1)."""
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.standard_normal((2, 64, 16)))
    x = q + 1e-3 * rng.standard_normal(q.shape)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _gram_rows(mesh=None):
    """R of ``_near_orthogonal`` in bf16: whole, or from this rank's half
    of the rows with the partials summed over the data axis."""
    x = _near_orthogonal()
    if mesh is None:
        return _np(newton_schulz._gram_residual(x, True))
    i = mesh.coords()["data"]
    return _np(newton_schulz._gram_residual(
        x[:, 32 * i:32 * (i + 1)].contiguous(), True,
        row_group=mesh.group(("data",))))


def _ranks(rank, world, inp, out_dir):
    mesh = tmesh.make_debug_mesh(data=2, model=2)
    res = _cases(inp, mesh)
    res["gram16"] = _gram_rows(mesh)
    with activation_sharding(mesh, RULES):
        res["axes"] = bucketing.local_reshard_axes(_cfg())[1:]
    torch_world.save(out_dir, rank, res)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("local_reshard")
    inp = _inputs()
    ctx = torch_world.start_world(_ranks, WORLD, out, inp, str(out))
    one = _cases(inp)
    one["gram16"] = _gram_rows()
    one["reference"] = _reference(inp)
    torch_world.join_world(ctx)
    return inp, one, [torch_world.load(out, r) for r in range(WORLD)]


def _reference(inp):
    """The JAX package's single-device polars of the stacks."""
    jcfg = JOpt(prism=JPrism(**{k: v for k, v in POLAR.items()
                                if k != "fuse"}), bucket_pad=True)
    return [np.asarray(w) for w in jbucketing.polar_bucketed(
        [jax.numpy.asarray(v) for v in inp["stacks"]], jcfg,
        jax.random.PRNGKey(0))]


def _close(got, want, rtol=TOL, atol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["stacks", "zoo"])
def test_local_reshard_polar_matches_one_process(world, case):
    _, one, ranks = world
    for r in ranks:
        assert r["axes"] == (("model",), ("data",))
        _close(r[case][0], one[case][0])
        # the same wrapper calls as one process (one launch a bucket and
        # iteration step, whatever the bucket's block)
        assert r[case][1] == one[case][1]
    for r in ranks[1:]:
        for a, b in zip(r[case][0], ranks[0][case][0]):
            np.testing.assert_array_equal(a, b)


def test_one_process_matches_the_reference(world):
    """The yardstick itself: one process's polars of the stacks against
    the JAX package's single-device ``polar_bucketed``."""
    _, one, _ = world
    _close(one["stacks"][0], one["reference"], 1e-4, 1e-4)


def test_local_reshard_update_matches_one_process(world):
    _, one, ranks = world
    for r in ranks:
        for k, v in one["update"].items():
            np.testing.assert_allclose(r["update"][k], v, rtol=TOL, atol=TOL,
                                       err_msg=k)


def test_local_reshard_bf16_policy(world):
    _, one, ranks = world
    for r in ranks:
        _close(r["stacks16"][0], one["stacks16"][0], BF16_RTOL, BF16_ATOL)


def test_local_reshard_bf16_gram_rounds_once(world):
    """In bf16 the row-split R = I - X^T X rounds once, as the whole one
    does: the partial X^T X is formed and summed in fp32.  Rounding each
    O(1) partial to bf16 first errs by ~2^-9 absolute, as large as R
    itself here; one rounding errs by at most one ulp of R's entries."""
    _, one, ranks = world
    want = one["gram16"]
    bound = 2.0 ** -8 * np.abs(want).max()
    assert np.abs(want).max() < 1e-2
    for r in ranks:
        assert np.abs(r["gram16"] - want).max() <= bound


def test_gram_census(world):
    """One [n, n] Gram all-reduce over the data axis a grid-tier
    iteration and bucket of stacks, of the rank's [B/2, n, n] partials;
    the zoo's mixed buckets issue none (they take the batch engine)."""
    inp, _, ranks = world
    iters = POLAR["iterations"]
    buckets = bucketing.plan_buckets([v.shape for v in inp["stacks"]],
                                     pad=True)
    want = []
    for b in buckets:
        per = -(-b.size // 2)
        n = min(b.shape)
        want += [per * n * n] * iters
    for r in ranks:
        grams = [numel for op, kind, numel in r["stacks"][2]
                 if kind == "gram"]
        assert sorted(grams) == sorted(want)
        assert all(op == "all_reduce_sum" for op, kind, _ in r["stacks"][2]
                   if kind == "gram")
        norms = [c for c in r["stacks"][2] if c[1] == "norm"]
        assert len(norms) == len(buckets)
        assert not [c for c in r["zoo"][2] if c[1] in ("gram", "norm")]
