"""int8 gradient compression against the reference (counterpart of
``repro/optim/compression.py`` and tests/test_sharded_precond.py:186-222).

``int8_roundtrip`` is held bit for bit against the reference's on the
same numpy inputs.  ``int8_psum`` runs in a world of 8 ranks on gloo with
the reference test's inputs (shard r scaled by 10^r / 1e3, odd length
1000 for the block pad): every rank returns the same sum, bit for bit
the reference's numerics (the shared-max rescale and the int32 sum,
emulated here with the reference's ``_quantize``), within 8 int8 steps of
the exact sum (the reference's bound), through exactly one int32 SUM and
one fp32 MAX all-reduce.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch import collectives
from repro_torch.optim import compression
import torch_world
import torch_threads  # noqa: F401  (the worker's share of the cores)

WORLD = 8


def _shards():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((WORLD, 1000)).astype(np.float32)
    return x * (10.0 ** np.arange(WORLD)[:, None] / 1e3).astype(np.float32)


@pytest.mark.parametrize("shape,dtype", [((1000,), "float32"),
                                         ((3, 64, 32), "float32"),
                                         ((7, 300), "float32"),
                                         ((64, 48), "bfloat16")])
def test_int8_roundtrip_matches_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape)
         * np.exp(rng.uniform(-6, 2, shape))).astype(np.float32)
    x[..., :3] = 0.0  # an all-zero head, where the scale clamps
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jcomp.int8_roundtrip({"g": jx})["g"], np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = compression.int8_roundtrip([tx])[0]
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantize_matches_reference():
    x = _shards()[5]
    q, s, shape, pad = compression._quantize(torch.from_numpy(x))
    jq, js, jshape, jpad = jcomp._quantize(jnp.asarray(x))
    assert (tuple(shape), pad) == (tuple(jshape), jpad) == ((1000,), 24)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _psum_ranks(rank, world, x, out_dir):
    mine = torch.from_numpy(x[rank].copy())
    with collectives.count_collectives() as calls:
        out = compression.int8_psum(mine)
    torch_world.save(out_dir, rank, {
        "out": out.numpy(),
        "calls": [(c.op, str(c.dtype), c.numel) for c in calls]})


@pytest.fixture(scope="module")
def psum_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("int8_psum")
    x = _shards()
    torch_world.run_world(_psum_ranks, WORLD, out, x, str(out))
    return x, [torch_world.load(out, r) for r in range(WORLD)]


def _reference_psum(x):
    """The reference's int8_psum over the 8 shards, each quantized by its
    ``_quantize`` and rescaled to the block's shared max scale."""
    parts = [jcomp._quantize(jnp.asarray(row)) for row in x]
    smax = np.max(np.stack([np.asarray(s) for _, s, _, _ in parts]), axis=0)
    qsum = sum(np.asarray(jnp.round(q.astype(jnp.float32)
                                    * (s / jnp.asarray(smax)))
                          .astype(jnp.int32)) for q, s, _, _ in parts)
    out = (qsum.astype(np.float32) * smax).reshape(-1)
    return out[:-parts[0][3]]


def test_int8_psum_matches_reference_and_bound(psum_world):
    x, ranks = psum_world
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
    got = ranks[0]["out"]
    np.testing.assert_array_equal(got, _reference_psum(x))
    step = np.abs(x).max() / 127.0
    err = np.abs(got - x.sum(axis=0)).max()
    assert err <= 8 * step, (err, step)


def test_int8_psum_collective_census(psum_world):
    """Exactly one fp32 MAX over the [blocks, 1] scale column and one int32
    SUM over the payload: nothing else crosses the ranks."""
    _, ranks = psum_world
    blocks = -(-1000 // compression.BLOCK)
    for r in ranks:
        assert r["calls"] == [
            ("all_reduce_max", "torch.float32", blocks),
            ("all_reduce_sum", "torch.int32", blocks * compression.BLOCK)]
