"""The port's sharding rules against the reference's, spec for spec
(counterpart of tests/test_sharding_rules.py and of
``repro/launch/sharding.py`` as a whole).

For each of the ten configs of the registry, on meshes of shape (2, 2),
(2, 4), (16, 16) and (2, 16, 16) (pod, data, model), each rule of
``launch/sharding.py`` must give the reference's ``PartitionSpec``: every
parameter under the tp, zero and serve strategies, with and without the
shapes; the optimizer state (Muon with its staleness cache and the §12
twins: ``opt_state_shardings``); the decode cache at batch 1 and 8; the
train and decode inputs; and the rule dicts themselves.  Both sides are
shape-only: the reference's meshes are ``compat_abstract_mesh``es and its
trees ``jax.eval_shape``s, the port's meshes have no process group and
its parameters and state live on the meta device.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsh
from repro.launch.mesh import compat_abstract_mesh
from repro.models import build
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.state import opt_state_shardings as jopt_state_shardings
from repro_torch import convert
from repro_torch.config import OptimizerConfig
from repro_torch.configs import arch_ids, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as sh
from repro_torch.models.transformer import param_specs
from repro_torch.optim import make_optimizer
from repro_torch.train.state import opt_state_shardings
import torch_threads  # noqa: F401  (the worker's share of the cores)

MESHES = [((2, 2), False), ((2, 4), False), ((16, 16), False),
          ((2, 16, 16), True)]
STRATEGIES = ("tp", "zero", "serve")
ARCHS = sorted(arch_ids())


def _meshes(shape, multi_pod):
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if multi_pod:
        mine = tmesh.make_debug_mesh(shape[1], shape[2], multi_pod=True,
                                     pods=shape[0])
    else:
        mine = tmesh.make_debug_mesh(*shape)
    return compat_abstract_mesh(shape, axes), mine


ALL_MESHES = [_meshes(s, m) for s, m in MESHES]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    cfg = jget_config(arch)
    model = build(cfg)
    return cfg, model, model.logical_axes(), model.param_shapes()


def _specs(tree):
    """name -> spec tuple of a tree of (Named)Shardings."""
    return {k: tuple(v.spec) for k, v in convert._flatten(tree).items()}


def _port_params(arch):
    specs = param_specs(get_config(arch))
    return ({k: a for k, (_, a, _) in specs.items()},
            {k: s for k, (s, _, _) in specs.items()})


def test_the_ten_configs_are_the_references():
    from repro.configs import arch_ids as jarch_ids

    assert ARCHS == sorted(jarch_ids()) and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch):
    jcfg, _, jaxes, jshapes = _reference(arch)
    cfg = get_config(arch)
    axes, shapes = _port_params(arch)
    for jmesh, mesh in ALL_MESHES:
        for strategy in STRATEGIES:
            jrules = jsh.param_rules(jcfg, jmesh, strategy)
            rules = sh.param_rules(cfg, mesh, strategy)
            assert rules == jrules, (arch, strategy)
            for with_shapes in (False, True):
                try:
                    want = _specs(jsh.tree_shardings(
                        jmesh, jaxes, jrules,
                        jshapes if with_shapes else None))
                except Exception as e:  # jax's DuplicateSpecError
                    # an axis on two dims: constrain_spec (the shapes)
                    # dedups it, the bare rules cannot
                    assert "duplicate" in str(e)
                    with pytest.raises(ValueError, match="more than one"):
                        sh.tree_shardings(mesh, axes, rules)
                    continue
                got = _specs(sh.tree_shardings(
                    mesh, axes, rules, shapes if with_shapes else None))
                assert got == want, (arch, mesh, strategy, with_shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_shardings_match_reference(arch):
    """Muon's state (momentum, AdamW's nu, the staleness cache "ortho"
    and its twin "ortho_p", the drift scalars) as the reference shards
    it, over tp-sharded parameters."""
    jcfg, _, jaxes, jshapes = _reference(arch)
    kw = dict(name="muon", precond_every=2, precond_async=True)
    jopt = jmake_optimizer(JOpt(**kw), jaxes)
    axes, shapes = _port_params(arch)
    named = [(k, torch.nn.Parameter(torch.empty(s, device="meta")))
             for k, s in shapes.items()]
    opt = make_optimizer(OptimizerConfig(**kw), named, axes)
    master = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), jshapes)
    for jmesh, mesh in ALL_MESHES:
        jp = jsh.tree_shardings(jmesh, jaxes,
                                jsh.param_rules(jcfg, jmesh), jshapes)
        p = sh.tree_shardings(mesh, axes,
                              sh.param_rules(get_config(arch), mesh), shapes)
        want = jopt_state_shardings(jmesh, jopt, master, jp)
        got = opt_state_shardings(mesh, opt, named, p)
        for k in ("count", "pending_at"):
            assert got.pop(k).spec == tuple(want[k].spec) == ()
        assert set(want) == {"leaves", "count", "pending_at"}
        leaves = _specs(want["leaves"])
        flat = {f"{k}.{sk}": tuple(v.spec) for k, slot in got.items()
                for sk, v in slot.items()}
        assert flat == leaves, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_shardings_match_reference(arch):
    jcfg, model, _, _ = _reference(arch)
    cfg = get_config(arch)
    for batch in (1, 8):
        jcache = jax.eval_shape(lambda: model.init_cache(batch, 64))

        def meta(node):
            if isinstance(node, dict):
                return {k: meta(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [meta(v) for v in node]
            return torch.empty(node.shape, device="meta")

        cache = meta(jcache)
        for jmesh, mesh in ALL_MESHES:
            assert _specs(sh.cache_shardings(mesh, cfg, cache, batch)) == \
                _specs(jsh.cache_shardings(jmesh, jcfg, jcache, batch))
            assert _specs(sh.decode_input_shardings(mesh, cfg, batch)) == \
                _specs(jsh.decode_input_shardings(jmesh, jcfg, batch))
    for jmesh, mesh in ALL_MESHES:
        for pipeline in (False, True):
            assert _specs(sh.train_batch_shardings(mesh, cfg, pipeline)) \
                == _specs(jsh.train_batch_shardings(jmesh, jcfg, pipeline))


@pytest.mark.parametrize("arch", ARCHS)
def test_activation_and_pipeline_rules_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for jmesh, mesh in ALL_MESHES:
        assert sh.batch_axes(mesh) == jsh.batch_axes(jmesh)
        for strategy in STRATEGIES:
            rules = sh.activation_rules(cfg, mesh, strategy)
            assert rules == jsh.activation_rules(jcfg, jmesh, strategy)
            assert sh.pipeline_rules(rules) == jsh.pipeline_rules(rules)
        prules = sh.param_rules(cfg, mesh)
        assert sh.pipeline_rules(prules) == jsh.pipeline_rules(prules)


@pytest.mark.parametrize("shape", [(3, 1024, 136), (50272, 136), (64,),
                                   (16, 48, 48), (2, 49155, 136)])
def test_cache_basis_and_replicated_rules_match_reference(shape):
    for jmesh, mesh in ALL_MESHES:
        for fn in ("precond_cache_sharding", "lowrank_basis_sharding"):
            assert getattr(sh, fn)(mesh, shape).spec == \
                tuple(getattr(jsh, fn)(jmesh, shape).spec)
        assert sh.replicated(mesh).spec == tuple(jsh.replicated(jmesh).spec)
        for spec in (("model", "data"), (None, ("data", "model"), "model"),
                     (("data", "model"), None)):
            spec = spec[:len(shape)]
            assert sh.constrain_spec(mesh, spec, shape) == tuple(
                jsh.constrain_spec(jmesh, jax.sharding.PartitionSpec(*spec),
                                   shape))
    # shardings_like: rank-0 leaves replicate, the rest take the reference
    jmesh, mesh = ALL_MESHES[2]
    ref = sh.Sharding(mesh, ("data",))
    out = sh.shardings_like(mesh, {"w": torch.empty(shape, device="meta"),
                                   "n": np.int32(0)}, {"w": ref, "n": ref})
    jref = jsh.NamedSharding(jmesh, jsh.P("data"))
    jout = jsh.shardings_like(jmesh, {"w": jax.ShapeDtypeStruct(
        shape, np.float32), "n": jax.ShapeDtypeStruct((), np.int32)},
        {"w": jref, "n": jref})
    assert _specs(out) == _specs(jout)


def test_placements_on_a_device_mesh_dimension():
    """A spec becomes one placement a mesh axis: Shard(d) for the axis
    splitting dim d, Replicate() for the rest."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_debug_mesh(2, 4, multi_pod=True, pods=2)
    spec = sh.constrain_spec(mesh, (("pod", "data"), None, "model"),
                             (8, 3, 16))
    assert sh.placements(sh.Sharding(mesh, spec)) == (Shard(0), Shard(0),
                                                      Shard(2))
    assert sh.placements(sh.replicated(mesh)) == (Replicate(),) * 3
