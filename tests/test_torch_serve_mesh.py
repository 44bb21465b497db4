"""Serving on a mesh: ``prefill_cache`` and greedy ``decode_step`` on a
``Model`` sharded under "tp" and "serve", in a world of 4 ranks on gloo
on a (data 2, model 2) mesh, for every family that batch mode serves
(the SMOKE configs of gpt2-paper, granite-moe-1b-a400m, falcon-mamba-7b,
recurrentgemma-2b, musicgen-medium and llava-next-34b at fp32).

Each case prefills a prompt batch of 8 positions (ragged but for vlm,
which takes no lengths) into a cache of 12 positions (28 with llava's 16
patches), then takes 4 greedy decode steps, the third with the second
and fourth lanes inactive (at batch 1 the one lane).  At global batch 4
each data rank serves two lanes and the ``kv_seq`` axis (model) splits
the slots in two; at batch 1 every rank holds the one lane and
``kv_seq`` is (data, model), four blocks of slots.  One more case has a cache of 13 positions, which the
model axis does not divide: the rules then replicate the slots.

Gates, on every rank: the logits of its lanes (whole padded vocab;
``prefill``'s too) within 2e-5 of one process of the port on the same
weights and within ``test_torch_decode.py``'s LOGIT_TOL["float32"] of
the JAX package's unsharded ``prefill_cache``/``decode_step`` (weights
carried by ``convert.params_to_jax``); the greedy tokens identical to
both; every cache leaf after each call within 2e-5 of its block of one
process's cache (``sharding.cache_blocks``) and the final blocks,
gathered whole (``sharding.gather_cache``), within 2e-5 of one
process's cache, kpos exactly; the inactive lanes' blocks bitwise
unchanged by the masked step; the collective kinds of each layout;
no call of a port kernel wrapper.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import collectives, convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding
from repro_torch.models import Model
from repro_torch.models.transformer import Layout, cache_leaves, param_specs
from repro_torch.serving import Engine, EngineConfig
import torch_world
import torch_threads  # noqa: F401  (the worker's share of the cores)

WORLD = 4
TOL = 2e-5
JAX_TOL = 1e-4  # tests/test_torch_decode.py LOGIT_TOL["float32"]
PROMPT, STEPS = 8, 4
MASKED = 2  # the decode step with lanes 1 and 3 inactive
GPT2, GRANITE = "gpt2-paper", "granite-moe-1b-a400m"
FALCON, RGEMMA = "falcon-mamba-7b", "recurrentgemma-2b"
MUSICGEN, LLAVA = "musicgen-medium", "llava-next-34b"
ARCHS = (GPT2, GRANITE, FALCON, RGEMMA, MUSICGEN, LLAVA)
STRATEGIES = ("tp", "serve")
BATCHES = (4, 1)
CFG32 = dict(dtype="float32", emb_dtype="float32")
#: the port's kernel wrappers (kernels/ops.py): serving calls none
OPS = ("matmul_add", "gram", "warm_tail", "sketch_traces",
       "residual_chain", "apply_g")


def _cache_len(arch, odd=False):
    return PROMPT + STEPS + (16 if arch == LLAVA else 0) + (1 if odd else 0)


#: name -> (arch, strategy, global batch, cache length)
CASES = {f"{a}/{s}/b{b}": (a, s, b, _cache_len(a))
         for a in ARCHS for s in STRATEGIES for b in BATCHES}
CASES[f"{GPT2}/serve/b4/odd"] = (GPT2, "serve", 4, _cache_len(GPT2, True))
#: (arch, batch, cache length) of every one-process run
RUNS = sorted({(a, b, c) for a, _, b, c in CASES.values()})


def _cfg(arch):
    return get_smoke_config(arch).replace(**CFG32)


def _inputs():
    """Each arch's SMOKE weights (drawn by the port; numpy) and a prompt
    batch and lengths for each batch size."""
    inits = {a: {k: p.detach().numpy().copy() for k, p in
                 Model(_cfg(a), device="cpu", seed=0).named_parameters()}
             for a in ARCHS}
    rng = np.random.default_rng(0)
    prompts = {}
    for a in ARCHS:
        cfg = _cfg(a)
        for b in BATCHES:
            shape = (b, cfg.num_codebooks, PROMPT) if cfg.family == "audio" \
                else (b, PROMPT)
            batch = {"tokens": rng.integers(0, cfg.vocab_size, shape)}
            if cfg.family == "vlm":
                batch["patches"] = rng.standard_normal(
                    (b, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
                lengths = None
            else:
                lengths = rng.integers(PROMPT // 2, PROMPT + 1, b)
                lengths[0] = PROMPT
            prompts[a, b] = (batch, lengths)
    return inits, prompts


def _model(init, cfg):
    model = Model(cfg, device="cpu")
    model.load_params({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _shardings(cfg, mesh, strategy):
    specs = param_specs(cfg)
    return sharding.tree_shardings(
        mesh, {k: a for k, (_, a, _) in specs.items()},
        sharding.param_rules(cfg, mesh, strategy),
        {k: s for k, (s, _, _) in specs.items()})


def _active(b):
    """The MASKED step's mask: the odd lanes inactive, the one lane at
    batch 1."""
    return (np.arange(b) % 2 == 0) & (b > 1)


def _np_tree(cache):
    return [t.numpy().copy() for t in cache_leaves(cache)]


def _serve(model, batch, lengths, cache_len, lanes=slice(None)):
    """``prefill`` (the last position's logits) and prefill_cache over
    the whole prompt batch, then STEPS greedy decode steps on ``lanes``
    (a mesh rank's): the logits and tokens of every call, the cache
    leaves after every call and the final cache."""
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    last = model.prefill(b).numpy().copy()
    logits, cache = model.prefill_cache(b, cache_len, lengths)
    start = (torch.full((batch["tokens"].shape[0],), PROMPT)
             if lengths is None else torch.from_numpy(lengths))[lanes]
    start = start + (model.cfg.num_patches
                     if model.cfg.family == "vlm" else 0)
    out = {"prefill": last, "logits": [logits.numpy().copy()],
           "caches": [_np_tree(cache)], "tokens": []}
    act_all = torch.from_numpy(_active(batch["tokens"].shape[0]))[lanes]
    for t in range(STEPS):
        tok = torch.argmax(logits, dim=-1)
        out["tokens"].append(tok.numpy().copy())
        pos = (start + t).to(torch.int32)[:, None]
        act = act_all if t == MASKED else None
        logits, cache = model.decode_step(cache, tok, pos, active=act)
        out["logits"].append(logits.numpy().copy())
        out["caches"].append(_np_tree(cache))
    out["final"] = cache
    return out


@contextlib.contextmanager
def _count_ops():
    """Calls of each port kernel wrapper inside the block."""
    from repro_torch.kernels import ops

    counts = dict.fromkeys(OPS, 0)
    real = {n: getattr(ops, n) for n in OPS}

    def counted(name):
        def call(*a, **k):
            counts[name] += 1
            return real[name](*a, **k)
        return call

    for n in OPS:
        setattr(ops, n, counted(n))
    try:
        yield counts
    finally:
        for n, f in real.items():
            setattr(ops, n, f)


def _case(name, inits, prompts, mesh):
    arch, strategy, b, cache_len = CASES[name]
    cfg = _cfg(arch)
    model = _model(inits[arch], cfg)
    model.shard(mesh, _shardings(cfg, mesh, strategy), strategy)
    batch, lengths = prompts[arch, b]
    lanes = model.serve_layout(b, cache_len).lanes
    with _count_ops() as ops, collectives.count_collectives() as calls:
        out = _serve(model, batch, lengths, cache_len, lanes)
    assert model.serving.lanes == lanes
    out["final"] = _np_tree(sharding.gather_cache(out["final"],
                                                  model.serving.shardings))
    out.update(kinds=sorted({c.kind for c in calls}), ops=ops,
               lanes=(lanes.start, lanes.stop),
               kv=None if model.serving.kv is None
               else model.serving.kv.size)
    return out


def _launcher(mesh):
    """``launch/serve.py``'s ``--mesh production`` path on this world, the
    production layout swapped for the debug mesh's: the greedy tokens of
    every lane, gathered."""
    from repro_torch.launch import serve

    real = serve.production_layout

    def debug_layout(cfg, multi_pod=False):
        return mesh, {"params": _shardings(cfg, mesh, "tp")}

    serve.production_layout = debug_layout
    try:
        res = serve.main(["--smoke", "--device", "cpu", "--mesh",
                          "production", "--batch", "4", "--prompt_len",
                          "6", "--gen_len", "3", "--cache_len", "10"])
    finally:
        serve.production_layout = real
    return res["tokens"], res["finite"]


def _ranks(rank, world, out_dir):
    """One rank: every case, then the launcher.  The inputs are drawn
    here again (deterministic): handing them to the spawned ranks would
    block each spawn until its rank had imported torch."""
    inits, prompts = _inputs()
    mesh = tmesh.make_debug_mesh(data=2, model=2)
    res = {name: _case(name, inits, prompts, mesh) for name in CASES}
    res["launcher"] = _launcher(mesh)
    torch_world.save(out_dir, rank, res)


def _one_process(inits, prompts):
    out = {}
    for arch, b, cache_len in RUNS:
        batch, lengths = prompts[arch, b]
        out[arch, b, cache_len] = _serve(_model(inits[arch], _cfg(arch)),
                                         batch, lengths, cache_len)
    from repro_torch.launch import serve

    out["launcher"] = serve.main(["--smoke", "--device", "cpu", "--batch",
                                  "4", "--prompt_len", "6", "--gen_len",
                                  "3", "--cache_len", "10"])["tokens"]
    return out


def _jax_reference(inits, prompts):
    """The JAX package's unsharded prefill_cache and greedy decode_step
    on the same weights (every step passes an ``active`` mask, all True
    but at MASKED, so one trace serves them all).  JAX is imported here:
    the ranks import this module and need none of it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build

    out = {}
    for arch, b, cache_len in RUNS:
        if cache_len != _cache_len(arch):
            continue
        jm = build(jsmoke(arch).replace(**CFG32))
        params = jax.tree.map(jnp.asarray, convert.params_to_jax(
            {k: torch.from_numpy(v) for k, v in inits[arch].items()}))
        batch, lengths = prompts[arch, b]
        jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
              for k, v in batch.items()}
        ln = None if lengths is None else jnp.asarray(lengths, jnp.int32)
        logits, cache = jax.jit(jm.prefill_cache, static_argnums=(2,))(
            params, jb, cache_len, ln)
        step = jax.jit(jm.decode_step)
        start = np.full(b, PROMPT) if lengths is None else lengths
        start = start + (jm.cfg.num_patches if jm.cfg.family == "vlm" else 0)
        got = {"logits": [np.asarray(logits)], "tokens": []}
        for t in range(STEPS):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            got["tokens"].append(np.asarray(tok))
            act = jnp.asarray(_active(b) if t == MASKED else np.ones(b, bool))
            logits, cache = step(params, cache, tok,
                                 jnp.asarray((start + t)[:, None], jnp.int32),
                                 act)
            got["logits"].append(np.asarray(logits))
        out[arch, b] = got
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh")
    inits, prompts = _inputs()
    ctx = torch_world.start_world(_ranks, WORLD, out, str(out))
    one = _one_process(inits, prompts)
    ref = _jax_reference(inits, prompts)
    torch_world.join_world(ctx)
    return one, ref, [torch_world.load(out, r) for r in range(WORLD)]


def _lanes(r, name):
    lo, hi = r[name]["lanes"]
    return slice(lo, hi)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_tokens_match_one_process(world, name):
    one, _, ranks = world
    arch, _, b, cache_len = CASES[name]
    want = one[arch, b, cache_len]
    for r in ranks:
        got, lanes = r[name], _lanes(r, name)
        assert len(got["logits"]) == STEPS + 1
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert g.shape == w[lanes].shape
            np.testing.assert_allclose(g, w[lanes], rtol=TOL, atol=TOL,
                                       err_msg=f"{name} call {i}")
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w[lanes])
        np.testing.assert_allclose(got["prefill"], want["prefill"][lanes],
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[3] == _cache_len(c[0])])
def test_logits_and_tokens_match_the_reference(world, name):
    _, ref, ranks = world
    arch, _, b, _ = CASES[name]
    want = ref[arch, b]
    for r in ranks:
        got, lanes = r[name], _lanes(r, name)
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(g, w[lanes], rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=f"{name} {i}")
        for g, w in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(g, w[lanes])


@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_match_one_process(world, name):
    """Every rank's cache leaf after every call is its block of one
    process's cache (kpos exactly); the masked step leaves the inactive
    lanes' blocks bitwise as they were; the slots split as the rules
    say (replicated when the cache length does not divide)."""
    one, _, ranks = world
    arch, _, b, cache_len = CASES[name]
    cfg = _cfg(arch)
    mesh = tmesh.make_debug_mesh(data=2, model=2)
    tree = Model(cfg, device="cpu").init_cache(b, cache_len)
    want = one[arch, b, cache_len]["caches"]
    frozen = ~_active(b)
    for rank, r in enumerate(ranks):
        got = r[name]["caches"]
        assert len(got) == len(want) == STEPS + 1
        for i, (g, w) in enumerate(zip(got, want)):
            blocks = cache_leaves(sharding.cache_blocks(
                mesh, cfg, _fill(tree, iter(w)), b, mesh.coords(rank)))
            assert len(g) == len(blocks) == len(w)
            for leaf, blk in zip(g, blocks):
                blk = blk.numpy()
                assert leaf.shape == blk.shape, (name, i)
                if leaf.dtype == np.int32:
                    np.testing.assert_array_equal(leaf, blk)
                else:
                    np.testing.assert_allclose(leaf, blk, rtol=TOL, atol=TOL,
                                               err_msg=f"{name} call {i}")
        before, after = got[MASKED], got[MASKED + 1]
        lanes = _lanes(r, name)
        lane_of = _lane_dims(tree)
        for leaf_b, leaf_a, d in zip(before, after, lane_of):
            idx = [slice(None)] * leaf_b.ndim
            idx[d] = frozen[lanes]
            np.testing.assert_array_equal(leaf_a[tuple(idx)],
                                          leaf_b[tuple(idx)])
        kv = r[name]["kv"]
        if cfg.family == "ssm":
            assert kv is None
        elif cache_len % 2:
            assert kv is None
        else:
            assert kv == (4 if b == 1 else 2)


@pytest.mark.parametrize("name", list(CASES))
def test_cache_gathers_whole(world, name):
    """Every rank's blocks of the final cache, gathered whole
    (``sharding.gather_cache``, the inverse of ``cache_blocks``), are one
    process's final cache (kpos exactly)."""
    one, _, ranks = world
    arch, _, b, cache_len = CASES[name]
    want = _np_tree(one[arch, b, cache_len]["final"])
    for r in ranks:
        got = r[name]["final"]
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            if g.dtype == np.int32:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                           err_msg=name)


def _fill(tree, values):
    """``tree``'s nesting with its leaves taken from ``values`` in
    ``cache_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _fill(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_fill(v, values) for v in tree]
    return torch.from_numpy(next(values))


def _lane_dims(tree):
    """The lane dim of each cache leaf, in ``cache_leaves`` order."""
    def dim(path, t):
        name = path[-1]
        if name == "kpos":
            return 0
        if name in ("k", "v"):
            return t.dim() - 4
        if name == "conv":
            return t.dim() - 3
        if name == "ssm":  # Mamba's state [L, B, d_inner, state]
            return 1
        return t.dim() - 2  # the RG-LRU's h

    def walk(node, path):
        if isinstance(node, dict):
            return [d for k in sorted(node) for d in walk(node[k],
                                                          path + (k,))]
        if isinstance(node, list):
            return [d for v in node for d in walk(v, path)]
        return [dim(path, node)]

    return walk(tree, ())


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_and_no_kernel(world, name):
    """"serve" gathers nothing over data, "tp" gathers its FSDP leaves
    every call; tensor parallelism gathers q and the logits; the softmax
    combines over the slots where they split; Mamba's and the RG-LRU's
    layers add their own kinds; no port kernel wrapper is called."""
    _, _, ranks = world
    arch, strategy, b, cache_len = CASES[name]
    family = _cfg(arch).family
    for r in ranks:
        kinds = set(r[name]["kinds"])
        assert ("fsdp" in kinds) == (strategy == "tp"), kinds
        assert {"tp", "logits"} <= kinds
        attention = family != "ssm"
        assert ("kv_q" in kinds) == attention
        assert ("kv_seq" in kinds) == (attention and r[name]["kv"] is not
                                       None)
        assert ("tp_gather" in kinds) == (family == "ssm")
        assert ("tp_scatter" in kinds) == (family == "hybrid")
        assert ("moe" in kinds) == (family == "moe" and b > 1)
        assert r[name]["ops"] == dict.fromkeys(OPS, 0)


def test_launcher_batch_mode_on_the_world(world):
    """``launch/serve.py --mesh production`` (the layout swapped for the
    debug mesh's) serves every lane's greedy tokens as one process
    does."""
    one, _, ranks = world
    for r in ranks:
        tokens, finite = r["launcher"]
        assert finite
        np.testing.assert_array_equal(tokens, one["launcher"])


def test_launcher_mesh_production_outside_a_world(monkeypatch):
    """Outside a world ``--mesh production`` fails as launch/train.py
    does; ``--continuous --mesh production`` exits with the reference's
    message."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import ENV_VARS

    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="no world in the environment"):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "production"])
    with pytest.raises(SystemExit, match="single-host"):
        serve.main(["--smoke", "--device", "cpu", "--continuous", "--mesh",
                    "production"])
    with pytest.raises(ValueError, match="--multi_pod needs"):
        serve.main(["--smoke", "--device", "cpu", "--multi_pod"])


def test_zero_layout_is_not_served():
    """A model sharded under "zero" refuses to serve (the reference
    serves under "tp" and "serve" only); so does the Engine a sharded
    model.  (The layout is set without a world: nothing here gathers.)"""
    cfg = _cfg(GPT2)
    model = Model(cfg, device="cpu")
    mesh = tmesh.make_debug_mesh(data=2, model=2)
    model.layout = Layout(mesh, _shardings(cfg, mesh, "zero"), "zero",
                          [k for k, _ in model.named_parameters()])
    with pytest.raises(ValueError, match="'zero' layout"):
        model.init_cache(4, 12)
    with pytest.raises(ValueError, match="one process"):
        Engine(model, None, EngineConfig(slots=2, cache_len=8))
