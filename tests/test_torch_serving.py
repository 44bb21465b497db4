"""The port's serving plane on the CPU: the counterparts of
``tests/test_serving.py`` for the dense family — sampling properties and
the sampler held against the reference's through the ``JaxKey`` seam,
the load generator byte for byte, the Engine's invariants (slot
accounting, bitwise batching invariance, eviction and replay, the shape
contract, continuous beating static), greedy and sampled Engine runs
equal to the reference Engine's, and the train -> serve handoff."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import hypothesis_or_stub

from repro.configs import get_smoke_config as jsmoke
from repro.configs import qwen3_14b as jqwen
from repro.models import build
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import make_trace as jmake_trace
from repro.serving import sample_logits as jsample_logits
from repro_torch import convert
from repro_torch.checkpoint import restore_params
from repro_torch.config import OptimizerConfig, PrismConfig, TrainConfig
from repro_torch.configs import gpt2_paper
from repro_torch.core.rng import Key
from repro_torch.data import DataConfig
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.serving import (Engine, EngineConfig, make_trace, pow2_pad,
                                 sample_logits)
from repro_torch.serving.decode import make_serve_step
from repro_torch.train import Trainer
from test_torch_decode import CFG32, port_config
from test_torch_moe import port_cfg
from test_torch_prism import JaxKey
import torch_threads  # noqa: F401  (the worker's share of the cores)

given, settings, st = hypothesis_or_stub()

CLEN = 64


@pytest.fixture(scope="module")
def served():
    cfg = port_config(jqwen.SMOKE)
    model = Model(cfg, device="cpu", seed=0)
    return cfg, model, model.cast_params()


def _trace(cfg, seed=7, n=10, qps=50.0, fn=make_trace):
    return fn(seed, n_requests=n, qps=qps, vocab_size=cfg.vocab_size,
              prompt_lens=(3, 5, 8, 12), gen_lens=(2, 4, 6))


def _engine(model, params, **kw):
    kw = dict(dict(slots=4, cache_len=CLEN, eos_id=0), **kw)
    return Engine(model, params, EngineConfig(**kw))


# ---------------------------------------------------------------- sampling


@given(b=st.integers(1, 4), extra=st.integers(0, 1), v=st.integers(2, 37),
       temp=st.floats(0.05, 4.0), k=st.integers(1, 40),
       seed=st.integers(0, 99))
@settings(max_examples=40, deadline=None)
def test_sample_logits_in_vocab(b, extra, v, temp, k, seed):
    """Samples are int32 and inside the vocab for any leading batch
    layout, temperature, and top_k (including top_k > vocab)."""
    rng = np.random.default_rng(seed)
    shape = (b, 2, v) if extra else (b, v)
    logits = torch.from_numpy(
        (rng.standard_normal(shape) * 3).astype(np.float32))
    out = sample_logits(logits, Key(seed), temperature=temp, top_k=k)
    assert out.dtype == torch.int32
    assert tuple(out.shape) == shape[:-1]
    assert bool(torch.all((out >= 0) & (out < v)))


@given(v=st.integers(2, 50), temp=st.floats(0.05, 9.0),
       seed=st.integers(0, 99))
@settings(max_examples=40, deadline=None)
def test_sample_topk1_is_argmax(v, temp, seed):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        (rng.standard_normal((3, v)) * 5).astype(np.float32))
    out = sample_logits(logits, Key(seed), temperature=temp, top_k=1)
    assert torch.equal(out, torch.argmax(logits, dim=-1).to(torch.int32))


@given(seed=st.integers(0, 99), temp=st.floats(0.1, 2.0))
@settings(max_examples=25, deadline=None)
def test_sample_replay_deterministic(seed, temp):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((4, 33)).astype(
        np.float32))
    a = sample_logits(logits, Key(seed), temperature=temp, top_k=8)
    b = sample_logits(logits, Key(seed), temperature=temp, top_k=8)
    assert torch.equal(a, b)


@pytest.mark.parametrize("top_k", [None, 1, 5, 40], ids=str)
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_sample_logits_matches_reference(top_k, ties):
    """Through the ``JaxKey`` seam (``Key.gumbel`` on
    ``jax.random.gumbel``) the port samples the reference's tokens, over a
    [B, V] and a [B, 2, V] layout.  With ``ties`` the logits are small
    integers, so the top-k support holds equal values: the port's stable
    sort orders them by index as ``lax.top_k`` does, and any other order
    would hand the noise to other tokens."""
    rng = np.random.default_rng(11)
    for i, shape in enumerate([(6, 33), (3, 2, 33)]):
        a = rng.standard_normal(shape) * 3
        a = np.round(a) if ties else a
        logits = a.astype(np.float32)
        for s in range(4):
            key = jax.random.PRNGKey(100 * i + s)
            want = jsample_logits(jnp.asarray(logits), key, temperature=0.7,
                                  top_k=top_k)
            got = sample_logits(torch.from_numpy(logits), JaxKey(key),
                                temperature=0.7, top_k=top_k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_domain_single_source(served):
    """The check raises identically from both entry points."""
    _, model, _ = served
    with pytest.raises(ValueError, match="temperature must be > 0"):
        sample_logits(torch.zeros((2, 8)), Key(0), temperature=0.0)
    with pytest.raises(ValueError, match="temperature must be > 0"):
        make_serve_step(model, greedy=False, temperature=-1.0)
    with pytest.raises(ValueError, match="temperature must be > 0"):
        EngineConfig(greedy=False, temperature=0.0)


def test_serve_step_rid_fold_separates_streams(served):
    """Two requests decoding at the SAME position must not share a sample
    stream: same logits and position, different rids -> different samples
    over 8 positions; the same (rid, pos) resamples identically."""
    cfg, model, params = served
    step = make_serve_step(model, greedy=False, temperature=1.0)
    cache_a = model.init_cache(2, 16)
    cache_b = model.init_cache(2, 16)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    seq_a, seq_b = [], []
    for t in range(8):
        pos = torch.full((2, 1), t, dtype=torch.int32)
        _, na, cache_a = step(cache_a, tok, pos, Key(3), rids=[0, 0],
                              params=params)
        _, nb, cache_b = step(cache_b, tok, pos, Key(3), rids=[0, 7],
                              params=params)
        seq_a.append(na.numpy())
        seq_b.append(nb.numpy())
    a, b = np.stack(seq_a), np.stack(seq_b)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    assert not np.array_equal(a[:, 1], b[:, 1])


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_make_trace_byte_identical_to_reference(seed):
    for kw in (dict(n_requests=20, qps=50.0, vocab_size=256),
               dict(n_requests=9, qps=3.5, vocab_size=50257,
                    prompt_lens=(3, 5), gen_lens=(2, 4, 6))):
        got, want = make_trace(seed, **kw), jmake_trace(seed, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.rid, g.arrival, g.max_new) == (w.rid, w.arrival,
                                                     w.max_new)
            assert g.prompt.dtype == w.prompt.dtype
            assert g.prompt.tobytes() == w.prompt.tobytes()
    with pytest.raises(ValueError, match="qps"):
        make_trace(seed, n_requests=2, qps=0.0, vocab_size=8)


# ------------------------------------------------------------------ engine


def test_engine_slot_accounting_never_leaks(served):
    cfg, model, params = served
    trace = _trace(cfg)
    eng = _engine(model, params)
    res = eng.run(trace, step_dt=0.01)
    assert sorted(c.rid for c in res.completions) == \
        sorted(r.rid for r in trace)
    assert eng.n_active == 0
    assert bool(np.all(eng._rid == -1))
    assert all(1 <= o <= 4 for o in res.occupancy)
    assert len(res.occupancy) == res.n_decode_steps
    for c in res.completions:
        req = trace[c.rid]
        assert 1 <= len(c.tokens) <= req.max_new
        assert all(0 <= t < cfg.vocab_size for t in c.tokens)
        if len(c.tokens) < req.max_new:   # early exit must be EOS
            assert c.tokens[-1] == 0


def _jax_engine_run(jcfg, params, trace, key=None, **kw):
    eng = JEngine(build(jcfg), params, JEngineConfig(**kw))
    return eng.run(trace, step_dt=0.01)


def _same_run(got, want):
    assert [(c.rid, c.tokens, c.admitted, c.finished, c.arrival,
             c.prompt_len) for c in got.completions] == \
        [(c.rid, c.tokens, c.admitted, c.finished, c.arrival, c.prompt_len)
         for c in want.completions]
    assert got.occupancy == want.occupancy
    assert got.n_decode_steps == want.n_decode_steps
    assert got.n_prefill_launches == want.n_prefill_launches
    assert got.decode_step_shapes == want.decode_step_shapes == 1
    assert got.elapsed == want.elapsed


def _pair32(seed):
    jcfg = jqwen.SMOKE.replace(**CFG32)
    params = build(jcfg).init(jax.random.PRNGKey(seed))
    pcfg = port_config(jcfg)
    model = Model(pcfg, device="cpu")
    model.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, params), pcfg))
    return jcfg, params, model


def test_greedy_engine_run_matches_reference():
    """The same fp32 model and trace through both Engines on the virtual
    clock: completions (rid, tokens, admission and finish times),
    occupancy, decode steps and prefill launches all equal, with EOS
    evictions (token 226 ends two requests early) and a padded admission
    bucket (6 prompts of one length on 8 lanes)."""
    jcfg, params, model = _pair32(21)
    trace = _trace(jcfg, seed=5, n=14, qps=200.0)
    kw = dict(slots=6, cache_len=CLEN, eos_id=226)
    want = _jax_engine_run(jcfg, params, trace, **kw)
    got = Engine(model, None, EngineConfig(**kw)).run(trace, step_dt=0.01)
    _same_run(got, want)
    assert sum(c.tokens[-1] == 226 and len(c.tokens) < trace[c.rid].max_new
               for c in got.completions) == 2


def test_sampled_engine_run_matches_reference():
    """A sampled run (temperature 0.8, top_k 20) through the ``JaxKey``
    seam: the port folds (rid, pos) into the reference's key and draws its
    Gumbel noise, so both Engines produce the same completions."""
    jcfg, params, model = _pair32(22)
    trace = _trace(jcfg, seed=9, n=10, qps=80.0)
    kw = dict(slots=4, cache_len=CLEN, eos_id=None, greedy=False,
              temperature=0.8, top_k=20, seed=4)
    want = _jax_engine_run(jcfg, params, trace, **kw)
    got = Engine(model, None, EngineConfig(**kw),
                 key=JaxKey(jax.random.PRNGKey(4))).run(trace, step_dt=0.01)
    _same_run(got, want)


def test_greedy_moe_engine_run_matches_reference():
    """granite-moe's SMOKE (8 experts, top-2, global dispatch at capacity
    1.25, so the slot table's lanes share each expert's slots) in fp32
    through both Engines on the virtual clock: the same completions."""
    jcfg = jsmoke("granite-moe-1b-a400m").replace(**CFG32)
    model = Model(port_cfg(jcfg), device="cpu", seed=23)
    params = jax.tree.map(jnp.asarray, convert.params_to_jax(
        dict(model.named_parameters())))
    trace = _trace(jcfg, seed=6, n=10, qps=200.0)
    kw = dict(slots=4, cache_len=CLEN, eos_id=None)
    want = _jax_engine_run(jcfg, params, trace, **kw)
    got = Engine(model, None, EngineConfig(**kw)).run(trace, step_dt=0.01)
    _same_run(got, want)


def test_engine_bitwise_matches_single_request_loop(served):
    """Every request decoded through the shared slot table (other lanes
    active, padded admission lanes, retired neighbours) produces the
    IDENTICAL tokens as a batch-1 loop over the same model."""
    cfg, model, params = served
    trace = _trace(cfg)
    res = _engine(model, params).run(trace, step_dt=0.01)
    for r in trace:
        P = pow2_pad(r.prompt_len)
        toks = torch.from_numpy(
            np.pad(r.prompt, (0, P - r.prompt_len)).reshape(1, P))
        logits, cache = model.prefill_cache(
            {"tokens": toks}, CLEN,
            torch.tensor([r.prompt_len], dtype=torch.int32), params=params)
        out = [int(torch.argmax(logits[:, 0], dim=-1)[0])]
        pos = r.prompt_len
        while len(out) < r.max_new and out[-1] != 0:
            lg, cache = model.decode_step(
                cache, torch.tensor([[out[-1]]], dtype=torch.int32),
                torch.tensor([[pos]], dtype=torch.int32),
                active=torch.tensor([True]), params=params)
            out.append(int(torch.argmax(lg[:, 0, :], dim=-1)[0]))
            pos += 1
        got = next(c for c in res.completions if c.rid == r.rid).tokens
        assert tuple(out) == got, f"rid {r.rid}: {out} != {got}"


def test_engine_deterministic_eviction_and_replay(served):
    cfg, model, params = served
    trace = _trace(cfg, seed=11, n=12, qps=80.0)
    r1 = _engine(model, params).run(trace, step_dt=0.01)
    r2 = _engine(model, params).run(trace, step_dt=0.01)
    order1 = sorted(r1.completions, key=lambda c: (c.finished, c.rid))
    order2 = sorted(r2.completions, key=lambda c: (c.finished, c.rid))
    assert [c.rid for c in order1] == [c.rid for c in order2]
    assert r1 == r2


def test_engine_shape_contract(served):
    """The decode step sees at most 2 distinct shapes across a whole
    mixed-length run — exactly 1, since [slots, 1] never varies — and
    serving launches no PRISM kernel."""
    cfg, model, params = served
    eng = _engine(model, params)
    counts = ops.count_launches(
        lambda: eng.run(_trace(cfg, seed=3, n=12, qps=60.0), step_dt=0.01))
    assert sum(counts.values()) == 0
    assert eng.decode_step_shapes == 1


def test_engine_continuous_beats_static(served):
    """On a mixed-length seeded trace, continuous admission strictly
    out-runs static (admit-only-when-drained) batching on the virtual
    clock, generating the same tokens."""
    cfg, model, params = served
    trace = _trace(cfg, seed=5, n=12, qps=100.0)
    cont = _engine(model, params).run(trace, step_dt=0.01)
    stat = _engine(model, params, admission="static").run(trace,
                                                          step_dt=0.01)
    assert cont.generated_tokens == stat.generated_tokens
    assert cont.tokens_per_s > stat.tokens_per_s
    assert cont.n_decode_steps < stat.n_decode_steps
    assert {c.rid: c.tokens for c in cont.completions} == \
        {c.rid: c.tokens for c in stat.completions}


def test_engine_rejects_unservable_families_and_admissions(served):
    cfg, model, params = served

    class Hybrid:
        cfg = model.cfg.replace(family="hybrid")

    with pytest.raises(NotImplementedError, match="slot-installable"):
        Engine(Hybrid(), None, EngineConfig(slots=2, cache_len=16))
    with pytest.raises(ValueError, match="admission"):
        EngineConfig(slots=2, cache_len=16, admission="magic")
    with pytest.raises(ValueError, match="slots"):
        EngineConfig(slots=0)
    long = make_trace(0, n_requests=1, qps=1.0, vocab_size=cfg.vocab_size,
                      prompt_lens=(20,), gen_lens=(2,))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        _engine(model, params, cache_len=16).run(long, step_dt=0.01)


# ----------------------------------------------------- checkpoint handoff


def test_checkpoint_to_serve_handoff(tmp_path):
    """Train 3 steps with the port's Trainer, restore only the params
    into a fresh model (bitwise the Trainer's), serve a trace to
    completion; a corrupted newest payload falls back to the newest step
    that verifies (§15)."""
    cfg = gpt2_paper.SMOKE
    model = Model(cfg, device="cpu", seed=0)
    ocfg = OptimizerConfig(name="muon", learning_rate=0.02,
                           prism=PrismConfig(degree=2, iterations=3,
                                             warm_alpha_iters=3,
                                             sketch_dim=8))
    tcfg = TrainConfig(steps=3, checkpoint_dir=str(tmp_path),
                       checkpoint_every=1, log_every=100,
                       async_checkpoint=False)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                      global_batch=4, markov_rank=8)
    Trainer(model, ocfg, tcfg, dcfg).run()

    served = Model(cfg, device="cpu", seed=1)
    step, params = restore_params(str(tmp_path),
                                  dict(served.named_parameters()))
    assert step == 3
    served.load_params(params)
    for name, p in model.named_parameters():
        assert torch.equal(p, dict(served.named_parameters())[name]), name
    eng = Engine(served, None, EngineConfig(slots=2, cache_len=32))
    trace = make_trace(1, n_requests=4, qps=100.0,
                       vocab_size=cfg.vocab_size, prompt_lens=(3, 6),
                       gen_lens=(2, 4))
    res = eng.run(trace, step_dt=0.01)
    assert len(res.completions) == 4
    assert all(0 <= t < cfg.vocab_size
               for c in res.completions for t in c.tokens)

    npz = os.path.join(str(tmp_path), "step_00000003", "tree.npz")
    raw = bytearray(open(npz, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(raw))
    step2, params2 = restore_params(str(tmp_path), served.cast_params())
    assert step2 == 2
    assert params2["layers.attn.wq"].dtype == torch.bfloat16
    lg, _ = served.prefill_cache({"tokens": torch.zeros((1, 4),
                                                        dtype=torch.int32)},
                                 8, params=params2)
    assert bool(torch.all(torch.isfinite(lg[..., :cfg.vocab_size])))
    with pytest.raises(ValueError, match="crc32"):
        restore_params(str(tmp_path), served.cast_params(), step=3)


# ----------------------------------------------------------------- launcher


def test_serve_launcher_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve`` at SMOKE width on the CPU:
    batch mode (one prefill call, greedy decode), continuous mode, and
    the production mesh, which outside a torchrun world fails as
    launch/train.py does, and with ``--continuous`` exits with the
    reference's message (tests/test_torch_serve_mesh.py serves on a
    world)."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import ENV_VARS

    res = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt_len", "8", "--gen_len", "4"])
    assert res["tokens"].shape == (2, 5)
    assert res["finite"]
    assert res["cache_bytes"] == 2 * 2 * 2 * 12 * 16 * 16 * 2 + 2 * 12 * 4
    out = serve.main(["--smoke", "--device", "cpu", "--continuous",
                      "--requests", "6", "--qps", "1000", "--slots", "4"])
    assert len(out.completions) == 6 and out.decode_step_shapes == 1
    assert "prefill_launches" in capsys.readouterr().out
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="no world in the environment"):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "production"])
    with pytest.raises(SystemExit, match="single-host"):
        serve.main(["--smoke", "--device", "cpu", "--continuous", "--mesh",
                    "production"])
