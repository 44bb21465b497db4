"""The port's §12 async refresh plane against the reference on the CPU
(counterparts of tests/test_async_precond.py, the validated install of
tests/test_guardian.py, the lowrank cases of tests/test_lowrank.py and
the restore of tests/test_fault.py).

Both packages run in lockstep on the same numpy parameters and gradients,
each through its own ``AsyncPrecondService``, with the same sketches
(``JaxKey``): the swaps fall at the same steps, ``pending_at`` and every
counter are equal, and parameters and state agree at 1e-5 (the bound of
tests/test_torch_muon.py).  A steady async step makes no kernel-wrapper
call (``test_torch_muon.count_ops``)."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.optim import base as jbase
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.config import OptimizerConfig, PrismConfig, TrainConfig
from repro_torch.configs import gpt2_paper
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.models import Model
from repro_torch.optim import base, bucketing, make_optimizer
from repro_torch.train import Trainer, fault, make_train_step
from test_torch_muon import count_ops
from test_torch_prism import JaxKey
import torch_threads  # noqa: F401  (the worker's share of the cores)

TOL = 1e-5
PRISM = dict(degree=2, iterations=4, warm_alpha_iters=1, sketch_dim=8,
             use_kernels=True)
AXES = {"w1": ("embed", "mlp"), "w3": ("layers", "embed", "mlp"),
        "b": ("embed",)}


def _tree(seed):
    """tests/test_async_precond.py::_tree as numpy."""
    key = jax.random.PRNGKey(seed)
    params = {"w1": jax.random.normal(key, (64, 32)),
              "w3": jax.random.normal(jax.random.fold_in(key, 2),
                                      (3, 48, 32)),
              "b": jax.random.normal(jax.random.fold_in(key, 4), (64,))}
    return {k: np.asarray(v) for k, v in params.items()}


def _grad_stream(seed, params, t, scale=0.1):
    """tests/test_async_precond.py::_grad_stream as numpy."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 1000 + t)
    return {n: np.array(scale * jax.random.normal(
        jax.random.fold_in(k, p.size), p.shape)) for n, p in params.items()}


def _cfgs(name, prism=PRISM, **kw):
    kw.setdefault("learning_rate", 0.05)
    kw.setdefault("precond_every", 3)
    kw.setdefault("precond_swap_delay", 1)
    kw = dict(name=name, precond_async=True, **kw)
    return (JOpt(prism=JPrism(**prism), **kw),
            OptimizerConfig(prism=PrismConfig(**prism), **kw))


class Pair:
    """The reference's optimizer and service and the port's, driven in
    lockstep; the port's parameters are named in ``order`` (the
    reference flattens them sorted)."""

    def __init__(self, name, params, axes=AXES, order=None, prism=PRISM,
                 **kw):
        jcfg, tcfg = _cfgs(name, prism, **kw)
        self.jopt = jmake_optimizer(jcfg, axes)
        self.jupdate = jax.jit(self.jopt.update, static_argnums=(5,))
        self.jp = {k: jnp.asarray(v) for k, v in params.items()}
        self.js = self.jopt.init(self.jp)
        self.jsvc = jbase.AsyncPrecondService(self.jopt, jcfg)
        self.named = [(k, torch.nn.Parameter(torch.from_numpy(
            params[k].copy()))) for k in (order or params)]
        self.topt = make_optimizer(tcfg, self.named, axes)
        self.tsvc = base.AsyncPrecondService(self.topt)

    def begin(self, t, key, drift=None):
        """Both services' phase 1, each fed its own drift (or ``drift``)."""
        jd = float(jbase.precond_drift(self.js)) if drift is None else drift
        td = float(base.precond_drift(self.topt)) if drift is None else drift
        self.js = self.jsvc.step_begin(self.js, t, key, drift=jd)
        self.tsvc.step_begin(t, JaxKey(key), drift=td)
        self.same_plane()

    def update(self, t, grads, key):
        """Both optimizers' steps with ``refresh=False``."""
        self.jp, self.js = self.jupdate(
            {k: jnp.asarray(v) for k, v in grads.items()}, self.js, self.jp,
            t, key, False)
        for k, p in self.named:
            p.grad = torch.from_numpy(grads[k].copy())
        self.topt.step(key=JaxKey(key), refresh=False)
        self.same_plane()

    def same_plane(self):
        assert int(self.topt.pending_at) == int(self.js["pending_at"])
        assert self.tsvc.counters == self.jsvc.counters
        assert self.tsvc.failures == self.jsvc.failures

    def hold(self, tol=TOL):
        """Parameters and every state entry at ``tol``, ints exactly."""
        jstate = convert._flatten(jax.tree.map(np.asarray,
                                               self.js["leaves"]))
        for k, p in self.named:
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(self.jp[k]), rtol=tol,
                                       atol=tol, err_msg=k)
            st = self.topt.state[p]
            assert set(st) == {n.split(".")[-1] for n in jstate
                               if n.rsplit(".", 1)[0] == k}, k
            for name, v in st.items():
                want = np.asarray(jstate[f"{k}.{name}"])
                if not v.is_floating_point():
                    np.testing.assert_array_equal(v.numpy(), want,
                                                  err_msg=f"{k}.{name}")
                    continue
                np.testing.assert_allclose(v.float().numpy(),
                                           want.astype(np.float32),
                                           rtol=tol, atol=tol,
                                           err_msg=f"{k}.{name}")
        assert int(self.topt.count) == int(self.js["count"])


# ------------------------------------------------- refresh period, config

def test_resolve_refresh_period():
    muon = OptimizerConfig(name="muon", precond_every=6)
    assert base.resolve_refresh_period(muon) == 6
    sham = OptimizerConfig(name="shampoo", precond_every=3,
                           precondition_every=10)
    assert base.resolve_refresh_period(sham) == 10
    assert base.resolve_refresh_period(OptimizerConfig(
        name="shampoo", precond_every=12, precondition_every=5)) == 12
    assert base.resolve_refresh_period(sham, name="muon") == 3
    assert base.resolve_refresh_period(
        OptimizerConfig(name="muon", precond_every=0)) == 1


def test_config_validation():
    with pytest.raises(ValueError, match="precond_every"):
        OptimizerConfig(name="muon", precond_async=True, precond_every=1)
    with pytest.raises(ValueError, match="matfn_tol"):
        OptimizerConfig(name="muon", precond_every=4,
                        precond_drift_slack=2.0)
    cfg = OptimizerConfig(name="muon", precond_every=4, precond_async=True,
                          matfn_tol=1e-2, precond_drift_slack=3.0)
    assert cfg.drift_threshold == pytest.approx(2e-2)
    assert OptimizerConfig(name="muon", precond_every=4, precond_async=True,
                           matfn_tol=1e-2,
                           precond_drift_slack=0.5).drift_threshold == 0.0
    assert OptimizerConfig(name="muon", precond_every=4,
                           precond_async=True).drift_threshold is None
    with pytest.raises(ValueError, match="refresh plane"):
        base.AsyncPrecondService(make_optimizer(
            OptimizerConfig(name="muon", precond_every=4),
            [("w", torch.nn.Parameter(torch.zeros(32, 16)))],
            {"w": ("embed", "mlp")}))


# ------------------------------------------------- async == the reference

@pytest.mark.parametrize("name", ["muon", "shampoo"])
def test_async_matches_reference(name):
    """Eight steps through both services (bootstrap at 0, clock refreshes
    at 3 and 6, each swapped in a step later): the swaps at the same
    steps, ``pending_at`` and the counters equal after every phase, and
    parameters and state at 1e-5 after every step."""
    params = _tree(0)
    pair = Pair(name, params, order=["w1", "w3", "b"])
    swaps = []
    for t in range(8):
        pair.begin(t, jax.random.fold_in(jax.random.PRNGKey(7), t))
        before = int(pair.topt.pending_at)
        pair.update(t, _grad_stream(0, params, t), jax.random.PRNGKey(t))
        if before != base.NO_PENDING and \
                int(pair.topt.pending_at) == base.NO_PENDING:
            swaps.append(t)
        pair.hold()
    assert swaps == [0, 4, 7], swaps
    assert pair.tsvc.counters["clock_triggered"] == 2


@pytest.mark.parametrize("name", ["muon", "shampoo"])
def test_swap_serves_pending_buffer(name):
    """Before the swap the step serves the ACTIVE buffer untouched; on the
    swap step the pending buffer becomes active and pending_at clears
    (the reference's test on the port)."""
    params = _tree(1)
    _, tcfg = _cfgs(name, precond_swap_delay=2, precond_every=8)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in params.items()]
    opt = make_optimizer(tcfg, named, AXES)
    svc = base.AsyncPrecondService(opt)
    cache_key = "ortho" if name == "muon" else "Linv"

    def caches(suffix=""):
        return [opt.state[p][cache_key + suffix].clone() for _, p in named
                if cache_key in opt.state[p]]

    def step(t):
        for k, p in named:
            p.grad = torch.from_numpy(_grad_stream(1, params, t)[k])
        opt.step(key=JaxKey(jax.random.PRNGKey(t)), refresh=False)

    key = JaxKey(jax.random.PRNGKey(1))
    svc.step_begin(0, key)
    assert opt.pending_at == -tcfg.precond_swap_delay  # back-dated
    step(0)
    assert opt.pending_at == base.NO_PENDING
    step(1)
    step(2)
    active = caches()
    base.install_pending(opt, opt.refresh(key.fold_in(1)), at_step=3)
    assert opt.pending_at == 3
    pending = caches("_p")
    for t in (3, 4):  # count < 3 + 2: no swap
        step(t)
        assert opt.pending_at == 3
        assert all(torch.equal(a, b) for a, b in zip(caches(), active))
    step(5)
    assert opt.pending_at == base.NO_PENDING
    assert all(torch.equal(a, b) for a, b in zip(caches(), pending))


def _smoke_run(**okw):
    """A 2-layer, 64-wide gpt2-paper SMOKE model, its async Muon and train
    step (tests/test_async_precond.py::test_steady_state_...)."""
    cfg = gpt2_paper.SMOKE.replace(num_layers=2, d_model=64, num_heads=4,
                                   num_kv_heads=4, d_ff=128)
    model = Model(cfg, device="cpu", seed=0)
    ocfg = OptimizerConfig(
        name="muon", precond_every=4, precond_async=True,
        prism=PrismConfig(degree=2, iterations=2, warm_alpha_iters=1,
                          sketch_dim=8, use_kernels=True), **okw)
    opt = make_optimizer(ocfg, model.named_parameters(),
                         model.logical_axes())
    batch = make_batch_fn(cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
        markov_rank=8), "cpu")(0)
    return model, opt, make_train_step(model, opt, ocfg), batch


@pytest.mark.parametrize("lowrank", [False, True])
def test_steady_state_makes_no_kernel_call(lowrank):
    """The §12 contract: an async train step calls no kernel wrapper, nor
    does one that swaps the pending twins in; the refresh carries every
    matrix-function call.  With the §14 tier on, the vocab tables route
    lowrank (the counterpart of tests/test_lowrank.py:260)."""
    kw = dict(lowrank_rank=8, lowrank_oversample=4,
              lowrank_max_dim=128) if lowrank else {}
    model, opt, step, batch = _smoke_run(**kw)
    if lowrank:
        embed = dict(model.named_parameters())["embed"]
        assert int(opt.state[embed]["tier"]) == \
            bucketing.TIER_CODES["lowrank"]
    with count_ops() as calls:
        step(batch, 0, False)
    assert sum(calls.values()) == 0, calls
    with count_ops() as calls:
        parts = opt.refresh(JaxKey(jax.random.PRNGKey(2)))
    assert sum(calls.values()) > 0, calls
    base.install_pending(opt, parts, at_step=0)  # due now: count 1
    with count_ops() as calls:
        metrics = step(batch, 1, False)
    assert sum(calls.values()) == 0, calls
    assert opt.pending_at == base.NO_PENDING  # it swapped
    assert np.isfinite(float(metrics["precond_drift"]))


# ------------------------------------------------------------ drift trigger

def test_drift_trigger_matches_reference():
    """tests/test_async_precond.py's drift trigger in both packages: a
    stationary stream settles the drift proxy under the threshold (no
    refresh, the far-out clock never fires), then gradients 30x larger
    in fresh directions drive it over and the trigger dispatches.  Every
    decision is the reference's: equal counters after every step."""
    params = _tree(3)
    key = jax.random.PRNGKey(3)
    pair = Pair("muon", params, precond_every=1000, matfn_tol=1e-2,
                precond_drift_slack=1.5, momentum=0.5)
    assert pair.tsvc.threshold == pytest.approx(5e-3)
    for t in range(30):
        shift = t >= 24
        if t == 12:  # the warmup's refreshes are done
            settled = dict(pair.tsvc.counters)
        pair.begin(t, jax.random.fold_in(key, t))
        pair.update(t, _grad_stream(3, params, t if shift else 0,
                                    scale=3.0 if shift else 0.1),
                    jax.random.PRNGKey(42))
        if t == 23:
            assert pair.tsvc.counters["refreshes"] == settled["refreshes"]
    assert pair.tsvc.counters["drift_triggered"] > \
        settled["drift_triggered"]
    assert pair.tsvc.counters["clock_triggered"] == 0
    assert pair.tsvc.matfn_telemetry["last_drift"] == pytest.approx(
        pair.jsvc.matfn_telemetry["last_drift"], rel=1e-4)
    pair.hold()


# ------------------------------------------------- validated install (§15)

def _poisonable(pair):
    """Wrap both services' refresh so that it can write NaN into every
    float entry of the pending twins."""
    poison = {"on": False}
    jreal, treal = pair.jsvc._refresh, pair.tsvc._refresh

    def jrefresh(state, k):
        out = jreal(state, k)
        if not poison["on"]:
            return out
        return jax.tree.map(lambda x: x * jnp.nan if jnp.issubdtype(
            x.dtype, jnp.floating) else x, out)

    def trefresh(k):
        out = treal(k)
        if poison["on"]:
            out = [{n: v * float("nan") if v.is_floating_point() else v
                    for n, v in part.items()} for part in out]
        return out

    pair.jsvc._refresh, pair.tsvc._refresh = jrefresh, trefresh
    return poison


def _guardian_pair():
    """tests/test_guardian.py::_poisonable_service in both packages."""
    w = {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                           (32, 16)))}
    prism = dict(degree=2, iterations=3, warm_alpha_iters=1, sketch_dim=8,
                 tol=1e-2)
    pair = Pair("muon", w, axes={"w": ("embed", "mlp")}, prism=prism,
                matfn_tol=1e-2, precond_every=8, precond_max_retries=2,
                precond_drift_slack=2.0, learning_rate=0.02)
    return pair, _poisonable(pair)


def _active_finite(opt):
    return all(bool(torch.isfinite(v.float()).all())
               for st in opt.state.values() for k, v in st.items()
               if k not in base.PENDING_STATE_KEYS)


def test_poisoned_buffer_never_installs():
    """A non-finite refresh is discarded before its swap: pending_at
    clears, the active plane stays finite (the drift trackers the install
    overwrote are rolled back), a backoff retry is scheduled."""
    pair, poison = _guardian_pair()
    poison["on"] = True
    pair.begin(0, jax.random.PRNGKey(0), drift=0.0)
    svc = pair.tsvc
    assert svc.counters["discarded"] == 1 and svc.failures == 1
    assert pair.topt.pending_at == base.NO_PENDING
    assert svc._retry_at == 1
    assert _active_finite(pair.topt)


def test_retry_backoff_then_degrade_matches_reference():
    """Consecutive failures: discard, a backoff retry, and after
    ``precond_max_retries`` the slot degrades and keeps serving its
    active buffer; the next clean trigger installs.  Every counter equals
    the reference's after every step."""
    pair, poison = _guardian_pair()
    key = jax.random.PRNGKey(0)
    grads = {"w": np.ones((32, 16), np.float32)}
    pair.begin(0, key, drift=0.0)
    pair.update(0, grads, key)
    poison["on"] = True
    for t in range(1, 16):
        pair.begin(t, jax.random.fold_in(key, t), drift=1e9)
        pair.update(t, grads, jax.random.fold_in(key, t))
        if pair.tsvc.counters["degraded"]:
            break
    assert pair.tsvc.counters["discarded"] == 2
    assert pair.tsvc.counters["retries"] >= 1
    assert pair.tsvc.counters["degraded"] == 1
    assert pair.topt.pending_at == base.NO_PENDING
    assert _active_finite(pair.topt)
    poison["on"] = False
    for t in range(t + 1, t + 5):
        pair.begin(t, jax.random.fold_in(key, t), drift=1e9)
        if pair.topt.pending_at != base.NO_PENDING:
            break
    assert pair.topt.pending_at != base.NO_PENDING
    assert pair.tsvc.counters["discarded"] == 2
    pair.hold()


# ------------------------------------------------------ skip-step guard

def test_skip_nonfinite_async_nan_on_the_swap_step():
    """skip_nonfinite with the refresh plane: a NaN gradient on the step a
    clock refresh swaps in rolls the swap back with the rest (pending_at,
    a device int32, keeps its value); the next step swaps.  Both packages
    agree after every step."""
    params = _tree(0)
    pair = Pair("muon", params, skip_nonfinite=True)
    assert isinstance(pair.topt.pending_at, torch.Tensor)
    pending = []
    for t in range(7):
        pair.begin(t, jax.random.fold_in(jax.random.PRNGKey(7), t))
        g = _grad_stream(0, params, t)
        if t == 4:  # the swap step of the refresh dispatched at 3
            g["w1"][3, 5] = np.nan
        pair.update(t, g, jax.random.PRNGKey(t))
        pending.append(int(pair.topt.pending_at))
        pair.hold()
    assert pending[3:6] == [3, 3, base.NO_PENDING], pending
    assert int(pair.topt.bad_steps) == int(pair.js["bad_steps"]) == 1


# ------------------------------------------------------------ the converter

@pytest.mark.parametrize("name", ["muon", "shampoo"])
def test_async_state_carries_across(name):
    """``convert.muon_state_from_jax`` / ``shampoo_state_from_jax`` carry
    the reference's async state across mid-interval (a refresh dispatched
    at 3, not yet swapped): the twins, the drift proxy and ``pending_at``;
    the next step swaps the carried twins in, as the reference's does."""
    params = _tree(0)
    pair = Pair(name, params, order=["w1", "w3", "b"])
    for t in range(4):
        pair.begin(t, jax.random.fold_in(jax.random.PRNGKey(7), t))
        pair.update(t, _grad_stream(0, params, t), jax.random.PRNGKey(t))
    assert int(pair.js["pending_at"]) == 3
    named = [(k, torch.nn.Parameter(torch.from_numpy(np.array(pair.jp[k]))))
             for k in ("w1", "w3", "b")]
    opt = make_optimizer(_cfgs(name)[1], named, AXES)
    carry = (convert.muon_state_from_jax if name == "muon"
             else convert.shampoo_state_from_jax)
    carry(opt, named, jax.tree.map(np.asarray, pair.js))
    assert opt.pending_at == opt.pending_host == 3
    pair.named, pair.topt = named, opt
    pair.hold()
    pair.update(4, _grad_stream(0, params, 4), jax.random.PRNGKey(4))
    assert opt.pending_at == base.NO_PENDING
    pair.hold()


# ------------------------------------------------------------ per-view keys

def test_per_view_refresh_keys_match_reference():
    """bucketed=False: the refresh's view i draws from key.fold_in(i), i
    its position among the refreshed views in the reference's slot order
    (here a bias sorts first, so a matrix leaf's leaf index is one more
    than its position, and the port names its leaves in another order);
    the fitted polars agree with the reference's at 1e-5."""
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal(16).astype(np.float32),
              "w1": rng.standard_normal((64, 32)).astype(np.float32),
              "w2": rng.standard_normal((48, 32)).astype(np.float32)}
    axes = {"a": ("mlp",), "w1": ("embed", "mlp"), "w2": ("embed", "mlp")}
    pair = Pair("muon", params, axes=axes, order=["w2", "a", "w1"],
                bucketed=False)
    moms = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in params.items()}
    js = pair.js
    js["leaves"] = {k: dict(v, mom=jnp.asarray(moms[k]))
                    for k, v in js["leaves"].items()}
    for k, p in pair.named:
        pair.topt.state[p]["mom"] = torch.from_numpy(moms[k])
    key = jax.random.PRNGKey(11)
    want = dict(zip(sorted(params), jax.jit(pair.jopt.refresh)(js, key)))
    got = dict(zip([k for k, _ in pair.named],
                   pair.topt.refresh(JaxKey(key))))
    for k in ("w1", "w2"):
        for name in ("ortho_p", "rnorm", "dnorm"):
            np.testing.assert_allclose(got[k][name].numpy(),
                                       np.asarray(want[k][name]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{k}.{name}")
    assert got["a"] == {} and want["a"] == {}


# ------------------------------------------------------------ lowrank tier

def test_lowrank_async_refresh_matches_reference():
    """The counterpart of tests/test_lowrank.py:239: with the §14 tier a
    vocab table (SMOKE's [256, 64] embedding) carries the LIFTED
    full-view caches (bf16, pending twin included), and the refresh fills
    the twins through the lowrank chains: from the same stored momentum,
    the port's pending polars agree with the reference's at two bf16
    half-ulps (the cache's rounding), their telemetry exactly and
    ``rnorm`` at 1e-5."""
    rng = np.random.default_rng(6)
    params = {"embed": rng.standard_normal((256, 64)).astype(np.float32),
              "w": rng.standard_normal((64, 128)).astype(np.float32)}
    axes = {"embed": ("vocab", "embed"), "w": ("embed", "mlp")}
    pair = Pair("muon", params, axes=axes, order=["w", "embed"],
                prism=dict(degree=2, iterations=3, warm_alpha_iters=1,
                           sketch_dim=8, use_kernels=True),
                learning_rate=0.02, precond_every=4,
                precond_cache_dtype="bfloat16", lowrank_rank=16,
                lowrank_oversample=8, matfn_tol=1e-4)
    emb = pair.topt.state[dict(pair.named)["embed"]]
    assert emb["ortho"].shape == emb["ortho_p"].shape == (64, 256)
    assert emb["ortho"].dtype == torch.bfloat16
    assert int(emb["tier"]) == bucketing.TIER_CODES["lowrank"]
    moms = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in params.items()}
    pair.js["leaves"] = {k: dict(v, mom=jnp.asarray(moms[k]))
                         for k, v in pair.js["leaves"].items()}
    for k, p in pair.named:
        pair.topt.state[p]["mom"] = torch.from_numpy(moms[k])
    key = jax.random.PRNGKey(1)
    want = dict(zip(sorted(params),
                    jax.jit(pair.jopt.refresh)(pair.js, key)))
    got = dict(zip([k for k, _ in pair.named],
                   pair.topt.refresh(JaxKey(key))))
    for k, part in got.items():
        assert set(part) == set(want[k]), k
        for name, v in part.items():
            w = np.asarray(want[k][name])
            if name == "ortho_p":
                assert v.dtype == torch.bfloat16
                np.testing.assert_allclose(v.float().numpy(),
                                           w.astype(np.float32),
                                           rtol=2 * 2.0 ** -7,
                                           atol=2 * 2.0 ** -7, err_msg=k)
            elif v.is_floating_point():
                np.testing.assert_allclose(v.numpy(), w, rtol=TOL, atol=TOL,
                                           err_msg=f"{k}.{name}")
            else:
                np.testing.assert_array_equal(v.numpy(), w,
                                              err_msg=f"{k}.{name}")
    assert torch.isfinite(got["embed"]["ortho_p"].float()).all()


# ------------------------------------------------------- restore, Trainer

def test_restore_discards_inflight_pending(tmp_path):
    """The counterpart of tests/test_fault.py:97: a checkpoint written
    mid-interval (a refresh dispatched at 2, its swap due at 4) leaves out
    the pending payloads and keeps ``pending_at``; the restore keeps the
    target's zeros for the twins and ``fault.discard_inflight`` clears
    ``pending_at``, so the resumed step 4 never swaps them in."""
    _, tcfg = _cfgs("muon", precond_every=4, precond_swap_delay=2,
                    prism=dict(degree=2, iterations=3, warm_alpha_iters=1,
                               sketch_dim=8))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (48, 32)))
    axes = {"w": ("embed", "mlp")}

    def fresh():
        p = torch.nn.Parameter(torch.from_numpy(np.array(w)))
        return p, make_optimizer(tcfg, [("w", p)], axes)

    def tree(p, opt):
        return {"opt": {"w": dict(opt.state[p]), "count": np.int32(
            opt.count), "pending_at": np.int32(opt.pending_at)}}

    p, opt = fresh()
    key = JaxKey(jax.random.PRNGKey(0))
    for t in range(3):
        if t == 2:
            base.install_pending(opt, opt.refresh(key), at_step=2)
        p.grad = torch.full(p.shape, 0.1)
        opt.step(key=key.fold_in(t), refresh=False)
    assert opt.pending_at == 2
    ckpt.save(str(tmp_path), 3, tree(p, opt), drop=base.PENDING_STATE_KEYS)
    files = np.load(tmp_path / "step_00000003" / "tree.npz").files
    assert not any(base.PENDING_STATE_KEYS.intersection(k.split("|"))
                   for k in files)
    assert "opt|pending_at" in files
    p2, opt2 = fresh()
    _, restored = ckpt.restore(str(tmp_path), tree(p2, opt2),
                               allow_missing=base.PENDING_STATE_KEYS)
    assert int(restored["opt"]["pending_at"]) == 2
    opt2.state[p2].update(restored["opt"]["w"])
    opt2.count = int(restored["opt"]["count"])
    base.set_pending_at(opt2, int(restored["opt"]["pending_at"]))
    fault.discard_inflight(opt2)
    assert opt2.pending_at == base.NO_PENDING
    st, st2 = opt.state[p], opt2.state[p2]
    assert torch.equal(st2["ortho_p"], torch.zeros_like(st["ortho_p"]))
    for k in ("mom", "ortho", "dnorm", "rnorm"):
        assert torch.equal(st2[k], st[k]), k
    p2.grad = torch.full(p2.shape, 0.1)
    opt2.step(key=key.fold_in(4), refresh=False)
    assert opt2.pending_at == base.NO_PENDING
    assert torch.equal(st2["ortho"], st["ortho"])


def _async_trainer(ckpt_dir, steps, every, seed=0):
    """tests/test_async_precond.py::test_trainer_async_run's Trainer."""
    model = Model(gpt2_paper.SMOKE, device="cpu", seed=seed)
    ocfg = OptimizerConfig(
        name="muon", learning_rate=0.02, precond_every=3,
        precond_async=True, precond_swap_delay=1,
        prism=PrismConfig(degree=2, iterations=3, warm_alpha_iters=3,
                          sketch_dim=8, use_kernels=True))
    tcfg = TrainConfig(steps=steps, checkpoint_dir=str(ckpt_dir),
                       checkpoint_every=every, log_every=100,
                       async_checkpoint=False)
    dcfg = DataConfig(vocab_size=gpt2_paper.SMOKE.vocab_size, seq_len=32,
                      global_batch=4, markov_rank=8)
    return Trainer(model, ocfg, tcfg, dcfg)


def test_trainer_async_run(tmp_path, monkeypatch):
    """End-to-end async training through the Trainer: the losses finite and
    falling, the service on its schedule (bootstrap at 0, the clock at 3
    and 6: a step after each dispatch the twins swap in), the drift in
    the metrics, and no step calls a kernel wrapper of its own; the
    checkpoints leave the pending twins out and keep ``pending_at`` (3 at
    step 4, mid-interval).  A fresh Trainer resumed there marks the plane
    stale and bootstraps at its first step."""
    tr = _async_trainer(tmp_path, 8, 4)
    seen, per_step = {}, []
    real = base.AsyncPrecondService.step_begin

    def step_begin(self, t, key, drift=0.0):
        with count_ops() as c:
            real(self, t, key, drift)
        per_step.append(sum(c.values()))
    monkeypatch.setattr(base.AsyncPrecondService, "step_begin", step_begin)
    with count_ops() as calls:
        _, opt_state, losses = tr.run(on_metrics=lambda t, m: seen.update(
            {t: (float(m["precond_drift"]), sum(calls.values()))}))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert [t for t, n in enumerate(per_step) if n] == [0, 3, 6]
    steps_calls = [seen[t][1] - sum(per_step[:t + 1]) for t in range(8)]
    assert steps_calls == [0] * 8, steps_calls
    assert all(np.isfinite(d) and d >= 0 for d, _ in seen.values())
    tele = tr.matfn_telemetry
    assert (tele["bootstrap"], tele["clock_triggered"],
            tele["refreshes"]) == (1, 2, 3), tele
    assert int(opt_state["pending_at"]) == base.NO_PENDING  # 6 swapped at 7
    for step, at in ((4, 3), (8, base.NO_PENDING)):
        data = np.load(tmp_path / f"step_{step:08d}" / "tree.npz")
        assert not any(base.PENDING_STATE_KEYS.intersection(k.split("|"))
                       for k in data.files)
        assert int(data["opt|pending_at"]) == at
    shutil.rmtree(tmp_path / "step_00000008")  # resume at 4, mid-refresh
    tr2 = _async_trainer(tmp_path, 6, 0, seed=1)
    _, _, losses2 = tr2.run()
    assert len(losses2) == 2 and all(np.isfinite(losses2))
    assert tr2.matfn_telemetry["bootstrap"] == 1
    assert tr2.precond.last_dispatch == 4
