"""The port's Trainer on the CPU: a run interrupted at a checkpoint and
resumed ends bitwise equal to an uninterrupted one (PRISM-3 with
``precond_every=2``, so that the restored ``count`` and the sketch key of
the resumed step both show), the first resumed step after an odd
checkpoint makes no matrix-function call, the loss falls and HEARTBEAT
and checkpoints appear, four steps against the reference's Trainer, and
the launcher with the options this slice ports (the second run of the
``--ckpt_dir`` case resumes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.config import TrainConfig as JTrain
from repro.configs import gpt2_paper as jgpt2
from repro.data import DataConfig as JData
from repro.models import build
from repro.train import Trainer as JTrainer
from repro_torch import convert
from repro_torch.config import OptimizerConfig, PrismConfig, TrainConfig
from repro_torch.configs import gpt2_paper
from repro_torch.core.rng import Key
from repro_torch.data import DataConfig
from repro_torch.launch import train_lm
from repro_torch.models import Model
from repro_torch.train import Trainer
from test_torch_muon import count_ops
import torch_threads  # noqa: F401  (the worker's share of the cores)

PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)
PRISM3 = dict(degree=1, iterations=5, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)


def _trainer(ckpt_dir, steps, every, prism=PRISM3, precond_every=2,
             seed=0, **tkw):
    model = Model(gpt2_paper.SMOKE, device="cpu", seed=seed)
    ocfg = OptimizerConfig(name="muon", learning_rate=0.02,
                           precond_every=precond_every,
                           prism=PrismConfig(**prism))
    tcfg = TrainConfig(steps=steps, checkpoint_dir=str(ckpt_dir),
                       checkpoint_every=every, log_every=100,
                       async_checkpoint=False, **tkw)
    dcfg = DataConfig(vocab_size=gpt2_paper.SMOKE.vocab_size, seq_len=32,
                      global_batch=4, markov_rank=8)
    return Trainer(model, ocfg, tcfg, dcfg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}|"))
        else:
            out[f"{prefix}{k}"] = torch.as_tensor(np.asarray(v)) \
                if not isinstance(v, torch.Tensor) else v
    return out


def test_resume_is_exact(tmp_path):
    """Run 1: steps 0..5 with a checkpoint at 4.  Run 2: the same
    configuration stopped after step 3 (checkpoint at 4), then a fresh
    Trainer with another model seed resumes it to 6: the final parameters
    and optimizer state are bitwise run 1's.  Step 4 refreshes the
    PRISM-3 polars with the key of global step 4, and the AdamW leaves
    read the restored count."""
    p1, o1, l1 = _trainer(tmp_path / "a", 6, 4).run()
    _trainer(tmp_path / "b", 4, 4).run()
    tr3 = _trainer(tmp_path / "b", 6, 4, seed=1)
    counts = []
    p3, o3, l3 = tr3.run(
        on_metrics=lambda t, m: counts.append((t, tr3.opt.count)))
    assert counts == [(4, 5), (5, 6)]  # the count came back as 4
    assert l3 == l1[4:]
    a, b = _flat({"params": p1, "opt": o1}), _flat({"params": p3, "opt": o3})
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(o3["count"]) == 6


def test_resumed_run_draws_the_global_steps_sketch(tmp_path, monkeypatch):
    """The sketch key of global step t is Key(0).fold_in(t) whatever step
    the run started at: a resumed PRISM-3 step 4 with step 0's key would
    fit other alphas (and update otherwise)."""
    _trainer(tmp_path, 4, 4).run()
    seen = []
    real = Key.fold_in

    def fold_in(self, data):
        seen.append(int(data))
        return real(self, data)

    monkeypatch.setattr(Key, "fold_in", fold_in)
    _trainer(tmp_path, 5, 4).run()
    assert seen[0] == 4


def test_first_resumed_step_after_an_odd_checkpoint_skips(tmp_path):
    """precond_every=2 with a checkpoint at step 3: the resumed run's first
    step (3) serves the cached polars and calls no kernel wrapper; step 4
    refreshes.  A count or schedule reset to 0 would refresh at step 3."""
    _trainer(tmp_path, 3, 3).run()
    per_step = []
    with count_ops() as calls:
        last = [0]

        def on_metrics(t, m):
            total = sum(calls.values())
            per_step.append((t, total - last[0]))
            last[0] = total

        _trainer(tmp_path, 5, 3).run(on_metrics=on_metrics)
    assert per_step[0] == (3, 0)
    assert per_step[1][0] == 4 and per_step[1][1] > 0


def test_train_reduces_loss_and_checkpoints(tmp_path):
    tr = _trainer(tmp_path, 8, 4, prism=PRISM5, precond_every=1,
                  keep_checkpoints=1)
    _, _, losses = tr.run()
    assert all(np.isfinite(losses)) and len(losses) == 8
    assert losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "HEARTBEAT", "step_00000008"]
    step, when = (tmp_path / "HEARTBEAT").read_text().split()
    assert step == "7" and float(when) > 0
    assert len(tr.step_times) == 7


def test_init_state_draws_the_seeds_parameters(tmp_path):
    """run(seed=s)/init_state(s) draws the masters as Model(seed=s) does
    and starts a fresh optimizer; seed None keeps the model's own."""
    tr = _trainer(tmp_path, 1, 0, seed=1)
    own = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    assert tr.init_state() == 0
    assert all(torch.equal(p, own[k])
               for k, p in tr.model.named_parameters())
    tr.run()
    assert tr.opt.count == 1
    assert tr.init_state(seed=0) == 0 and tr.opt.count == 0
    want = dict(Model(gpt2_paper.SMOKE, device="cpu", seed=0)
                .named_parameters())
    for k, p in tr.model.named_parameters():
        assert torch.equal(p, want[k]), k


def test_unported_trainer_options_raise(tmp_path):
    """A model mesh takes the dense, moe and hybrid families (their
    replicated Trainers need no process group on one data rank; the
    hybrid's raised item 11h before); pipeline stages raise item 11c."""
    model = Model(gpt2_paper.SMOKE, device="cpu")
    dcfg = DataConfig(vocab_size=gpt2_paper.SMOKE.vocab_size)
    ocfg = OptimizerConfig(name="muon")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(data=1, model=2)
    assert Trainer(model, ocfg, TrainConfig(), dcfg, mesh=mesh).mesh is mesh
    moe = Model(get_smoke_config("granite-moe-1b-a400m"), device="cpu")
    assert Trainer(moe, ocfg, TrainConfig(), dcfg, mesh=mesh).mesh is mesh
    hybrid = Model(get_smoke_config("recurrentgemma-2b"), device="cpu")
    assert Trainer(hybrid, ocfg, TrainConfig(), dcfg, mesh=mesh).mesh is mesh
    with pytest.raises(NotImplementedError, match="item 11c"):
        Trainer(model, ocfg, TrainConfig(pipeline_stages=2), dcfg)
    tr = Trainer(model, OptimizerConfig(name="muon", precond_async=True,
                                        precond_every=2),
                 TrainConfig(), dcfg)
    assert tr.precond is not None and tr.matfn_telemetry["refreshes"] == 0


def test_trainer_matches_reference(tmp_path):
    """Four steps of Muon PRISM-5 with precond_every=2 through both
    Trainers, the reference's initial weights carried across by convert
    and its batches passed in (the two synthetic streams share a
    distribution, not bits): the losses agree at 1e-4, the bound of
    tests/test_torch_train.py."""
    cfg32 = dict(dtype="float32", emb_dtype="float32")
    jcfg = jgpt2.SMOKE.replace(**cfg32)
    kw = dict(name="muon", learning_rate=0.02, precond_every=2)
    jtr = JTrainer(build(jcfg), JOpt(prism=JPrism(**PRISM5), **kw),
                   JTrain(steps=4, checkpoint_dir=str(tmp_path / "j"),
                          checkpoint_every=0, log_every=100),
                   JData(vocab_size=jcfg.vocab_size, seq_len=32,
                         global_batch=4, markov_rank=8))
    _, _, jlosses = jtr.run()

    tcfg = gpt2_paper.SMOKE.replace(**cfg32)
    model = Model(tcfg, device="cpu")
    model.load_params(convert.params_from_jax(jax.tree.map(
        np.asarray, jtr.model.init(jax.random.PRNGKey(0))), tcfg))

    def batch_fn(t):
        tok = np.asarray(jtr.batch_fn(jnp.asarray(t))["tokens"])
        return {"tokens": torch.from_numpy(tok.astype(np.int64))}

    tr = Trainer(model, OptimizerConfig(prism=PrismConfig(**PRISM5), **kw),
                 TrainConfig(steps=4, checkpoint_dir=str(tmp_path / "t"),
                             checkpoint_every=0, log_every=100),
                 DataConfig(vocab_size=tcfg.vocab_size), batch_fn=batch_fn)
    _, _, losses = tr.run()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("args", [["--method", "polar_express"],
                                  ["--optimizer", "adamw"],
                                  ["--precond_every", "2",
                                   "--precond_async"]])
def test_launcher_runs_the_baselines(args, capsys):
    losses = train_lm.main(["--preset", "cpu-small", "--steps", "1",
                            "--device", "cpu"] + args)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert abs(losses[0] - np.log(4096)) < 1.5
    assert "step 0: loss" in capsys.readouterr().out


def test_launcher_resumes(tmp_path, capsys):
    """Killed after step 1 (its checkpoint at 2) and run again: the second
    run resumes at step 2 and reproduces the first run's loss there."""
    argv = ["--preset", "cpu-small", "--device", "cpu", "--precond_every",
            "2", "--ckpt_dir", str(tmp_path), "--ckpt_every", "2"]
    first = train_lm.main(argv + ["--steps", "3"])
    assert (tmp_path / "step_00000002").is_dir()
    second = train_lm.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert second == first[2:]
