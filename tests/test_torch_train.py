"""Three training steps of the port against the reference on the CPU,
and the device rule of the entry points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.configs import gpt2_paper as jgpt2
from repro.models import build
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.state import make_train_step as jmake_train_step
from repro.train.state import master_params
from repro_torch import convert
from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.configs import gpt2_paper
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.launch import train_lm
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.train import make_train_step

PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)
CFG32 = dict(dtype="float32", emb_dtype="float32")


def test_three_steps_match_reference():
    jcfg = jgpt2.SMOKE.replace(**CFG32)
    tcfg = gpt2_paper.SMOKE.replace(**CFG32)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
               for _ in range(3)]

    jmodel = build(jcfg)
    jocfg = JOpt(name="muon", prism=JPrism(**PRISM5))
    jopt = jmake_optimizer(jocfg, jmodel.logical_axes())
    init = jmodel.init(jax.random.PRNGKey(0))
    jp = master_params(init)
    js = jopt.init(jp)
    jstep = jax.jit(jmake_train_step(jmodel, jopt, jocfg))
    jlosses = []
    for s, b in enumerate(batches):
        jp, js, m = jstep(jp, js, {"tokens": jnp.asarray(b)}, s)
        jlosses.append(float(m["loss"]))

    model = Model(tcfg, device="cpu")
    model.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, init), tcfg))
    ocfg = OptimizerConfig(name="muon", prism=PrismConfig(**PRISM5))
    opt = make_optimizer(ocfg, model.named_parameters(),
                         model.logical_axes())
    step = make_train_step(model, opt, ocfg)
    losses = [float(step({"tokens": torch.from_numpy(b)})["loss"])
              for b in batches]

    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_entry_points_need_a_device_when_no_gpu(monkeypatch):
    """Naming no device on a machine without CUDA raises, never falls
    back to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(gpt2_paper.SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch_fn(gpt2_paper.SMOKE, DataConfig(vocab_size=256))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--preset", "cpu-small", "--steps", "1"])


def test_synthetic_stream_is_deterministic_and_learnable():
    dcfg = DataConfig(vocab_size=256, seq_len=16, global_batch=3,
                      markov_rank=8)
    fn = make_batch_fn(gpt2_paper.SMOKE, dcfg, device="cpu")
    a, b, c = fn(0)["tokens"], fn(0)["tokens"], fn(1)["tokens"]
    assert a.shape == (3, 16) and a.dtype == torch.int64
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 256


def test_launcher_runs_on_the_cpu(capsys):
    losses = train_lm.main(["--preset", "cpu-small", "--steps", "1",
                            "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    # ln(4096) = 8.3; a random init starts near it
    assert abs(losses[0] - np.log(4096)) < 1.5
    assert "step 0: loss" in capsys.readouterr().out
