"""The port's watchdog and restart point (counterparts of
tests/test_fault.py:12-49), each state checked against the reference's
``Watchdog`` on the same heartbeat file, and the Trainer's heartbeat in
the format the watchdog reads."""
import os
import time

import numpy as np
import torch

from repro.train import fault as jfault
from repro_torch import checkpoint as ckpt
from repro_torch.config import OptimizerConfig, TrainConfig
from repro_torch.configs import gpt2_paper
from repro_torch.data import DataConfig
from repro_torch.models import Model
from repro_torch.train import Trainer
from repro_torch.train.fault import (Watchdog, WatchdogConfig,
                                     latest_restart_point)
import torch_threads  # noqa: F401  (the worker's share of the cores)


def test_watchdog_states(tmp_path):
    hb = tmp_path / "HEARTBEAT"
    wd = Watchdog(str(hb), WatchdogConfig(stale_after_s=10))
    jwd = jfault.Watchdog(str(hb), jfault.WatchdogConfig(stale_after_s=10))
    now = time.time()
    assert wd.check(now) == jwd.check(now) == "missing"
    hb.write_text(f"5 {now}")
    assert wd.check(now) == jwd.check(now) == "ok"
    assert not wd.should_restart(now)
    assert wd.read() == jwd.read() == (5, now)
    # stale heartbeat
    hb.write_text(f"6 {now - 100}")
    assert wd.check(now) == jwd.check(now) == "stale"
    assert wd.should_restart(now)
    # regression (a restarted host reports an older step than expected)
    hb.write_text(f"2 {now}")
    wd2 = Watchdog(str(hb), WatchdogConfig(stale_after_s=1000))
    jwd2 = jfault.Watchdog(str(hb), jfault.WatchdogConfig(
        stale_after_s=1000))
    wd2.last_step = jwd2.last_step = 6
    assert wd2.check(now) == jwd2.check(now) == "regressed"
    # a torn heartbeat reads as missing
    hb.write_text("7")
    assert wd2.check(now) == jwd2.check(now) == "missing"


def test_watchdog_config_not_shared(tmp_path):
    """The default WatchdogConfig is per instance: one watchdog's
    threshold tweak must not leak into another."""
    a = Watchdog(str(tmp_path / "a"))
    b = Watchdog(str(tmp_path / "b"))
    assert a.cfg is not b.cfg
    a.cfg.stale_after_s = 1.0
    assert b.cfg.stale_after_s == WatchdogConfig().stale_after_s \
        == jfault.WatchdogConfig().stale_after_s


def test_latest_restart_point(tmp_path):
    assert latest_restart_point(str(tmp_path / "nope")) is None
    ckpt.save(str(tmp_path), 7, {"x": np.ones(2, np.float32)})
    os.makedirs(tmp_path / "step_00000009.tmp")  # crashed write
    assert latest_restart_point(str(tmp_path)) == 7 == \
        jfault.latest_restart_point(str(tmp_path))


def test_trainer_heartbeat_feeds_the_watchdog(tmp_path):
    model = Model(gpt2_paper.SMOKE, device="cpu")
    tr = Trainer(model, OptimizerConfig(name="adamw"),
                 TrainConfig(steps=2, checkpoint_dir=str(tmp_path),
                             checkpoint_every=0),
                 DataConfig(vocab_size=gpt2_paper.SMOKE.vocab_size,
                            seq_len=16, global_batch=2))
    tr.run()
    wd = Watchdog(str(tmp_path / "HEARTBEAT"))
    assert wd.check() == "ok" and wd.last_step == 1
    assert torch.isfinite(next(model.parameters())).all()
