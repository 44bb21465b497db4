"""End-to-end training driver: the paper's Sec. 6.2 experiments on the
port (counterpart of ``examples/train_lm.py`` and ``repro/launch/train.py
--optimizer shampoo``).

Trains the paper's GPT-2 config (10 layers, 16 heads, d=1024) on the
synthetic bigram stream for a few steps, and prints the losses, with
``--optimizer muon`` (PRISM polar factors, the default) or ``shampoo``
(PRISM inverse square roots).  The matrix-function GEMMs always run
through the hand-written kernels (``use_kernels=True``).  ``--prism``
picks a PRISM configuration from ``PRISM``:

  * ``prism5``: degree 2, three warm iterations — Muon's PRISM-5
    (``benchmarks/fig6_muon_lm.py``) and Shampoo's default
    (``OptimizerConfig(name="shampoo")``, ``repro/launch/train.py``);
  * ``prism3``: degree 1, three warm then two fitted iterations with a
    sketch of 8 rows (Muon's PRISM-3);
  * ``fig5``: degree 2, five fitted iterations, sketch 8, learning rate
    3e-3 (Shampoo's fitted configuration, ``benchmarks/fig5_shampoo.py``).

``--precondition_every`` sets Shampoo's refresh period (Fig. 5 uses 5).

    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset full \\
        --steps 5 --prism prism3
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset full \\
        --steps 5 --optimizer shampoo --prism fig5
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset cpu-small \\
        --steps 3 --device cpu [--optimizer shampoo]

Checkpointing, heartbeats and straggler detection (the reference's
``Trainer``) are ported with a later slice (ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.configs import gpt2_paper
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.train import make_train_step


PRISM = {
    "prism5": dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8),
    "prism3": dict(degree=1, iterations=5, warm_alpha_iters=3, sketch_dim=8),
    "fig5": dict(degree=2, iterations=5, warm_alpha_iters=0, sketch_dim=8),
}
# learning rates: 6e-3 as in examples/train_lm.py and repro/launch/train.py;
# 3e-3 for the fitted Shampoo of benchmarks/fig5_shampoo.py
LEARNING_RATE = {"fig5": 3e-3}


def build(preset: str, method: str, matfn_dtype: str, device=None,
          seed: int = 0, prism: str = "prism5", optimizer: str = "muon",
          precondition_every: int = 1):
    """(model, optimizer, train_step, batch_for_step, (seq, batch)) of the
    ``optimizer`` experiment at ``preset`` on ``device`` (CUDA unless
    named), with the PRISM configuration ``prism`` (a key of ``PRISM``)
    and, for Shampoo, the refresh period ``precondition_every``."""
    dev = resolve_device(device)
    cfg = gpt2_paper.CONFIG
    if preset == "cpu-small":
        cfg = cfg.replace(num_layers=4, d_model=256, num_heads=8,
                          num_kv_heads=8, head_dim=32, d_ff=1024,
                          vocab_size=4096)
        seq, batch = 128, 8
    else:
        seq, batch = 512, 4
    model = Model(cfg, device=dev, seed=seed)
    ocfg = OptimizerConfig(
        name=optimizer, learning_rate=LEARNING_RATE.get(prism, 6e-3),
        momentum=0.95, weight_decay=0.01, matfn_method=method,
        matfn_dtype=matfn_dtype, precondition_every=precondition_every,
        max_precond_dim=2048,
        prism=PrismConfig(use_kernels=True, **PRISM[prism]))
    opt = make_optimizer(ocfg, model.named_parameters(),
                         model.logical_axes())
    step = make_train_step(model, opt, ocfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, markov_rank=64, seed=1234 + seed)
    return model, opt, step, make_batch_fn(cfg, dcfg, dev), (seq, batch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--preset", default="full",
                    choices=["full", "cpu-small"])
    ap.add_argument("--optimizer", default="muon",
                    choices=["muon", "shampoo"])
    ap.add_argument("--method", default="prism",
                    choices=["prism", "polar_express", "newton_schulz",
                             "eigh"])
    ap.add_argument("--prism", default="prism5", choices=sorted(PRISM))
    ap.add_argument("--precondition_every", type=int, default=1,
                    help="Shampoo's inverse-root refresh period")
    ap.add_argument("--matfn_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless named")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    model, _, train_step, batch_for_step, (seq, batch) = build(
        args.preset, args.method, args.matfn_dtype, args.device, args.seed,
        args.prism, args.optimizer, args.precondition_every)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {model.cfg.name}: {n_params / 1e6:.1f}M params, "
          f"seq {seq}, batch {batch}, device {model.embed.device}, "
          f"{args.optimizer} {args.prism}")
    losses = []
    for s in range(args.steps):
        b = batch_for_step(s)
        t0 = time.perf_counter()
        m = train_step(b)
        loss = float(m["loss"])
        if model.embed.is_cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss)
        print(f"step {s}: loss {loss:.4f} grad_norm "
              f"{float(m['grad_norm']):.4f} ({dt * 1e3:.1f} ms)", flush=True)
    return losses


if __name__ == "__main__":
    main()
