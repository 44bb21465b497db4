"""End-to-end training driver: the paper's Sec. 6.2 experiments on the
port (counterpart of ``examples/train_lm.py`` and ``repro/launch/train.py``).

Trains the paper's GPT-2 config (10 layers, 16 heads, d=1024) on the
synthetic bigram stream through the ``Trainer``, and prints the losses,
with ``--optimizer muon`` (PRISM polar factors, the default), ``shampoo``
(PRISM inverse square roots) or ``adamw`` (the Sec. 6.2 baseline).
``--method`` picks the matrix function's method: ``prism`` (the
hand-written kernels, ``use_kernels=True``), ``newton_schulz``,
``polar_express`` or ``eigh`` (Shampoo).  ``--prism`` picks a PRISM
configuration from ``PRISM``:

  * ``prism5``: degree 2, three warm iterations — Muon's PRISM-5
    (``benchmarks/fig6_muon_lm.py``) and Shampoo's default
    (``OptimizerConfig(name="shampoo")``, ``repro/launch/train.py``);
  * ``prism3``: degree 1, three warm then two fitted iterations with a
    sketch of 8 rows (Muon's PRISM-3);
  * ``fig5``: degree 2, five fitted iterations, sketch 8, learning rate
    3e-3 (Shampoo's fitted configuration, ``benchmarks/fig5_shampoo.py``).

``--precond_every K`` refreshes the preconditioners (Muon's polar factors,
Shampoo's inverse roots) every K steps and serves them from the state in
between; ``--precondition_every`` is Shampoo's legacy period (Fig. 5 uses
5).  ``--precond_async`` (with K > 1) moves that refresh off the step: the
Trainer dispatches it between steps (on a side CUDA stream on the card)
and swaps its result in a step later (DESIGN.md §12).  With
``--ckpt_dir`` the run writes crc-verified checkpoints every
``--ckpt_every`` steps and a HEARTBEAT file; killed and run again with the
same arguments, it resumes from the newest checkpoint that verifies.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset full \
        --steps 5 --prism prism3
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset full \
        --steps 5 --optimizer shampoo --prism fig5
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset cpu-small \
        --steps 4 --device cpu --precond_every 2 --ckpt_dir CKPT \
        --ckpt_every 2
"""
from __future__ import annotations

import argparse

from repro_torch.config import OptimizerConfig, PrismConfig, TrainConfig
from repro_torch.configs import gpt2_paper
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, make_train_step


PRISM = {
    "prism5": dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8),
    "prism3": dict(degree=1, iterations=5, warm_alpha_iters=3, sketch_dim=8),
    "fig5": dict(degree=2, iterations=5, warm_alpha_iters=0, sketch_dim=8),
}
# learning rates: 6e-3 as in examples/train_lm.py and repro/launch/train.py;
# 3e-3 for the fitted Shampoo of benchmarks/fig5_shampoo.py
LEARNING_RATE = {"fig5": 3e-3}


def configs(preset: str, method: str, matfn_dtype: str, seed: int = 0,
            prism: str = "prism5", optimizer: str = "muon",
            precondition_every: int = 1, precond_every: int = 1,
            precond_async: bool = False):
    """(model config, optimizer config, data config) of the ``optimizer``
    experiment at ``preset`` with the PRISM configuration ``prism`` (a key
    of ``PRISM``), the refresh periods and the async refresh plane."""
    cfg = gpt2_paper.CONFIG
    if preset == "cpu-small":
        cfg = cfg.replace(num_layers=4, d_model=256, num_heads=8,
                          num_kv_heads=8, head_dim=32, d_ff=1024,
                          vocab_size=4096)
        seq, batch = 128, 8
    else:
        seq, batch = 512, 4
    ocfg = OptimizerConfig(
        name=optimizer, learning_rate=LEARNING_RATE.get(prism, 6e-3),
        momentum=0.95, weight_decay=0.01, matfn_method=method,
        matfn_dtype=matfn_dtype, precondition_every=precondition_every,
        precond_every=precond_every, precond_async=precond_async,
        max_precond_dim=2048,
        prism=PrismConfig(use_kernels=True, **PRISM[prism]))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, markov_rank=64, seed=1234 + seed)
    return cfg, ocfg, dcfg


def build(preset: str, method: str, matfn_dtype: str, device=None,
          seed: int = 0, prism: str = "prism5", optimizer: str = "muon",
          precondition_every: int = 1, precond_every: int = 1):
    """(model, optimizer, train_step, batch_for_step, (seq, batch)) of the
    ``optimizer`` experiment at ``preset`` on ``device`` (CUDA unless
    named); see ``configs``.  ``train_step(batch, step, refresh=None)``."""
    dev = resolve_device(device)
    cfg, ocfg, dcfg = configs(preset, method, matfn_dtype, seed, prism,
                              optimizer, precondition_every, precond_every)
    model = Model(cfg, device=dev, seed=seed)
    opt = make_optimizer(ocfg, model.named_parameters(),
                         model.logical_axes())
    step = make_train_step(model, opt, ocfg)
    return (model, opt, step, make_batch_fn(cfg, dcfg, dev),
            (dcfg.seq_len, dcfg.global_batch))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--preset", default="full",
                    choices=["full", "cpu-small"])
    ap.add_argument("--optimizer", default="muon",
                    choices=["muon", "shampoo", "adamw"])
    ap.add_argument("--method", default="prism",
                    choices=["prism", "polar_express", "newton_schulz",
                             "eigh"])
    ap.add_argument("--prism", default="prism5", choices=sorted(PRISM))
    ap.add_argument("--precond_every", type=int, default=1,
                    help="refresh the preconditioners every K steps, "
                         "serving them from the state in between")
    ap.add_argument("--precond_async", action="store_true",
                    help="dispatch the refresh between steps and swap it "
                         "in a step later (needs --precond_every > 1)")
    ap.add_argument("--precondition_every", type=int, default=1,
                    help="Shampoo's legacy inverse-root refresh period")
    ap.add_argument("--matfn_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt_dir", default=None,
                    help="checkpoint directory; resume from it when it "
                         "holds a checkpoint (none written without it)")
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless named")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, ocfg, dcfg = configs(args.preset, args.method, args.matfn_dtype,
                              args.seed, args.prism, args.optimizer,
                              args.precondition_every, args.precond_every,
                              args.precond_async)
    model = Model(cfg, device=dev, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, seq "
          f"{dcfg.seq_len}, batch {dcfg.global_batch}, device {dev}, "
          f"{args.optimizer} {args.method} {args.prism}", flush=True)
    tcfg = TrainConfig(steps=args.steps, log_every=1,
                       checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.ckpt_every)
    trainer = Trainer(model, ocfg, tcfg, dcfg)
    _, _, losses = trainer.run()
    if trainer.straggler_events:
        print(f"straggler events: {trainer.straggler_events}")
    return losses


if __name__ == "__main__":
    main()
