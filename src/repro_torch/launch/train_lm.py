"""End-to-end training driver: the paper's Sec. 6.2 Muon experiment on the
port (counterpart of ``examples/train_lm.py``).

Trains the paper's GPT-2 config (10 layers, 16 heads, d=1024) with Muon +
PRISM-accelerated polar decomposition on the synthetic bigram stream, for
a few steps, and prints the losses.  The matrix-function GEMMs always run
through the hand-written kernels (``use_kernels=True``).

    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset full \\
        --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset cpu-small \\
        --steps 3 --device cpu

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


def build(preset: str, method: str, matfn_dtype: str, device=None,
          seed: int = 0):
    """(model, optimizer, train_step, batch_for_step, (seq, batch)) of the
    Muon experiment at ``preset`` on ``device`` (CUDA unless named)."""
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
        name="muon", learning_rate=6e-3, momentum=0.95, weight_decay=0.01,
        matfn_method=method, matfn_dtype=matfn_dtype,
        prism=PrismConfig(degree=2, iterations=3, warm_alpha_iters=3,
                          sketch_dim=8, use_kernels=True))
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
    ap.add_argument("--method", default="prism",
                    choices=["prism", "polar_express", "newton_schulz"])
    ap.add_argument("--matfn_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless named")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    model, _, train_step, batch_for_step, (seq, batch) = build(
        args.preset, args.method, args.matfn_dtype, args.device, args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {model.cfg.name}: {n_params / 1e6:.1f}M params, "
          f"seq {seq}, batch {batch}, device {model.embed.device}")
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
