"""Training launcher CLI for any architecture of the registry (counterpart
of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --steps 4 --seq 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch musicgen-medium --smoke --steps 2 --device cpu

Builds ``--arch`` (``--smoke``: its SMOKE width) with random weights
from ``--seed`` and trains it through the ``Trainer`` on the synthetic
bigram stream (audio and vlm batches carry their codebooks and patches),
with the reference launcher's flags, defaults and optimizer: Muon (or
``--optimizer shampoo | adamw``) with ``PrismConfig(degree=2,
iterations=3, warm_alpha_iters=3, sketch_dim=8)``, routed through the
hand-written CUDA kernels on the card (``use_kernels=True``; the plain
versions on the CPU).  Two differences: ``--device`` (CUDA unless
named), and ``--ckpt_dir`` defaults to none, so a run writes nothing
unless it names a directory (the reference writes /tmp/repro_ckpt).
With ``--ckpt_dir`` the run checkpoints every ``--ckpt_every`` steps and
resumes from the newest checkpoint that verifies.

``--compression int8`` passes the clipped gradients through the int8
round trip (``optim/compression.py``), as the reference's step does.

``--mesh production [--multi_pod]`` trains as one rank of a world that
torchrun describes (``launch/mesh.init_world_from_env``):

    torchrun --nproc_per_node 256 -m repro_torch.launch.train --mesh production

on ``make_production_mesh`` ((data 16, model 16), a pod axis of 2 in
front with ``--multi_pod``) under the reference's default rules,
``param_rules(cfg, mesh)`` ("tp": FSDP over data, tensor parallelism
over model), through the Trainer (``production_layout`` builds the mesh
and the shardings, also without a world), with any of the optimizers
and ``--precond_async``: Muon and Shampoo keep their moments and cached
preconditioners as blocks of the layout.  Every family trains there:
dense; moe (granite-moe-1b-a400m by expert parallelism, its 32 experts
over the model axis; mixtral-8x7b by each expert's columns); vlm; audio
(each codebook's vocab rows over the model axis); ssm (falcon-mamba-7b,
d_inner over the model axis); hybrid (recurrentgemma-2b, the LRU width,
the heads and the mlp columns over it).  A world of another size fails
with the ``Mesh``'s ValueError; ``--multi_pod`` without ``--mesh
production`` is a ValueError; ``--pipeline_stages > 1`` (the 1F1B
pipeline) raises (ROADMAP.md Queue 1 item 11c).
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.config import OptimizerConfig, PrismConfig, TrainConfig
from repro_torch.configs import arch_ids, get_config, get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.mesh import init_world_from_env, make_production_mesh
from repro_torch.models import Model
from repro_torch.models.transformer import param_specs
from repro_torch.train import Trainer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper",
                    choices=sorted(arch_ids() + ["gpt2-paper"]))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--optimizer", default="muon",
                    choices=["muon", "shampoo", "adamw"])
    ap.add_argument("--method", default="prism",
                    choices=["prism", "polar_express", "newton_schulz",
                             "eigh"])
    ap.add_argument("--lr", type=float, default=6e-3)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "production"])
    ap.add_argument("--multi_pod", action="store_true")
    ap.add_argument("--ckpt_dir", default=None,
                    help="checkpoint directory; resume from it when it "
                         "holds a checkpoint (none written without it)")
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--precond_every", type=int, default=1,
                    help="staleness period K: refresh matrix "
                         "preconditioners every K steps (DESIGN.md §8)")
    ap.add_argument("--precond_async", action="store_true",
                    help="dispatch the refreshes between steps and swap "
                         "them in a step later (DESIGN.md §12)")
    ap.add_argument("--pipeline_stages", type=int, default=1,
                    help="1F1B pipeline depth (DESIGN.md §13)")
    ap.add_argument("--n_micro", type=int, default=4,
                    help="microbatches per step for the 1F1B schedule")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless named")
    return ap


def configs(args):
    """(model config, optimizer config, train config, data config) of the
    parsed ``args``."""
    if args.multi_pod and args.mesh != "production":
        raise ValueError("--multi_pod needs --mesh production")
    if args.pipeline_stages > 1:
        raise NotImplementedError(
            "--pipeline_stages > 1 (1F1B) comes with ROADMAP.md Queue 1 "
            "item 11c")
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    ocfg = OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr,
        matfn_method=args.method, gradient_compression=args.compression,
        precond_every=args.precond_every,
        precond_async=args.precond_async,
        prism=PrismConfig(degree=2, iterations=3, warm_alpha_iters=3,
                          sketch_dim=8, use_kernels=True))
    tcfg = TrainConfig(steps=args.steps, checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.ckpt_every, log_every=10,
                       pipeline_stages=args.pipeline_stages,
                       n_micro=args.n_micro)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    return cfg, ocfg, tcfg, dcfg


def production_layout(cfg, multi_pod: bool = False):
    """(mesh, {"params": shardings}) of ``--mesh production``: the
    production mesh and ``tree_shardings`` of the reference's default
    rules (``param_rules(cfg, mesh)``, "tp").  Outside a world the mesh
    has its shape only; inside one it must hold every rank."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = sharding.param_rules(cfg, mesh)
    specs = param_specs(cfg)
    shards = sharding.tree_shardings(
        mesh, {k: a for k, (_, a, _) in specs.items()}, rules,
        {k: s for k, (s, _, _) in specs.items()})
    return mesh, {"params": shards}


def build(args) -> Trainer:
    """The Trainer of the parsed ``args``: its model drawn from
    ``args.seed`` on ``args.device``; with ``--mesh production``, one rank
    of the world the environment describes, on its block of the
    parameters."""
    cfg, ocfg, tcfg, dcfg = configs(args)
    mesh = shardings = None
    if args.mesh == "production":
        if not dist.is_initialized():
            init_world_from_env(device=args.device)
        mesh, shardings = production_layout(cfg, args.multi_pod)
    model = Model(cfg, device=resolve_device(args.device), seed=args.seed)
    return Trainer(model, ocfg, tcfg, dcfg, mesh=mesh, shardings=shardings)


def main(argv=None):
    args = parser().parse_args(argv)
    trainer = build(args)
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {model.cfg.name} [{model.cfg.family}]: {n_params} params, "
          f"seq {args.seq}, batch {args.batch}, device {trainer.device}, "
          f"{args.optimizer} {args.method}", flush=True)
    _, _, losses = trainer.run()
    print("losses: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    return losses


if __name__ == "__main__":
    main()
