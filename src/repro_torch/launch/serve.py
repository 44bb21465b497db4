"""Serving launcher (counterpart of ``repro/launch/serve.py`` and
``examples/serve_lm.py``): batched prefill and greedy KV-cache decode,
or the continuous-batching Engine under a seeded Poisson trace.

    # batch mode: one prefill_cache call, then a greedy decode loop
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --batch 4 \\
        --prompt_len 16 --gen_len 32 --device cpu
    # continuous batching (DESIGN.md §16) at the offered QPS
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --continuous \\
        --qps 20 --slots 8 --requests 64 --device cpu
    # train -> serve handoff: parameters from a Trainer checkpoint
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
        --ckpt_dir CKPT
    # another architecture of the registry (every family in batch mode)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m --smoke --device cpu
    # batch mode as one rank of a torchrun world on the production mesh
    torchrun --nproc_per_node 256 -m repro_torch.launch.serve \\
        --mesh production --cache_len 32768

``--arch`` names a model of the registry (``configs/registry.py``,
default gpt2-paper); ``--smoke`` takes its SMOKE width.  The Engine
(``--continuous``) serves dense and moe models; batch mode serves every
family (a vlm prompt carries its patch prefix, so its positions and
cache include it; audio decodes K codebooks a step; ssm and hybrid
prefill one decode step a prompt position).  Weights are random from
``--seed`` unless ``--ckpt_dir`` names a checkpoint.  Batch-mode prompts
come from ``models/inputs.make_train_batch`` on a generator seeded with
``--seed``.  The first prefill call is timed apart from the second, so
the prefill tokens/s is a steady-state number.

``--mesh production [--multi_pod]`` serves batch mode as one rank of
the world torchrun describes (``launch/mesh.init_world_from_env``; a
ValueError outside one, as ``launch/train.py`` raises), as the
reference does: ``make_production_mesh``, the reference's default rules
``param_rules(cfg, mesh)`` ("tp": FSDP over data, tensor parallelism
over model) through ``launch/train.production_layout``, ``Model.shard``,
then ``batch_loop`` with the decode cache as the rank's blocks of the
reference's ``cache_shardings`` (``models/transformer.py``); rank 0
prints, the tokens gathered over the lanes.  ``--continuous --mesh
production`` exits with the reference's message: the Engine runs on
one process.  Without ``--device`` it runs on CUDA.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.checkpoint import restore_params
from repro_torch.configs import arch_ids, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_world_from_env
from repro_torch.launch.train import production_layout
from repro_torch.models import Model
from repro_torch.models.inputs import make_train_batch
from repro_torch.models.transformer import cache_leaves
from repro_torch.serving import (Engine, EngineConfig, make_serve_step,
                                 make_trace)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_model(args, device):
    """(model, compute-dtype params) of ``args``: random from
    ``args.seed``, or the params of ``args.ckpt_dir``'s newest checkpoint
    that verifies."""
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = Model(cfg, device=device, seed=args.seed)
    if args.ckpt_dir:
        step, params = restore_params(args.ckpt_dir,
                                      dict(model.named_parameters()))
        model.load_params(params)
        print(f"restored params from {args.ckpt_dir} step {step}")
    with torch.inference_mode():
        return model, model.cast_params()


def batch_loop(model, params, args, device) -> dict:
    """One prefill_cache call over ``args.batch`` prompts of
    ``args.prompt_len`` (timed twice: the first call apart), then
    ``args.gen_len`` greedy decode steps from its token; returns the
    times, the tokens [B, gen_len + 1] ([B, K, gen_len + 1] audio),
    whether every logit was finite and the KV cache bytes (on a mesh the
    rank's blocks; the tokens gathered over the lanes, the finiteness
    over the world, and rank 0 prints).  A vlm prompt's patch prefix adds
    its length to the cache and the decode positions."""
    cfg = model.cfg
    B = args.batch
    cache_len = args.cache_len or (args.prompt_len + args.gen_len)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    batch = make_train_batch(gen, cfg, B, args.prompt_len)
    extra = batch["patches"].shape[1] if cfg.family == "vlm" else 0
    cache_len += extra
    start = args.prompt_len + extra
    times = []
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill_cache(batch, cache_len,
                                            params=params)
        _sync(device)
        times.append(time.perf_counter() - t0)
    step = make_serve_step(model)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out, seen = [tok], [logits]
    _sync(device)
    t0 = time.perf_counter()
    for t in range(start, start + args.gen_len):
        pos = torch.full((tok.shape[0], 1), t, dtype=torch.int32,
                         device=device)
        lg, tok, cache = step(cache, tok, pos, params=params)
        out.append(tok)
        seen.append(lg)
    _sync(device)
    decode_s = time.perf_counter() - t0
    steps = args.gen_len
    bad = (~torch.isfinite(torch.cat(seen, dim=-2))).sum()
    if model.layout is not None:
        bad = collectives.all_reduce(bad.reshape(1), "sum", kind="lanes")
    res = {"first_prefill_s": times[0], "prefill_s": times[1],
           "decode_s": decode_s, "decode_ms_step": decode_s / steps * 1e3,
           "prefill_tok_s": B * args.prompt_len / times[1],
           "decode_tok_s": B * steps / decode_s,
           "tokens": model.whole_lanes(torch.cat(out, dim=-1)).cpu().numpy(),
           "finite": int(bad.sum()) == 0,
           "cache_bytes": sum(v.numel() * v.element_size()
                              for v in cache_leaves(cache))}
    if model.layout is not None and dist.get_rank() != 0:
        return res
    print(f"arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen_len} cache_len={cache_len}")
    print(f"prefill {res['prefill_s'] * 1e3:.1f} ms (1 call, "
          f"{res['prefill_tok_s']:.1f} tok/s; first call "
          f"{res['first_prefill_s']:.2f} s) | {res['decode_ms_step']:.2f} "
          f"ms/step | {res['decode_tok_s']:.1f} tok/s | KV cache "
          f"{res['cache_bytes']} bytes")
    return res


def serve_continuous(model, params, args):
    """The Engine over a seeded trace on the wall clock (offered-load
    mode); returns its ``RunResult``."""
    cfg = model.cfg
    eng = Engine(model, params, EngineConfig(
        slots=args.slots, cache_len=args.cache_len or 64, greedy=True,
        eos_id=0, seed=args.seed))
    trace = make_trace(args.seed, n_requests=args.requests, qps=args.qps,
                       vocab_size=cfg.vocab_size)
    res = eng.run(trace)
    lat = res.latency_percentiles()
    print(f"arch={cfg.name} slots={args.slots} qps={args.qps} "
          f"requests={args.requests}")
    print(f"completed={len(res.completions)} "
          f"tokens={res.generated_tokens} "
          f"tok/s={res.tokens_per_s:.1f} "
          f"p50={lat['p50'] * 1e3:.1f}ms p99={lat['p99'] * 1e3:.1f}ms "
          f"decode_shapes={res.decode_step_shapes} "
          f"prefill_launches={res.n_prefill_launches}")
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper",
                    choices=sorted(arch_ids() + ["gpt2-paper"]))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=16)
    ap.add_argument("--gen_len", type=int, default=32)
    ap.add_argument("--cache_len", type=int, default=0)
    ap.add_argument("--mesh", default="none", choices=["none", "production"])
    ap.add_argument("--multi_pod", action="store_true")
    ap.add_argument("--ckpt_dir", default="",
                    help="restore params from a training checkpoint "
                         "(train -> serve handoff, §15/§16 integrity rules)")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-table continuous batching (§16)")
    ap.add_argument("--qps", type=float, default=20.0,
                    help="offered load for --continuous")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; CUDA unless named")
    return ap


def sharded_model(args):
    """(model, compute-dtype params, device) of ``--mesh production``: one
    rank of the world the environment describes, its block of the
    parameters under the reference's default rules."""
    device = init_world_from_env(device=args.device) \
        if not dist.is_initialized() else resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    mesh, shardings = production_layout(cfg, args.multi_pod)
    model, _ = load_model(args, device)
    model.shard(mesh, shardings["params"], "tp")
    with torch.inference_mode():
        return model, model.cast_params(), device


def main(argv=None):
    args = parser().parse_args(argv)
    if args.multi_pod and args.mesh != "production":
        raise ValueError("--multi_pod needs --mesh production")
    if args.continuous and args.mesh == "production":
        raise SystemExit("--continuous runs single-host for now; "
                         "drop --mesh production")
    if args.mesh == "production":
        model, params, device = sharded_model(args)
        return batch_loop(model, params, args, device)
    device = resolve_device(args.device)
    model, params = load_model(args, device)
    if args.continuous:
        return serve_continuous(model, params, args)
    return batch_loop(model, params, args, device)


if __name__ == "__main__":
    main()
