"""Serving steps: prefill (last-token logits) and single-token decode
(counterpart of ``repro/serving/decode.py``).

Two decode policies share one step shape:

  greedy=True   serve_step(cache, tokens, pos)
                -> (logits, argmax token, cache); fully deterministic,
                the ``launch/serve.py`` loop.
  greedy=False  serve_step(cache, tokens, pos, key, rids=None)
                -> (logits, sampled token, cache); temperature / top-k
                sampling.  The caller threads ONE base key
                (``core.rng.Key``); each lane folds (request id, position)
                into it, so replays are reproducible and two requests
                decoding at the same position never share a sample stream
                (rids=None keys by position alone).

``top_k=1`` degenerates to greedy regardless of temperature, so the
sampled path can be regression-tested against the greedy one.

Sampling is the Gumbel-max trick of ``jax.random.categorical``:
argmax(gumbel(key, shape) + logits / temperature), the noise drawn by the
key's ``gumbel``.  With ``top_k`` the support is the k largest logits, in
descending order with ties broken by the lower index (a stable sort, the
order of ``lax.top_k``), and the noise has shape [..., k].
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.models.transformer import Model


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(batch, params=None):
        return model.prefill(batch, params=params)

    return prefill_step


def _check_temperature(temperature: float) -> None:
    """Single source of truth for the temperature domain check (raised
    both at ``make_serve_step`` factory time and inside
    ``sample_logits`` for direct callers)."""
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature} "
                         "(use greedy=True for argmax decoding)")


def _support(logits: torch.Tensor, top_k: Optional[int]):
    """(values, indices or None): the top_k largest logits in descending
    order, ties by index, or the whole vocab when top_k is None or not
    below it."""
    if top_k is None or top_k >= logits.shape[-1]:
        return logits, None
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def _pick(vals, idx, noise, temperature: float) -> torch.Tensor:
    choice = torch.argmax(noise + vals / temperature, dim=-1)
    if idx is not None:
        choice = torch.gather(idx, -1, choice[..., None])[..., 0]
    return choice.to(torch.int32)


def sample_logits(logits: torch.Tensor, key, temperature: float = 1.0,
                  top_k: Optional[int] = None) -> torch.Tensor:
    """Temperature / top-k sample over the trailing vocab axis, one draw
    of noise shaped like the (restricted) logits from ``key``.

    Works for any leading batch layout: returns int32 token ids shaped
    ``logits.shape[:-1]``.  ``temperature`` scales after the restriction,
    so top_k=1 is exact argmax for any temperature.
    """
    _check_temperature(temperature)
    vals, idx = _support(logits.float(), top_k)
    noise = key.gumbel(vals.shape, torch.float32, vals.device)
    return _pick(vals, idx, noise, temperature)


def sample_lanes(logits: torch.Tensor, keys: Sequence, temperature: float,
                 top_k: Optional[int] = None) -> torch.Tensor:
    """``sample_logits`` of each lane ``logits[i]`` with its own key
    ``keys[i]`` (the reference's ``vmap`` over lanes), in one restriction
    and one argmax for the whole batch."""
    _check_temperature(temperature)
    vals, idx = _support(logits.float(), top_k)
    noise = torch.stack([k.gumbel(vals.shape[1:], torch.float32,
                                  vals.device) for k in keys])
    return _pick(vals, idx, noise, temperature)


def lane_keys(key, rids: Sequence[int], pos: Sequence[int]) -> list:
    """Each lane's key: ``key.fold_in(rid).fold_in(pos)``."""
    return [key.fold_in(int(r)).fold_in(int(p)) for r, p in zip(rids, pos)]


def make_serve_step(model: Model, greedy: bool = True,
                    temperature: float = 1.0,
                    top_k: Optional[int] = None) -> Callable:
    """The decode step of one policy (see the module docstring).  The
    cache is updated in place; ``params`` (compute-dtype tensors, e.g.
    ``model.cast_params()``) defaults to casting the model's masters.  On
    a sharded model the tokens, positions, ``rids`` and the returned
    logits and tokens are the rank's lanes (``sharding.
    decode_input_shardings``), the logits over the whole padded vocab,
    and the cache the rank's blocks (``models/transformer.py``)."""
    if greedy:
        def serve_step(cache, tokens, pos, params=None):
            logits, cache = model.decode_step(cache, tokens, pos,
                                              params=params)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            return logits, nxt, cache

        return serve_step

    _check_temperature(temperature)

    def serve_step(cache, tokens, pos, key, rids=None, params=None):
        """The per-lane keys fold host integers, so ``pos`` is read to
        the host once a call (one synchronization on the card)."""
        logits, cache = model.decode_step(cache, tokens, pos,
                                          params=params)
        # per-lane key = fold_in(fold_in(key, request_id), position):
        # under continuous batching two requests routinely decode at the
        # SAME position in the same step, so the rid keeps their streams
        # apart while any step of a trace replays identically
        B = logits.shape[0]
        p = pos.reshape(B, -1)[:, 0].tolist()
        r = [0] * B if rids is None else torch.as_tensor(rids).tolist()
        nxt = sample_lanes(logits, lane_keys(key, r, p), temperature,
                           top_k)
        return logits, nxt, cache

    return serve_step
