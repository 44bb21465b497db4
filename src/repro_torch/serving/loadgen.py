"""Deterministic load generator for the serving engine (DESIGN.md §16).

Produces a fully materialized request trace up front — seeded Poisson
arrivals (exponential inter-arrival gaps at the offered QPS), mixed
prompt/generation lengths drawn from configurable palettes, and uniform
random prompt tokens — so every consumer (engine tests, the static- vs
continuous-batching bench, replay debugging) sees the byte-identical
workload for a given ``(seed, qps, n_requests)`` triple.  Traces are
host-side numpy, cheap to build and to diff.  The port's own copy of
``repro/serving/loadgen.py``: the same arguments give byte-identical
traces in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: ``prompt`` is the real (unpadded) token ids;
    ``arrival`` is seconds since trace start on the load clock."""

    rid: int
    arrival: float
    prompt: np.ndarray          # [prompt_len] int32
    max_new: int

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


def make_trace(seed: int, *, n_requests: int, qps: float, vocab_size: int,
               prompt_lens: Sequence[int] = (4, 8, 12, 24),
               gen_lens: Sequence[int] = (4, 8, 16),
               ) -> Tuple[Request, ...]:
    """Seeded Poisson trace: ``n_requests`` requests at offered rate
    ``qps``, prompt/gen lengths sampled uniformly from the palettes.

    The mixed-length palettes are the point (not a nicety): uniform
    lengths would let static batching pad-free-ride, while ragged traces
    are exactly where continuous batching wins — the continuous-beats-
    static throughput invariant is only meaningful on a mixed trace.
    """
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    if n_requests <= 0:
        raise ValueError(f"n_requests must be > 0, got {n_requests}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / qps, size=n_requests)
    arrivals = np.cumsum(gaps)
    plens = rng.choice(np.asarray(prompt_lens, np.int64), size=n_requests)
    glens = rng.choice(np.asarray(gen_lens, np.int64), size=n_requests)
    out = []
    for i in range(n_requests):
        prompt = rng.integers(0, vocab_size, size=int(plens[i]),
                              dtype=np.int64).astype(np.int32)
        out.append(Request(rid=i, arrival=float(arrivals[i]), prompt=prompt,
                           max_new=int(glens[i])))
    return tuple(out)
