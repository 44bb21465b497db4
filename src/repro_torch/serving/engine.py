"""Continuous-batching decode engine (counterpart of
``repro/serving/engine.py``, DESIGN.md §16).

A fixed-capacity slot table turns ragged request traffic into dense,
fixed-shape device steps:

  admit    arrived requests are right-padded to pow2 prompt lengths on
           the host, grouped into exact-shape buckets by the §6 planner
           (``plan_buckets``/``gather_bucket`` on the request dimension —
           each view is one prompt shaped [1, P]), and each bucket runs
           ONE ``model.prefill_cache`` call over its lanes padded to a
           power of two; the real lanes' KV rows and first sampled token
           install into free slots (the filler lanes are computed and
           dropped);
  decode   every engine step runs ONE fixed-shape [slots, 1]
           ``decode_step`` over the whole table; the ``active`` mask keeps
           retired and free lanes' cache rows bitwise frozen (dead lanes
           cost a lane of work, never correctness);
  evict    slots free on EOS or ``max_new`` in ascending-slot order, so
           eviction is deterministic under a seeded trace.

The shape contract: the decode step sees at most 2 distinct (tokens, pos,
active) shapes in a run, and exactly 1 in practice, because the slot
table never changes shape (``decode_step_shapes`` counts them; the
reference counts its ``jit`` cache).  Prefill shapes are one per (pow2
admit count, pow2 prompt length) bucket.  Each tick reads its next tokens
to the host once (one synchronization on the card).

Clocking is dual-mode: ``step_dt=None`` measures wall time, a float
``step_dt`` runs a virtual clock where every device call costs one tick
(tests, and the hardware-independent invariant: continuous admission
beats static admission on mixed-length traces, because static convoys —
it re-admits only when the WHOLE table has drained).

Per-slot sampling keys fold (request id, position) — see
``serving/decode.py`` — so two requests decoding at the same position
never share a sample stream and any trace replays bitwise.  The engine
serves the KV-cache families with one token per lane, dense and moe, as
the reference's does.  A moe model routes the whole slot table as one
global dispatch (``models/moe.py``): once an expert overflows its
capacity, a lane's tokens depend on its batch-mates, by the reference's
design.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.rng import Key
from repro_torch.models.transformer import Model
from repro_torch.optim.bucketing import gather_bucket, plan_buckets
from repro_torch.serving.decode import (_check_temperature, lane_keys,
                                        sample_lanes)
from repro_torch.serving.loadgen import Request

_MAX_STEPS = 200_000


def pow2_pad(n: int, floor: int = 4) -> int:
    """Smallest power of two >= max(n, floor) — the admission length
    bucket, bounding prefill shapes to one per (count, len) pow2."""
    p = floor
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int = 8              # slot-table capacity == decode batch
    cache_len: int = 64         # per-slot KV length (>= prompt + gen!)
    greedy: bool = True
    temperature: float = 1.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    admission: str = "continuous"   # "continuous" | "static"
    seed: int = 0                   # base key for sampling

    def __post_init__(self):
        if self.slots <= 0:
            raise ValueError(f"slots must be > 0, got {self.slots}")
        if self.admission not in ("continuous", "static"):
            raise ValueError(f"unknown admission {self.admission!r}")
        if not self.greedy:
            _check_temperature(self.temperature)


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    prompt_len: int
    arrival: float
    admitted: float
    finished: float
    tokens: Tuple[int, ...]     # generated tokens (incl. prefill's first)

    @property
    def latency(self) -> float:
        """Full-request latency including queue wait."""
        return self.finished - self.arrival

    @property
    def queue_wait(self) -> float:
        return self.admitted - self.arrival


@dataclasses.dataclass(frozen=True)
class RunResult:
    completions: Tuple[Completion, ...]
    occupancy: Tuple[int, ...]  # active slots at each decode step
    n_decode_steps: int
    n_prefill_launches: int
    decode_step_shapes: int     # distinct decode-call shapes
    elapsed: float

    @property
    def generated_tokens(self) -> int:
        return sum(len(c.tokens) for c in self.completions)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / max(self.elapsed, 1e-9)

    def latency_percentiles(self, qs=(50, 99)) -> Dict[str, float]:
        lats = np.asarray([c.latency for c in self.completions])
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}


class Engine:
    """Slot-table continuous-batching engine over one model.

    ``params``: compute-dtype parameters (name -> tensor, e.g.
    ``model.cast_params()`` or ``checkpoint.restore_params``'s); None
    casts the model's masters once.  ``key``: the base sampling key
    (``Key(cfg.seed)`` when None; any object with ``fold_in`` and
    ``gumbel``)."""

    def __init__(self, model: Model, params, cfg: EngineConfig, key=None):
        if model.cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"Engine serves KV-cache families (dense, moe); "
                f"{model.cfg.family!r} caches are not slot-installable")
        if model.layout is not None:
            raise ValueError("the Engine runs on one process: its slot "
                             "table installs whole caches (serve a sharded "
                             "model in batch mode)")
        self.model = model
        if params is None:
            with torch.inference_mode():
                params = model.cast_params()
        self.params = params
        self.cfg = cfg
        self.device = model.embed.device
        self._key = Key(cfg.seed) if key is None else key
        self._shapes: set = set()
        self.reset()

    # ------------------------------------------------------------ state

    def reset(self):
        cfg = self.cfg
        self.cache = self.model.init_cache(cfg.slots, cfg.cache_len)
        self._rid = np.full(cfg.slots, -1, np.int64)     # -1 == free
        self._pos = np.zeros(cfg.slots, np.int32)        # next decode pos
        self._max_new = np.zeros(cfg.slots, np.int64)
        self._toks: List[List[int]] = [[] for _ in range(cfg.slots)]
        self._meta: Dict[int, Tuple[Request, float]] = {}  # rid -> admit t

    @property
    def active_mask(self) -> np.ndarray:
        return self._rid >= 0

    @property
    def n_active(self) -> int:
        return int(self.active_mask.sum())

    @property
    def decode_step_shapes(self) -> int:
        return len(self._shapes)

    def _next_tokens(self, logits, rids, pos) -> np.ndarray:
        """Greedy or sampled next tokens of fp32 logits [N, V], read to
        the host; lane i samples with ``key.fold_in(rids[i]).fold_in(
        pos[i])``."""
        cfg = self.cfg
        if cfg.greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = sample_lanes(logits, lane_keys(self._key, rids, pos),
                               cfg.temperature, cfg.top_k)
        return nxt.cpu().numpy().astype(np.int32)

    # -------------------------------------------------------- admission

    def _plan_admission(self, reqs: Sequence[Request]):
        """§6 planner on the request dimension: each prompt is a [1, P]
        view at its pow2-padded length; exact-shape buckets become one
        prefill call each."""
        padded = [pow2_pad(r.prompt_len) for r in reqs]
        for r, p in zip(reqs, padded):
            if p > self.cfg.cache_len:
                raise ValueError(
                    f"request {r.rid}: padded prompt {p} exceeds "
                    f"cache_len {self.cfg.cache_len}")
        return plan_buckets([(1, p) for p in padded])

    @torch.inference_mode()
    def admit(self, reqs: Sequence[Request], free: Sequence[int],
              now: float) -> int:
        """Admit up to ``len(free)`` requests (FIFO) into free slots;
        one prefill call per prompt-length bucket.  Returns the calls."""
        reqs = list(reqs)[:len(free)]
        if not reqs:
            return 0
        launches = 0
        buckets = self._plan_admission(reqs)
        # views are globally indexed (Entry.index points into reqs);
        # each prompt right-pads to its own pow2 bucket length
        views = [torch.from_numpy(np.pad(
            r.prompt, (0, pow2_pad(r.prompt_len) - r.prompt_len)
        ).reshape(1, -1).astype(np.int32)) for r in reqs]
        slot_iter = iter(sorted(free)[:len(reqs)])
        for b in buckets:
            take = [reqs[e.index] for e in b.entries]
            slots = [next(slot_iter) for _ in take]
            n, P = len(take), b.shape[1]
            tokens = gather_bucket(b, views).reshape(n, P)
            lengths = np.asarray([r.prompt_len for r in take], np.int32)
            pad = pow2_pad(n, floor=1) - n
            if pad:  # filler lanes repeat the last request: one shape a
                # (pow2 count, pow2 length), computed and never installed
                tokens = torch.cat([tokens, tokens[-1:].expand(pad, P)])
                lengths = np.concatenate([lengths,
                                          np.repeat(lengths[-1:], pad)])
            logits, rows = self.model.prefill_cache(
                {"tokens": tokens.to(self.device)}, self.cfg.cache_len,
                torch.from_numpy(lengths).to(self.device),
                params=self.params)
            first = self._next_tokens(
                logits[:n, 0], [r.rid for r in take],
                [r.prompt_len - 1 for r in take])
            idx = torch.as_tensor(slots, device=self.device)
            self.cache["k"][:, idx] = rows["k"][:, :n]
            self.cache["v"][:, idx] = rows["v"][:, :n]
            self.cache["kpos"][idx] = rows["kpos"][:n]
            launches += 1
            for j, (r, s) in enumerate(zip(take, slots)):
                self._rid[s] = r.rid
                self._pos[s] = r.prompt_len
                self._max_new[s] = r.max_new
                self._toks[s] = [int(first[j])]
                self._meta[r.rid] = (r, now)
        return launches

    # ----------------------------------------------------------- decode

    @torch.inference_mode()
    def step(self) -> np.ndarray:
        """One fixed-shape decode call over the slot table.  Returns the
        per-slot next tokens (garbage at inactive lanes)."""
        cfg = self.cfg
        active = self.active_mask
        tokens = torch.tensor(
            [[t[-1] if t else 0] for t in self._toks], dtype=torch.int32)
        pos = torch.from_numpy(self._pos.reshape(cfg.slots, 1).copy())
        act = torch.from_numpy(active.copy())
        self._shapes.add((tuple(tokens.shape), tuple(pos.shape),
                          tuple(act.shape)))
        logits, self.cache = self.model.decode_step(
            self.cache, tokens.to(self.device), pos.to(self.device),
            active=act.to(self.device), params=self.params)
        nxt = self._next_tokens(logits[:, 0],
                                np.maximum(self._rid, 0).tolist(),
                                self._pos.tolist())
        for s in range(cfg.slots):
            if active[s]:
                self._toks[s].append(int(nxt[s]))
                self._pos[s] += 1
        return nxt

    def sweep(self, now: float, out: List[Completion]):
        """Evict finished slots (EOS or max_new), ascending slot order."""
        for s in range(self.cfg.slots):
            rid = self._rid[s]
            if rid < 0:
                continue
            toks = self._toks[s]
            done = len(toks) >= self._max_new[s] or (
                self.cfg.eos_id is not None and toks
                and toks[-1] == self.cfg.eos_id)
            if done:
                req, admitted = self._meta.pop(int(rid))
                out.append(Completion(
                    rid=int(rid), prompt_len=req.prompt_len,
                    arrival=req.arrival, admitted=admitted, finished=now,
                    tokens=tuple(toks)))
                self._rid[s] = -1
                self._toks[s] = []

    # -------------------------------------------------------------- run

    def run(self, trace: Sequence[Request],
            step_dt: Optional[float] = None,
            prefill_dt: Optional[float] = None) -> RunResult:
        """Drive a loadgen trace to completion.

        ``step_dt=None``: wall clock (sleeps through idle gaps — the
        offered-load mode).  A float runs the virtual clock: every decode
        call costs ``step_dt``, every prefill call ``prefill_dt`` (default
        ``step_dt``) — fully deterministic.
        """
        cfg = self.cfg
        virtual = step_dt is not None
        if virtual and prefill_dt is None:
            prefill_dt = step_dt
        pending = sorted(trace, key=lambda r: (r.arrival, r.rid))
        done: List[Completion] = []
        occupancy: List[int] = []
        n_steps = 0
        n_prefill = 0
        vt = 0.0
        t0 = time.monotonic()

        def now():
            return vt if virtual else time.monotonic() - t0

        for _ in range(_MAX_STEPS):
            if not pending and not self.n_active:
                break
            t = now()
            arrived = [r for r in pending if r.arrival <= t]
            free = [s for s in range(cfg.slots) if self._rid[s] < 0]
            admit_ok = bool(arrived) and bool(free) and (
                cfg.admission == "continuous" or self.n_active == 0)
            if admit_ok:
                n = min(len(arrived), len(free))
                launches = self.admit(arrived[:n], free, t)
                n_prefill += launches
                pending = pending[n:]
                if virtual:
                    vt += launches * prefill_dt
                # prefill may already satisfy max_new == 1
                self.sweep(now(), done)
            if self.n_active:
                occupancy.append(self.n_active)
                self.step()
                n_steps += 1
                if virtual:
                    vt += step_dt
                self.sweep(now(), done)
            elif pending:
                nxt_t = pending[0].arrival
                if virtual:
                    vt = max(vt, nxt_t)
                else:
                    time.sleep(max(0.0, nxt_t - now()))
        else:
            raise RuntimeError(f"engine exceeded {_MAX_STEPS} steps "
                               f"({len(pending)} pending)")

        done.sort(key=lambda c: c.rid)
        return RunResult(
            completions=tuple(done), occupancy=tuple(occupancy),
            n_decode_steps=n_steps, n_prefill_launches=n_prefill,
            decode_step_shapes=self.decode_step_shapes, elapsed=now())
