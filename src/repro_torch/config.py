"""Central configuration dataclasses of the PyTorch port.

A copy of the reference package's ``config.py`` with the same fields and
defaults, so a config written for one package reads the same in the
other.  Dtype-valued properties return ``torch.dtype``s; fields keep
their string values ("float32", "bfloat16").  Architecture files under
``repro_torch/configs`` construct ``ModelConfig`` instances.

Two fields change meaning on the GPU: ``PrismConfig.use_kernels`` routes
the GEMM hot spots through the hand-written CUDA kernels
(``kernels/ops.py``) instead of ``torch.matmul``, and ``vmem_budget``
overrides the shared-memory budget of one fused-tier block (bytes; 0 =
the card's 232,448, see ``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """torch dtype of a config dtype string (or a torch dtype as is)."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# PRISM


@dataclass(frozen=True)
class MatfnPrecision:
    """Precision policy of the matrix-function engine (DESIGN.md §9).

    Three roles, threaded end-to-end through core/, kernels/ and optim/:

      compute:    dtype of GEMM operands and iterates (X, R, V, the
                  sketch S).  "bfloat16" halves device-memory traffic
                  and optimizer-state bytes.
      accumulate: dtype of dot accumulation.  PINNED float32 — every
                  CUDA kernel keeps an fp32 accumulator and every plain
                  torch path (``kernels/ref.py``) mirrors that exactly.
      fit:        dtype of the PRISM alpha machinery — sketched traces,
                  the trace-weight map W, the closed-form minimization,
                  Frobenius norms, and the §7 pad-trace correction.
                  PINNED float32 (DESIGN.md §2/§9): the fit is O(n^2 p)
                  scalars, so pinning costs nothing, while a bf16 fit
                  would make alpha itself noisy instead of letting the
                  fit *absorb* bf16 residual noise adaptively.
    """

    compute: str = "float32"
    accumulate: str = "float32"
    fit: str = "float32"

    def __post_init__(self):
        if self.accumulate != "float32":
            raise ValueError("MatfnPrecision.accumulate is pinned float32 "
                             f"(got {self.accumulate!r}); see DESIGN.md §9")
        if self.fit != "float32":
            raise ValueError("MatfnPrecision.fit is pinned float32 "
                             f"(got {self.fit!r}); see DESIGN.md §9")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.compute)

    @property
    def accumulate_dtype(self) -> torch.dtype:
        return torch_dtype(self.accumulate)

    @property
    def fit_dtype(self) -> torch.dtype:
        return torch_dtype(self.fit)


@dataclass(frozen=True)
class PrismConfig:
    """Configuration of the PRISM matrix-function engine.

    Attributes:
      degree: d in g_d(xi; alpha) = f_{d-1}(xi) + alpha xi^d.  degree=1 is
        the 3rd-order Newton-Schulz family, degree=2 the 5th-order family.
      sketch_dim: rows p of the Gaussian OSE sketch S in R^{p x n}.  The
        paper observes p as small as 5 suffices; we default to 8.
      iterations: fixed iteration count (Muon/Shampoo).
      warm_alpha_iters: use alpha = u (the upper constraint) for this many
        initial iterations instead of fitting (paper Sec. C efficiency
        trick; preserves the quadratic-convergence guarantee by Lemma B.1).
      alpha_bounds: override [l, u]; None selects the paper's defaults
        ([1/2, 1] for d=1, [3/8, 29/20] for d=2).
      use_kernels: route GEMM hot spots through the hand-written CUDA
        kernels (kernels/ops.py); False uses torch.matmul paths with the
        same accumulation order.
      dtype: COMPUTE dtype of the iteration (operands, iterates, sketch);
        accumulation and the alpha fit stay fp32 regardless — see
        ``precision`` / MatfnPrecision (DESIGN.md §9).
      fuse: the single-launch fused-iteration kernel tier (DESIGN.md §10).
        "auto" engages it per call when the iteration's whole working set
        fits one block's shared memory (kernels/ops.py::fused_fits — a
        batch-size-independent shape test); "on"/"off" force it, and "on"
        raises on a shape that does not fit.  Only meaningful with
        ``use_kernels``.
      vmem_budget: shared-memory budget in bytes of one fused-tier block
        (the name is kept from the reference config).  0 selects the
        card's per-block maximum (kernels/ops.py).
      tol: convergence certificate for ADAPTIVE early stopping
        (DESIGN.md §11).  When set, every FITTED iteration reads the
        sketched residual estimate est_r ~ ||R_k||_F off the trace chain
        it already computes (t_2 = tr(S R^2 S^T), fp32, §7 pad-corrected)
        and freezes any [B, n, n] slice whose est_r <= tol — the fit
        phase becomes a lax.while_loop that exits when the SLOWEST slice
        certifies, so ``iterations`` turns from a fixed cost into a
        budget (upper bound).  ``None`` (default) keeps the fixed-iters
        chains: fully unrolled, reverse-differentiable, bit-identical to
        previous releases.  The certificate is an UNBIASED sketch
        estimate, not a bound: with sketch_dim = p its relative std is
        ~sqrt(2/p), so a slice can certify while its true ||R||_F sits
        slightly above tol (sketch_dim=0 makes est_r exact).  Warm
        iterations and classical (fit-free) chains never consult tol —
        they have no trace chain to read — and run their static schedule.
      divergence_factor: the §15 divergence detector riding the same
        certificate.  Inside the adaptive loop every slice tracks its
        best (smallest) est_r so far; the step est_r goes non-finite or
        exceeds ``divergence_factor ×`` that best, the slice is
        QUARANTINED — rolled back to its best-so-far iterate
        (bitwise, like the freeze masks) and withdrawn from further
        updates, with an int8 status code surfacing the event.  Only
        consulted when ``tol`` is set (the detector reads the same free
        trace-chain certificate); must be > 1.  Larger values tolerate
        more transient certificate noise before declaring divergence —
        with sketch_dim = p the certificate's relative std is
        ~sqrt(2/p), so factors below ~2 would quarantine healthy chains
        on sketch variance alone.
    """

    degree: int = 2
    sketch_dim: int = 8
    iterations: int = 5
    warm_alpha_iters: int = 0
    alpha_bounds: Optional[Tuple[float, float]] = None
    use_kernels: bool = False
    dtype: str = "float32"
    fuse: str = "auto"
    vmem_budget: int = 0
    tol: Optional[float] = None
    divergence_factor: float = 10.0

    def __post_init__(self):
        if self.fuse not in ("auto", "on", "off"):
            raise ValueError(f"PrismConfig.fuse must be auto|on|off, "
                             f"got {self.fuse!r}")
        if self.tol is not None and not self.tol > 0.0:
            raise ValueError(f"PrismConfig.tol must be positive or None, "
                             f"got {self.tol!r}")
        if not self.divergence_factor > 1.0:
            raise ValueError(f"PrismConfig.divergence_factor must be > 1 "
                             f"(the §15 detector compares est_r against "
                             f"factor x best-so-far), got "
                             f"{self.divergence_factor!r}")

    @property
    def bounds(self) -> Tuple[float, float]:
        if self.alpha_bounds is not None:
            return self.alpha_bounds
        return {1: (0.5, 1.0), 2: (3.0 / 8.0, 29.0 / 20.0)}[self.degree]

    @property
    def precision(self) -> "MatfnPrecision":
        """The full precision policy implied by ``dtype`` (accumulate and
        fit pinned fp32 by construction)."""
        return MatfnPrecision(compute=self.dtype)


# ---------------------------------------------------------------------------
# Model


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    num_experts_per_tok: int = 2
    # "expert": shard expert dim over the model axis (EP);
    # "tensor": shard each expert's hidden dim over the model axis (TP).
    sharding: str = "expert"
    router_aux_loss_coef: float = 0.01
    # per-expert slot budget C = ceil(k*T/E * capacity_factor); tokens over
    # budget are dropped (standard Switch/GShard semantics).  Set to
    # num_experts for drop-free routing (exact but unbalanced memory).
    capacity_factor: float = 1.25
    # "global": one dispatch over all B*S tokens (baseline; the gather
    # crosses data shards -> all-gathers of the token stream).
    # "per_sample": dispatch within each sequence -> gathers stay local to
    # the batch shard (§Perf MoE iteration); capacity is per sample.
    dispatch: str = "global"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent-block config (RG-LRU + local attention)."""

    lru_width: int = 0          # 0 => d_model
    conv_dim: int = 4
    attention_window: int = 2048
    # block pattern period: `pattern` entries cycle over layers
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int = 12
    head_dim: int = 0  # 0 => d_model // num_heads
    d_ff: int = 3072
    vocab_size: int = 50257
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    mlp_act: str = "silu"  # silu (SwiGLU) | gelu
    sliding_window: int = 0  # 0 => full causal attention
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # audio (decoder over EnCodec tokens)
    num_codebooks: int = 0  # 0 => ordinary single-vocab LM
    # vlm (stub frontend): number of precomputed patch embeddings prepended
    num_patches: int = 0
    vision_dim: int = 1152  # dim of the (stubbed) precomputed patch embeds
    logits_softcap: float = 0.0
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) embed scale
    emb_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    remat: str = "block"  # none | block (checkpoint each scanned block)
    scan_layers: bool = True
    # seq-chunk size for the chunked CE loss; larger chunks amortize the
    # LM-head all-gather across more tokens (ZeRO-3; §Perf iteration 4)
    loss_chunk: int = 512

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if serving memory does not grow with full seq_len attention."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Optimizer


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "muon"  # muon | shampoo | adamw
    learning_rate: float = 6e-3
    weight_decay: float = 0.01
    momentum: float = 0.95
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    # muon
    matfn_method: str = "prism"  # prism | polar_express | newton_schulz | eigh
    prism: PrismConfig = field(default_factory=lambda: PrismConfig(
        degree=2, iterations=3, warm_alpha_iters=3))
    # mixed-precision matrix-function engine (DESIGN.md §9): COMPUTE dtype
    # of the whole matfn stack — bucket gathers, NS/inverse-root chains,
    # sketch chains.  "bfloat16" halves chain HBM reads; accumulation and
    # the PRISM fit stay fp32 regardless (MatfnPrecision pins them).
    # "float32" (default) defers to prism.dtype untouched.
    matfn_dtype: str = "float32"
    # shared-memory budget (bytes) of one fused-tier block (DESIGN.md
    # §10).  0 selects the card's per-block maximum; threads into
    # resolved_prism so bucketing and the iteration families share one
    # number.  The tier itself stays per-bucket automatic (prism.fuse).
    vmem_budget: int = 0
    # adaptive early stopping (DESIGN.md §11): convergence certificate for
    # the fitted matfn iterations — a bucket slice freezes once its
    # sketched residual estimate drops to tol, so prism.iterations becomes
    # a budget instead of a fixed cost.  None keeps fixed-iters chains.
    # Threads into resolved_prism; per-leaf iters_used telemetry lands in
    # the Muon/Shampoo state whenever a tol is set (matfn_telemetry).
    matfn_tol: Optional[float] = None
    # dtype of the staleness caches carried in the optimizer state (Muon
    # "ortho", Shampoo "Linv"/"Rinv").  "auto" follows matfn_dtype —
    # bf16 halves cached optimizer state; sharding rules are unchanged
    # (launch/sharding.py::precond_cache_sharding is dtype-independent).
    precond_cache_dtype: str = "auto"  # auto | float32 | bfloat16
    adamw_lr_scale: float = 0.05   # lr scale for non-matrix params under muon
    # shampoo
    precondition_every: int = 1
    max_precond_dim: int = 2048
    shampoo_eps: float = 1e-6
    grad_clip_norm: float = 1.0
    # shape-bucketed batched matrix-function engine (optim/bucketing.py):
    # stack same-shape matrix leaves into one [B, m, n] call per bucket
    # instead of a Python loop of per-leaf polar/sqrtm calls.  bucket_pad
    # additionally merges near-miss shapes into a shared padded bucket
    # (Muon/polar only; exact — see DESIGN.md §7) when the padded area
    # overhead stays below bucket_pad_slack.
    bucketed: bool = True
    bucket_pad: bool = False
    bucket_pad_slack: float = 0.25
    # mesh-sharded preconditioner engine (DESIGN.md §8): partition each
    # bucket's [B, m, n] batch dim over the (pod, data) mesh axes via
    # shard_map — each device runs the fitted PRISM/NS chain only on its
    # slice, then all-gathers the bucket.  "auto" activates whenever an
    # activation-sharding context with a >1-sized batch axis is installed
    # (launcher / multi-device tests); "off" keeps the replicated dispatch.
    precond_shard: str = "auto"  # auto | off
    # staleness-scheduled refresh: recompute matrix preconditioners (Muon
    # polar factors, Shampoo inverse roots) every K steps and serve the
    # K-1 steps in between from caches carried in the optimizer state.
    # Exact at step 0 (count % K == 0 refreshes, so the first step always
    # computes).  1 => refresh every step; Muon then carries no cache.
    # Shampoo's effective period is max(precond_every, precondition_every)
    # (the latter is the legacy Shampoo-only knob); use
    # optim.base.resolve_refresh_period for the resolved K.
    precond_every: int = 1
    # async preconditioner service (DESIGN.md §12): double-buffered
    # refresh plane.  Matrix-function chains NEVER run inside the train
    # step — each Muon/Shampoo state carries an ACTIVE preconditioner
    # buffer (consumed every step) and a PENDING one, recomputed by a
    # separately jitted ``Optimizer.refresh`` dispatched between steps
    # without blocking and swapped in ``precond_swap_delay`` steps later
    # under a lax.cond.  Steady-state steps then compile with zero matfn
    # launches.  Requires precond_every > 1 (the fixed refresh clock stays
    # as the staleness ceiling).
    precond_async: bool = False
    # steps between the async refresh DISPATCH and the pending->active
    # buffer swap: the window the refresh chains have to complete behind
    # forward/backward before any step consumes them.
    precond_swap_delay: int = 1
    # drift-triggered refresh (DESIGN.md §12): with matfn_tol set, the
    # optimizer state tracks a first-order proxy for the cached
    # preconditioner's residual drift (accumulated relative movement of
    # the matrix the cache was computed from) and a refresh is dispatched
    # as soon as the estimated cached residual tol + drift crosses
    # matfn_tol * precond_drift_slack — instead of waiting for the fixed
    # precond_every clock, which remains the ceiling.  0 disables the
    # trigger (pure clock schedule).
    precond_drift_slack: float = 0.0
    # distributed tricks
    gradient_compression: str = "none"  # none | int8
    # "bfloat16": differentiate wrt the bf16 compute params so the data-
    # parallel gradient reduction moves bf16 on the wire (fp32 master
    # update unchanged); "float32": reduce in fp32 (baseline).
    grads_dtype: str = "float32"
    # reshard stacked momentum matrices to (layers->model, rows->data)
    # before the polar iteration: Newton-Schulz runs with one small R-psum
    # instead of full cross-mesh GEMM collectives (§Perf iteration 3).
    muon_local_reshard: bool = False
    # low-rank sketched orthogonalization tier (DESIGN.md §14): views too
    # large or too rectangular for the cubic polar path (embedding,
    # LM-head, MoE-expert tables) orthogonalize in a sketched top-k
    # subspace at O(mnl) — a randomized rangefinder builds Q in R^{m x l}
    # (l = lowrank_rank + lowrank_oversample), the existing fitted
    # PRISM-NS polar runs on the projected [l, n] view, and the result
    # lifts back through Q.  lowrank_rank=0 (default) disables the tier;
    # with rank > 0 Muon additionally CLAIMS vocab/codebook leaves that
    # otherwise fall through to the AdamW path (base.is_matrix_param).
    lowrank_rank: int = 0
    # planner thresholds (optim/bucketing.py::resolve_lowrank_tier): a
    # bucket routes through the lowrank tier when its max view dim
    # exceeds lowrank_max_dim OR its aspect ratio max/min reaches
    # lowrank_aspect — and the modeled projected-chain FLOPs actually
    # beat the cubic path (kernels/ops.py::lowrank_polar_flops).
    lowrank_max_dim: int = 4096
    lowrank_aspect: float = 4.0
    lowrank_oversample: int = 8
    # numerics guardian (DESIGN.md §15): skip-step protection.  When on,
    # the optimizer update still computes unconditionally, but ONE fused
    # finiteness check over grads + proposed state gates the state write
    # under a single lax.cond — a non-finite step leaves params/momentum
    # bitwise untouched and bumps the ``bad_steps`` counter carried in
    # the optimizer state.  Adds zero matfn launches (the check is a
    # scalar reduction fused into the step program); off by default so
    # existing state trees stay bit-identical.
    skip_nonfinite: bool = False
    # async refresh validation (DESIGN.md §15): consecutive validation
    # failures a pending-buffer slot may accumulate — each failure
    # discards the poisoned pending twin (never swapped) and re-dispatches
    # with capped exponential backoff — before the service stops retrying
    # and DEGRADES the slot to its last good active buffer until the next
    # clock-period refresh.
    precond_max_retries: int = 3

    def __post_init__(self):
        if self.precond_async and self.precond_every <= 1:
            raise ValueError(
                "precond_async requires precond_every > 1: the fixed "
                "refresh clock is the staleness ceiling of the async "
                "service (DESIGN.md §12)")
        if self.precond_swap_delay < 0:
            raise ValueError("precond_swap_delay must be >= 0, got "
                             f"{self.precond_swap_delay!r}")
        if self.precond_drift_slack < 0:
            raise ValueError("precond_drift_slack must be >= 0, got "
                             f"{self.precond_drift_slack!r}")
        if self.precond_drift_slack > 0 and self.matfn_tol is None:
            raise ValueError(
                "precond_drift_slack needs matfn_tol: the drift trigger "
                "threshold is matfn_tol * precond_drift_slack — the "
                "certificate units of DESIGN.md §11/§12")
        if self.lowrank_rank < 0:
            raise ValueError(f"lowrank_rank must be >= 0 (0 disables the "
                             f"§14 tier), got {self.lowrank_rank!r}")
        if self.lowrank_oversample < 0:
            raise ValueError(f"lowrank_oversample must be >= 0, got "
                             f"{self.lowrank_oversample!r}")
        if self.lowrank_max_dim < 1:
            raise ValueError(f"lowrank_max_dim must be >= 1, got "
                             f"{self.lowrank_max_dim!r}")
        if self.lowrank_aspect < 1.0:
            raise ValueError(f"lowrank_aspect must be >= 1.0, got "
                             f"{self.lowrank_aspect!r}")
        if self.precond_max_retries < 0:
            raise ValueError(f"precond_max_retries must be >= 0, got "
                             f"{self.precond_max_retries!r}")
        if self.lowrank_rank and self.matfn_method not in (
                "prism", "newton_schulz"):
            raise ValueError(
                "lowrank_rank needs an NS-family matfn_method (prism | "
                "newton_schulz): the §14 tier runs the fitted chains in "
                f"the projected subspace, got {self.matfn_method!r}")

    @property
    def drift_threshold(self) -> Optional[float]:
        """Drift value at which the async service dispatches a refresh
        (DESIGN.md §12), or None when the trigger is disabled: the
        estimated residual of the CACHED preconditioner — its refresh
        certificate (<= matfn_tol, §11) plus the accumulated relative
        drift of the underlying matrix — crosses
        ``matfn_tol * precond_drift_slack``, i.e. the drift proxy alone
        crosses ``matfn_tol * (precond_drift_slack - 1)``."""
        if not (self.precond_async and self.precond_drift_slack > 0
                and self.matfn_tol is not None):
            return None
        return self.matfn_tol * max(self.precond_drift_slack - 1.0, 0.0)

    @property
    def resolved_prism(self) -> PrismConfig:
        """PrismConfig with ``matfn_dtype`` (and ``vmem_budget``) threaded
        in.  The default matfn_dtype="float32" leaves an explicitly
        configured prism.dtype alone."""
        out = self.prism
        if self.matfn_dtype != "float32" and \
                self.matfn_dtype != out.dtype:
            out = dataclasses.replace(out, dtype=self.matfn_dtype)
        if self.vmem_budget and self.vmem_budget != out.vmem_budget:
            out = dataclasses.replace(out, vmem_budget=self.vmem_budget)
        if self.matfn_tol is not None and self.matfn_tol != out.tol:
            out = dataclasses.replace(out, tol=self.matfn_tol)
        return out

    @property
    def matfn_telemetry(self) -> bool:
        """True when the optimizer should carry per-leaf ``iters_used``
        telemetry in its state (DESIGN.md §11): an adaptive tol is set
        and the method actually runs fitted (certifiable) iterations."""
        return (self.resolved_prism.tol is not None
                and self.matfn_method == "prism")

    @property
    def matfn_precision(self) -> MatfnPrecision:
        return self.resolved_prism.precision

    @property
    def cache_dtype(self) -> str:
        """Storage dtype of the precond_every staleness caches."""
        if self.precond_cache_dtype == "auto":
            return self.resolved_prism.dtype
        return self.precond_cache_dtype


# ---------------------------------------------------------------------------
# Mesh / shapes / training


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    data_axis: int = 16
    model_axis: int = 16
    num_pods: int = 2

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.multi_pod:
            return (self.num_pods, self.data_axis, self.model_axis)
        return (self.data_axis, self.model_axis)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        if self.multi_pod:
            return ("pod", "data", "model")
        return ("data", "model")


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    kind: str = "train"  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    # None: no checkpoints and no HEARTBEAT (the Trainer writes nothing)
    checkpoint_dir: Optional[str] = None
    async_checkpoint: bool = True
    seed: int = 0
    straggler_slack: float = 3.0  # flag steps slower than slack x median
    keep_checkpoints: int = 3
    # 1F1B pipeline parallelism over the "pod" mesh axis (launch/pipeline.py):
    # >1 slices the layer stack into that many stages; n_micro microbatches
    # fill the schedule (bubble fraction 2(S-1)/(n_micro+2(S-1))).
    pipeline_stages: int = 1
    n_micro: int = 4

    def __post_init__(self):
        if self.pipeline_stages < 1:
            raise ValueError("pipeline_stages must be >= 1")
        if self.pipeline_stages > 1 and self.n_micro < 1:
            raise ValueError("n_micro must be >= 1 when pipelining")
