"""Serving plane of the port (counterpart of ``repro/serving``): the
continuous-batching ``Engine``, the prefill and decode steps with
sampling, and the seeded load generator."""
from repro_torch.serving.decode import (make_prefill_step, make_serve_step,
                                        sample_logits)
from repro_torch.serving.engine import (Completion, Engine, EngineConfig,
                                        RunResult, pow2_pad)
from repro_torch.serving.loadgen import Request, make_trace

__all__ = [
    "Completion", "Engine", "EngineConfig", "Request", "RunResult",
    "make_prefill_step", "make_serve_step", "make_trace", "pow2_pad",
    "sample_logits",
]
