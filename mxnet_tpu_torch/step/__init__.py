"""The fused whole-train-step compiler of the port.

Counterpart of ``mxnet_tpu/step/``:

- :class:`~mxnet_tpu_torch.step.stepfn.StepFunction` — forward, backward,
  gradient exchange and the multi-tensor optimizer update as one function
  of the step's inputs, captured on CUDA as one CUDA graph per input
  signature and replayed, with hit/miss counters in the telemetry
  registry; ``gluon.Trainer.fuse_step`` makes one;
- :mod:`~mxnet_tpu_torch.step.buckets` — size-capped flat gradient
  buckets for the gradient exchange;
- :mod:`~mxnet_tpu_torch.step.cache` — the persistent kernel cache behind
  ``MXNET_COMPILE_CACHE_DIR``.

``step/tunables.py`` (the step's knobs in ``tune.space``) waits for
ROADMAP Queue A item 8.
"""
from __future__ import annotations

from .buckets import GradientBuckets  # noqa: F401
from .cache import enable_compile_cache, maybe_enable_compile_cache  # noqa: F401
from .stepfn import StepFunction  # noqa: F401

__all__ = ["StepFunction", "GradientBuckets", "enable_compile_cache",
           "maybe_enable_compile_cache"]
