"""Typed flags of the port: the flags its modules read.

Counterpart of ``mxnet_tpu/config.py``, holding the ``MXSERVE_*`` flags
the serving engine and batcher read, the ``MXSERVE2_*`` and ``MXSERVE3_*``
flags of the decode tier (``serve2/``), the circuit breaker's
``MXRESIL_BREAKER_*``, the optimizer's
``MXNET_OPTIMIZER_AGGREGATION_SIZE``, the nd ops'
``MXNET_SAFE_ACCUMULATION``, the sparse storage's
``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``, and the fused step's
``MXNET_GRAD_BUCKET_BYTES``, ``MXNET_EAGER_SYNC`` and
``MXNET_COMPILE_CACHE_DIR`` with the engine's ``MXNET_ENGINE_TYPE``,
and the native input pipeline's ``MXNET_CPU_WORKER_NTHREADS``.
Resolution order: :func:`set_flag` runtime override > environment >
declared default. :func:`generation` counts the overrides, for the
per-op dispatch that caches a flag against it.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

__all__ = ["Flag", "get", "set_flag", "unset_flag", "generation"]


@dataclass(frozen=True)
class Flag:
    name: str
    type: type
    default: Any
    doc: str
    choices: Optional[tuple] = None


_FLAGS: Dict[str, Flag] = {f.name: f for f in (
    Flag("MXSERVE_BUCKETS", str, "1,2,4,8,16,32",
         "Shape-bucket ladder (serve.buckets.default_ladder): batch rungs "
         "as a comma list, or named axes as 'batch:1,2,4,8;seq:16,32,64' "
         "where axis<k> addresses batched-array axis k (seq = axis1)."),
    Flag("MXSERVE_MAX_LINGER_MS", float, 2.0,
         "Max milliseconds the batcher waits for co-batchable requests "
         "before dispatching a partial batch."),
    Flag("MXSERVE_QUEUE_DEPTH", int, 256,
         "Bounded serving-queue capacity; a submit against a full queue "
         "raises QueueFullError."),
    Flag("MXSERVE_MAX_BATCH", int, 0,
         "Row cap per serving dispatch. 0 = the ladder's top batch rung."),
    Flag("MXSERVE2_PAGE_SIZE", int, 16,
         "KV-cache page width in tokens of the continuous-batching tier "
         "(serve2.kvcache): admit/finish/preempt never change the decode "
         "programs' shapes."),
    Flag("MXSERVE2_NUM_PAGES", int, 256,
         "Pages in a serve2 KV pool (page 0 is the reserved null page); "
         "running out under load preempts the youngest sequence."),
    Flag("MXSERVE2_MAX_INFLIGHT", int, 8,
         "Sequences one serve2 DecodeEngine decodes at once; the decode "
         "batch rungs are the powers of two up to it."),
    Flag("MXSERVE2_REPLICAS", int, 2,
         "Default replicas per model group of a serve2 Router."),
    Flag("MXSERVE2_RELOAD_DRAIN_TIMEOUT_S", float, 30.0,
         "Per-replica drain budget of Router.rolling_reload; requests "
         "still queued after it count as dropped."),
    Flag("MXSERVE2_DECODE_STEPS", int, 4,
         "Decode iterations per serve2 decode call (n-step scheduling); "
         "admit/preempt/finish coarsen to this many tokens."),
    Flag("MXSERVE2_PREFILL_BUCKETS", str, "16,32,64",
         "Prompt-length rungs of the serve2 prefill (comma list); longer "
         "prompts are rejected at submit."),
    Flag("MXSERVE3_PREFIX_CACHE", bool, False,
         "Prefix caching in serve2 DecodeEngines: full prompt pages are "
         "content-hashed and shared (refcounted, copy-on-write); greedy "
         "outputs are unchanged."),
    Flag("MXSERVE3_PREFIX_CACHE_PAGES", int, 0,
         "Cap on pages the prefix cache may pin (0 = no cap; pool "
         "pressure still evicts LRU cache pages before preemption)."),
    Flag("MXSERVE3_SPEC_TOKENS", int, 0,
         "Draft tokens proposed per speculative tick when a DecodeEngine "
         "has draft_params (0 = off); greedy acceptance is exact."),
    Flag("MXSERVE3_KV_DTYPE", str, "f32",
         "Storage type of the serve2 KV pools: 'f32', 'bf16' (quant_bf16 "
         "class) or 'int8' (per-slot f32 scales, quant_int8 class).",
         choices=("f32", "bf16", "int8")),
    Flag("MXRESIL_BREAKER_FAILURES", int, 5,
         "Consecutive failures that open a circuit breaker "
         "(resil.policy.CircuitBreaker)."),
    Flag("MXRESIL_BREAKER_COOLDOWN_S", float, 30.0,
         "Seconds an open circuit breaker waits before one half-open "
         "probe."),
    Flag("MXNET_OPTIMIZER_AGGREGATION_SIZE", int, 4,
         "Parameters per aggregated update (Optimizer.update_multi) for "
         "optimizers with a fused_apply; clamped to 1-45. Multi-precision "
         "SGD with momentum updates all fp16 parameters in one launch "
         "whatever it is."),
    Flag("MXNET_SAFE_ACCUMULATION", int, 0,
         "1: the nd reductions and softmax of 16-bit floats accumulate "
         "in fp32 and round the result back."),
    Flag("MXNET_STORAGE_FALLBACK_LOG_VERBOSE", bool, True,
         "Warn (once per op) when a sparse input runs through an op's "
         "dense implementation (ref: env_var.md:30)."),
    Flag("MXNET_GRAD_BUCKET_BYTES", int, 4 << 20,
         "Byte cap of one flat gradient bucket (step.GradientBuckets): "
         "parameters of one dtype share a bucket up to it. No step reads "
         "the buckets yet: the trainer's bucketed exchange comes with "
         "the distribution slice (ROADMAP Queue A item 6)."),
    Flag("MXNET_EAGER_SYNC", bool, False,
         "Block after every eager op (engine.eager_sync, read by the op "
         "dispatch, ops.registry.call_op): a device error surfaces at "
         "the op that raised it."),
    Flag("MXNET_COMPILE_CACHE_DIR", str, "",
         "Directory of the persistent kernel cache: the nvcc-built "
         "libraries of csrc/, keyed by source digest (empty: _build/ "
         "beside the package)."),
    Flag("MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice",
         "'NaiveEngine' makes dispatch synchronous (engine.is_sync): "
         "every eager op blocks, as under MXNET_EAGER_SYNC."),
    Flag("MXNET_CPU_WORKER_NTHREADS", int, 1,
         "Sizes the native record pipeline's thread pool where the caller "
         "gives no count (native/: max(2, this), as the JAX package's)."),
)}
_OVERRIDES: Dict[str, Any] = {}
_LOCK = threading.Lock()
_GEN = [0]  # bumped on every runtime override


def generation() -> int:
    """How many overrides were set or unset so far: a value cached
    against it is stale once it moves."""
    return _GEN[0]


def get(name: str) -> Any:
    """Resolve a registered flag: override > environment > default."""
    f = _FLAGS[name]
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    raw = os.environ.get(name)
    if raw is None:
        return f.default
    if f.type is bool:
        return raw.strip().lower() not in ("0", "false", "no", "off", "")
    val = f.type(raw)
    if f.choices and val not in f.choices:
        raise ValueError(f"{name}={val!r} not in {f.choices}")
    return val


def set_flag(name: str, value: Any) -> None:
    """Runtime override (highest precedence)."""
    f = _FLAGS[name]
    value = value if isinstance(value, f.type) else f.type(value)
    if f.choices and value not in f.choices:
        raise ValueError(f"{name}={value!r} not in {f.choices}")
    with _LOCK:
        _OVERRIDES[name] = value
        _GEN[0] += 1


def unset_flag(name: str) -> None:
    with _LOCK:
        _OVERRIDES.pop(name, None)
        _GEN[0] += 1
