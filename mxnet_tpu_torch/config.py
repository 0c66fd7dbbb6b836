"""Typed flags of the port: the flags its modules read.

Counterpart of ``mxnet_tpu/config.py``, holding the ``MXSERVE_*`` flags
the serving engine and batcher read and the optimizer's
``MXNET_OPTIMIZER_AGGREGATION_SIZE``. Resolution order: :func:`set_flag`
runtime override > environment > declared default.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict

__all__ = ["Flag", "get", "set_flag", "unset_flag"]


@dataclass(frozen=True)
class Flag:
    name: str
    type: type
    default: Any
    doc: str


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
    Flag("MXNET_OPTIMIZER_AGGREGATION_SIZE", int, 4,
         "Parameters per aggregated update (Optimizer.update_multi) for "
         "optimizers with a fused_apply; clamped to 1-45. Multi-precision "
         "SGD with momentum updates all fp16 parameters in one launch "
         "whatever it is."),
)}
_OVERRIDES: Dict[str, Any] = {}
_LOCK = threading.Lock()


def get(name: str) -> Any:
    """Resolve a registered flag: override > environment > default."""
    f = _FLAGS[name]
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    raw = os.environ.get(name)
    return f.default if raw is None else f.type(raw)


def set_flag(name: str, value: Any) -> None:
    """Runtime override (highest precedence)."""
    f = _FLAGS[name]
    with _LOCK:
        _OVERRIDES[name] = value if isinstance(value, f.type) \
            else f.type(value)


def unset_flag(name: str) -> None:
    with _LOCK:
        _OVERRIDES.pop(name, None)
