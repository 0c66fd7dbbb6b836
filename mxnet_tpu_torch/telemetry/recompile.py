"""Program-signature record: the serving engine's recompile audit.

Counterpart of ``mxnet_tpu/telemetry/recompile.py``, reduced to what
``ServingEngine`` keeps. PyTorch runs eagerly and compiles nothing, so a
"program" here is one padded input signature: each new signature is
recorded once, and one seen after ``warmup()`` is the alarm that the
bucket ladder let a request through off its closed set of shapes.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

from . import metrics as _metrics

__all__ = ["record_recompile", "recompile_count", "recompile_report"]

_LOCK = threading.Lock()
_HISTORY: Dict[str, int] = {}     # entry -> signatures recorded
_RECORDS: List[dict] = []         # ring of records
_MAX_RECORDS = 512


def record_recompile(entry: str, signature: dict,
                     kind: str = "serving") -> dict:
    """Record one new program signature of ``entry``."""
    with _LOCK:
        n = _HISTORY[entry] = _HISTORY.get(entry, 0) + 1
        record = {"entry": entry, "kind": kind, "signature": signature,
                  "ts": time.time(), "n_for_entry": n}
        _RECORDS.append(record)
        del _RECORDS[:-_MAX_RECORDS]
    _metrics.counter("recompile_total",
                     "new program signatures across entry points").inc()
    return record


def recompile_count() -> int:
    return _metrics.counter("recompile_total").value()


def recompile_report() -> List[dict]:
    """The recorded signatures, oldest first (bounded ring)."""
    with _LOCK:
        return list(_RECORDS)
