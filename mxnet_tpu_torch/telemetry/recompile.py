"""Program-signature record: why each new program was made.

Counterpart of ``mxnet_tpu/telemetry/recompile.py``. PyTorch compiles
nothing for an eager call, so a "program" here is what an entry point
keeps per input signature: a padded serving signature (``ServingEngine``,
``PagedLM``), or a captured CUDA graph of the fused training step
(``StepFunction``, kind ``fused_step``). Each miss is recorded with its
signature, diffed against the entry's earlier ones and classified:

- ``first-compile``    — the entry's first signature;
- ``shape-change``     — same dtypes and arity, other dims;
- ``dtype-change``     — same shapes, other dtypes;
- ``train-flag``       — only the training flag differs;
- ``cache-evicted``    — a signature seen before, made again;
- ``key-change``       — the same inputs and flag, but a non-shape key
                         moved (the fused step's parameter dtypes,
                         optimizer scalars or parameter storage);
- ``signature-change`` — arity or structure changed.

Each record feeds the ``recompile_total`` counter and a bounded ring that
:func:`recompile_report` returns. The profiler's instant events wait for
the profiler (ROADMAP Queue A item 8).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from . import metrics as _metrics

__all__ = ["record_recompile", "recompile_count", "recompile_report",
           "reset_recompiles", "signature_of"]

_LOCK = threading.Lock()
_HISTORY: Dict[str, List[dict]] = {}   # entry -> [signature, ...]
_RECORDS: List[dict] = []              # ring of records
_MAX_RECORDS = 512


def signature_of(inputs, training: Optional[bool] = None) -> dict:
    """A program key as ``{"inputs": [{"shape", "dtype"}...]}`` plus the
    training flag."""
    sig = {"inputs": [{"shape": list(getattr(a, "shape", ())),
                       "dtype": str(getattr(a, "dtype", "?"))}
                      for a in inputs]}
    if training is not None:
        sig["training"] = bool(training)
    return sig


def _classify(entry: str, sig: dict) -> str:
    prior = _HISTORY.get(entry)
    if not prior:
        return "first-compile"
    s_in = sig.get("inputs")
    same_inputs = [p for p in prior if p.get("inputs") == s_in]
    same_train = [p for p in same_inputs
                  if p.get("training") == sig.get("training")]
    if any(p == sig for p in same_train):
        return "cache-evicted"
    if same_train:
        return "key-change"
    if same_inputs:
        return "train-flag"
    for p in prior:
        p_in = p.get("inputs") or []
        if s_in is None or len(p_in) != len(s_in):
            continue
        shapes_differ = any(a["shape"] != b["shape"]
                            for a, b in zip(p_in, s_in))
        dtypes_differ = any(a["dtype"] != b["dtype"]
                            for a, b in zip(p_in, s_in))
        if shapes_differ and not dtypes_differ:
            return "shape-change"
        if dtypes_differ and not shapes_differ:
            return "dtype-change"
    return "signature-change"


def record_recompile(entry: str, signature: dict,
                     kind: str = "serving") -> dict:
    """Record one new program signature of ``entry``; returns the
    classified record."""
    with _LOCK:
        reason = _classify(entry, signature)
        _HISTORY.setdefault(entry, []).append(signature)
        record = {"entry": entry, "kind": kind, "reason": reason,
                  "signature": signature, "ts": time.time(),
                  "n_for_entry": len(_HISTORY[entry])}
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


def reset_recompiles():
    """Forget every entry's history and record (the counter stays
    monotone)."""
    with _LOCK:
        _HISTORY.clear()
        _RECORDS.clear()
