"""ServingEngine: a warmed, bucketed, batched inference unit.

Counterpart of ``mxnet_tpu/serve/engine.py``. One engine owns one model
and everything between a request and the device:

- the **bucket ladder** (:mod:`~mxnet_tpu_torch.serve.buckets`) that pads
  every dispatch onto a closed set of shapes;
- the **dynamic batcher** (:mod:`~mxnet_tpu_torch.serve.batcher`) that
  coalesces concurrent requests into one dispatch;
- the **program record**: PyTorch runs eagerly, so a "program" is one
  padded input signature. :meth:`warmup` runs every ladder rung once, and
  a signature first seen after it counts in ``recompiles_after_warmup``
  (the alarm that should stay 0);
- **reusable staging buffers**: a pair of host staging buffers per
  signature alternates across dispatches — no per-dispatch allocation,
  and one dispatch of headroom for an asynchronous host-to-device copy
  (the copy from these pageable buffers is synchronous today);
- **device-side unpadding**: each request's rows and real positions are
  sliced out of the padded outputs on the device, and only those go to
  the host, asynchronously into one reused pinned buffer, with one sync
  per dispatch (the JAX package copies the whole padded bucket and
  unpads on the host).

Two model kinds are accepted: a ``torch.nn.Module`` (put in eval mode and
run under ``torch.inference_mode``) and any plain callable over tensors.
Inputs are copied to ``device`` (default ``"cuda"``; a host without a GPU
raises unless the caller passes ``device="cpu"``).

Determinism contract: the engine pads with a constant, so for
batch-independent models a request's result depends only on the bucket
it landed in, not on which requests shared its dispatch.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..telemetry import metrics as _metrics
from ..telemetry import recompile as _recompile
from .. import config
from .batcher import DynamicBatcher, Request
from .buckets import BucketLadder, default_ladder

__all__ = ["ServingEngine", "InputSpec"]


class InputSpec:
    """Shape/dtype of ONE request item (no batch axis)."""

    __slots__ = ("shape", "dtype", "name")

    def __init__(self, shape: Sequence[int], dtype: str = "float32",
                 name: str = "data"):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = str(dtype)
        self.name = name

    def __repr__(self):
        return f"InputSpec({self.name}: {self.shape}, {self.dtype})"


def _as_specs(input_specs) -> List[InputSpec]:
    specs = []
    for i, s in enumerate(input_specs):
        if isinstance(s, InputSpec):
            specs.append(s)
        elif isinstance(s, dict):
            specs.append(InputSpec(**s))
        else:  # bare shape tuple
            specs.append(InputSpec(s, name="data" if i == 0 else f"data{i}"))
    return specs


def _unpad_output(rows: np.ndarray,
                  orig_items: Sequence[Tuple[int, ...]],
                  padded_items: Sequence[Tuple[int, ...]]) -> np.ndarray:
    """Slice non-batch padding back out of an output block.

    ``orig_items``/``padded_items`` are the request's per-INPUT item
    shapes (no batch axis), aligned. Heuristic: an output axis is
    sliced to an input's original extent when its size equals that
    input's PADDED extent on the same axis and the original was
    smaller — i.e. the model preserved that axis (sequence models);
    the first input that matches decides. Axes the model reshaped are
    left alone. Engines with exotic output geometry pass ``unpad=``
    to override (same signature).
    """
    idx = [slice(None)] * rows.ndim
    changed = False
    for ax in range(1, rows.ndim):
        k = ax - 1
        for orig, padded in zip(orig_items, padded_items):
            if k < len(padded) and rows.shape[ax] == padded[k] \
                    and orig[k] < padded[k]:
                idx[ax] = slice(0, orig[k])
                changed = True
                break
    return rows[tuple(idx)] if changed else rows


class ServingEngine:
    """Request-level inference over one model. See the module docstring.

    Parameters
    ----------
    model : torch.nn.Module | callable over tensors
    input_specs : list of InputSpec/shape-tuples, per-item (no batch axis).
        Required for :meth:`warmup`; inferred from the first request
        otherwise.
    ladder : BucketLadder, default from ``MXSERVE_BUCKETS``.
    batching : bool — route ``predict`` through the dynamic batcher
        (default True). False = direct dispatch (still bucketed).
    unpad : optional ``f(rows, orig_items, padded_items)`` overriding
        the output-unpadding heuristic (see :func:`_unpad_output`);
        ``rows`` is a request's block of a device output (a tensor),
        and the hook returns a slice of it.
    device : where the model runs, default ``"cuda"``.
    """

    def __init__(self, model, input_specs=None,
                 ladder: Optional[BucketLadder] = None,
                 name: Optional[str] = None,
                 max_batch_size: Optional[int] = None,
                 max_linger_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 batching: bool = True,
                 pad_value: float = 0.0,
                 unpad: Optional[Callable] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.ladder = ladder if ladder is not None else default_ladder()
        self.name = name or type(model).__name__
        self.input_specs: Optional[List[InputSpec]] = \
            _as_specs(input_specs) if input_specs is not None else None
        self.pad_value = float(pad_value)
        self._unpad = unpad or _unpad_output
        self._lock = threading.Lock()       # program/staging caches
        self._warmed = False
        self._seen_programs: set = set()    # full padded signatures
        self._staging: Dict[Tuple, List[List[np.ndarray]]] = {}
        self._staging_flip: Dict[Tuple, int] = {}
        self._host_lock = threading.Lock()  # the pinned result buffers
        self._pinned: Dict[torch.dtype, torch.Tensor] = {}
        self._warmup_report: List[dict] = []
        self._after_warmup_count = 0  # per-engine; the registry counter
        # below is the process-global aggregate across all engines
        self._m_after = _metrics.counter(
            "mxserve_recompile_after_warmup_total",
            "padded program signatures first seen after warmup declared "
            "the set closed — should stay 0")
        self._m_pad = _metrics.histogram(
            "mxserve_padding_ratio",
            "padded rows / real rows per dispatch (bucket efficiency)")
        self._pad_sum = 0.0  # per-engine; the histogram is process-global
        self._pad_n = 0
        if isinstance(model, torch.nn.Module):
            self._kind = "module"
            model.eval()
        elif callable(model):
            self._kind = "callable"
        else:
            raise MXNetError(
                f"ServingEngine cannot serve a {type(model).__name__}; "
                "pass a torch.nn.Module or a callable")
        # row cap per dispatch: explicit arg > MXSERVE_MAX_BATCH flag >
        # the ladder's top batch rung; never above the top rung (a
        # dispatch larger than the biggest warmed signature)
        if max_batch_size is None:
            max_batch_size = int(config.get("MXSERVE_MAX_BATCH")) \
                or self.ladder.max_batch
        max_rows = min(int(max_batch_size), self.ladder.max_batch)
        self.batcher: Optional[DynamicBatcher] = DynamicBatcher(
            self._dispatch_group, max_batch_size=max_rows,
            max_linger_ms=max_linger_ms, queue_depth=queue_depth,
            name=self.name) if batching else None

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _group_key(self, arrays: List[np.ndarray]) -> Tuple:
        return self.ladder.signature(arrays)

    def _staging_for(self, full_sig: Tuple,
                     shapes: List[Tuple[int, ...]],
                     dtypes: List[str]) -> List[np.ndarray]:
        """Two host staging sets per signature, alternated per dispatch:
        reuse avoids per-dispatch allocation, and the flip gives one
        dispatch of headroom (see the module docstring)."""
        pair = self._staging.get(full_sig)
        if pair is None:
            pair = [
                [np.empty(s, d) for s, d in zip(shapes, dtypes)],
                [np.empty(s, d) for s, d in zip(shapes, dtypes)],
            ]
            self._staging[full_sig] = pair
            self._staging_flip[full_sig] = 0
        flip = self._staging_flip[full_sig] = \
            1 - self._staging_flip[full_sig]
        return pair[flip]

    def _record_program(self, full_shapes: List[Tuple[int, ...]],
                        dtypes: List[str]):
        """Record every NEW padded signature; after warmup this also
        trips the alarm counter."""
        full_sig = tuple(zip(map(tuple, full_shapes), dtypes))
        if full_sig in self._seen_programs:
            return
        self._seen_programs.add(full_sig)
        sig = {"inputs": [{"shape": list(s), "dtype": d}
                          for s, d in zip(full_shapes, dtypes)],
               "training": False}
        _recompile.record_recompile(
            f"ServingEngine:{self.name}", sig, kind="serving")
        if self._warmed:
            self._m_after.inc()
            self._after_warmup_count += 1

    def _execute(self, padded: List[np.ndarray]) -> List[torch.Tensor]:
        """Launch ONE padded, bucketed batch; returns device-side outputs
        (CUDA work may still be in flight). Callers copy to the host
        outside the staging lock so the next dispatch can assemble while
        the device works."""
        shapes = [tuple(a.shape) for a in padded]
        dtypes = [str(a.dtype) for a in padded]
        self._record_program(shapes, dtypes)
        # a copy: the staging buffer is refilled two dispatches later
        in_vals = [torch.tensor(a, device=self.device) for a in padded]
        with torch.inference_mode():
            outs = self.model(*in_vals)
        return list(outs) if isinstance(outs, (tuple, list)) else [outs]

    def _to_host(self, blocks: List[torch.Tensor]) -> List[np.ndarray]:
        """Numpy copies of device ``blocks``. On CUDA each block is copied
        asynchronously into its own stretch of a pinned buffer (one per
        dtype, grown as needed, reused across dispatches), then one sync,
        then out of the buffer by torch's CPU copy (threaded: a 500 MB
        block's first touch of fresh pages is most of its cost)."""
        if self.device.type != "cuda":
            return [b.numpy() for b in blocks]
        need: Dict[torch.dtype, int] = {}
        for b in blocks:
            need[b.dtype] = need.get(b.dtype, 0) + b.numel()
        with self._host_lock:
            for dt, n in need.items():
                buf = self._pinned.get(dt)
                if buf is None or buf.numel() < n:
                    self._pinned[dt] = torch.empty(n, dtype=dt,
                                                   pin_memory=True)
            offs = dict.fromkeys(need, 0)
            views = []
            for b in blocks:
                off, n = offs[b.dtype], b.numel()
                view = self._pinned[b.dtype][off:off + n].view(b.shape)
                view.copy_(b, non_blocking=True)
                offs[b.dtype] = off + n
                views.append(view)
            torch.cuda.current_stream(self.device).synchronize()
            return [torch.empty(v.shape, dtype=v.dtype).copy_(v).numpy()
                    for v in views]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_group(self, group_key: Tuple,
                        requests: List[Request]) -> List[Any]:
        """Batcher callback: concat + pad claimed requests, one device
        dispatch, scatter slices back (one result list per request)."""
        rows = sum(r.n_items for r in requests)
        bucket = self.ladder.batch_bucket(rows)
        n_inputs = len(requests[0].arrays)
        padded_items = [ps for ps, _ in group_key]
        dtypes = [dt for _, dt in group_key]
        full_shapes = [(bucket,) + tuple(ps) for ps in padded_items]
        with self._lock:
            staging = self._staging_for(tuple(group_key) + (bucket,),
                                        full_shapes, dtypes)
            for buf in staging:
                buf.fill(self.pad_value)
            offset = 0
            for r in requests:
                for i in range(n_inputs):
                    a = r.arrays[i]
                    idx = (slice(offset, offset + r.n_items),) + tuple(
                        slice(0, s) for s in a.shape[1:])
                    staging[i][idx] = a
                offset += r.n_items
            self._m_pad.observe(bucket / max(rows, 1))
            self._pad_sum += bucket / max(rows, 1)
            self._pad_n += 1
            outs_dev = self._execute(staging)
        # slice each request's rows and positions on the device, and
        # copy them to the host OUTSIDE the lock: a concurrent
        # direct-dispatch caller (batching=False) can assemble and launch
        # into the flipped staging set while this thread waits
        padded_tuples = [tuple(ps) for ps in padded_items]
        blocks = []
        offset = 0
        for r in requests:
            orig_items = [tuple(a.shape[1:]) for a in r.arrays]
            for o in outs_dev:
                blocks.append(self._unpad(o[offset:offset + r.n_items],
                                          orig_items, padded_tuples))
            offset += r.n_items
        host = self._to_host(blocks)
        k = len(outs_dev)
        return [host[i * k:(i + 1) * k] for i in range(len(requests))]

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def warmup(self, input_specs=None) -> List[dict]:
        """Run every ladder rung once so the set of padded signatures is
        CLOSED.

        Enumerates the ladder's shapes per input spec, runs one padded
        dummy dispatch per combination, and records its wall time (first
        run: the kernels' lazy set-up included). After this returns, any
        new signature increments ``mxserve_recompile_after_warmup_total``.
        """
        if input_specs is not None:
            self.input_specs = _as_specs(input_specs)
        if not self.input_specs:
            raise MXNetError(
                "warmup needs input_specs (per-item shapes, no batch "
                "axis) — pass them to the engine or to warmup()")
        specs = self.input_specs
        combo_lists = [self.ladder.item_shape_combos(s.shape)
                       for s in specs]
        report = []
        # CROSS-product across inputs: live requests pad each input
        # independently, so the closed set must hold every combination
        for combo in itertools.product(*combo_lists):
            for b in self.ladder.batch_buckets:
                padded = [
                    np.full((b,) + tuple(combo[i]),
                            self.pad_value, specs[i].dtype)
                    for i in range(len(specs))]
                t0 = time.perf_counter()
                with self._lock:
                    self._execute(padded)
                self._sync()
                report.append({
                    "shapes": [list(p.shape) for p in padded],
                    "ms": (time.perf_counter() - t0) * 1000.0})
        self._warmed = True
        self._warmup_report = report
        _metrics.gauge(
            "mxserve_programs_compiled",
            "distinct padded program signatures seen by serving engines"
        ).set(len(self._seen_programs))
        return report

    @property
    def warmed(self) -> bool:
        return self._warmed

    def predict(self, data, timeout_ms: Optional[float] = None):
        """Serve one request.

        ``data``: one array or a list (multi-input models), each with a
        leading batch axis (``n`` rows, any ``n`` up to the batch cap).
        Returns numpy output(s) with padding sliced back off — a single
        array when the model has one output.
        """
        arrays = self._coerce_request(data)
        n = int(arrays[0].shape[0])
        key = self._group_key(arrays)
        if self.batcher is None and timeout_ms is not None:
            raise MXNetError(
                "timeout_ms requires batching=True — direct "
                "dispatch is synchronous and cannot enforce a "
                "deadline")
        if self.batcher is not None:
            outs = self.batcher.submit(arrays, n, key, timeout_ms=timeout_ms)
        else:
            outs = self._dispatch_group(key, [Request(arrays, n, key, None)])[0]
        return outs[0] if len(outs) == 1 else outs

    def predict_async(self, data, timeout_ms: Optional[float] = None):
        """Non-blocking submit; returns the batcher Request (``wait()``,
        then ``.result``/``.error``)."""
        if self.batcher is None:
            raise MXNetError("predict_async requires batching=True")
        arrays = self._coerce_request(data)
        return self.batcher.submit_async(
            arrays, int(arrays[0].shape[0]), self._group_key(arrays),
            timeout_ms=timeout_ms)

    def _coerce_request(self, data) -> List[np.ndarray]:
        items = data if isinstance(data, (list, tuple)) else [data]
        arrays = []
        for i, a in enumerate(items):
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            a = np.asarray(a)
            if self.input_specs and i < len(self.input_specs):
                spec = self.input_specs[i]
                if a.ndim == len(spec.shape):  # single item, no batch axis
                    a = a[None]
                a = a.astype(spec.dtype, copy=False)
            arrays.append(a)
        if self.input_specs is None:
            self.input_specs = [InputSpec(a.shape[1:], str(a.dtype),
                                          name=f"data{i}" if i else "data")
                                for i, a in enumerate(arrays)]
        return arrays

    def stats(self) -> dict:
        out = {
            "name": self.name,
            "kind": self._kind,
            "device": str(self.device),
            "warmed": self._warmed,
            "buckets": self.ladder.spec(),
            "programs_compiled": len(self._seen_programs),
            "recompiles_after_warmup": self._after_warmup_count,
        }
        if self._pad_n:
            out["avg_padding_ratio"] = round(
                self._pad_sum / self._pad_n, 4)
        if self.batcher is not None:
            out["batcher"] = self.batcher.stats()
        return out

    def warmup_report(self) -> List[dict]:
        return list(self._warmup_report)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: refuse new requests, flush the queue."""
        return self.batcher.drain(timeout) if self.batcher else True

    def close(self):
        if self.batcher is not None:
            self.batcher.stop()

    def __repr__(self):
        return (f"ServingEngine({self.name!r}, kind={self._kind}, "
                f"device={self.device}, ladder={self.ladder!r}, "
                f"warmed={self._warmed})")
