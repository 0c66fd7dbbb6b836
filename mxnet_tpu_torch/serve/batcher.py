"""Dynamic micro-batching queue: coalesce concurrent requests into one
device dispatch.

Counterpart of ``mxnet_tpu/serve/batcher.py``. A GPU, like the TPU, is a
batch machine: a (1, ...) and an (8, ...) matrix product cost nearly the
same time at serving sizes. Concurrent callers enqueue; a single
dispatcher thread coalesces compatible requests (same padded per-item
signature, see :mod:`~mxnet_tpu_torch.serve.buckets`) up to a batch cap or
a linger deadline, fires ONE dispatch, and scatters the per-request slices
back.

Operational behavior, all of it bounded:

- **bounded queue with load-shed** — ``submit`` on a full queue raises
  :class:`QueueFullError` immediately instead of blocking unboundedly;
- **per-request deadlines** — a request whose deadline passes while
  still queued is failed fast with :class:`DeadlineExceededError` and
  never occupies a dispatch slot;
- **max linger** — the dispatcher waits at most ``max_linger_ms`` for
  co-batchable requests before dispatching a partial batch;
- **graceful drain** — :meth:`drain` stops intake, flushes what is
  queued, and leaves in-flight work to finish.

Telemetry (metrics registry): ``mxserve_queue_depth`` gauge,
``mxserve_batch_occupancy`` / ``mxserve_batch_rows`` /
``mxserve_request_seconds`` histograms, ``mxserve_requests_total`` /
``mxserve_shed_total`` / ``mxserve_deadline_expired_total`` /
``mxserve_dispatch_total`` counters.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

from .. import config
from ..base import MXNetError
from ..telemetry import metrics as _metrics
from ..telemetry.metrics import percentile_of

__all__ = ["DynamicBatcher", "QueueFullError", "DeadlineExceededError",
           "BatcherStoppedError", "RequestTooLargeError",
           "InvalidRequestError", "Request"]


class QueueFullError(MXNetError):
    """Load-shed: the bounded request queue is at MXSERVE_QUEUE_DEPTH."""


class RequestTooLargeError(MXNetError):
    """A single request exceeds max_batch_size rows — a CLIENT error
    (typed so serving breakers can exclude it from health accounting)."""


class InvalidRequestError(MXNetError):
    """The request itself is malformed (empty prompt, bad shape, bad
    max_new_tokens) — a CLIENT error: deterministic for the request, so
    routers must neither retry it on another replica nor count it
    against replica health."""


class DeadlineExceededError(MXNetError):
    """The request's deadline passed before its dispatch completed."""


class BatcherStoppedError(MXNetError):
    """submit() after stop()/drain() began."""


# request lifecycle: QUEUED -> CLAIMED (dispatcher owns it) -> DONE,
# or QUEUED -> CANCELLED (deadline hit while still queued)
_QUEUED, _CLAIMED, _DONE, _CANCELLED = range(4)


class Request:
    """One in-flight request. ``wait()`` blocks for the result."""

    __slots__ = ("arrays", "n_items", "group_key", "deadline", "enq_t",
                 "event", "result", "error", "state", "callbacks")

    def __init__(self, arrays: Sequence[Any], n_items: int, group_key: Any,
                 deadline: Optional[float]):
        self.arrays = list(arrays)
        self.n_items = int(n_items)
        self.group_key = group_key
        self.deadline = deadline
        self.enq_t = time.monotonic()
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.state = _QUEUED
        # completion hooks run (once) after result/error is final —
        # async callers use these to record circuit-breaker outcomes
        self.callbacks: List[Callable[["Request"], None]] = []

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.event.wait(timeout)

    def finish(self):
        """Terminal transition: wake waiters, then run callbacks (which
        must never take down the dispatcher)."""
        self.event.set()
        for cb in self.callbacks:
            try:
                cb(self)
            except Exception:
                pass


class DynamicBatcher:
    """Thread-safe dynamic micro-batcher.

    ``dispatch_fn(group_key, requests) -> [result, ...]`` runs on the
    dispatcher thread with a list of claimed requests sharing
    ``group_key`` and must return one result per request, in order. An
    exception from ``dispatch_fn`` fails every request in the group.

    ``max_batch_size`` caps the summed ``n_items`` (rows) per dispatch.
    Defaults resolve from the flag registry: ``MXSERVE_MAX_BATCH``,
    ``MXSERVE_MAX_LINGER_MS``, ``MXSERVE_QUEUE_DEPTH``. The flag's
    documented ``0 = ladder top rung`` resolution happens in
    :class:`~mxnet_tpu.serve.engine.ServingEngine` (which knows the
    ladder and always passes an explicit cap); a bare ``DynamicBatcher``
    with the flag unset/0 falls back to 32.
    """

    def __init__(self, dispatch_fn: Callable[[Any, List[Request]], List[Any]],
                 max_batch_size: Optional[int] = None,
                 max_linger_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 name: str = "mxserve"):
        self._dispatch_fn = dispatch_fn
        self.max_batch_size = int(max_batch_size
                                  if max_batch_size is not None
                                  else (config.get("MXSERVE_MAX_BATCH")
                                        or 32))
        self.max_linger_s = float(max_linger_ms
                                  if max_linger_ms is not None
                                  else config.get("MXSERVE_MAX_LINGER_MS")
                                  ) / 1000.0
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else config.get("MXSERVE_QUEUE_DEPTH"))
        if self.max_batch_size <= 0 or self.queue_depth <= 0:
            raise MXNetError("max_batch_size and queue_depth must be > 0")
        self.name = name
        self._cv = threading.Condition()
        self._queue: "deque[Request]" = deque()
        self._stopping = False
        self._draining = False
        self._crashed: Optional[BaseException] = None
        self._in_flight = 0  # claimed but not yet completed
        self._current_group: List[Request] = []  # dispatcher-owned
        self._m_depth = _metrics.gauge(
            "mxserve_queue_depth", "requests waiting in the batcher queue")
        self._m_occ = _metrics.histogram(
            "mxserve_batch_occupancy", "requests coalesced per dispatch")
        self._m_rows = _metrics.histogram(
            "mxserve_batch_rows", "rows (pre-padding) per dispatch")
        self._m_lat = _metrics.histogram(
            "mxserve_request_seconds", "submit-to-result request latency")
        self._m_req = _metrics.counter(
            "mxserve_requests_total", "requests accepted by the batcher")
        self._m_shed = _metrics.counter(
            "mxserve_shed_total", "requests rejected by queue backpressure")
        self._m_expired = _metrics.counter(
            "mxserve_deadline_expired_total",
            "requests failed fast on deadline")
        self._m_disp = _metrics.counter(
            "mxserve_dispatch_total", "device dispatches issued")
        # per-instance accounting: the registry instruments above are
        # process-global (shared across every engine), so stats() keeps
        # its own numbers — a multi-model endpoint must not report
        # model A's queue/occupancy/latency under model B's name
        self._n_req = 0
        self._n_shed = 0
        self._n_expired = 0
        self._n_disp = 0
        self._occ_sum = 0
        self._lat_recent: "deque[float]" = deque(maxlen=512)
        self._thread = threading.Thread(
            target=self._loop, name=f"{name}-batcher", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def submit_async(self, arrays: Sequence[Any], n_items: int,
                     group_key: Any,
                     timeout_ms: Optional[float] = None,
                     on_done: Optional[Callable[[Request], None]] = None
                     ) -> Request:
        """Enqueue without blocking for the result. Raises
        :class:`QueueFullError` / :class:`BatcherStoppedError` on
        intake; the returned :class:`Request` resolves via ``wait()``.
        ``on_done`` is registered BEFORE the request is enqueued —
        appending to ``req.callbacks`` after submit races a dispatcher
        that may already have finished it."""
        if n_items > self.max_batch_size:
            raise RequestTooLargeError(
                f"request of {n_items} rows exceeds max_batch_size="
                f"{self.max_batch_size}; shard it client-side")
        deadline = (time.monotonic() + timeout_ms / 1000.0
                    if timeout_ms is not None else None)
        req = Request(arrays, n_items, group_key, deadline)
        if on_done is not None:
            req.callbacks.append(on_done)
        with self._cv:
            if self._crashed is not None:
                raise BatcherStoppedError(
                    f"batcher {self.name!r} dispatcher crashed: "
                    f"{self._crashed!r}") from self._crashed
            if self._stopping or self._draining:
                raise BatcherStoppedError(
                    f"batcher {self.name!r} is "
                    + ("draining" if self._draining else "stopped"))
            if len(self._queue) >= self.queue_depth:
                self._m_shed.inc()
                self._n_shed += 1
                raise QueueFullError(
                    f"batcher {self.name!r} queue is full "
                    f"({self.queue_depth} waiting); shed — retry with "
                    "backoff")
            self._queue.append(req)
            self._m_depth.set(len(self._queue))
            self._m_req.inc()
            self._n_req += 1
            self._cv.notify_all()
        return req

    def submit(self, arrays: Sequence[Any], n_items: int, group_key: Any,
               timeout_ms: Optional[float] = None) -> Any:
        """Enqueue and block until the result (or deadline). Returns the
        dispatch result for this request; raises
        :class:`DeadlineExceededError` when the deadline passes first."""
        req = self.submit_async(arrays, n_items, group_key, timeout_ms)
        budget = (None if req.deadline is None
                  else max(0.0, req.deadline - time.monotonic()))
        if not req.wait(budget):
            with self._cv:
                if req.state == _QUEUED:
                    # still ours: cancel in place, fail fast
                    req.state = _CANCELLED
                    try:
                        self._queue.remove(req)
                    except ValueError:
                        pass
                    self._m_depth.set(len(self._queue))
                    self._m_expired.inc()
                    self._n_expired += 1
                    raise DeadlineExceededError(
                        f"request expired after {timeout_ms} ms in queue "
                        f"(batcher {self.name!r})")
            # claimed by the dispatcher: the dispatch is already running
            # on-device; wait it out and deliver whatever it produced
            req.wait()
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------
    def _claim_group(self) -> Tuple[Any, List[Request]]:
        """Under ``_cv``: pick the oldest live request, then coalesce
        same-key queued requests up to the caps, lingering for
        stragglers. Returns (group_key, claimed requests)."""
        while True:
            while not self._queue and not self._stopping:
                self._cv.wait()
            if self._stopping and not self._queue:
                return None, []
            head = self._queue.popleft()
            if head.state != _QUEUED:
                continue  # cancelled while queued
            if head.expired():
                head.state = _DONE
                head.error = DeadlineExceededError(
                    "request deadline passed while queued")
                self._m_expired.inc()
                self._n_expired += 1
                head.finish()
                continue
            head.state = _CLAIMED
            self._in_flight += 1
            break
        group = [head]
        rows = head.n_items
        linger_until = time.monotonic() + self.max_linger_s
        while rows < self.max_batch_size:
            took = False
            for req in list(self._queue):
                if req.state != _QUEUED or req.group_key != head.group_key:
                    continue
                if req.expired():
                    self._queue.remove(req)
                    req.state = _DONE
                    req.error = DeadlineExceededError(
                        "request deadline passed while queued")
                    self._m_expired.inc()
                    self._n_expired += 1
                    req.finish()
                    continue
                if rows + req.n_items > self.max_batch_size:
                    continue
                self._queue.remove(req)
                req.state = _CLAIMED
                self._in_flight += 1
                group.append(req)
                rows += req.n_items
                took = True
                if rows >= self.max_batch_size:
                    break
            if rows >= self.max_batch_size:
                break
            remaining = linger_until - time.monotonic()
            if remaining <= 0:
                break
            if not took:
                # sleep until a new submit notifies (any arrival could
                # be same-key) or the linger deadline — no polling ticks
                self._cv.wait(remaining)
                if self._stopping:
                    break
        self._m_depth.set(len(self._queue))
        return head.group_key, group

    def _loop(self):
        # the dispatcher is the batcher's single worker: if IT dies (a
        # bug outside the per-group dispatch_fn guard below), every
        # queued/claimed request would otherwise sit out its full
        # deadline — or forever — on a thread that no longer exists:
        # crash ⇒ every in-flight future fails fast with its exception.
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — fail fast, loudly
            self._crash(e)

    def _crash(self, exc: BaseException):
        with self._cv:
            self._crashed = exc
            self._stopping = True
            pending = list(self._queue) + [
                r for r in self._current_group if not r.event.is_set()]
            self._queue.clear()
            self._current_group = []
            self._in_flight = 0
            self._m_depth.set(0)
            self._cv.notify_all()
        err = BatcherStoppedError(
            f"batcher {self.name!r} dispatcher crashed: {exc!r}")
        err.__cause__ = exc
        for r in pending:
            r.state = _DONE
            r.error = err
            r.finish()

    def _loop_inner(self):
        while True:
            with self._cv:
                key, group = self._claim_group()
                self._current_group = group
                if not group:
                    return
            now = time.monotonic()
            live = [r for r in group if not r.expired(now)]
            n_late = 0
            for r in group:
                if r not in live:
                    r.error = DeadlineExceededError(
                        "request deadline passed before dispatch")
                    self._m_expired.inc()
                    n_late += 1
            if live:
                try:
                    results = self._dispatch_fn(key, live)
                    if len(results) != len(live):
                        raise MXNetError(
                            f"dispatch_fn returned {len(results)} results "
                            f"for {len(live)} requests")
                    for r, res in zip(live, results):
                        r.result = res
                except BaseException as e:  # noqa: BLE001 — fail the group
                    for r in live:
                        r.error = e
                self._m_disp.inc()
                self._m_occ.observe(len(live))
                self._m_rows.observe(sum(r.n_items for r in live))
            done_t = time.monotonic()
            with self._cv:
                self._in_flight -= len(group)
                self._n_expired += n_late
                if live:
                    self._n_disp += 1
                    self._occ_sum += len(live)
                for r in group:
                    # under _cv: stats() sorts this deque and a
                    # concurrent append would blow up its iteration
                    self._lat_recent.append(done_t - r.enq_t)
                # dispatch is over: clear while still under _cv so
                # stats() never sees a finished group as current
                self._current_group = []
                self._cv.notify_all()
            for r in group:
                r.state = _DONE
                self._m_lat.observe(done_t - r.enq_t)
                r.finish()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def __len__(self):
        with self._cv:
            return len(self._queue)

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop intake, flush the queue, wait for in-flight dispatches.
        Returns True when fully drained within ``timeout``."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._queue or self._in_flight:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is not None else 0.1)
        return True

    def stop(self, timeout: float = 5.0):
        """Drain, then terminate the dispatcher thread."""
        self.drain(timeout)
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def stats(self) -> dict:
        """Per-instance numbers (the registry metrics are process-global
        aggregates across every engine; a multi-model endpoint reports
        these instead so model A's load never shows under model B)."""
        with self._cv:
            lat = sorted(self._lat_recent)
            depth = len(self._queue)
            n_disp, occ_sum = self._n_disp, self._occ_sum
            n_req, n_shed = self._n_req, self._n_shed
            n_expired = self._n_expired
        return {
            "queue_depth": depth,
            "queue_capacity": self.queue_depth,
            "max_batch_size": self.max_batch_size,
            "max_linger_ms": self.max_linger_s * 1000.0,
            "dispatches": n_disp,
            "requests": n_req,
            "shed": n_shed,
            "deadline_expired": n_expired,
            "avg_occupancy": (occ_sum / n_disp) if n_disp else 0.0,
            "latency_p50_ms": (percentile_of(lat, 50) or 0.0) * 1000.0,
            "latency_p99_ms": (percentile_of(lat, 99) or 0.0) * 1000.0,
            "draining": self._draining,
        }
