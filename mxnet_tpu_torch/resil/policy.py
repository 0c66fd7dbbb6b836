"""Circuit breaker: fail fast while a dependency is down.

Counterpart of ``CircuitBreaker`` and ``CircuitOpenError`` in
``mxnet_tpu/resil/policy.py`` (:56, :157), which the serve2 router wraps
around each replica. The breaker's crash dump (the flight recorder)
waits for ROADMAP Queue A item 8.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from .. import config
from ..base import MXNetError
from ..telemetry import metrics as _metrics

__all__ = ["CircuitBreaker", "CircuitOpenError"]


class CircuitOpenError(MXNetError):
    """Fail-fast rejection while a circuit breaker is open (degraded
    mode). Not retryable: the breaker exists to stop retry pressure."""


class CircuitBreaker:
    """closed -> (N consecutive failures) -> open -> (cooldown) ->
    half-open -> one probe -> closed | open.

    ``check()`` raises :class:`CircuitOpenError` while open; callers
    report outcomes with ``record_success``/``record_failure``. The
    injectable ``clock`` makes trip and reset testable without
    sleeping."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str = "", failure_threshold: int = None,
                 cooldown_s: float = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name or "breaker"
        self.failure_threshold = int(
            failure_threshold if failure_threshold is not None
            else config.get("MXRESIL_BREAKER_FAILURES"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else config.get("MXRESIL_BREAKER_COOLDOWN_S"))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0
        self._m_trips = _metrics.counter(
            "mxresil_breaker_trips_total", "circuit-breaker open events")
        self._m_fastfail = _metrics.counter(
            "mxresil_breaker_fastfail_total",
            "calls rejected while a breaker was open")

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        # under self._lock
        if self._state == self.OPEN and \
                self._clock() - self._opened_at >= self.cooldown_s:
            self._state = self.HALF_OPEN
            self._probing = False

    def check(self):
        """Admission: raise while open; half-open admits ONE probe and
        fails the rest fast. A probe whose outcome is never recorded
        expires after another cooldown, so the breaker cannot wedge
        half-open."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return
            if self._state == self.HALF_OPEN and self._probing and \
                    self._clock() - self._probe_started >= self.cooldown_s:
                self._probing = False
            if self._state == self.HALF_OPEN and not self._probing:
                self._probing = True
                self._probe_started = self._clock()
                return
            self._m_fastfail.inc()
            left = max(0.0, self.cooldown_s
                       - (self._clock() - self._opened_at))
            raise CircuitOpenError(
                f"circuit {self.name!r} is {self._state} "
                f"({self._failures} consecutive failures; "
                f"~{left:.1f}s until half-open probe) — degraded mode, "
                "failing fast")

    def record_success(self):
        with self._lock:
            if self._state == self.OPEN:
                # a straggler admitted before the trip: only the
                # half-open probe may close an opened breaker
                return
            self._failures = 0
            self._probing = False
            self._state = self.CLOSED

    def record_failure(self):
        with self._lock:
            self._failures += 1
            tripped = self._state == self.HALF_OPEN or \
                self._failures >= self.failure_threshold
            if tripped and self._state != self.OPEN:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probing = False
                self._m_trips.inc()
            elif tripped:
                self._opened_at = self._clock()

    def describe(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {"name": self.name, "state": self._state,
                    "consecutive_failures": self._failures,
                    "failure_threshold": self.failure_threshold,
                    "cooldown_s": self.cooldown_s}
