"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of ``mxnet_tpu/telemetry/metrics.py``, holding the part the
serving layer feeds: named instruments in one registry, a histogram with
exact count/sum/min/max and quantiles over a reservoir of recent samples,
the one nearest-rank :func:`percentile_of`, :func:`unregister`, the
owner tokens that tie per-instance instruments to the object that retires
them, and the Prometheus text the HTTP endpoint serves. The pod merge
waits for the slice that needs it.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "snapshot", "percentile_of", "unregister", "OwnerToken", "owner",
           "all_metrics", "to_prometheus"]


def percentile_of(sorted_vals, q: float):
    """Nearest-rank percentile (0..100) over an ascending-sorted
    sequence; None when empty. Shared by Histogram, the serving loadgen
    and the batcher's stats."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


_LOCK = threading.Lock()
_METRICS: Dict[str, "Metric"] = {}


class Metric:
    """Base: a named, documented instrument."""

    kind = "untyped"

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc

    def value(self):
        raise NotImplementedError


class Counter(Metric):
    """Monotone counter (requests, dispatches, recompiles)."""

    kind = "counter"

    def __init__(self, name, doc=""):
        super().__init__(name, doc)
        self._v = 0

    def inc(self, n=1):
        with _LOCK:
            self._v += n

    def value(self):
        return self._v


class Gauge(Metric):
    """Point-in-time value (queue depth, programs in the cache)."""

    kind = "gauge"

    def __init__(self, name, doc=""):
        super().__init__(name, doc)
        self._v = 0.0

    def set(self, v):
        with _LOCK:
            self._v = v

    def value(self):
        return self._v


class Histogram(Metric):
    """Streaming distribution: exact count / sum / min / max over the
    full history, p50/p99 over the last ``RESERVOIR`` samples."""

    kind = "histogram"
    RESERVOIR = 512

    def __init__(self, name, doc=""):
        super().__init__(name, doc)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._recent = deque(maxlen=self.RESERVOIR)

    def observe(self, v):
        v = float(v)
        with _LOCK:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            self._recent.append(v)

    def value(self):
        with _LOCK:
            if not self._count:
                return {"count": 0, "sum": 0.0}
            samples = sorted(self._recent)
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "avg": self._sum / self._count,
                    "p50": percentile_of(samples, 50),
                    "p99": percentile_of(samples, 99)}


def _get_or_create(cls, name: str, doc: str) -> Metric:
    with _LOCK:
        m = _METRICS.get(name)
        if m is None:
            m = _METRICS[name] = cls(name, doc)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m


def counter(name: str, doc: str = "") -> Counter:
    return _get_or_create(Counter, name, doc)


def gauge(name: str, doc: str = "") -> Gauge:
    return _get_or_create(Gauge, name, doc)


def histogram(name: str, doc: str = "") -> Histogram:
    return _get_or_create(Histogram, name, doc)


def unregister(name: str) -> bool:
    """Drop one instrument by name (per-engine gauges when their engine
    is closed: a reload must not leave a dead pool looking live)."""
    with _LOCK:
        return _METRICS.pop(name, None) is not None


class OwnerToken:
    """Ties per-instance instruments (an engine's pool gauges, a
    replica's breaker gauge) to the object that registered them: it
    adopts their names at construction and closes the token once it has
    unregistered them; :meth:`leaked` names any still registered."""

    __slots__ = ("name", "names", "closed")

    def __init__(self, name: str):
        self.name = str(name)
        self.names: set = set()
        self.closed = False

    def adopt(self, *names) -> "OwnerToken":
        """Instrument names (or instruments) this owner retires."""
        for n in names:
            self.names.add(n.name if isinstance(n, Metric) else str(n))
        return self

    def close(self) -> None:
        self.closed = True

    def leaked(self) -> List[str]:
        """Adopted instruments still registered after close."""
        if not self.closed:
            return []
        with _LOCK:
            return sorted(n for n in self.names if n in _METRICS)

    def __repr__(self):
        return (f"<OwnerToken {self.name!r} {len(self.names)} "
                f"instrument(s){' closed' if self.closed else ''}>")


def owner(name: str) -> OwnerToken:
    """A new instrument owner (one per engine or replica). The audit over
    every owner (the JAX package's metriclint) waits for ROADMAP Queue A
    item 8."""
    return OwnerToken(name)


def all_metrics() -> Dict[str, Metric]:
    with _LOCK:
        return dict(_METRICS)


def snapshot() -> Dict[str, object]:
    """{name: value} for every instrument; histogram values are dicts."""
    return {name: m.value() for name, m in sorted(all_metrics().items())}


def to_prometheus() -> str:
    """Prometheus text exposition of the current snapshot."""
    lines: List[str] = []
    for name, m in sorted(all_metrics().items()):
        if m.doc:
            lines.append(f"# HELP {name} {m.doc}")
        if isinstance(m, Histogram):
            lines.append(f"# TYPE {name} summary")
            v = m.value()
            lines.append(f"{name}_count {v['count']}")
            lines.append(f"{name}_sum {v['sum']}")
            if v["count"]:
                lines.append(f"{name}_min {v['min']}")
                lines.append(f"{name}_max {v['max']}")
                lines.append(f'{name}{{quantile="0.5"}} {v["p50"]}')
                lines.append(f'{name}{{quantile="0.99"}} {v["p99"]}')
        else:
            lines.append(f"# TYPE {name} {m.kind}")
            lines.append(f"{name} {m.value()}")
    return "\n".join(lines) + "\n"
