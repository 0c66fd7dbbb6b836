"""Closed- and open-loop load generators over a serving target.

Counterpart of ``mxnet_tpu/serve/loadgen.py``. Payloads fire at a
``fire(payload)`` callable (an in-process engine's ``predict``), with
per-request latency recorded. Two arrival disciplines:

- :func:`run_loadgen` — **closed-loop**: N workers each wait for their
  response before sending the next request. Offered load tracks
  capacity, which a throughput benchmark wants, but it *understates tail
  latency*: a slow server slows the arrival process (coordinated
  omission).
- :func:`run_loadgen_open` — **open-loop**: arrivals are a Poisson
  process at a target QPS, sent on schedule whether or not earlier
  requests finished (up to a worker-pool cap, late starts counted).
  Latency is measured from the SCHEDULED arrival, so queueing delay under
  overload lands in p99.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Sequence

from ..telemetry.metrics import percentile_of

__all__ = ["run_loadgen", "run_loadgen_open"]


def run_loadgen(fire: Callable, payloads: Sequence,
                concurrency: int = 8) -> dict:
    """Fire every payload through ``fire`` from ``concurrency`` workers.

    Returns ``{completed, errors (messages), wall_s, throughput_rps,
    p50_ms, p99_ms, latencies_s}``.
    """
    latencies: List[float] = []
    errors: List[str] = []
    lock = threading.Lock()
    cursor = [0]

    def worker():
        while True:
            with lock:
                i = cursor[0]
                if i >= len(payloads):
                    return
                cursor[0] += 1
            t0 = time.perf_counter()
            try:
                fire(payloads[i])
                dt = time.perf_counter() - t0
                with lock:
                    latencies.append(dt)
            except Exception as e:  # noqa: BLE001 — record, keep loading
                with lock:
                    errors.append(f"{type(e).__name__}: {e}"[:200])

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(time.perf_counter() - t_start, 1e-9)
    lat = sorted(latencies)
    return {
        "completed": len(latencies),
        "errors": errors,
        "wall_s": wall,
        "throughput_rps": len(latencies) / wall,
        "p50_ms": (percentile_of(lat, 50) or 0.0) * 1000.0,
        "p99_ms": (percentile_of(lat, 99) or 0.0) * 1000.0,
        "latencies_s": lat,
    }


def run_loadgen_open(fire: Callable, payloads: Sequence, qps: float,
                     concurrency: int = 32, seed: int = 0,
                     timeout_errors: tuple = ()) -> dict:
    """Open-loop load: fire ``payloads`` as a Poisson process at ``qps``.

    Inter-arrival gaps are exponential with mean ``1/qps`` (seeded —
    runs are reproducible); each request's latency is measured from its
    SCHEDULED arrival time, so time spent waiting for a free worker or
    queued behind a slow server counts against the tail. ``concurrency``
    caps simultaneously-outstanding requests — when the pool is dry the
    request starts late and ``late_starts`` records it (the open-loop
    analog of load-shedding, visible instead of silently coordinated).

    Exception types in ``timeout_errors`` count into ``timeouts`` (the
    SLO timeout rate) and still contribute their deadline-bounded
    latency to the percentiles — p99 must not exclude exactly the
    requests that missed; everything else lands in ``errors``.

    Returns ``{completed, errors, timeouts, timeout_rate, wall_s,
    offered_qps, achieved_qps, p50_ms, p99_ms, late_starts,
    latencies_s}``.
    """
    if qps <= 0:
        raise ValueError("qps must be > 0 for open-loop load")
    rng = random.Random(seed)
    t0 = time.perf_counter() + 0.005
    sched, t = [], t0
    for _ in payloads:
        sched.append(t)
        t += rng.expovariate(qps)
    latencies: List[float] = []
    errors: List[str] = []
    timeouts = [0]
    late = [0]
    lock = threading.Lock()
    cursor = [0]

    def worker():
        while True:
            with lock:
                i = cursor[0]
                if i >= len(payloads):
                    return
                cursor[0] += 1
                arrival = sched[i]
            delay = arrival - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            elif delay < -0.001:
                # all workers were busy past this arrival: an honest
                # open-loop harness counts it, the latency below still
                # runs from the scheduled arrival
                with lock:
                    late[0] += 1
            try:
                fire(payloads[i])
                done = time.perf_counter()
                with lock:
                    latencies.append(done - arrival)
            except timeout_errors:  # noqa: B030 — caller-typed
                # a deadline miss is an SLO *measurement* (the timeout
                # rate), not a harness error — and it still contributes
                # its (deadline-bounded) latency to the percentiles, or
                # p99 would exclude exactly the slowest requests
                done = time.perf_counter()
                with lock:
                    timeouts[0] += 1
                    latencies.append(done - arrival)
            except Exception as e:  # noqa: BLE001 — record, keep loading
                with lock:
                    errors.append(f"{type(e).__name__}: {e}"[:200])

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(min(int(concurrency), len(payloads)) or 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = max(time.perf_counter() - t0, 1e-9)
    n = len(payloads)
    lat = sorted(latencies)  # successes AND timed-out requests
    completed = len(latencies) - timeouts[0]
    return {
        "completed": completed,
        "errors": errors,
        "timeouts": timeouts[0],
        "timeout_rate": timeouts[0] / max(n, 1),
        "wall_s": wall,
        "offered_qps": float(qps),
        "achieved_qps": completed / wall,
        "p50_ms": (percentile_of(lat, 50) or 0.0) * 1000.0,
        "p99_ms": (percentile_of(lat, 99) or 0.0) * 1000.0,
        "late_starts": late[0],
        "latencies_s": lat,
    }
