"""Router tier: spread mixed traffic over N engine replicas.

Counterpart of ``mxnet_tpu/serve2/router.py`` (its trace spans wait for
ROADMAP Queue A item 8). The router holds no device: its replicas are
whatever the group's factory builds (a ``DecodeEngine`` defaults to
CUDA and raises on a host without a GPU unless given ``device="cpu"``).

One :class:`Router` owns named **model groups**; each group is N
replicas of an engine (a :class:`~mxnet_tpu_torch.serve.engine.ServingEngine`
for request/response models, a
:class:`~mxnet_tpu_torch.serve2.scheduler.DecodeEngine` for autoregressive
LMs — anything with the ``predict/warmup/warmed/stats/drain/close``
duck type) built by the group's ``factory(version)`` — or
``factory(version, replica)`` when the factory accepts a second
positional argument, which it should use to give every replica a
UNIQUE engine name: per-engine gauges (page pool, in-flight/waiting
sequences, serve3 prefix/acceptance counters) are keyed by engine
name, so same-named sibling replicas would overwrite each other's
metrics, and closing one during a rolling reload would unregister
gauges a live sibling still owns. serve3 **draft/target groups** are
ordinary groups whose factory builds
``DecodeEngine(draft_params=..., spec_tokens=K)`` replicas — the
draft rides inside the engine (shared block tables, one allocator),
so routing, breakers, and rolling reload need no special cases, and a
reload swaps draft and target atomically together (a version's draft
can never verify against another version's target). :meth:`audit`
exposes the group-wide page-accounting audit.

Routing is queue-depth + breaker aware: each call picks the admitting
replica with the shallowest queue (ties round-robin), wrapped in a
per-replica :class:`~mxnet_tpu_torch.resil.policy.CircuitBreaker`. Replica
failures record into the breaker and the request retries on the next
replica; backpressure (``QueueFullError``) and a draining replica
(``BatcherStoppedError``) retry WITHOUT a breaker mark (they are load
signals, not health signals); client-caused errors (deadline, oversize)
propagate immediately. A tripped replica is simply routed around —
graceful degradation — until its cooldown admits a half-open probe.
Only when every replica refuses does the call fail
(``mxserve2_router_dropped_total``).

**Rolling reload** (:meth:`rolling_reload`) is the zero-downtime model
update: per replica, the NEW engine is built and warmed FIRST (capacity
never dips), the registry entry is atomically swapped to the new
version (:meth:`~mxnet_tpu_torch.serve.endpoint.ModelRegistry.swap` — version
pinning lives there), then the old engine drains within
``MXSERVE2_RELOAD_DRAIN_TIMEOUT_S`` and closes. Requests racing the
swap land on the draining engine, get ``BatcherStoppedError``, and
retry onto a live replica — the soak test enforces zero dropped
requests through a reload under load.

Telemetry: per-replica ``mxserve2_replica_depth_*`` /
``mxserve2_replica_breaker_open_*`` gauges plus router counters, all
through the metrics registry.
"""
from __future__ import annotations

import inspect
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import config
from ..base import MXNetError
from ..resil.policy import CircuitBreaker, CircuitOpenError
from ..serve.batcher import (BatcherStoppedError, DeadlineExceededError,
                             InvalidRequestError, QueueFullError,
                             RequestTooLargeError)
from ..serve.buckets import BucketOverflowError
from ..serve.endpoint import ModelRegistry
from .kvcache import PagePoolExhausted, _gauge_tag
from .scheduler import EngineCrashedError
from ..telemetry import metrics as _metrics

__all__ = ["Router", "RoutedModel", "AllReplicasUnavailable"]

# errors the CLIENT caused (or that carry its deadline): never retried,
# never a breaker mark. PagePoolExhausted qualifies because the only
# instance that escapes DecodeEngine.submit/predict is the
# deterministic request-bigger-than-the-whole-pool rejection —
# transient exhaustion is handled inside the scheduler by preemption
# and a scheduler crash surfaces as EngineCrashedError.
_CLIENT_ERRORS = (DeadlineExceededError, RequestTooLargeError,
                  BucketOverflowError, InvalidRequestError,
                  PagePoolExhausted)
# load signals: retry another replica, but a busy/draining replica is
# not an UNHEALTHY replica (EngineCrashedError subclasses
# BatcherStoppedError yet IS unhealthy — caught before this)
_BACKPRESSURE = (QueueFullError, BatcherStoppedError)


class AllReplicasUnavailable(MXNetError):
    """Every replica refused this request (open breakers, backpressure,
    or failures) — the router's degraded-mode fail-fast."""


class _Replica:
    __slots__ = ("rname", "engine", "breaker", "inflight", "lock",
                 "version", "depth_gauge", "breaker_gauge", "owner")

    def __init__(self, rname: str, engine, version: int):
        self.rname = rname
        self.engine = engine
        self.version = version
        self.breaker = CircuitBreaker(name=rname)
        self.inflight = 0
        self.lock = threading.Lock()
        self.depth_gauge = _metrics.gauge(
            f"mxserve2_replica_depth_{_gauge_tag(rname)}",
            f"queued + in-flight requests on replica {rname}")
        self.breaker_gauge = _metrics.gauge(
            f"mxserve2_replica_breaker_open_{_gauge_tag(rname)}",
            f"1 while replica {rname}'s circuit breaker is not closed")
        # owner token: retire_gauges() closes it
        self.owner = _metrics.owner(f"Replica:{rname}")
        self.owner.adopt(self.depth_gauge, self.breaker_gauge)

    def depth(self) -> int:
        # the engine's own queue depth already counts a request for the
        # whole predict() call; rep.inflight only covers the submit
        # window before the engine sees it — max, not sum (summing
        # double-counts every in-flight request, inflating routing
        # depth and the reload's drained numbers)
        eng = self.engine
        qd = getattr(eng, "queue_depth", None)
        if callable(qd):
            d = qd()
        elif getattr(eng, "batcher", None) is not None:
            d = len(eng.batcher)
        else:
            return self.inflight
        return max(d, self.inflight)

    def export(self):
        self.depth_gauge.set(self.depth())
        self.breaker_gauge.set(
            0 if self.breaker.state == CircuitBreaker.CLOSED else 1)

    def retire_gauges(self):
        """Unregister this replica's gauges (router close) — same
        retirement contract as the engine/pool gauges, so a closed
        router's replicas don't linger in /metrics as live ones."""
        _metrics.unregister(self.depth_gauge.name)
        _metrics.unregister(self.breaker_gauge.name)
        self.owner.close()


class _Group:
    __slots__ = ("model", "factory", "replicas", "version", "lock")

    def __init__(self, model: str, factory, replicas, version: int):
        self.model = model
        self.factory = factory
        self.replicas: List[_Replica] = replicas
        self.version = version
        # serializes reloads per group
        self.lock = threading.Lock()


class Router:
    """See the module docstring. ``registry`` is shared/visible — the
    endpoint and tools introspect replica engines through it."""

    def __init__(self, name: str = "router",
                 registry: Optional[ModelRegistry] = None,
                 drain_timeout_s: Optional[float] = None):
        self.name = name
        self.registry = registry or ModelRegistry()
        self.drain_timeout_s = float(
            drain_timeout_s if drain_timeout_s is not None
            else config.get("MXSERVE2_RELOAD_DRAIN_TIMEOUT_S"))
        self._groups: Dict[str, _Group] = {}
        self._rr = itertools.count()
        self._m_routed = _metrics.counter(
            "mxserve2_router_requests_total",
            "requests routed by serve2 routers")
        self._m_retried = _metrics.counter(
            "mxserve2_router_retries_total",
            "requests re-routed to another replica")
        self._m_dropped = _metrics.counter(
            "mxserve2_router_dropped_total",
            "requests failed after every replica refused")
        self._m_reloads = _metrics.counter(
            "mxserve2_router_reloads_total",
            "rolling model reloads completed")

    # ------------------------------------------------------------------
    # groups
    # ------------------------------------------------------------------
    @staticmethod
    def _build(factory, version: int, replica: int):
        """Call ``factory(version, replica)`` when the factory REQUIRES
        a second positional argument (no default — a defaulted second
        parameter is a closure convenience like ``_e=engines``, not a
        request for the index), else ``factory(version)``. Decided by
        inspection, not try/except — a TypeError raised INSIDE a
        two-argument factory must propagate, not silently retry the
        one-argument form."""
        try:
            params = inspect.signature(factory).parameters.values()
        except (TypeError, ValueError):
            return factory(version)
        required = [p for p in params
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)
                    and p.default is p.empty]
        if (len(required) >= 2
                or any(p.kind == p.VAR_POSITIONAL for p in params)):
            return factory(version, replica)
        return factory(version)

    def add_group(self, model: str, factory: Callable[[int], object],
                  n_replicas: Optional[int] = None,
                  warmup: bool = True) -> List[object]:
        """Create ``n_replicas`` engines via ``factory(version)`` /
        ``factory(version, replica)`` (see module docstring — the
        two-argument form lets the factory give replicas unique engine
        names) and register them as ``<model>/r<i>`` (version 1).
        Returns the engines."""
        if model in self._groups:
            raise MXNetError(f"group {model!r} already exists")
        n = int(n_replicas if n_replicas is not None
                else config.get("MXSERVE2_REPLICAS"))
        if n < 1:
            raise MXNetError("n_replicas must be >= 1")
        replicas = []
        for i in range(n):
            engine = self._build(factory, 1, i)
            if warmup and not engine.warmed:
                engine.warmup()
            rname = f"{model}/r{i}"
            self.registry.register(rname, engine, version=1)
            replicas.append(_Replica(rname, engine, 1))
        self._groups[model] = _Group(model, factory, replicas, 1)
        return [r.engine for r in replicas]

    def models(self) -> List[str]:
        return sorted(self._groups)

    def group_version(self, model: str) -> int:
        return self._group(model).version

    def _group(self, model: str) -> _Group:
        g = self._groups.get(model)
        if g is None:
            raise MXNetError(f"no model group {model!r} "
                             f"(have: {sorted(self._groups)})")
        return g

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def predict(self, model: str, data,
                timeout_ms: Optional[float] = None):
        """Route one request: shallowest admitting replica first, then
        failover across the rest. See the module docstring for the
        error taxonomy. (The fleet's preferred-replica routing waits
        for ROADMAP Queue A item 8.)"""
        group = self._group(model)
        self._m_routed.inc()
        last_err: Optional[BaseException] = None
        # rotate BEFORE the stable sort: equal-depth ties must not
        # always go to the lowest-index replica. Depths are read once.
        reps = group.replicas
        start = next(self._rr) % len(reps)
        rotated = reps[start:] + reps[:start]
        keyed = sorted(((r.depth(), i, r) for i, r in enumerate(rotated)),
                       key=lambda t: (t[0], t[1]))
        order = [r for _, _, r in keyed]
        for rep in order:
            try:
                rep.breaker.check()
            except CircuitOpenError as e:
                last_err = e
                continue
            engine = rep.engine  # snapshot: a concurrent swap must not
            # change the engine between the call and the outcome record
            with rep.lock:
                rep.inflight += 1
            try:
                out = engine.predict(data, timeout_ms=timeout_ms)
                rep.breaker.record_success()
                return out
            except _CLIENT_ERRORS:
                raise
            except EngineCrashedError as e:
                rep.breaker.record_failure()
                last_err = e
                self._m_retried.inc()
                continue
            except _BACKPRESSURE as e:
                last_err = e
                self._m_retried.inc()
                continue
            except Exception as e:  # noqa: BLE001 — replica failure;
                # KeyboardInterrupt/SystemExit propagate
                rep.breaker.record_failure()
                last_err = e
                self._m_retried.inc()
                continue
            finally:
                with rep.lock:
                    rep.inflight -= 1
                rep.export()
        self._m_dropped.inc()
        raise AllReplicasUnavailable(
            f"model {model!r}: all {len(order)} replicas refused "
            f"(last: {type(last_err).__name__}: {last_err})"
        ) from last_err

    # ------------------------------------------------------------------
    # rolling reload
    # ------------------------------------------------------------------
    def rolling_reload(self, model: str,
                       drain_timeout_s: Optional[float] = None) -> dict:
        """Zero-downtime model update: warm new → swap → drain old →
        close, one replica at a time. Returns a report dict. (Resizing
        the group in the same step, the fleet autoscaler's use, waits
        for ROADMAP Queue A item 8.)"""
        group = self._group(model)
        timeout = float(drain_timeout_s if drain_timeout_s is not None
                        else self.drain_timeout_s)
        t0 = time.perf_counter()
        with group.lock:
            new_version = group.version + 1
            drained = 0
            dropped = 0
            old_after = 0
            steps = []
            for rep_idx, rep in enumerate(group.replicas):
                new_engine = self._build(group.factory, new_version,
                                         rep_idx)
                if not new_engine.warmed:
                    new_engine.warmup()
                old = self.registry.swap(rep.rname, new_engine,
                                         version=new_version)
                # in-flight + queued on the OLD engine at swap time is
                # what the drain must flush
                pending = rep.depth()
                rep.engine = new_engine
                rep.version = new_version
                # fresh engine, fresh health: a breaker tripped by the
                # OLD engine (e.g. a crashed scheduler the operator is
                # reloading to fix) must not route traffic around the
                # replacement for the rest of its cooldown
                rep.breaker = CircuitBreaker(name=rep.rname)
                ok = old.drain(timeout)
                leftover = 0
                if not ok:
                    leftover = (old.queue_depth()
                                if callable(getattr(old, "queue_depth",
                                                    None))
                                else len(old.batcher)
                                if getattr(old, "batcher", None)
                                else 0)
                    dropped += leftover
                drained += max(0, pending - leftover)
                # the old engine leaves the router's stats surface at
                # close; its after-warmup recompiles must not vanish
                # with it (bench/soak sum this field)
                try:
                    old_after += int(old.stats()
                                     .get("recompiles_after_warmup", 0))
                except Exception:
                    pass
                old.close()
                steps.append({"replica": rep.rname,
                              "pending_at_swap": pending,
                              "drained_ok": bool(ok)})
            group.version = new_version
        self._m_reloads.inc()
        return {"model": model, "new_version": new_version,
                "replicas": len(group.replicas), "drained": drained,
                "dropped": dropped, "steps": steps,
                "retired_recompiles_after_warmup": old_after,
                "duration_s": round(time.perf_counter() - t0, 3)}

    # ------------------------------------------------------------------
    # introspection / lifecycle
    # ------------------------------------------------------------------
    def audit(self, model: Optional[str] = None) -> dict:
        """serve3 page-accounting audit across a group's replicas (all
        groups when ``model`` is None): every decode replica's
        :meth:`~mxnet_tpu_torch.serve2.scheduler.DecodeEngine.page_audit`
        snapshot is run through
        :func:`~mxnet_tpu_torch.passes.servelint.lint_page_audit`. Replicas
        without a paged pool (CNN engines) are skipped. A draft/target
        group (factories building ``DecodeEngine(draft_params=...)``)
        audits like any other — the draft shares the target's
        allocator, so one audit covers both models' pages."""
        from ..passes.servelint import lint_page_audit
        models = [model] if model is not None else self.models()
        out = {"findings": [], "replicas": {}}
        for m in models:
            for rep in self._group(m).replicas:
                audit_fn = getattr(rep.engine, "page_audit", None)
                if not callable(audit_fn):
                    continue
                snap = audit_fn()
                findings = lint_page_audit(snap)
                out["replicas"][rep.rname] = {
                    "pages_used": len(snap.get("refcounts") or {}),
                    "cache_pages": len(snap.get("cache_pages") or ()),
                    "findings": len(findings),
                }
                out["findings"].extend(f.to_dict() for f in findings)
        return out

    def frontend(self, model: str) -> "RoutedModel":
        """An engine-duck-typed facade over one group, registrable in a
        front ModelRegistry for the HTTP endpoint."""
        return RoutedModel(self, model)

    def stats(self) -> dict:
        out = {"name": self.name, "models": {}}
        for model, g in sorted(self._groups.items()):
            reps = []
            for r in g.replicas:
                r.export()
                reps.append({
                    "replica": r.rname,
                    "version": r.version,
                    "depth": r.depth(),
                    "breaker": r.breaker.describe(),
                })
            out["models"][model] = {"version": g.version,
                                    "replicas": reps}
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        ok = True
        for g in self._groups.values():
            for r in g.replicas:
                ok = r.engine.drain(timeout) and ok
        return ok

    def close(self):
        for g in self._groups.values():
            for r in g.replicas:
                r.engine.close()
                r.retire_gauges()


class RoutedModel:
    """Duck-typed "engine" over one router group, so the existing
    :class:`~mxnet_tpu_torch.serve.endpoint.ServingEndpoint` can serve a
    routed model without knowing about routers."""

    def __init__(self, router: Router, model: str):
        self._router = router
        self.model = model
        self.name = model

    @property
    def input_specs(self):
        return self._router._group(self.model).replicas[0] \
            .engine.input_specs

    @property
    def warmed(self) -> bool:
        return all(r.engine.warmed
                   for r in self._router._group(self.model).replicas)

    def warmup(self, input_specs=None):
        reports = []
        for r in self._router._group(self.model).replicas:
            if not r.engine.warmed:
                reports.extend(r.engine.warmup())
        return reports

    def predict(self, data, timeout_ms: Optional[float] = None):
        return self._router.predict(self.model, data,
                                    timeout_ms=timeout_ms)

    def audit_report(self) -> dict:
        """The endpoint's ``GET /v1/models/<m>:audit`` hook: page-
        accounting audit across every replica of this group."""
        return self._router.audit(self.model)

    def stats(self) -> dict:
        g = self._router._group(self.model)
        return {"name": self.model, "kind": "routed",
                "warmed": self.warmed, "version": g.version,
                "replicas": [r.engine.stats() for r in g.replicas]}

    def drain(self, timeout: Optional[float] = None) -> bool:
        # no all(generator): a replica that fails to drain must not
        # stop the later replicas from being drained at all
        ok = True
        for r in self._router._group(self.model).replicas:
            ok = r.engine.drain(timeout) and ok
        return ok

    def close(self):
        for r in self._router._group(self.model).replicas:
            r.engine.close()
