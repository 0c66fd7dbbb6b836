"""Multi-model registry + stdlib HTTP JSON endpoint.

Counterpart of ``mxnet_tpu/serve/endpoint.py`` (its trace spans and the
SIGTERM flight dump wait for ROADMAP Queue A item 8). A thin,
dependency-free front door for :class:`ServingEngine`, a serve2
``DecodeEngine`` or a router's ``RoutedModel``:
``http.server.ThreadingHTTPServer`` (one thread per connection — the
dynamic batcher is what turns that concurrency into batched device
dispatches) with the conventional serving surface:

- ``GET  /healthz``                     — liveness (always 200 while up)
- ``GET  /readyz``                      — readiness: 200 only when every
  registered engine is warmed and the endpoint is not draining
- ``GET  /metrics``                     — Prometheus exposition of the
  metrics registry (queue depth, occupancy, p50/p99, recompiles)
- ``GET  /v1/models``                   — model list + stats
- ``GET  /v1/models/<name>``            — one model's stats
- ``POST /v1/models/<name>:predict``    — ``{"inputs": ...}`` →
  ``{"outputs": ...}``
- ``POST /v1/models/<name>:warmup``     — run AOT warmup, return report
- ``POST /admin/drain``                 — graceful drain: readiness goes
  503, queues flush, in-flight requests finish, then the server stops.

JSON body for predict: ``inputs`` is a (nested) list for single-input
models, or a list of such per input for multi-input models (dtype comes
from the engine's input specs). Row results come back as nested lists.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as onp

from ..base import MXNetError
from ..telemetry import metrics as _metrics
from .batcher import (BatcherStoppedError, DeadlineExceededError,
                      QueueFullError)
from .engine import ServingEngine

__all__ = ["ModelRegistry", "ServingEndpoint"]

# mxserve_models_registered is one PROCESS-WIDE gauge, and serve2 makes
# multiple live registries per process the norm (a router's registry +
# the endpoint's front registry) — each registry publishing its own
# len() would be last-writer-wins garbage, so they share this tally
_registered_lock = threading.Lock()
_registered_total = 0


def _count_registered(delta: int) -> None:
    global _registered_total
    with _registered_lock:
        _registered_total += delta
        count = _registered_total
    _metrics.gauge("mxserve_models_registered",
                   "engines registered across all serving registries "
                   "in this process").set(count)


class ModelRegistry:
    """Thread-safe name → :class:`ServingEngine` map with version
    pinning.

    Every registration carries a monotonically-increasing **version**
    (explicit, or auto-assigned). :meth:`swap` atomically replaces the
    engine behind a name with a newer version and returns the old one
    for the caller to drain — the serve2 router's rolling-reload
    primitive. Clients that must not silently cross a model version
    pass ``version=`` to :meth:`get`: a mismatch raises instead of
    serving from the wrong weights.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, ServingEngine] = {}
        self._versions: Dict[str, int] = {}

    def register(self, name: str, engine: ServingEngine,
                 warmup: bool = False,
                 version: Optional[int] = None) -> ServingEngine:
        if warmup and not engine.warmed:
            engine.warmup()
        with self._lock:
            if name in self._models:
                raise MXNetError(f"model {name!r} already registered "
                                 "(use swap() to replace it)")
            self._models[name] = engine
            self._versions[name] = int(version) if version is not None \
                else 1
        _count_registered(+1)
        return engine

    def swap(self, name: str, engine: ServingEngine,
             version: Optional[int] = None) -> ServingEngine:
        """Atomically replace ``name``'s engine; returns the OLD engine
        (still live — the caller owns draining and closing it, so
        in-flight requests on the old version finish untouched).
        ``version`` must be newer than the current one (default:
        current + 1); a stale version is refused, which is what makes
        concurrent reloads safe to retry."""
        with self._lock:
            if name not in self._models:
                raise MXNetError(f"model {name!r} not registered")
            cur = self._versions[name]
            new = int(version) if version is not None else cur + 1
            if new <= cur:
                raise MXNetError(
                    f"swap of {name!r} with stale version {new} "
                    f"(current {cur})")
            old = self._models[name]
            self._models[name] = engine
            self._versions[name] = new
        return old

    def version_of(self, name: str) -> int:
        with self._lock:
            if name not in self._versions:
                raise MXNetError(f"model {name!r} not registered")
            return self._versions[name]

    def unregister(self, name: str, close: bool = True) -> None:
        with self._lock:
            engine = self._models.pop(name, None)
            self._versions.pop(name, None)
        if engine is None:
            raise MXNetError(f"model {name!r} not registered")
        if close:
            engine.close()
        _count_registered(-1)

    def get(self, name: str,
            version: Optional[int] = None) -> ServingEngine:
        """Look up an engine; ``version=`` pins the call to a specific
        model version (raises on mismatch instead of silently serving
        newer/older weights across a rolling reload)."""
        with self._lock:
            engine = self._models.get(name)
            have = sorted(self._models)
            cur = self._versions.get(name)
        if engine is None:
            raise MXNetError(f"model {name!r} not registered "
                             f"(have: {have})")
        if version is not None and int(version) != cur:
            raise MXNetError(
                f"model {name!r} is at version {cur}, caller pinned "
                f"version {int(version)}")
        return engine

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def engines(self) -> List[ServingEngine]:
        with self._lock:
            return list(self._models.values())

    def items(self) -> List:
        """Consistent (name, engine) snapshot in one lock acquisition —
        handlers iterate this, never names()+get() (a concurrent
        unregister between the two would raise mid-response)."""
        with self._lock:
            return sorted(self._models.items())

    def all_ready(self) -> bool:
        with self._lock:
            engines = list(self._models.values())
        return all(e.warmed for e in engines)


def _json_bytes(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


class _Handler(BaseHTTPRequestHandler):
    # the endpoint instance is attached to the server object
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.endpoint.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    # -- helpers -------------------------------------------------------
    def _send(self, code: int, obj, headers=None):
        body = _json_bytes(obj)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _endpoint(self) -> "ServingEndpoint":
        return self.server.endpoint  # type: ignore[attr-defined]

    # -- routes --------------------------------------------------------
    def do_GET(self):  # noqa: N802 — http.server API
        ep = self._endpoint()
        path = self.path.split("?")[0]
        if path == "/healthz":
            return self._send(200, {"status": "alive"})
        if path == "/readyz":
            if ep.draining:
                return self._send(503, {"status": "draining"})
            if not ep.registry.all_ready():
                return self._send(
                    503, {"status": "warming",
                          "models": {n: e.warmed
                                     for n, e in ep.registry.items()}})
            return self._send(200, {"status": "ready"})
        if path == "/metrics":
            text = _metrics.to_prometheus().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)
            return
        if path == "/v1/models":
            return self._send(200, {
                "models": [e.stats()
                           for _, e in ep.registry.items()]})
        if path.startswith("/v1/models/") and path.endswith(":audit"):
            # serve3 page-accounting audit: refcount/block-table/
            # prefix-cache cross-check as servelint findings (decode
            # engines only — others have no paged pool to audit)
            name = path[len("/v1/models/"):-len(":audit")]
            try:
                engine = ep.registry.get(name)
            except MXNetError as e:
                return self._send(404, {"error": str(e)})
            # a routed model audits every replica through its router
            # (RoutedModel.audit_report); a bare decode engine exposes
            # its own page_audit snapshot
            report = getattr(engine, "audit_report", None)
            if callable(report):
                return self._send(200, dict(report(), model=name))
            audit = getattr(engine, "page_audit", None)
            if not callable(audit):
                return self._send(400, {
                    "error": f"model {name!r} has no paged KV pool "
                             "to audit"})
            from ..passes.servelint import lint_page_audit
            snapshot = audit()
            findings = [f.to_dict() for f in lint_page_audit(snapshot)]
            return self._send(200, {"model": name, "audit": snapshot,
                                    "findings": findings})
        if path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            try:
                return self._send(200, ep.registry.get(name).stats())
            except MXNetError as e:
                return self._send(404, {"error": str(e)})
        return self._send(404, {"error": f"no route {path!r}"})

    def do_POST(self):  # noqa: N802 — http.server API
        ep = self._endpoint()
        path = self.path.split("?")[0]
        if path == "/admin/drain":
            threading.Thread(target=ep.drain, daemon=True).start()
            return self._send(202, {"status": "draining"})
        if path == "/admin/reload":
            if ep.reloader is None:
                return self._send(
                    404, {"error": "no reloader configured (start the "
                                    "endpoint over a serve2 Router)"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError(
                        f"body must be a JSON object, got "
                        f"{type(payload).__name__}")
                model = payload.get("model")
            except ValueError as e:
                return self._send(400, {"error": f"bad JSON body: {e}"})
            try:
                report = ep.reloader(model)
            except MXNetError as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — JSON 500, not a drop
                return self._send(500,
                                  {"error": f"{type(e).__name__}: {e}"})
            return self._send(200, report)
        if path.startswith("/v1/models/") and ":" in path:
            name, _, verb = path[len("/v1/models/"):].rpartition(":")
            try:
                engine = ep.registry.get(name)
            except MXNetError as e:
                return self._send(404, {"error": str(e)})
            if verb == "warmup":
                try:
                    return self._send(200, {"report": engine.warmup()})
                except MXNetError as e:
                    return self._send(400, {"error": str(e)})
            if verb == "predict":
                return self._predict(ep, engine)
            return self._send(404, {"error": f"unknown verb {verb!r}"})
        return self._send(404, {"error": f"no route {path!r}"})

    # latency histogram tagging: EVERY request (error paths included)
    # lands in the base histogram AND an outcome-suffixed one — error
    # storms must move p99, not flatter it by only sampling successes
    _OUTCOME_OF_CODE = {200: "ok", 400: "bad_request", 429: "shed",
                        503: "unavailable", 504: "deadline",
                        500: "error"}

    def _predict(self, ep: "ServingEndpoint", engine: ServingEngine):
        t0 = time.perf_counter()
        code = 500
        try:
            code, obj = self._predict_inner(ep, engine, t0)
        finally:
            dt = time.perf_counter() - t0
            outcome = self._OUTCOME_OF_CODE.get(code, "error")
            _metrics.histogram(
                "mxserve_request_seconds",
                "endpoint predict wall time, ALL outcomes").observe(dt)
            _metrics.histogram(
                f"mxserve_request_seconds_{outcome}",
                f"endpoint predict wall time, outcome={outcome}"
            ).observe(dt)
        return self._send(code, obj)

    def _predict_inner(self, ep: "ServingEndpoint",
                       engine: ServingEngine, t0: float):
        if ep.draining:
            return 503, {"error": "endpoint is draining"}
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise TypeError(
                    f"body must be a JSON object, got "
                    f"{type(payload).__name__}")
            inputs = payload["inputs"]
        except (ValueError, KeyError, TypeError) as e:
            return 400, {"error": f"bad JSON body: {e}"}
        specs = engine.input_specs
        try:
            if specs and len(specs) > 1:
                data = [onp.asarray(x, dtype=s.dtype)
                        for x, s in zip(inputs, specs)]
            else:
                dtype = specs[0].dtype if specs else "float32"
                data = onp.asarray(inputs, dtype=dtype)
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad inputs: {e}"}
        try:
            out = engine.predict(
                data, timeout_ms=payload.get("timeout_ms"))
        except QueueFullError as e:
            return 429, {"error": str(e)}
        except DeadlineExceededError as e:
            return 504, {"error": str(e)}
        except BatcherStoppedError as e:
            return 503, {"error": str(e)}
        except MXNetError as e:
            # a routed model with every replica refusing is a SERVER
            # outage, not a client error: it must land in the
            # 'unavailable' outcome histogram (and give clients a
            # retryable 503), or an outage storm files as bad_request
            # (lazy import: serve2.router imports this module)
            from ..serve2.router import AllReplicasUnavailable
            if isinstance(e, AllReplicasUnavailable):
                return 503, {"error": str(e)}
            return 400, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — model errors: the client
            # must get a JSON 500, not a dropped connection
            return 500, {"error": f"{type(e).__name__}: {e}"}
        outs = [o.tolist() for o in out] if isinstance(out, list) \
            else out.tolist()
        return 200, {"outputs": outs, "model": engine.name,
                     "latency_ms": (time.perf_counter() - t0) * 1000.0}


class ServingEndpoint:
    """The HTTP front door. ``start()`` serves on a background thread;
    ``drain()`` performs the graceful-shutdown dance."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 host: str = "127.0.0.1", port: int = 8080,
                 verbose: bool = False, reloader=None):
        self.registry = registry or ModelRegistry()
        self.verbose = verbose
        # optional ``reloader(model_name) -> report dict`` hook backing
        # POST /admin/reload (the serve2 Router's rolling_reload)
        self.reloader = reloader
        self.draining = False
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._server.endpoint = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self, background: bool = True):
        if background:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="mxserve-endpoint", daemon=True)
            self._thread.start()
        else:
            self._server.serve_forever()
        return self

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Graceful drain: readiness flips to 503 (load balancers stop
        routing), every engine's batcher flushes, then the listener
        stops. Returns True when every queue drained in time."""
        self.draining = True
        ok = all(e.drain(timeout) for e in self.registry.engines())
        self.stop()
        return ok

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
