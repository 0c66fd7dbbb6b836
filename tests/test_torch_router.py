"""The port's router tier (``serve2/router.py``), circuit breaker
(``resil/policy.py``), model registry and HTTP endpoint
(``serve/endpoint.py``) and servelint (``passes/servelint.py``) on the CPU.

The router and registry are host logic: they are driven here over cheap
replicas (an echo ``ServingEngine`` and failing duck-typed engines) and,
for the reload under load and the HTTP round trip, over the port's
``DecodeEngine``. servelint is held to the JAX package's: the same report
and audit dicts must give the same (check, severity, object) findings.
"""
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

from mxnet_tpu.parallel.pipeline_lm import init_pipeline_lm as jinit
from mxnet_tpu.passes import servelint as jlint
from mxnet_tpu_torch import MXNetError, config
from mxnet_tpu_torch.convert import pipeline_lm_from_mxnet_tpu
from mxnet_tpu_torch.passes import servelint
from mxnet_tpu_torch.resil import CircuitBreaker, CircuitOpenError
from mxnet_tpu_torch.serve import (BatcherStoppedError, BucketLadder,
                                   InvalidRequestError,
                                   ModelRegistry, ServingEndpoint,
                                   ServingEngine)
from mxnet_tpu_torch.serve.loadgen import run_loadgen
from mxnet_tpu_torch.serve2 import (AllReplicasUnavailable, DecodeEngine,
                                    EngineCrashedError, PagePoolExhausted,
                                    Router)
from mxnet_tpu_torch.telemetry import metrics


@pytest.fixture(scope="module")
def lm_params():
    return pipeline_lm_from_mxnet_tpu(jax.tree.map(np.asarray, jinit(
        0, vocab=32, d_model=16, n_layers=2, n_heads=2, d_head=8, d_ff=32,
        n_experts=2)), "cpu")


def _decode_engine(params, name, **kw):
    args = dict(page_size=4, num_pages=32, max_inflight=4,
                prefill_buckets=[8], max_new_default=4, max_seq_len=16,
                name=name, device="cpu")
    args.update(kw)
    return DecodeEngine(params, **args)


def _echo_engine(name, ladder=(1, 2, 4)):
    return ServingEngine(lambda x: x * 2.0, input_specs=[(3,)],
                         ladder=BucketLadder(list(ladder)), name=name,
                         max_linger_ms=0.5, device="cpu")


class _FailingEngine:
    """A replica that raises ``exc`` on every call."""

    def __init__(self, exc=RuntimeError):
        self.name, self.warmed, self.input_specs = "failing", True, None
        self.exc, self.calls = exc, 0

    def warmup(self, input_specs=None):
        return []

    def predict(self, data, timeout_ms=None):
        self.calls += 1
        raise self.exc("replica down")

    def queue_depth(self):
        return 0

    def stats(self):
        return {"name": self.name}

    def drain(self, timeout=None):
        return True

    def close(self):
        pass


@pytest.fixture
def breaker_failures():
    def set_(n):
        config.set_flag("MXRESIL_BREAKER_FAILURES", n)
    yield set_
    config.unset_flag("MXRESIL_BREAKER_FAILURES")


def test_failover_and_breaker_degradation(breaker_failures):
    breaker_failures(3)
    router = Router(name="t-router")
    bad = _FailingEngine()
    built = []

    def factory(version):
        e = bad if not built else _echo_engine(f"ok{len(built)}")
        built.append(e)
        return e

    router.add_group("m", factory, n_replicas=2)
    x = np.ones((1, 3), "float32")
    for _ in range(8):
        assert np.array_equal(router.predict("m", x, timeout_ms=1e4), x * 2)
    assert router._group("m").replicas[0].breaker.state == "open"
    calls = bad.calls
    for _ in range(5):
        router.predict("m", x, timeout_ms=1e4)
    assert bad.calls == calls          # routed around, not re-called
    assert router.stats()["models"]["m"]["replicas"][0]["breaker"][
        "state"] == "open"
    router.close()


@pytest.mark.parametrize("exc,tripped", [(EngineCrashedError, True),
                                         (MXNetError, True),
                                         (BatcherStoppedError, False)])
def test_all_replicas_down_and_crashes_mark_the_breaker(breaker_failures,
                                                       exc, tripped):
    breaker_failures(1)
    router = Router(name=f"down-{exc.__name__}")
    router.add_group("m", lambda v: _FailingEngine(exc), n_replicas=2)
    dropped = metrics.counter("mxserve2_router_dropped_total").value()
    with pytest.raises(AllReplicasUnavailable):
        router.predict("m", np.ones((1, 3), "float32"))
    assert metrics.counter("mxserve2_router_dropped_total").value() \
        == dropped + 1
    states = {r.breaker.state for r in router._group("m").replicas}
    assert states == {"open" if tripped else "closed"}
    router.close()


def test_client_errors_propagate_without_retry_or_mark(breaker_failures,
                                                       lm_params):
    eng = _decode_engine(lm_params, "cli-err", num_pages=6, max_seq_len=24)
    with pytest.raises(InvalidRequestError):
        eng.predict(np.zeros((2, 3), "int32"))
    with pytest.raises(InvalidRequestError):
        eng.submit([1, 2], max_new_tokens=0)
    with pytest.raises(PagePoolExhausted):
        eng.submit([1, 2, 3, 4], max_new_tokens=17)   # > the whole pool
    eng.close()
    breaker_failures(2)
    for exc in (InvalidRequestError, PagePoolExhausted):
        router = Router(name=f"cli-{exc.__name__}")
        engines = []

        def factory(version, replica, _e=engines, _x=exc):
            _e.append(_FailingEngine(_x))
            return _e[-1]

        router.add_group("m", factory, n_replicas=2)
        for _ in range(4):
            with pytest.raises(exc):
                router.predict("m", np.ones((1, 3), "float32"))
        assert engines[0].calls + engines[1].calls == 4
        assert {r.breaker.state for r in router._group("m").replicas} \
            == {"closed"}
        router.close()


def test_breaker_half_open_probe_and_reset():
    now = [0.0]
    b = CircuitBreaker("t", failure_threshold=2, cooldown_s=5.0,
                       clock=lambda: now[0])
    b.record_failure()
    b.check()
    b.record_failure()
    assert b.state == "open"
    with pytest.raises(CircuitOpenError):
        b.check()
    now[0] = 5.0
    assert b.state == "half_open"
    b.check()                          # the one probe
    with pytest.raises(CircuitOpenError):
        b.check()
    b.record_failure()                 # the probe failed: open again
    assert b.state == "open"
    now[0] = 10.0
    b.check()
    b.record_success()
    assert b.describe()["state"] == "closed"


def test_reload_resets_breaker_and_close_retires_gauges(breaker_failures):
    breaker_failures(1)

    def factory(version, replica):
        return _FailingEngine(EngineCrashedError) if version == 1 \
            else _echo_engine(f"heal-v{version}-r{replica}")

    router = Router(name="heal")
    router.add_group("m", factory, n_replicas=1)
    x = np.ones((1, 3), "float32")
    with pytest.raises(AllReplicasUnavailable):
        router.predict("m", x)
    rep = router._group("m").replicas[0]
    gauges = (rep.depth_gauge.name, rep.breaker_gauge.name)
    assert router.rolling_reload("m")["new_version"] == 2
    assert rep.breaker.state == "closed"
    assert np.array_equal(router.predict("m", x, timeout_ms=1e4), x * 2)
    assert all(g in metrics.all_metrics() for g in gauges)
    router.close()
    assert not [g for g in gauges if g in metrics.all_metrics()]


def test_rolling_reload_under_load_drops_nothing(lm_params):
    """Two DecodeEngine replicas, reloaded while 6 clients send 40
    prompts: every request answers with the greedy tokens a direct
    predict gives, none dropped, both replicas at version 2."""
    router = Router(name="reload")
    router.add_group("lm", lambda v, r: _decode_engine(
        lm_params, f"reload-r{r}-v{v}"), n_replicas=2)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 32, size=(1 + i % 7,)).astype("int32")
               for i in range(40)]
    results, box = {}, {}

    def fire(i):
        results[i] = router.predict("lm", prompts[i], timeout_ms=60000.0)

    def reload_mid():
        time.sleep(0.05)
        box["report"] = router.rolling_reload("lm")

    t = threading.Thread(target=reload_mid, daemon=True)
    t.start()
    res = run_loadgen(fire, list(range(len(prompts))), concurrency=6)
    t.join(60.0)
    assert not t.is_alive()
    assert res["completed"] == len(prompts) and not res["errors"]
    assert box["report"]["dropped"] == 0
    assert box["report"]["new_version"] == 2
    assert router.registry.version_of("lm/r0") == 2
    assert router.registry.version_of("lm/r1") == 2
    ref = _decode_engine(lm_params, "reload-ref")
    try:
        for i in (0, 5, 13):
            assert results[i].tolist() == ref.predict(prompts[i]).tolist()
    finally:
        ref.close()
    audit = router.audit("lm")
    assert set(audit["replicas"]) == {"lm/r0", "lm/r1"}
    assert audit["findings"] == []
    router.close()


def test_router_without_a_device_builds_cuda_engines(lm_params):
    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    router = Router(name="cuda-default")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        router.add_group("lm", lambda v: DecodeEngine(
            lm_params, num_pages=8, prefill_buckets=[8]), n_replicas=1)


def test_registry_version_pinning_and_swap():
    reg = ModelRegistry()
    e1, e2 = _echo_engine("v1"), _echo_engine("v2")
    try:
        reg.register("m", e1)
        assert reg.version_of("m") == 1 and reg.get("m", version=1) is e1
        with pytest.raises(MXNetError):
            reg.get("m", version=2)
        assert reg.swap("m", e2) is e1 and reg.get("m") is e2
        assert reg.version_of("m") == 2
        with pytest.raises(MXNetError):
            reg.swap("m", e1, version=2)
        with pytest.raises(MXNetError):
            reg.register("m", e1)
        reg.unregister("m", close=False)
        assert reg.names() == []
    finally:
        e1.close()
        e2.close()


def _key(findings):
    return sorted((f.check, f.severity, f.obj) for f in findings)


GOOD = {"name": "g", "warmed": True, "decode_rungs": (1, 2),
        "prefill_rungs": (8,),
        "compiled": [("decode", 1), ("decode", 2), ("prefill", 8)],
        "donate_mode": "auto", "donate_pages": True, "backend": "tpu",
        "recompiles_after_warmup": 0}
REPORTS = [
    GOOD,
    dict(GOOD, compiled=GOOD["compiled"] + [("decode", 3)],
         donate_pages=False, donate_mode="off", recompiles_after_warmup=2),
    dict(GOOD, compiled=[("decode", 1), ("prefill", 8), ("mystery", 1)]),
    dict(GOOD, warmed=False, backend="cpu", donate_pages=False),
    dict(GOOD, backend="cpu", donate_mode="off", donate_pages=False,
         verify_rungs=(1, 2), prefill_ext_rungs=(8,)),
]
AUDITS = [
    {"name": "g", "page_size": 4, "admitting": 0,
     "refcounts": {3: 2, 5: 1, 9: 1},
     "sequences": {1: {"pages": [3, 5], "length": 5},
                   2: {"pages": [3, 9], "length": 6}}, "cache_pages": []},
    {"name": "b", "page_size": 4, "admitting": 0,
     "refcounts": {3: 2, 7: 1, 9: 3},
     "sequences": {1: {"pages": [3, 0, 5, 5], "length": 9},
                   2: {"pages": [3], "length": 2}}, "cache_pages": [9]},
    {"name": "m", "page_size": 4, "admitting": 1,
     "refcounts": {3: 1, 7: 1}, "sequences": {}, "cache_pages": []},
]


@pytest.mark.parametrize("i", range(len(REPORTS)))
def test_servelint_report_findings_equal_jax(i):
    assert _key(servelint.lint_serve_report(REPORTS[i])) == \
        _key(jlint.lint_serve_report(REPORTS[i]))


@pytest.mark.parametrize("i", range(len(AUDITS)))
def test_servelint_audit_findings_equal_jax(i):
    got = servelint.lint_page_audit(AUDITS[i])
    assert _key(got) == _key(jlint.lint_page_audit(AUDITS[i]))
    assert all(set(f.to_dict()) >= {"pass", "check", "obj", "severity",
                                    "message"} for f in got)


def test_http_endpoint_round_trip(lm_params):
    eng = _decode_engine(lm_params, "http-lm")
    eng.warmup()
    reg = ModelRegistry()
    reg.register("lm", eng)
    ep = ServingEndpoint(reg, host="127.0.0.1", port=0).start()
    try:
        prompt = [3, 9, 1, 4, 7]

        def call(method, path, body=None):
            req = urllib.request.Request(
                ep.address + path, method=method,
                data=None if body is None else json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, body = call("POST", "/v1/models/lm:predict",
                          {"inputs": prompt})
        assert code == 200 and body["model"] == "http-lm"
        assert body["outputs"] == eng.predict(prompt).tolist()
        assert call("GET", "/readyz")[0] == 200
        code, audit = call("GET", "/v1/models/lm:audit")
        assert code == 200 and audit["findings"] == []
        assert call("POST", "/v1/models/lm:predict", {"x": 1})[0] == 400
        assert call("POST", "/v1/models/nope:predict",
                    {"inputs": prompt})[0] == 404
        with urllib.request.urlopen(ep.address + "/metrics",
                                    timeout=60) as r:
            assert b"mxserve_request_seconds" in r.read()
    finally:
        assert ep.drain(30.0)
        reg.unregister("lm")
