"""The port's serving layer against the JAX package's, on the CPU.

Bucket decisions must be identical. ``ServingEngine(device="cpu")``
serving a small BERT must return what the JAX ``ServingEngine`` returns
for the same mixed-length requests: the same padding onto the same rungs,
the same unpadding, outputs within rtol 1e-4 / atol 1e-5 (fp32, XLA:CPU
vs ATen summation orders), and no new padded signature after warmup.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import BERTModel as JaxBERT
from mxnet_tpu.serve import InputSpec as JaxInputSpec
from mxnet_tpu.serve import ServingEngine as JaxEngine
from mxnet_tpu.serve import buckets as jax_buckets
from mxnet_tpu.serve.engine import _unpad_output as jax_unpad
from mxnet_tpu.telemetry.metrics import percentile_of as jax_percentile
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import mxnet_tpu_shapes, params_from_mxnet_tpu
from mxnet_tpu_torch.models import BERTModel as TorchBERT
from mxnet_tpu_torch.serve import (DynamicBatcher, InputSpec, QueueFullError,
                                   ServingEngine, run_loadgen)
from mxnet_tpu_torch.serve import buckets as torch_buckets
from mxnet_tpu_torch.serve.engine import _unpad_output as torch_unpad
from mxnet_tpu_torch.telemetry.metrics import percentile_of

from test_torch_resnet_train import keep_zeros

RTOL, ATOL = 1e-4, 1e-5
V, C, L, H, FFN, MAXLEN = 100, 64, 2, 4, 128, 64
LADDER = "batch:1,2,4;seq:16,32"
SPECS = ["1,2,4,8,16,32", "4,1,2", "batch:1,2,4,8;seq:16,32,64",
         "batch:2,8;axis2:3,5;seq:10", " batch:1 ; axis1:4,8 "]
BAD_SPECS = ["", "batch:", "seq:16,32", "1,x", "batch:0,2", "foo:1",
             "batch:1;axisq:2", "batch:1;axis0:"]


def _ladders(spec):
    return (jax_buckets.parse_bucket_spec(spec),
            torch_buckets.parse_bucket_spec(spec))


@pytest.mark.parametrize("spec", SPECS)
def test_bucket_ladder_decisions_equal_jax(spec):
    jl, tl = _ladders(spec)
    assert (tl.batch_buckets, tl.dim_buckets) == \
        (jl.batch_buckets, jl.dim_buckets)
    assert (tl.spec(), repr(tl), tl.max_batch) == \
        (jl.spec(), repr(jl), jl.max_batch)
    for n in range(1, tl.max_batch + 1):
        assert tl.batch_bucket(n) == jl.batch_bucket(n)
    for item in [(1,), (7,), (16,), (3, 4), (10, 3, 2), (1, 5, 9)]:
        try:
            want = jl.pad_item_shape(item)
        except jax_buckets.BucketOverflowError:
            with pytest.raises(torch_buckets.BucketOverflowError):
                tl.pad_item_shape(item)
            continue
        assert tl.pad_item_shape(item) == want
        assert tl.item_shape_combos(item) == jl.item_shape_combos(item)
        assert tl.warmup_shapes(item) == jl.warmup_shapes(item)
        assert tl.program_count(item) == jl.program_count(item)
        arrays = [np.zeros((1,) + item, "int32")]
        assert tl.signature(arrays) == jl.signature(arrays)
    with pytest.raises(torch_buckets.BucketOverflowError):
        tl.batch_bucket(tl.max_batch + 1)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_bucket_specs_raise_in_both(spec):
    with pytest.raises(mx.base.MXNetError):
        jax_buckets.parse_bucket_spec(spec)
    with pytest.raises(MXNetError):
        torch_buckets.parse_bucket_spec(spec)


def test_default_ladder_equals_jax():
    assert torch_buckets.default_ladder().spec() == \
        jax_buckets.default_ladder().spec()


@pytest.mark.parametrize("case", [
    ((2, 32, 100), [(20,)], [(32,)]),
    ((2, 32), [(20,)], [(32,)]),
    ((3, 8, 5), [(8, 3)], [(8, 5)]),
    ((1, 16, 16), [(10,), (16,)], [(16,), (16,)]),
    ((2, 4), [(4,)], [(4,)]),
])
def test_unpad_equals_jax(case):
    out_shape, orig, padded = case
    rows = np.arange(np.prod(out_shape), dtype="float32").reshape(out_shape)
    np.testing.assert_array_equal(torch_unpad(rows, orig, padded),
                                  jax_unpad(rows, orig, padded))


def test_percentile_of_equals_jax():
    rng = np.random.RandomState(0)
    for n in (0, 1, 2, 7, 100):
        vals = sorted(rng.rand(n).tolist())
        for q in (0, 50, 90, 99, 100):
            assert percentile_of(vals, q) == jax_percentile(vals, q)


def _models():
    """A small JAX BERT and the port's, with the same seeded weights. The
    JAX net's deferred shapes come from the port's model (its names and
    dims are held to JAX's after a JAX forward in
    ``test_torch_transformer.py``), not from an eager forward that would
    compile every op, and it starts from zeros, not a random draw that
    compiles a program per shape (``keep_zeros``)."""
    tb = TorchBERT(vocab_size=V, units=C, num_layers=L, num_heads=H,
                   hidden_size=FFN, max_len=MAXLEN, device="cpu")
    jb = JaxBERT(vocab_size=V, units=C, num_layers=L, num_heads=H,
                 hidden_size=FFN, max_len=MAXLEN)
    jb.initialize(keep_zeros)
    shapes = mxnet_tpu_shapes(tb)
    rng = np.random.RandomState(11)
    named = {}
    for n, p in sorted(jb._collect_params_with_prefix().items()):
        p.shape = shapes[n]
        p._finish_deferred_init()
        w = rng.randn(*p.shape).astype("float32") * 0.1
        named[n] = w + 1.0 if n.endswith("gamma") else w
        p.set_data(mx.nd.array(named[n]))
    tb.load_state_dict(params_from_mxnet_tpu(named, tb))
    return jb, tb


def _requests(seed, n=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, (rng.randint(1, 4), rng.randint(1, 33)))
            .astype("int32") for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    """The two models and the JAX engine over its model, warmed once for
    this file (its programs compile once)."""
    jb, tb = _models()
    je = JaxEngine(jb, input_specs=[JaxInputSpec((32,), "int32")],
                   ladder=jax_buckets.parse_bucket_spec(LADDER),
                   batching=False)
    je.warmup()
    yield je, tb
    je.close()


def _engine(tb, batching):
    te = ServingEngine(tb, input_specs=[InputSpec((32,), "int32")],
                       ladder=torch_buckets.parse_bucket_spec(LADDER),
                       batching=batching, device="cpu")
    te.warmup()
    return te


def test_engine_matches_jax_engine_direct(models):
    je, tb = models
    te = _engine(tb, batching=False)
    # the JAX engine's padding tally over this test's requests alone
    pad_sum, pad_n = je._pad_sum, je._pad_n
    try:
        for req in _requests(0):
            want = je.predict(req)
            got = te.predict(req)
            assert got.shape == want.shape == req.shape + (V,)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        js, ts = je.stats(), te.stats()
        assert ts["programs_compiled"] == js["programs_compiled"] == 6
        assert ts["recompiles_after_warmup"] == \
            js["recompiles_after_warmup"] == 0
        assert ts["avg_padding_ratio"] == round(
            (je._pad_sum - pad_sum) / (je._pad_n - pad_n), 4)
    finally:
        te.close()


def test_engine_batched_under_load_matches_jax_engine(models):
    """Through the batcher, concurrent requests share dispatches; BERT
    rows are independent, so each still gets the JAX engine's answer."""
    je, tb = models
    te = _engine(tb, batching=True)
    reqs = _requests(1, n=12)
    got = {}
    try:
        res = run_loadgen(lambda i: got.__setitem__(i, te.predict(reqs[i])),
                          list(range(len(reqs))), concurrency=4)
        assert res["completed"] == len(reqs) and not res["errors"]
        for i, req in enumerate(reqs):
            np.testing.assert_allclose(got[i], je.predict(req), rtol=RTOL,
                                       atol=ATOL)
        stats = te.stats()
        assert stats["recompiles_after_warmup"] == 0
        assert stats["batcher"]["requests"] == len(reqs)
    finally:
        te.close()


def test_engine_new_signature_after_warmup_counts():
    """A request off the warmed set (no seq ladder here) is recorded as a
    signature after warmup, like the JAX engine's recompile alarm."""
    from mxnet_tpu_torch.serve import BucketLadder
    te = ServingEngine(lambda x: x * 2.0, input_specs=[InputSpec((3,))],
                       ladder=BucketLadder([1, 2]), batching=False,
                       device="cpu")
    te.warmup()
    out = te.predict(np.ones((1, 3), "float32"))
    np.testing.assert_array_equal(out, np.full((1, 3), 2.0, "float32"))
    assert te.stats()["recompiles_after_warmup"] == 0
    te.predict(np.ones((1, 5), "float32"))
    assert te.stats()["recompiles_after_warmup"] == 1


def test_engine_takes_tensors_and_multi_input():
    te = ServingEngine(lambda a, b: a + 2.0 * b, batching=False,
                       device="cpu")
    a = torch.ones(2, 3)
    b = np.full((2, 3), 0.5, "float32")
    np.testing.assert_allclose(te.predict([a, b]), np.full((2, 3), 2.0))
    assert te.stats()["kind"] == "callable"


def test_engine_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        ServingEngine(lambda x: x)


def test_batcher_load_shed_and_dispatch_error():
    gate = threading.Event()

    def slow(key, reqs):
        gate.wait(5)
        return [r.arrays[0] for r in reqs]

    b = DynamicBatcher(slow, max_batch_size=1, max_linger_ms=0,
                       queue_depth=1)
    try:
        first = b.submit_async([np.zeros(1)], 1, "k")
        t_end = time.monotonic() + 5
        while b._in_flight == 0 and time.monotonic() < t_end:
            time.sleep(0.005)
        assert b._in_flight == 1
        b.submit_async([np.zeros(1)], 1, "k")
        with pytest.raises(QueueFullError):
            b.submit_async([np.zeros(1)], 1, "k")
        gate.set()
        assert first.wait(5) and first.error is None
    finally:
        gate.set()
        b.stop()

    def broken(key, reqs):
        raise ValueError("boom")

    b = DynamicBatcher(broken, max_batch_size=2, max_linger_ms=0,
                       queue_depth=4)
    try:
        with pytest.raises(ValueError, match="boom"):
            b.submit([np.zeros(1)], 1, "k")
    finally:
        b.stop()


def test_max_batch_flag_caps_rows_per_dispatch():
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.serve import BucketLadder
    config.set_flag("MXSERVE_MAX_BATCH", "2")
    try:
        te = ServingEngine(lambda x: x, input_specs=[InputSpec((3,))],
                           ladder=BucketLadder([1, 2, 4]), device="cpu")
        assert te.batcher.max_batch_size == 2
        te.close()
    finally:
        config.unset_flag("MXSERVE_MAX_BATCH")
    te = ServingEngine(lambda x: x, input_specs=[InputSpec((3,))],
                       ladder=BucketLadder([1, 2, 4]), device="cpu")
    assert te.batcher.max_batch_size == 4
    te.close()


def test_serving_feeds_metrics_and_signature_record():
    from mxnet_tpu_torch.serve import BucketLadder
    from mxnet_tpu_torch.telemetry import metrics, recompile
    te = ServingEngine(lambda x: x + 1.0, input_specs=[InputSpec((3,))],
                       ladder=BucketLadder([1, 2]), name="metrics-probe",
                       device="cpu")
    te.warmup()
    before = metrics.snapshot().get("mxserve_requests_total", 0)
    te.predict(np.zeros((1, 3), "float32"))
    te.close()
    snap = metrics.snapshot()
    assert snap["mxserve_requests_total"] == before + 1
    assert snap["mxserve_request_seconds"]["count"] >= 1
    mine = [r for r in recompile.recompile_report()
            if r["entry"] == "ServingEngine:metrics-probe"]
    assert [r["signature"]["inputs"][0]["shape"] for r in mine] == \
        [[1, 3], [2, 3]]
    assert recompile.recompile_count() >= 2


def test_open_loop_loadgen_counts_timeouts_and_errors():
    from mxnet_tpu_torch.serve import DeadlineExceededError, run_loadgen_open

    def fire(i):
        if i == 3:
            raise DeadlineExceededError("late")
        if i == 5:
            raise ValueError("bad")

    res = run_loadgen_open(fire, list(range(10)), qps=2000.0, concurrency=4,
                           timeout_errors=(DeadlineExceededError,))
    assert res["completed"] == 8 and res["timeouts"] == 1
    assert len(res["errors"]) == 1 and "bad" in res["errors"][0]
    assert len(res["latencies_s"]) == 9
