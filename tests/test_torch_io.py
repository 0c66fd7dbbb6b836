"""The port's data iterators against the JAX package's on the CPU:
``NDArrayIter`` with pad, discard and roll_over and its shuffle order for
one seed (batches equal exactly), ``ResizeIter``, ``PrefetchingIter`` (the
three cases of ``tests/test_io_prefetch.py``: the depth kept across
``reset``, a worker's exception raised in the consumer, a clean end),
``MNISTIter`` over tiny idx files written to ``tmp_path`` (plain and
gzipped) and ``CSVIter``; the record iterators raise naming their ROADMAP
item. Batches are made inside ``with mx.cpu():``.
"""
import gzip
import struct
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.io import (DataBatch, DataIter, NDArrayIter,
                                PrefetchingIter)


def _batches(it):
    out = []
    for b in it:
        out.append(([np.asarray(d.asnumpy()) for d in b.data],
                    [np.asarray(lab.asnumpy()) for lab in b.label], b.pad))
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


def _arrays(n=10):
    x = np.arange(n * 3, dtype="float32").reshape(n, 3)
    y = np.arange(n, dtype="float32")
    return x, y


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_batches_equal_the_jax_packages(handle, shuffle):
    x, y = _arrays()
    kw = dict(batch_size=4, shuffle=shuffle, shuffle_seed=7,
              last_batch_handle=handle)
    jit = jmx.io.NDArrayIter(x, y, **kw)
    with mx.cpu():
        tit = mx.io.NDArrayIter(x, y, **kw)
        assert tit.provide_data == jit.provide_data
        assert tit.provide_label == jit.provide_label
        for epoch in range(2):  # a reset reshuffles with numpy's state
            np.random.seed(11 + epoch)
            want = _batches(jit)
            np.random.seed(11 + epoch)
            _equal(_batches(tit), want)
            np.random.seed(20 + epoch)
            jit.reset()
            np.random.seed(20 + epoch)
            tit.reset()


def test_resize_iter_loops_and_clips_as_the_jax_package():
    x, y = _arrays()
    with mx.cpu():
        for size in (2, 5):
            want = _batches(jmx.io.ResizeIter(
                jmx.io.NDArrayIter(x, y, batch_size=4), size))
            _equal(_batches(mx.io.ResizeIter(
                mx.io.NDArrayIter(x, y, batch_size=4), size)), want)


def _bounded(fn, timeout=20.0):
    out = {}

    def runner():
        try:
            out["result"] = fn()
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"call did not finish within {timeout}s"
    if "error" in out:
        raise out["error"]
    return out.get("result")


def _base_iter(n=12, batch=2):
    return NDArrayIter(np.arange(n * 3, dtype="float32").reshape(n, 3),
                       np.zeros(n, "float32"), batch_size=batch)


def test_prefetch_reset_preserves_depth():
    with mx.cpu():
        it = PrefetchingIter(_base_iter(), prefetch_depth=5)
        assert it._queue.maxsize == 5
        _bounded(it.next)
        it.reset()
        assert it._queue.maxsize == 5
        assert len(_bounded(lambda: list(it))) == 6
        it.reset()
        batches = _bounded(lambda: list(it))
    assert len(batches) == 6 and batches[0].data[0].ctx == mx.cpu()


class _FailingIter(DataIter):
    def __init__(self, good=2):
        super().__init__(batch_size=2)
        self.good = good
        self.count = 0
        self.provide_data = []
        self.provide_label = []

    def next(self):
        self.count += 1
        if self.count > self.good:
            raise ValueError("simulated decode failure")
        return DataBatch(data=[mx.nd.array(np.full((2, 3), float(self.count),
                                                   "float32"))],
                         label=[], pad=0)


def test_prefetch_worker_exception_propagates_not_hangs():
    with mx.cpu():
        it = PrefetchingIter(_FailingIter(good=2), prefetch_depth=2)
        assert _bounded(it.next).data[0].asnumpy()[0, 0] == 1.0
        _bounded(it.next)
        for _ in range(2):
            with pytest.raises(ValueError, match="simulated decode failure"):
                _bounded(it.next)


def test_prefetch_stop_iteration_still_clean():
    with mx.cpu():
        it = PrefetchingIter(_base_iter(n=4, batch=2), prefetch_depth=3)
        assert len(_bounded(lambda: list(it))) == 2


def _write_idx(path, arr, gz=False):
    header = struct.pack(">I", 0x800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_iter_reads_idx_files_as_the_jax_package(tmp_path, gz):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (10, 28, 28))
    labels = rs.randint(0, 10, 10)
    ext = ".gz" if gz else ""
    ip, lp = str(tmp_path / f"img{ext}"), str(tmp_path / f"lab{ext}")
    _write_idx(ip, imgs, gz)
    _write_idx(lp, labels, gz)
    for flat in (False, True):
        kw = dict(image=ip, label=lp, batch_size=4, shuffle=False, flat=flat)
        want = _batches(jmx.io.MNISTIter(**kw))
        with mx.cpu():
            got = _batches(mx.io.MNISTIter(**kw))
        _equal(got, want)
        assert len(got) == 2  # the partial batch is discarded


def test_csv_iter_matches(tmp_path):
    x = np.random.RandomState(1).rand(6, 4).astype("float32")
    y = np.arange(6, dtype="float32")
    np.savetxt(tmp_path / "x.csv", x, delimiter=",")
    np.savetxt(tmp_path / "y.csv", y, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "x.csv"), data_shape=(4,),
              label_csv=str(tmp_path / "y.csv"), batch_size=3)
    want = _batches(jmx.io.CSVIter(**kw))
    with mx.cpu():
        _equal(_batches(mx.io.CSVIter(**kw)), want)


@pytest.mark.parametrize("name", ["ImageRecordIter", "ImageDetRecordIter",
                                  "LibSVMIter", "MXDataIter"])
def test_record_iterators_raise_naming_their_item(name):
    """The record iterators are ported (tests/test_torch_image_data.py):
    on a file that is not there each raises naming it, and
    ``MXDataIter`` refuses as the JAX package's does."""
    with mx.cpu():
        if name == "MXDataIter":
            with pytest.raises(MXNetError, match="named iterator classes"):
                mx.io.MXDataIter("x.rec", data_shape=(3, 8, 8))
            return
        with pytest.raises(FileNotFoundError, match="x.rec"):
            getattr(mx.io, name)("x.rec", data_shape=(3, 8, 8))
