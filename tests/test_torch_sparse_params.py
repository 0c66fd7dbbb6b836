"""``.params`` files with sparse entries, across the two packages, and
sparse NDArray pickling, on the CPU.

The same numpy-seeded arrays (a ``row_sparse`` weight, a ``row_sparse``
gradient with an empty twin, a ``csr`` batch and a dense array) are
saved by both packages: the files are byte-equal, the JAX package's file
loads in the port and the port's in the JAX package with the same
storage types, shapes, payloads (indices exactly, values bit for bit),
and a port array pickles by value (``tests/test_aux_runtime.py:483``
holds the JAX package to the same).
"""
import pickle

import numpy as np
import pytest

from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ndarray import sparse as tsp

_RS = np.random.RandomState(13)
W_VALS = _RS.randn(3, 4).astype("float32")
W_IDX = np.asarray([0, 5, 7], "int64")
G_VALS = _RS.randn(2, 4).astype("float32")
G_IDX = np.asarray([2, 5], "int64")
X = ((_RS.uniform(0, 1, (5, 9)) < 0.3) * _RS.randn(5, 9)).astype("float32")
D = _RS.randn(2, 3).astype("float32")


def _arrays(nd, sp):
    return {"weight": sp.row_sparse_array((W_VALS, W_IDX), shape=(8, 4)),
            "grad": sp.row_sparse_array((G_VALS, G_IDX), shape=(8, 4)),
            "empty": sp.zeros("row_sparse", (8, 4)),
            "batch": sp.cast_storage(nd.array(X), "csr"),
            "dense": nd.array(D)}


def _payload(a):
    out = {"stype": a.stype, "shape": tuple(a.shape)}
    if a.stype == "default":
        out["data"] = a.asnumpy()
        return out
    out["data"] = a.data.asnumpy()
    out["indices"] = a.indices.asnumpy().astype("int64")
    if a.stype == "csr":
        out["indptr"] = a.indptr.asnumpy().astype("int64")
    return out


def _equal(p, q):
    assert p.keys() == q.keys()
    for k in p:
        if isinstance(p[k], np.ndarray):
            assert p[k].shape == q[k].shape, k
            assert p[k].tobytes() == q[k].tobytes(), k
        else:
            assert p[k] == q[k], k


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse_params")
    jpath, tpath = str(d / "jax.params"), str(d / "port.params")
    jnd.save(jpath, _arrays(jnd, jsp))
    with mx.cpu():
        tnd.save(tpath, _arrays(tnd, tsp))
    return jpath, tpath


def test_both_packages_write_the_same_bytes(files):
    jpath, tpath = files
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_port_reads_either_file(files, writer):
    path = files[0] if writer == "jax" else files[1]
    with mx.cpu():
        got = tnd.load(path)
        want = _arrays(tnd, tsp)
    assert sorted(got) == sorted(want)
    for k in want:
        _equal(_payload(got[k]), _payload(want[k]))
    assert isinstance(got["weight"], tsp.RowSparseNDArray)
    assert isinstance(got["batch"], tsp.CSRNDArray)
    assert not got["batch"].densified()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_jax_package_reads_either_file(files, writer):
    path = files[0] if writer == "jax" else files[1]
    got = jnd.load(path)
    want = _arrays(jnd, jsp)
    for k in want:
        _equal(_payload(got[k]), _payload(want[k]))


def test_tensor_level_load_gives_sparse_arrays(files):
    from mxnet_tpu_torch.ndarray import serialization
    got = serialization.load(files[0], device="cpu")
    assert got["grad"].stype == "row_sparse" and got["dense"].shape == (2, 3)
    np.testing.assert_array_equal(got["batch"].asnumpy(), X)


@pytest.mark.parametrize("name", ["weight", "batch", "empty"])
def test_sparse_arrays_pickle_by_value(name):
    with mx.cpu():
        a = _arrays(tnd, tsp)[name]
        b = pickle.loads(pickle.dumps(a))
    assert type(b) is type(a) and not b.densified()
    _equal(_payload(b), _payload(a))
    np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
