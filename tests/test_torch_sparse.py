"""The port's sparse storage against the JAX package's, on the CPU.

Each case runs the same calls through both packages on numpy-seeded
values and returns what it observed: arrays agree within rtol 1e-5 /
atol 1e-6 (fp32), index arrays and storage types exactly. Mirrors
``tests/test_sparse.py``'s containers, kernels and gradients and
``tests/test_ndarray.py::test_sparse_basics``; adds ``retain`` with a
missing row, the fallback warning once per op, ``dot`` in both
directions with its gradients, ``square``, the sparse ``Embedding`` and
``_contrib_SparseEmbedding`` with duplicate ids, the deposit rules under
``write``/``add`` and into dense slots, a leaf stored sparse, and the
``create_graph`` refusal.
"""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, nd as jnd
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag, nd as tnd
from mxnet_tpu_torch.ndarray import sparse as tsp

RTOL, ATOL = 1e-5, 1e-6
JAX = SimpleNamespace(nd=jnd, ag=jag, sp=jsp, err=jmx.base.MXNetError)
PORT = SimpleNamespace(nd=tnd, ag=tag, sp=tsp, err=mx.MXNetError)


def _rand_csr(rs, m, n, density):
    return ((rs.uniform(0, 1, (m, n)) < density)
            * rs.randn(m, n)).astype("float32")


def both(case):
    """``case(ns)`` through the JAX package and through the port (on the
    CPU)."""
    j = case(JAX)
    with mx.cpu():
        t = case(PORT)
    return j, t


def same(j, t):
    """``j`` and ``t`` (dicts, lists, arrays, scalars, strings) agree:
    integer arrays and strings exactly, floats within the tolerance."""
    if isinstance(j, dict):
        assert sorted(j) == sorted(t)
        for k in j:
            same(j[k], t[k])
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            same(a, b)
    elif isinstance(j, np.ndarray) or hasattr(j, "shape"):
        j, t = np.asarray(j), np.asarray(t)
        assert j.shape == t.shape, (j.shape, t.shape)
        if j.dtype.kind in "iub":
            np.testing.assert_array_equal(t.astype("int64"),
                                          j.astype("int64"))
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    elif isinstance(j, float):
        assert t == pytest.approx(j, rel=RTOL, abs=ATOL)
    else:
        assert j == t, (j, t)


def rsp(a):
    """A row_sparse array's observable state."""
    return {"stype": a.stype, "shape": tuple(a.shape),
            "indices": a.indices.asnumpy().astype("int64"),
            "values": a.data.asnumpy()}


# -- containers ---------------------------------------------------------------

def test_containers_build_no_dense_view_until_read():
    def case(ns):
        a = ns.sp.RowSparseNDArray(np.ones((2, 3), "float32"),
                                   np.array([1, 4], "int64"), (6, 3))
        seen = {"before": a.densified(), "shape": tuple(a.shape),
                "dtype": str(a.dtype),
                "indices": a.indices.asnumpy().astype("int64"),
                "after_payload": a.densified()}
        b = a.copy()
        seen["copy"] = {"stype": b.stype, "values": b.data.asnumpy(),
                        "densified": b.densified()}
        seen["dense"] = a.asnumpy()
        seen["after_dense"] = a.densified()
        return seen
    j, t = both(case)
    same(j, t)
    assert t["after_dense"] and not t["after_payload"]
    with mx.cpu():
        a = tsp.row_sparse_array((np.ones((1, 2), "float32"),
                                  np.asarray([3])), shape=(4, 2))
        b = a.copy()
        b.data._data += 1          # the copy owns its payload
    assert a.data.asnumpy().tolist() == [[1.0, 1.0]]


def test_csr_round_trip_slice_and_cast_back():
    a = _rand_csr(np.random.RandomState(0), 6, 8, 0.3)

    def case(ns):
        m = ns.sp.cast_storage(ns.nd.array(a), "csr")
        s = m.slice(2, 5)
        return {"stype": m.stype, "dense": m.asnumpy(),
                "indptr": m.indptr.asnumpy().astype("int64"),
                "indices": m.indices.asnumpy().astype("int64"),
                "data": m.data.asnumpy(), "slice": s.asnumpy(),
                "slice_indptr": s.indptr.asnumpy().astype("int64"),
                "back": ns.sp.cast_storage(m, "default").asnumpy()}
    j, t = both(case)
    same(j, t)
    np.testing.assert_array_equal(t["dense"], a)


def test_sparse_basics_cast_storage_both_ways():
    """``tests/test_ndarray.py::test_sparse_basics``."""
    def case(ns):
        dense = ns.nd.array([[0, 0, 1], [2, 0, 0], [0, 0, 0]])
        r = ns.sp.cast_storage(dense, "row_sparse")
        c = ns.sp.cast_storage(dense, "csr")
        return {"rsp": rsp(r), "rsp_back": r.tostype("default").asnumpy(),
                "csr_indptr": c.indptr.asnumpy().astype("int64"),
                "csr_back": c.tostype("default").asnumpy(),
                "tostype": dense.tostype("row_sparse").stype,
                "op": ns.nd.cast_storage(dense, stype="csr").stype}
    same(*both(case))


def test_retain_keeps_first_stored_slot_and_zero_missing_rows():
    def case(ns):
        a = ns.sp.row_sparse_array(
            (np.asarray([[1., 2.], [3., 4.], [5., 6.]], "float32"),
             np.asarray([3, 0, 3], "int64")), shape=(5, 2))
        kept = a.retain(ns.nd.array(np.asarray([3, 4, 0], "int64")))
        by_op = ns.nd._sparse_retain(a, ns.nd.array(np.asarray([0], "int64")))
        return {"kept": rsp(kept), "dense": kept.asnumpy(),
                "op": rsp(by_op)}
    same(*both(case))


def test_dense_retain_op_zeroes_other_rows():
    x = np.random.RandomState(2).randn(5, 3).astype("float32")

    def case(ns):
        return ns.nd._sparse_retain(
            ns.nd.array(x), ns.nd.array(np.asarray([1, 3], "int64"))
        ).asnumpy()
    same(*both(case))


def test_storage_fallback_warns_once_per_op():
    def case(ns):
        ns.sp._fallback_warned.clear()
        a = ns.sp.row_sparse_array((np.ones((1, 2), "float32"),
                                    np.asarray([0], "int64")), shape=(3, 2))
        with warnings.catch_warnings(record=True) as first:
            warnings.simplefilter("always")
            out = ns.nd.relu(a)
        with warnings.catch_warnings(record=True) as second:
            warnings.simplefilter("always")
            ns.nd.relu(a)

        def n(ws):
            return sum("dense implementation" in str(w.message) for w in ws)
        return {"first": n(first), "second": n(second),
                "out": out.asnumpy()}
    j, t = both(case)
    same(j, t)
    assert t["first"] == 1 and t["second"] == 0


# -- kernels and their gradients ----------------------------------------------

def test_csr_dot_dense_forward_and_row_sparse_gradient():
    rs = np.random.RandomState(1)
    a = _rand_csr(rs, 8, 10, 0.3)
    w = rs.randn(10, 4).astype("float32")

    def case(ns):
        x = ns.sp.cast_storage(ns.nd.array(a), "csr")
        wv = ns.nd.array(w)
        wv.attach_grad(stype="row_sparse")
        with ns.ag.record():
            out = ns.nd.dot(x, wv)
            loss = (out * out).sum()
        loss.backward()
        return {"out": out.asnumpy(), "grad": rsp(wv.grad),
                "densified": x.densified()}
    j, t = both(case)
    same(j, t)
    np.testing.assert_allclose(t["out"], a @ w, rtol=RTOL, atol=1e-5)
    nz_cols = np.unique(np.nonzero(a)[1])
    np.testing.assert_array_equal(t["grad"]["indices"], nz_cols)
    assert not t["densified"]


def test_csr_transpose_dot_gives_row_sparse_and_its_gradient():
    rs = np.random.RandomState(2)
    a = _rand_csr(rs, 6, 9, 0.4)
    r = rs.randn(6, 3).astype("float32")

    def case(ns):
        x = ns.sp.cast_storage(ns.nd.array(a), "csr")
        out = ns.nd.dot(x, ns.nd.array(r), transpose_a=True)
        return rsp(out)
    j, t = both(case)
    same(j, t)
    np.testing.assert_array_equal(t["indices"], np.unique(np.nonzero(a)[1]))
    # the gradient to the dense right operand, through the dense view of
    # the row_sparse result: d sum(A^T r) / dr = A 1
    with mx.cpu():
        x = tsp.cast_storage(tnd.array(a), "csr")
        rv = tnd.array(r)
        rv.attach_grad(stype="row_sparse")
        with tag.record():
            loss = tnd.sum(tnd.dot(x, rv, transpose_a=True))
        loss.backward()
        g = rv.grad
    assert g.stype == "row_sparse"
    want = np.repeat(a.sum(1, keepdims=True), 3, 1)
    rows = g.indices.asnumpy()
    np.testing.assert_array_equal(rows, np.nonzero(a.any(1))[0])
    np.testing.assert_allclose(g.data.asnumpy(), want[rows], rtol=RTOL,
                               atol=ATOL)


def test_dot_with_a_row_sparse_leaf_gives_a_values_shaped_gradient():
    """A leaf stored sparse: its gradient pairs the values' gradient with
    its own indices."""
    rs = np.random.RandomState(3)
    a = _rand_csr(rs, 5, 7, 0.5)
    vals = rs.randn(4, 2).astype("float32")
    idx = np.asarray([0, 2, 3, 6], "int64")

    def case(ns):
        x = ns.sp.cast_storage(ns.nd.array(a), "csr")
        w = ns.sp.row_sparse_array((vals, idx), shape=(7, 2))
        w.attach_grad()
        with ns.ag.record():
            out = ns.nd.dot(x, w)
            loss = (out * out).sum()
        loss.backward()
        return {"out": out.asnumpy(), "grad": rsp(w.grad)}
    same(*both(case))


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_square_on_the_payload(stype):
    a = _rand_csr(np.random.RandomState(4), 5, 6, 0.4)

    def case(ns):
        x = ns.sp.cast_storage(ns.nd.array(a), stype)
        y = ns.nd.square(x)
        return {"stype": y.stype, "data": y.data.asnumpy(),
                "dense": y.asnumpy(), "densified": x.densified()}
    j, t = both(case)
    same(j, t)
    assert not t["densified"]


@pytest.mark.parametrize("keepdims", [True, False])
def test_square_sum_row_sparse(keepdims):
    def case(ns):
        v = ns.sp.row_sparse_array(
            (np.asarray([[1., 2.], [3., 4.]], "float32"),
             np.asarray([1, 3], "int64")), shape=(5, 2))
        return rsp(ns.nd._square_sum(v, axis=1, keepdims=keepdims))
    same(*both(case))


@pytest.mark.parametrize("op", ["Embedding", "_contrib_SparseEmbedding"])
def test_sparse_embedding_sums_duplicate_ids(op):
    rs = np.random.RandomState(3)
    w = rs.randn(20, 4).astype("float32")
    ids = np.asarray([[1, 3], [3, 7], [7, 3]], "float32")
    head = rs.randn(3, 2, 4).astype("float32")

    def case(ns):
        weight = ns.nd.array(w)
        weight.attach_grad(stype="row_sparse")
        kw = {"sparse_grad": True} if op == "Embedding" else {}
        with ns.ag.record():
            emb = getattr(ns.nd, op)(ns.nd.array(ids), weight, input_dim=20,
                                     output_dim=4, **kw)
            loss = (emb * ns.nd.array(head)).sum()
        loss.backward()
        g = weight.grad
        return {"out": emb.asnumpy(), "stype": g.stype,
                "grad": g.asnumpy(),
                "grad_rows": (g.indices.asnumpy().astype("int64")
                              if g.stype == "row_sparse" else None)}
    j, t = both(case)
    same(j, t)
    if op == "Embedding":
        np.testing.assert_array_equal(t["grad_rows"], [1, 3, 7])
        np.testing.assert_allclose(t["grad"][3],
                                   head[0, 1] + head[1, 0] + head[2, 1],
                                   rtol=RTOL, atol=ATOL)


# -- deposits -------------------------------------------------------------------

def _embedding_steps(ns, grad_req, stype, dense_too=False, steps=2):
    """``steps`` backwards of a sparse Embedding into one variable; its
    ``.grad`` after each."""
    rs = np.random.RandomState(5)
    w = ns.nd.array(rs.randn(12, 3).astype("float32"))
    w.attach_grad(grad_req, stype=stype)
    seen = []
    for ids in ([[1, 4], [4, 9]], [[9, 2], [0, 0]])[:steps]:
        with ns.ag.record():
            emb = ns.nd.Embedding(ns.nd.array(np.asarray(ids, "float32")),
                                  w, input_dim=12, output_dim=3,
                                  sparse_grad=True)
            loss = (emb * emb).sum()
            if dense_too:
                loss = loss + (w * w).sum()
        loss.backward()
        g = w.grad
        seen.append({"stype": g.stype, "dense": g.asnumpy(),
                     "rows": (g.indices.asnumpy().astype("int64")
                              if g.stype == "row_sparse" else None)})
    return seen


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_sparse_cotangent_into_a_sparse_slot(grad_req):
    j, t = both(lambda ns: _embedding_steps(ns, grad_req, "row_sparse"))
    same(j, t)
    assert all(s["stype"] == "row_sparse" for s in t)
    if grad_req == "add":
        np.testing.assert_array_equal(t[1]["rows"], [0, 1, 2, 4, 9])


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_sparse_cotangent_into_a_dense_slot_is_densified(grad_req):
    j, t = both(lambda ns: _embedding_steps(ns, grad_req, None))
    same(j, t)
    assert all(s["stype"] == "default" for s in t)


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_dense_cotangent_into_a_sparse_slot_makes_it_dense(grad_req):
    j, t = both(lambda ns: _embedding_steps(ns, grad_req, "row_sparse",
                                            dense_too=True))
    same(j, t)
    assert t[0]["stype"] == "default"


def test_create_graph_through_a_sparse_gradient_raises():
    def case(ns):
        w = ns.nd.array(np.ones((6, 2), "float32"))
        w.attach_grad()
        with ns.ag.record():
            emb = ns.nd.Embedding(ns.nd.array(np.asarray([1, 1], "float32")),
                                  w, input_dim=6, output_dim=2,
                                  sparse_grad=True)
            loss = (emb * emb).sum()
            with pytest.raises(ns.err, match="not supported"):
                ns.ag.grad(loss, [w], create_graph=True)
        return True
    same(*both(case))


def test_grad_of_a_sparse_path_is_dense():
    def case(ns):
        w = ns.nd.array(np.arange(12, dtype="float32").reshape(6, 2))
        w.attach_grad()
        with ns.ag.record():
            emb = ns.nd.Embedding(ns.nd.array(np.asarray([1, 4, 1], "float32")),
                                  w, input_dim=6, output_dim=2,
                                  sparse_grad=True)
            loss = (emb * emb).sum()
        g = ns.ag.grad(loss, [w])[0]
        return {"stype": g.stype, "grad": g.asnumpy()}
    same(*both(case))


def test_repr_builds_no_dense_view():
    with mx.cpu():
        a = tsp.csr_matrix((np.ones(3, "float32"), np.asarray([0, 5, 2]),
                            np.asarray([0, 2, 3])), shape=(2, 1_000_000))
        text = repr(a)
    assert "CSRNDArray 2x1000000" in text and not a.densified()
