"""The port's sparse optimizer paths against the JAX package's, on the CPU.

The same numpy-seeded weights and gradients go through both packages'
``Updater``: the lazy row-wise updates of SGD (momentum 0 and 0.9), Adam
(``lazy_update`` True, and False, which takes the dense path) and AdaGrad,
on dense and on ``row_sparse`` weights; a list-form call with one sparse
gradient; an optimizer with no sparse path (it densifies, with the
fallback warning); the missing-row error. Then three loops, each step
against the JAX package: the factorization machine of
``tests/test_sparse.py`` for 3 epochs, ``examples/sparse/
linear_classification.py``'s loop at a density where some rows are never
active (they keep their bits), and ``examples/recommenders/
matrix_fact.py``'s Gluon model with ``Embedding(sparse_grad=True)``, whose
gradient is dense as in the JAX package. Tolerance rtol 1e-5 / atol 1e-6
(fp32); rows a gradient never named are compared bit for bit.
"""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon, nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag, gluon as tgluon, nd as tnd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ndarray import sparse as tsp

from test_torch_resnet_train import keep_zeros

RTOL, ATOL = 1e-5, 1e-6
JAX = SimpleNamespace(nd=jnd, ag=jag, sp=jsp, opt=jopt, gluon=jgluon,
                      err=jmx.base.MXNetError)
PORT = SimpleNamespace(nd=tnd, ag=tag, sp=tsp, opt=topt, gluon=tgluon,
                       err=mx.MXNetError)

OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.0}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.8}),
    ("adam", {"learning_rate": 0.01, "lazy_update": True}),
    ("adam", {"learning_rate": 0.01, "lazy_update": False}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01}),
]
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
       for n, kw in OPTIMIZERS]


def both(case):
    j = case(JAX)
    with mx.cpu():
        t = case(PORT)
    return j, t


def close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def _grads(rs, steps=3, rows=10, width=3):
    """Row-sparse gradients: duplicate-free sorted rows, some shared."""
    out = []
    for _ in range(steps):
        idx = np.sort(rs.choice([1, 2, 5, 6, 8], 3, replace=False))
        out.append((rs.randn(3, width).astype("float32"), idx))
    return out


@pytest.mark.parametrize("storage", ["dense", "row_sparse"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=IDS)
def test_sparse_gradient_updates_only_its_rows(name, kw, storage):
    rs = np.random.RandomState(4)
    w0 = rs.randn(10, 3).astype("float32")
    grads = _grads(rs)

    def case(ns):
        if storage == "dense":
            weight = ns.nd.array(w0)
        else:
            weight = ns.sp.row_sparse_array((w0, np.arange(10)),
                                            shape=(10, 3))
        upd = ns.opt.get_updater(ns.opt.create(name, rescale_grad=0.5, **kw))
        ns.sp._fallback_warned.clear()
        seen = []
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            for vals, idx in grads:
                upd(0, ns.sp.row_sparse_array((vals, idx), shape=(10, 3)),
                    weight)
                seen.append(weight.asnumpy())
        fell_back = any("dense implementation" in str(w.message)
                        for w in ws)
        state = upd.states[0]
        state = state if isinstance(state, (tuple, list)) else [state]
        return seen, [None if s is None else s.asnumpy() if hasattr(
            s, "asnumpy") else s.numpy() for s in state], fell_back
    (jw, js, jfb), (tw, ts, tfb) = both(case)
    for a, b in zip(tw, jw):
        close(a, b)
    for a, b in zip(ts, js):
        if b is None:
            assert a is None
        else:
            close(a, b)
    assert tfb == jfb == (kw.get("lazy_update") is False)
    if tfb:
        return
    # the rows no gradient named keep their bits, in the weight and states
    never = [r for r in range(10) if r not in {1, 2, 5, 6, 8}]
    assert np.array_equal(tw[-1][never], w0[never])
    for s in ts:
        if s is not None:
            assert not s[never].any()


def test_row_sparse_weight_is_updated_through_its_payload():
    w0 = np.random.RandomState(5).randn(8, 2).astype("float32")

    def case(ns):
        weight = ns.sp.RowSparseNDArray(w0, np.arange(8, dtype="int64"),
                                        (8, 2))
        grad = ns.sp.RowSparseNDArray(np.ones((2, 2), "float32"),
                                      np.asarray([1, 6], "int64"), (8, 2))
        ns.opt.get_updater(ns.opt.SGD(learning_rate=0.5))(0, grad, weight)
        return weight.densified(), weight.data.asnumpy()
    (jd, jv), (td, tv) = both(case)
    assert jd is td is False
    close(tv, jv)
    assert np.array_equal(tv[0], w0[0])


def test_gradient_row_missing_from_a_row_sparse_weight_raises():
    def case(ns):
        weight = ns.sp.RowSparseNDArray(np.ones((3, 2), "float32"),
                                        np.asarray([0, 2, 4], "int64"),
                                        (6, 2))
        grad = ns.sp.RowSparseNDArray(np.ones((1, 2), "float32"),
                                      np.asarray([5], "int64"), (6, 2))
        with pytest.raises(ns.err, match="missing"):
            ns.opt.get_updater(ns.opt.SGD())(0, grad, weight)
        return True
    assert both(case) == (True, True)


def test_list_form_updater_with_one_sparse_gradient():
    rs = np.random.RandomState(6)
    w = [rs.randn(6, 2).astype("float32") for _ in range(3)]
    g_dense = [rs.randn(6, 2).astype("float32") for _ in range(2)]
    g_vals = rs.randn(2, 2).astype("float32")

    def case(ns):
        weights = [ns.nd.array(x) for x in w]
        upd = ns.opt.get_updater(ns.opt.create("sgd", learning_rate=0.1,
                                               momentum=0.9))
        for _ in range(2):
            grads = [ns.nd.array(g_dense[0]),
                     ns.sp.row_sparse_array((g_vals, np.asarray([1, 4])),
                                            shape=(6, 2)),
                     ns.nd.array(g_dense[1])]
            upd([0, 1, 2], grads, weights)
        return [x.asnumpy() for x in weights]
    j, t = both(case)
    for a, b in zip(t, j):
        close(a, b)
    untouched = [0, 2, 3, 5]
    assert np.array_equal(t[1][untouched], w[1][untouched])


def test_optimizer_without_a_sparse_path_densifies_with_the_warning():
    rs = np.random.RandomState(7)
    w0 = rs.randn(6, 3).astype("float32")
    vals = rs.randn(2, 3).astype("float32")

    def case(ns):
        weight = ns.nd.array(w0)
        ns.sp._fallback_warned.clear()
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            ns.opt.get_updater(ns.opt.create("rmsprop", learning_rate=0.01))(
                0, ns.sp.row_sparse_array((vals, np.asarray([0, 3])),
                                          shape=(6, 3)), weight)
        return weight.asnumpy(), any("dense implementation" in
                                     str(w.message) for w in ws)
    (jw, jwarn), (tw, twarn) = both(case)
    close(tw, jw)
    assert jwarn and twarn
    # the dense update moves every row, the ones the gradient does not
    # name too (rmsprop's epsilon over a zero history)
    assert not np.array_equal(tw[1], w0[1]) or np.array_equal(jw[1], w0[1])


def test_nd_array_does_not_share_a_numpy_source():
    """A port fault found by this slice: on the CPU ``nd.array`` of a
    float32 numpy array kept the numpy array's memory, so an in-place
    update of one array showed in every array made from the same source
    (the JAX package copies)."""
    src = np.zeros((2, 2), "float32")
    with mx.cpu():
        a, b = tnd.array(src), tnd.array(src)
        a += 1
    assert not src.any() and not b.asnumpy().any()


# -- loops ------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name,kwargs", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "clip_gradient": 5.0}),
    ("adam", {"learning_rate": 0.02, "clip_gradient": 5.0}),
    ("adagrad", {"learning_rate": 0.1, "clip_gradient": 5.0}),
])
def test_factorization_machine_steps_as_in_the_jax_package(opt_name,
                                                            kwargs):
    """``tests/test_sparse.py``'s FM loop (csr inputs, a row-sparse
    gradient for ``w1``) for 3 epochs of 3 batches (of its 8), its density
    0.05 as 10 active features in every row, so that the batches share one
    csr shape, which the JAX package compiles once: losses and parameters
    after every step."""
    rs = np.random.RandomState(0)
    feature_dim, factor_size, batch, n_batches = 200, 4, 32, 3
    X = np.zeros((batch * n_batches, feature_dim), "float32")
    for row in X:
        row[rs.choice(feature_dim, 10, replace=False)] = rs.randn(10)
    y = X @ rs.randn(feature_dim, 1).astype("float32")
    w1_0 = rs.randn(feature_dim, 1).astype("float32") * 0.01
    v_0 = rs.randn(feature_dim, factor_size).astype("float32") * 0.01

    def case(ns):
        w1, v = ns.nd.array(w1_0), ns.nd.array(v_0)
        bias = ns.nd.array(np.zeros((1,), "float32"))
        for p in (w1, v):
            p.attach_grad(stype="row_sparse")
        bias.attach_grad()
        upd = ns.opt.get_updater(ns.opt.create(
            opt_name, rescale_grad=1.0 / batch, **kwargs))
        trace = []
        for epoch in range(3):
            for b in range(n_batches):
                xb = ns.sp.cast_storage(
                    ns.nd.array(X[b * batch:(b + 1) * batch]), "csr")
                yb = ns.nd.array(y[b * batch:(b + 1) * batch])
                with ns.ag.record():
                    t1 = ns.nd.dot(xb, w1) + bias
                    xv = ns.nd.dot(xb, v)
                    t2 = 0.5 * ns.nd.sum(xv * xv, axis=1, keepdims=True)
                    t3 = 0.5 * ns.nd.dot(ns.nd.square(xb), ns.nd.sum(
                        v * v, axis=1, keepdims=True))
                    loss = ns.nd.sum(ns.nd.square(t1 + t2 - t3 - yb)) / batch
                loss.backward()
                trace.append((float(loss.asscalar()), w1.grad.stype,
                              v.grad.stype))
                upd(0, w1.grad, w1)
                upd(2, bias.grad, bias)
                trace.append((w1.asnumpy(), bias.asnumpy()))
        return trace
    j, t = both(case)
    assert len(j) == len(t)
    for a, b in zip(t, j):
        if isinstance(a[0], float):
            assert a[0] == pytest.approx(b[0], rel=RTOL, abs=ATOL)
            assert a[1:] == b[1:] == ("row_sparse", "default")
        else:
            close(a[0], b[0])
            close(a[1], b[1])


def test_linear_classification_loop_as_in_the_jax_package():
    """``examples/sparse/linear_classification.py``'s loop (AdaGrad, lr 0.5,
    rescale 1/batch) for 2 epochs of 4 batches over 1000 features, each
    row two active features and each batch 128 distinct ones (so every
    batch has one shape, which the JAX package compiles once): 488
    features are never active and keep their bits."""
    rs = np.random.RandomState(0)
    dim, batch, batches = 1000, 64, 4
    X = np.zeros((batch * batches, dim), "float32")
    for b in range(batches):
        cols = rs.permutation(dim)[:2 * batch].reshape(2, batch).T
        rows = np.arange(b * batch, (b + 1) * batch)[:, None]
        X[rows, cols] = rs.rand(batch, 2)
    y = (X @ rs.randn(dim, 1).astype("float32") > 0).astype("float32")
    w_init = rs.randn(dim, 1).astype("float32") * 0.01

    def case(ns):
        w, b = ns.nd.array(w_init), ns.nd.zeros((1,))
        w.attach_grad(stype="row_sparse")
        b.attach_grad()
        upd = ns.opt.get_updater(ns.opt.create(
            "adagrad", learning_rate=0.5, rescale_grad=1.0 / batch))
        trace = []
        for epoch in range(2):
            for i in range(batches):
                sl = slice(i * batch, (i + 1) * batch)
                xb = ns.sp.cast_storage(ns.nd.array(X[sl]), "csr")
                yb = ns.nd.array(y[sl])
                with ns.ag.record():
                    logit = ns.nd.dot(xb, w) + b
                    loss = ns.nd.mean(ns.nd.log(
                        1 + ns.nd.exp(-(2 * yb - 1) * logit)))
                loss.backward()
                assert w.grad.stype == "row_sparse"
                upd(0, w.grad, w)
                upd(1, b.grad, b)
                trace.append((float(loss.asscalar()), w.asnumpy(),
                              b.asnumpy()))
        return trace
    j, t = both(case)
    for (tl, tw, tb), (jl, jw, jb) in zip(t, j):
        assert tl == pytest.approx(jl, rel=RTOL, abs=ATOL)
        close(tw, jw)
        close(tb, jb)
    never = np.nonzero(~X.any(0))[0]
    assert never.size > 0
    assert np.array_equal(t[-1][1][never], w_init[never])


class _JMF(jgluon.HybridBlock):
    def __init__(self, users, items, k):
        super().__init__()
        with self.name_scope():
            self.user = jgluon.nn.Embedding(users, k, sparse_grad=True)
            self.item = jgluon.nn.Embedding(items, k, sparse_grad=True)

    def hybrid_forward(self, F, uid, iid):
        return (self.user(uid) * self.item(iid)).sum(axis=1)


class _TMF(tgluon.HybridBlock):
    def __init__(self, users, items, k):
        super().__init__()
        self.user = tgluon.nn.Embedding(users, k, device="cpu",
                                        sparse_grad=True)
        self.item = tgluon.nn.Embedding(items, k, device="cpu",
                                        sparse_grad=True)

    def hybrid_forward(self, F, uid, iid):
        return (self.user(uid) * self.item(iid)).sum(axis=1)


def test_matrix_factorization_gluon_sparse_grad_embedding_is_dense():
    """``examples/recommenders/matrix_fact.py``'s model with
    ``Embedding(sparse_grad=True)`` for 4 Adam steps: the same losses and
    tables, and a dense gradient in both packages."""
    users, items, k, batch = 30, 20, 4, 32
    rs = np.random.RandomState(0)
    true_u = rs.randn(users, k).astype("float32") * 0.7
    true_i = rs.randn(items, k).astype("float32") * 0.7
    init = {"user": rs.randn(users, k).astype("float32") * 0.07,
            "item": rs.randn(items, k).astype("float32") * 0.07}
    batches = []
    for _ in range(4):
        uid, iid = rs.randint(0, users, batch), rs.randint(0, items, batch)
        batches.append((uid.astype("float32"), iid.astype("float32"),
                        (true_u[uid] * true_i[iid]).sum(1)))

    def run(ns, net, weight, set_weight):
        for name, v in init.items():
            set_weight(getattr(net, name).weight, v)
        trainer = ns.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 5e-3})
        l2 = ns.gluon.loss.L2Loss()
        trace = []
        for uid, iid, r in batches:
            with ns.ag.record():
                loss = l2(net(ns.nd.array(uid), ns.nd.array(iid)),
                          ns.nd.array(r)).mean()
            loss.backward()
            g = weight(net.user)
            trace.append((float(loss.asscalar()), g))
            trainer.step(batch)
        return trace, {n: getattr(net, n).weight for n in init}

    jnet = _JMF(users, items, k)
    jnet.initialize(keep_zeros)   # every value is set by run
    jtrace, jw = run(JAX, jnet, lambda m: m.weight.grad().stype,
                     lambda p, v: p.set_data(jnd.array(v)))
    with mx.cpu():
        tnet = _TMF(users, items, k)
        ttrace, tw = run(PORT, tnet, lambda m: (
            "default" if m.weight.grad.layout == torch.strided else "sparse"),
            lambda p, v: p.data.copy_(torch.from_numpy(v)))
    for (tl, ts), (jl, js) in zip(ttrace, jtrace):
        assert tl == pytest.approx(jl, rel=RTOL, abs=ATOL)
        assert ts == js == "default"
    for n in init:
        close(tw[n].detach().numpy(), jw[n].data().asnumpy())
