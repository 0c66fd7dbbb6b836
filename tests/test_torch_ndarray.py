"""The port's NDArray against the JAX package's, on the CPU.

Each expression below runs on NDArrays of both packages built from the
same numpy-seeded values (``a`` (2, 3, 4) float32, ``b`` (3, 4), ``c``
(2, 3, 4) int32, ``v`` (4,)); results agree in shape and dtype, and in
value within rtol 1e-5 / atol 1e-6 (both fp32; the two libraries order
some sums differently). Also held: creation and its dtype rules,
indexing and in-place writes (views write through, as the reference's
write-back does), ``out=``, contexts, files in MXNet's format read by the
other package, pickling, DLPack, and the stated bfloat16 behaviour
(``asnumpy`` gives float32 values, ``dtype`` is ``torch.bfloat16``).
"""
import contextlib
import pickle

import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, nd

RTOL, ATOL = 1e-5, 1e-6

_RS = np.random.RandomState(11)
A = _RS.uniform(0.1, 2.0, (2, 3, 4)).astype("float32")
B = _RS.uniform(0.1, 2.0, (3, 4)).astype("float32")
C = _RS.randint(-7, 9, (2, 3, 4)).astype("int32")
V = _RS.uniform(0.1, 2.0, (4,)).astype("float32")


def _same(j, t, rtol=RTOL, atol=ATOL):
    if isinstance(j, (list, tuple)):
        assert len(j) == len(t)
        for x, y in zip(j, t):
            _same(x, y, rtol, atol)
        return
    if not hasattr(j, "asnumpy"):
        assert j == pytest.approx(t, rel=rtol, abs=atol)
        return
    assert str(j.dtype) == str(t.dtype), (j.dtype, t.dtype)
    assert tuple(j.shape) == tuple(t.shape)
    np.testing.assert_allclose(t.asnumpy().astype("float64"),
                               np.asarray(j.asnumpy()).astype("float64"),
                               rtol=rtol, atol=atol, equal_nan=True)


def _both(expr):
    jns = dict(a=jnd.array(A), b=jnd.array(B), c=jnd.array(C, dtype="int32"),
               v=jnd.array(V), nd=jnd, np=np)
    j = eval(expr, jns)
    with mx.cpu():
        tns = dict(a=nd.array(A), b=nd.array(B), c=nd.array(C, dtype="int32"),
                   v=nd.array(V), nd=nd, np=np)
        t = eval(expr, tns)
    return j, t


EXPRS = [
    # shape
    "a.reshape((4, 6))", "a.reshape((0, -1))", "a.reshape((-2,))",
    "a.reshape((-3, 4))", "a.reshape((2, -4, 1, 3, 4))",
    "a.reshape((-4, 1, -1, 0, 0))", "a.reshape(6, 4)", "a.reshape_like(a)",
    "a.T", "a.transpose((1, 0, 2))", "a.swapaxes(0, 2)", "a.flatten()",
    "a.expand_dims(1)", "a.reshape((2, 1, 12)).squeeze()",
    "a.reshape((2, 1, 12)).squeeze(axis=1)", "b.broadcast_to((2, 3, 4))",
    "b.reshape((1, 3, 4)).broadcast_like(a)", "b.tile((2, 1))",
    "b.repeat(2, axis=1)", "b.repeat(2)", "a.slice((0, 1), (2, 3))",
    "a.slice_axis(2, 1, 3)", "b.take(nd.array([0, 2]))",
    "b.take(nd.array([5, -1]), mode='wrap')",
    "b.pick(nd.array([0, 3, 1]))", "b.pick(nd.array([0, 2, 1, 0]), axis=0)",
    "nd.array([0, 2, 1]).one_hot(3)", "a.split(3, axis=1)",
    "a.pad(mode='constant', pad_width=(0, 0, 0, 0, 1, 1, 2, 0))",
    # reductions
    "a.sum()", "a.sum(axis=1)", "a.sum(axis=(0, 2), keepdims=True)",
    "a.mean(axis=2)", "a.max(axis=0)", "a.min()", "b.prod(axis=1)",
    "a.std(axis=1)", "a.var()", "a.norm()", "b.norm(axis=1)",
    "c.sum(axis=1)", "c.max()",
    # indices and ordering
    "a.argmax(axis=2)", "a.argmin()", "b.argsort()",
    "b.argsort(is_ascend=False)", "b.sort(axis=0)", "b.sort(is_ascend=False)",
    "b.topk(k=2)", "b.topk(k=2, ret_typ='value')", "b.topk(k=2, axis=0)",
    # elementwise
    "a.clip(0.5, 1.5)", "(a - 1).abs()", "(a - 1).sign()", "a.sqrt()",
    "a.square()", "a.exp()", "a.log()", "(a - 1).relu()", "a.sigmoid()",
    "a.tanh()", "a.softmax()", "a.log_softmax(axis=1)", "(a * 3).round()",
    "(a * 3).floor()", "(a * 3).ceil()", "b.dot(b.T)",
    "a.batch_dot(a, transpose_b=True)", "a.zeros_like()", "c.ones_like()",
    "a.astype('float16')", "c.astype('float32')", "a.astype('int32')",
    "a.copy()",
    # operators, scalars on either side, broadcasting
    "a + b", "a - v", "a * 2", "2 * a", "a / 3", "3 / a", "a // 0.3",
    "a % 0.7", "a ** 2", "2 ** a", "b @ b.T", "-a", "abs(a - 1)",
    "a + nd.array([[1], [2], [3]])", "1 - a", "c + 1.7", "c * 2", "c / 3",
    "c // 3", "c % 5", "c - c", "c + a", "a == b", "a != 1", "a < b",
    "a <= 1", "a > 1", "a >= b", "c == 1",
    # indexing
    "a[1]", "a[-1]", "a[:, 1]", "a[0, 1:3]", "a[..., 2]", "a[:, None]",
    "a[::-1]", "b[:, ::-2]", "a[1, 2, 3]", "b[nd.array([0, 2], dtype='int32')]",
    "b[nd.array([0, 2], dtype='int32'), nd.array([1, 3], dtype='int32')]",
    # module functions
    "nd.concat(a, a, dim=2)", "nd.concatenate([b, b])", "nd.stack(b, b, axis=1)",
    "nd.split(a, 2, axis=0)", "nd.dot(b, b, transpose_b=True)",
    "nd.moveaxis(a, 0, 2)", "nd.zeros_like(a)", "nd.ones_like(b)",
]


@pytest.mark.parametrize("expr", EXPRS)
def test_expression_matches_the_jax_package(expr):
    j, t = _both(expr)
    _same(j, t)


CREATION = [
    "nd.array([1, 2])", "nd.array([[1.5, 2]], dtype='float16')",
    "nd.array(np.arange(6))", "nd.array(np.arange(6.0))",
    "nd.array(np.arange(6, dtype='int8'))", "nd.array(np.ones(3, 'float16'))",
    "nd.array(7.0)", "nd.array(a)", "nd.zeros((2, 3))",
    "nd.zeros(4, dtype='int32')", "nd.ones((2, 2), dtype='float16')",
    "nd.full((2, 3), 7)", "nd.full(3, 2.5, dtype='int32')",
    "nd.arange(0, 3)", "nd.arange(5)", "nd.arange(1, 2, 0.25)",
    "nd.arange(0, 3, repeat=2)", "nd.arange(0, 6, 2, dtype='int32')",
    "nd.eye(3)", "nd.eye(3, 4, k=1)", "nd.eye(4, 3, k=-1)",
    "nd.linspace(0, 1, 5)", "nd.linspace(0, 1, 4, endpoint=False)",
    "nd.empty((2, 2)).shape", "nd.from_numpy(np.ones((2,), 'float32'))",
]


@pytest.mark.parametrize("expr", CREATION)
def test_creation_matches_the_jax_package(expr):
    j, t = _both(expr)
    _same(j, t)


SETS = [
    ("x[1] = 0", "a"), ("x[:, 1:3] = 5", "a"), ("x[0, 0, 0] = -1", "a"),
    ("x[:] = nd.ones((3, 4))", "b"), ("x[nd.array([0, 2], dtype='int32')] = 9", "b"),
    ("x[:] = x - 0.5 * x", "a"), ("x += 1", "a"), ("x -= b", "a"),
    ("x *= 2", "a"), ("x /= 4", "a"), ("x += 1", "c"), ("x /= 2", "c"),
    ("x[1][:] = 3", "a"), ("x[1:2][0, 2] = 7", "b"),
]


@pytest.mark.parametrize("stmt,src", SETS, ids=[s for s, _ in SETS])
def test_writes_match_the_jax_package(stmt, src):
    """In place writes, and writes through basic views, as the
    reference's write-back makes them."""
    out = []
    for ns_nd, ctx in ((jnd, None), (nd, mx.cpu())):
        with (ctx or contextlib.nullcontext()):
            ns = dict(a=ns_nd.array(A), b=ns_nd.array(B),
                      c=ns_nd.array(C, dtype="int32"), nd=ns_nd)
            ns["x"] = ns[src]
            exec(stmt, ns)
            out.append(ns["x"])
    _same(*out)


def test_out_writes_into_the_given_array():
    with mx.cpu():
        x = nd.array([-1.0, 2.0])
        y = nd.zeros((2,))
        ret = nd.relu(x, out=y)
        assert ret is y and y.asnumpy().tolist() == [0.0, 2.0]
        nd.clip(x, 0, 1, out=x)
        assert x.asnumpy().tolist() == [0.0, 1.0]
        outs = [nd.zeros((1, 2)), nd.zeros((1, 2))]
        nd.SliceChannel(nd.array([[1.0, 2], [3, 4]]), num_outputs=2, axis=0,
                        out=outs)
        assert outs[1].asnumpy().tolist() == [[3.0, 4.0]]


def test_positional_parameters_fill_the_op_parameters_in_order():
    with mx.cpu():
        x = nd.array([0.0, 0.5, 2.0])
        assert nd.clip(x, 0.2, 1.0).asnumpy().tolist() == \
            pytest.approx([0.2, 0.5, 1.0])
        assert nd.clip(x, 0.2, a_max=0.4).asnumpy().tolist() == \
            pytest.approx([0.2, 0.4, 0.4])
        assert nd.sum(nd.ones((2, 3)), 1).shape == (2,)


def test_conversion_and_host_reads():
    with mx.cpu():
        x = nd.array([[1.0, 2.0], [3.0, 4.0]])
        assert isinstance(x.asnumpy(), np.ndarray)
        assert nd.array([5.0]).asscalar() == 5.0 and x[1, 0].item() == 3.0
        assert len(x) == 2 and [r.shape for r in x] == [(2,), (2,)]
        assert bool(nd.array([1.0])) and not bool(nd.array([0.0]))
        with pytest.raises(ValueError):
            bool(x)
        with pytest.raises(ValueError):
            x.asscalar()
        assert np.array_equal(np.asarray(x), x.asnumpy())
        assert "<NDArray 2x2 @cpu(0)>" in repr(x)
        assert x.size == 4 and x.ndim == 2 and x.stype == "default"
        x.wait_to_read()
        nd.waitall()


def test_bfloat16_reads_back_as_float32_values():
    with mx.cpu():
        x = nd.array([1.0, 3.140625, -2.5], dtype="bfloat16")
        got = x.asnumpy()
        assert x.dtype is torch.bfloat16 and got.dtype == np.float32
        assert got.tolist() == [1.0, 3.140625, -2.5]
        assert x.astype("float32").dtype == np.float32


def test_contexts_map_to_torch_devices():
    assert mx.cpu().torch_device == torch.device("cpu")
    assert mx.cpu(0) == mx.Context("cpu") and str(mx.cpu()) == "cpu(0)"
    with mx.cpu() as ctx:
        assert mx.current_context() == ctx
        x = nd.ones((2,))
        assert x.ctx == mx.cpu() and x.context == mx.cpu()
        assert x.as_in_context(mx.cpu()) is x
        y = x.copyto(mx.cpu())
        assert y is not x and y.asnumpy().tolist() == [1.0, 1.0]
        z = nd.zeros((2,), dtype="float16")
        assert x.copyto(z) is z and z.dtype == np.float16
        assert z.asnumpy().tolist() == [1.0, 1.0]
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA is not available"):
            mx.gpu(0)
        with pytest.raises(MXNetError, match="CUDA is not available"):
            nd.ones((2,))


def test_files_cross_between_the_packages(tmp_path):
    rs = np.random.RandomState(3)
    data = {"w": rs.randn(3, 4).astype("float32"),
            "i": rs.randint(0, 9, (5,)).astype("int32")}
    port_file, jax_file = str(tmp_path / "p.params"), str(tmp_path / "j")
    with mx.cpu():
        nd.save(port_file, {k: nd.array(v, dtype=v.dtype)
                            for k, v in data.items()})
        jnd.save(jax_file, {k: jnd.array(v, dtype=v.dtype)
                            for k, v in data.items()})
        back = nd.load(jax_file)
        listed = nd.load_frombuffer(open(port_file, "rb").read())
        nd.save(port_file + "2", [nd.array(data["w"])])
        as_list = nd.load(port_file + "2")
    theirs = jnd.load(port_file)
    for k, v in data.items():
        assert isinstance(back[k], nd.NDArray)
        assert np.array_equal(back[k].asnumpy(), v)
        assert np.array_equal(listed[k].asnumpy(), v)
        assert np.array_equal(np.asarray(theirs[k].asnumpy()), v)
    assert isinstance(as_list, list) and as_list[0].shape == (3, 4)


def test_pickle_keeps_values_and_grad_req():
    with mx.cpu():
        x = nd.array([1.0, 2.0])
        x.attach_grad("add")
        y = pickle.loads(pickle.dumps(x))
    assert y.asnumpy().tolist() == [1.0, 2.0] and y.grad_req == "add"
    assert y.ctx == mx.cpu()


def test_dlpack_shares_storage():
    with mx.cpu():
        x = nd.array([1.0, 2.0, 3.0])
        t = torch.utils.dlpack.from_dlpack(nd.to_dlpack_for_write(x))
        t[0] = 9.0
        assert x.asnumpy()[0] == 9.0
        r = torch.utils.dlpack.from_dlpack(nd.to_dlpack_for_read(x))
        assert r.tolist() == [9.0, 2.0, 3.0]
        src = torch.arange(4.0)
        y = nd.from_dlpack(src)
        src[1] = -1.0
        assert y.asnumpy().tolist() == [0.0, -1.0, 2.0, 3.0]
        z = nd.from_dlpack(torch.utils.dlpack.to_dlpack(src))
        assert z.shape == (4,)


def test_sparse_storage_waits_for_the_deferred_half():
    """Since the sparse slice (the name is the earlier refusal's):
    ``tostype`` converts and ``attach_grad(stype=...)`` makes a sparse
    gradient slot, empty until a backward."""
    with mx.cpu():
        x = nd.array([[0, 1], [0, 0]])
        r = x.tostype("row_sparse")
        assert r.stype == "row_sparse" and r.indices.asnumpy().tolist() == [0]
        assert x.tostype("csr").indptr.asnumpy().tolist() == [0, 1, 1]
        x.attach_grad(stype="row_sparse")
        assert x.grad.stype == "row_sparse" and x.grad.data.shape[0] == 0
        assert x.tostype("default") is x
