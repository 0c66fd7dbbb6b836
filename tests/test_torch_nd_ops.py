"""The port's ``mx.nd`` op corpus against the JAX package's, on the CPU.

Every registered op of the port that is not a stub, a sampler or a
control-flow graph node runs on
the inputs ``tests/test_op_sweep.py::CASES`` gives it (or three seeded
(2, 3, 4) tensors where it has no case, as that sweep does), drawn from a
seeded generator of this file's own, in both packages; the outputs must
agree in count, shape and dtype, and in value within rtol 1e-5 / atol
1e-6 (both compute in fp32; XLA:CPU and ATen order some sums
differently), NaN where the reference gives NaN (their gradients:
``tests/test_torch_autograd_nd.py``). Samplers cannot match JAX's
threefry streams value by value: they are held to the JAX package's
shapes and dtypes (recorded in :data:`SAMPLED`), support, moments (within
5 standard errors over 20,000 draws) and reproducibility under
``mx.random.seed``. Stubs raise ``NotImplementedError`` naming their
ROADMAP item. The out-of-range-index repair (labels and indices -1, n
and n + 2 through ``pick``, ``Embedding``, ``SoftmaxCrossEntropyLoss``
and the ``Embedding`` layer) gives the JAX package's values: -1 wraps,
the rest give NaN.
"""
import numpy as np
import pytest
import torch

import test_op_sweep as sweep
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops.registry import _OPS as JAX_OPS

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.ops.control_flow import GRAPH_NODES
from mxnet_tpu_torch.ops.registry import _OPS, register_op

from test_torch_resnet_train import keep_zeros

RTOL, ATOL = 1e-5, 1e-6

_SAMPLER_PREFIXES = ("_random_", "_sample_", "_shuffle", "random_",
                     "sample_", "shuffle")


def _is_sampler(info):
    return info.needs_rng and info.name.startswith(_SAMPLER_PREFIXES)


def _unique(pred):
    seen = {}
    for info in _OPS.values():
        if pred(info):
            seen.setdefault(id(info.fn), info.name)
    return sorted(seen.values())


# the control-flow graph nodes take sub-Symbols as parameters, not arrays:
# tests/test_torch_control_flow.py holds them to the JAX package's; the
# random image ops (drawn from torch's generator, not JAX's threefry) and
# the decode ops (which take encoded bytes or a file) are held to it by
# tests/test_torch_image_data.py
IMAGE_ELSEWHERE = ("_image_random_", "_cvimdecode", "_cvimread")
DENSE = _unique(lambda i: not i.stub and not _is_sampler(i)
                and i.name not in GRAPH_NODES
                and not i.name.startswith(IMAGE_ELSEWHERE))
SAMPLERS = _unique(lambda i: not i.stub and _is_sampler(i)
                   and not i.name.startswith("_random_pdf"))
STUBS = sorted(n for n, i in _OPS.items() if i.stub)


def _case(name, seed=7):
    """The sweep's inputs for ``name`` (JAX NDArrays) and params, drawn
    from a generator of this file's own: the sweep's is put back."""
    saved = sweep.rs
    sweep.rs = np.random.RandomState(seed)
    try:
        case = sweep.CASES.get(name)
        if case is not None:
            return case()
        n = sweep._n_required(JAX_OPS[name])
        return [sweep.T(2, 3, 4) for _ in range(n)], {}
    finally:
        sweep.rs = saved


def _port_args(args):
    return [nd.array(a.asnumpy(), dtype=a.asnumpy().dtype)
            if hasattr(a, "asnumpy") else a for a in args]


def _outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _same(jout, tout, rtol=RTOL, atol=ATOL):
    jout, tout = _outs(jout), _outs(tout)
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        assert str(a.dtype) == str(b.dtype)
        an, bn = np.asarray(a.asnumpy()), b.asnumpy()
        assert an.shape == bn.shape
        np.testing.assert_allclose(bn.astype("float64"),
                                   an.astype("float64"), rtol=rtol,
                                   atol=atol, equal_nan=True)


def test_the_registry_names_every_op_of_the_reference():
    """Every name of the JAX package's registry is registered: ported,
    aliased or a stub."""
    missing = sorted(set(JAX_OPS) - set(_OPS))
    assert not missing
    assert len(DENSE) > 200 and len(STUBS) > 100


@pytest.mark.parametrize("name", DENSE)
def test_op_matches_the_jax_package(name):
    args, params = _case(name)
    jout = getattr(jnd, name)(*args, **params)
    with mx.cpu():
        tout = getattr(nd, name)(*_port_args(args), **params)
    _same(jout, tout)


def _draw(name, seed):
    mx.random.seed(seed)
    args, params = _case(name)
    with mx.cpu():
        return _outs(getattr(nd, name)(*_port_args(args), **params))


# the JAX package's draws on the sweep's cases: (shape, dtype) per output
SAMPLED = {
    "_random_exponential": [((3, 4), "float32")],
    "_random_exponential_like": [((3, 4), "float32")],
    "_random_gamma": [((3, 4), "float32")],
    "_random_gamma_like": [((3, 4), "float32")],
    "_random_generalized_negative_binomial": [((3, 4), "float32")],
    "_random_generalized_negative_binomial_like": [((3, 4), "float32")],
    "_random_negative_binomial": [((3, 4), "float32")],
    "_random_negative_binomial_like": [((3, 4), "float32")],
    "_random_normal": [((3, 4), "float32")],
    "_random_normal_like": [((3, 4), "float32")],
    "_random_poisson": [((3, 4), "float32")],
    "_random_poisson_like": [((3, 4), "float32")],
    "_random_randint": [((3, 4), "int32")],
    "_random_uniform": [((3, 4), "float32")],
    "_random_uniform_like": [((3, 4), "float32")],
    "_sample_exponential": [((3, 4), "float32")],
    "_sample_gamma": [((3, 4), "float32")],
    "_sample_generalized_negative_binomial": [((3, 4), "float32")],
    "_sample_multinomial": [((2, 3), "int32")],
    "_sample_negative_binomial": [((3, 4), "float32")],
    "_sample_normal": [((3, 4), "float32")],
    "_sample_poisson": [((3, 4), "float32")],
    "_sample_uniform": [((3, 4), "float32")],
    "_sample_unique_zipfian": [((1, 8), "int32"), ((), "int32")],
    "_shuffle": [((6, 3), "float32")],
}


def test_every_sampler_has_its_jax_shape_recorded():
    assert sorted(SAMPLED) == SAMPLERS


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_shape_dtype_and_seed(name):
    """The JAX package's shapes and dtypes (:data:`SAMPLED`); one seed
    draws the same values twice, another seed others."""
    first, again, other = _draw(name, 1), _draw(name, 1), _draw(name, 2)
    assert [(a.shape, str(a.dtype)) for a in first] == SAMPLED[name]
    for a, b in zip(first, again):
        assert np.array_equal(a.asnumpy(), b.asnumpy())
    if first[0].size > 4:
        assert not np.array_equal(first[0].asnumpy(), other[0].asnumpy())


# (name, params, mean, variance) of 20,000 draws
MOMENTS = [
    ("_random_uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    ("_random_normal", dict(loc=2.0, scale=0.5), 2.0, 0.25),
    ("_random_gamma", dict(alpha=3.0, beta=2.0), 6.0, 12.0),
    ("_random_exponential", dict(lam=4.0), 0.25, 1 / 16),
    ("_random_poisson", dict(lam=3.0), 3.0, 3.0),
    ("_random_negative_binomial", dict(k=4, p=0.5), 4.0, 8.0),
    ("_random_generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0,
     2.0 + 0.5 * 4.0),
    ("_random_randint", dict(low=0, high=10), 4.5, 99 / 12),
]


@pytest.mark.parametrize("name,params,mean,var", MOMENTS,
                         ids=[m[0] for m in MOMENTS])
def test_sampler_moments(name, params, mean, var):
    mx.random.seed(5)
    with mx.cpu():
        x = getattr(nd, name)(shape=(20000,), **params).asnumpy()
    x = x.astype("float64")
    assert abs(x.mean() - mean) < 5 * np.sqrt(var / x.size)
    assert abs(x.var() - var) < 0.1 * var


def test_row_samplers_and_multinomial_follow_their_rows():
    mx.random.seed(0)
    with mx.cpu():
        u = nd._sample_uniform(nd.array([0.0, 10.0]), nd.array([1.0, 11.0]),
                               shape=(5000,)).asnumpy()
        p = nd.array([[0.1, 0.9, 0.0], [0.0, 0.0, 1.0]])
        m = nd._sample_multinomial(p, shape=(4000,)).asnumpy()
        perm = nd.shuffle(nd.arange(0, 50)).asnumpy()
    assert u.shape == (2, 5000) and (u[0] < 1).all() and (u[1] >= 10).all()
    assert abs(u[1].mean() - 10.5) < 0.05
    assert m.dtype == np.int32 and (m[1] == 2).all() and (m[0] != 2).all()
    assert abs((m[0] == 1).mean() - 0.9) < 0.03
    assert sorted(perm.tolist()) == list(range(50))


def test_random_namespace_samplers():
    """``mx.random`` / ``nd.random``: shapes, dtypes, seeds, devices."""
    with mx.cpu():
        mx.random.seed(3)
        a = nd.random.uniform(0, 1, shape=(3, 4))
        b = nd.random.normal(shape=(2,), dtype="float16")
        c = nd.random.randint(0, 5, shape=(6,))
        mx.random.seed(3)
        a2 = nd.random.uniform(0, 1, shape=(3, 4))
        m = nd.random.multinomial(nd.array([[0.0, 1.0], [1.0, 0.0]]))
        e = nd.random.exponential(scale=2.0, shape=(10000,))
    assert a.shape == (3, 4) and a.dtype == np.float32
    assert b.dtype == np.float16 and c.dtype == np.int32
    assert np.array_equal(a.asnumpy(), a2.asnumpy())
    assert m.asnumpy().tolist() == [1, 0]
    assert abs(e.asnumpy().mean() - 2.0) < 0.1


@pytest.mark.parametrize("name", STUBS[::7])
def test_stub_raises_not_implemented_naming_its_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        getattr(nd, name)()


def test_late_registered_op_appears_on_first_access():
    register_op("_test_torch_late_op")(lambda data, k=2.0: data * k)
    with mx.cpu():
        out = nd._test_torch_late_op(nd.ones((2,)), 3.0)
    assert out.asnumpy().tolist() == [3.0, 3.0]
    with pytest.raises(AttributeError):
        nd.not_an_op_name


def test_sparse_input_raises_naming_the_deferred_half():
    """Since the sparse slice a sparse input to an op with no sparse
    implementation runs the dense op on its dense view, with the
    storage-fallback warning (the name is the earlier refusal's)."""
    from mxnet_tpu_torch.ndarray import sparse
    sparse._fallback_warned.clear()
    with mx.cpu():
        s = sparse.row_sparse_array((-np.ones((1, 2), "float32"),
                                     np.asarray([1])), shape=(2, 2))
        with pytest.warns(UserWarning, match="dense implementation"):
            out = nd.relu(s)
    assert out.stype == "default" and not out.asnumpy().any()


# -- the out-of-range index repair -------------------------------------------

BAD = [-1, 5, 7]   # n = 5: wraps, NaN, NaN


@pytest.mark.parametrize("bad", BAD)
def test_pick_and_embedding_ops_wrap_or_give_nan_as_jax(bad):
    rs = np.random.RandomState(0)
    x = rs.randn(4, 5).astype("float32")
    w = rs.randn(5, 3).astype("float32")
    idx = np.array([0, 4, bad, 2], "float32")
    jp = jnd.pick(jnd.array(x), jnd.array(idx)).asnumpy()
    je = jnd.Embedding(jnd.array(idx), jnd.array(w), input_dim=5,
                       output_dim=3).asnumpy()
    with mx.cpu():
        tp = nd.pick(nd.array(x), nd.array(idx)).asnumpy()
        te = nd.Embedding(nd.array(idx), nd.array(w), input_dim=5,
                          output_dim=3).asnumpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
    assert np.isnan(tp[2]) == (bad != -1)


@pytest.mark.parametrize("bad", BAD)
def test_loss_and_embedding_layer_wrap_or_give_nan_as_jax(bad):
    rs = np.random.RandomState(1)
    x = rs.randn(4, 5).astype("float32")
    w = rs.randn(5, 3).astype("float32")
    label = np.array([0, 4, bad, 2], "float32")
    jl = jgluon.loss.SoftmaxCrossEntropyLoss()(jnd.array(x),
                                               jnd.array(label)).asnumpy()
    jemb = jgluon.nn.Embedding(5, 3)
    jemb.initialize(keep_zeros)   # its weight is set below
    jemb.weight.set_data(jnd.array(w))
    je = jemb(jnd.array(label)).asnumpy()
    temb = gluon.nn.Embedding(5, 3, device="cpu")
    with torch.no_grad():
        temb.weight.copy_(torch.from_numpy(w))
    tl = gluon.loss.SoftmaxCrossEntropyLoss()(torch.from_numpy(x),
                                              torch.from_numpy(label))
    te = temb(torch.from_numpy(label).long())
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(te.detach().numpy(), je)
    with mx.cpu():
        tl_nd = gluon.loss.SoftmaxCrossEntropyLoss()(nd.array(x),
                                                     nd.array(label))
    np.testing.assert_allclose(tl_nd.asnumpy(), jl, rtol=RTOL, atol=ATOL)


def test_bad_label_gradient_reaches_only_the_valid_rows():
    """A NaN loss row does not poison the others' gradients."""
    x = torch.randn(3, 5, requires_grad=True)
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(x, torch.tensor([1., 9, 0]))
    loss[torch.isfinite(loss)].sum().backward()
    assert torch.isfinite(x.grad).all() and (x.grad[1] == 0).all()


# -- the optimizer ops' out= contract --------------------------------------------

OPT_CASES = [
    ("sgd_update", 2, dict(lr=0.1, wd=0.01)),
    ("sgd_mom_update", 3, dict(lr=0.1, momentum=0.9, wd=0.01)),
    ("mp_sgd_update", 3, dict(lr=0.1, wd=0.01)),
    ("mp_sgd_mom_update", 4, dict(lr=0.1, momentum=0.9, wd=0.01)),
    ("nag_mom_update", 3, dict(lr=0.1, momentum=0.9)),
    ("adam_update", 4, dict(lr=0.01)),
    ("_adamw_update", 4, dict(lr=0.01, wd=0.1)),
    ("rmsprop_update", 3, dict(lr=0.01)),
    ("signum_update", 3, dict(lr=0.01, momentum=0.9)),
    ("adagrad_update", 3, dict(lr=0.1)),
    ("adadelta_update", 4, dict()),
    ("mp_nag_mom_update", 4, dict(lr=0.1, momentum=0.9)),
]


@pytest.mark.parametrize("name,n_in,params", OPT_CASES,
                         ids=[c[0] for c in OPT_CASES])
def test_update_op_writes_weight_and_state_in_place_under_out(name, n_in,
                                                              params):
    """``out=weight`` writes the new weight and the new state in place;
    the values are the JAX package's outputs."""
    rs = np.random.RandomState(2)
    ins = [rs.uniform(0.1, 0.9, (3, 4)).astype("float32")
           for _ in range(n_in)]
    jres = _outs(getattr(jnd, name)(*[jnd.array(a) for a in ins], **params))
    with mx.cpu():
        arrs = [nd.array(a) for a in ins]
        free = _outs(getattr(nd, name)(*arrs, **params))
        for a, b in zip(arrs, ins):
            assert np.array_equal(a.asnumpy(), b)   # nothing written
        got = getattr(nd, name)(*arrs, out=arrs[0], **params)
    assert got is arrs[0]
    _same(jres, free)
    state_in = {o: i for o, i in _OPS[name].mutates.items()}
    np.testing.assert_allclose(arrs[0].asnumpy(), jres[0].asnumpy(),
                               rtol=RTOL, atol=ATOL)
    for o, i in state_in.items():
        np.testing.assert_allclose(arrs[i].asnumpy(), jres[o].asnumpy(),
                                   rtol=RTOL, atol=ATOL)


def test_multi_mp_sgd_mom_update_is_the_loop_of_the_single_update():
    """fp16 weights: the kernel's list form (its plain version here) is
    bit-equal to a loop of ``mp_sgd_mom_update``; with ``out=`` the
    weights, momenta and master weights are written in place."""
    rs = np.random.RandomState(4)
    shapes = [(3, 4), (5,), (2, 2)]
    quads = []
    for s in shapes:
        w32 = rs.randn(*s).astype("float32")
        quads += [w32.astype("float16"),
                  rs.randn(*s).astype("float16"),
                  (rs.randn(*s) * 0.1).astype("float32"), w32]
    lrs, wds = [0.1, 0.05, 0.2], [1e-4, 0.0, 1e-3]
    with mx.cpu():
        arrs = [nd.array(a, dtype=a.dtype) for a in quads]
        loop = [nd.mp_sgd_mom_update(*arrs[4 * i:4 * i + 4], lr=lrs[i],
                                     wd=wds[i], momentum=0.9)
                for i in range(3)]
        nd.multi_mp_sgd_mom_update(*arrs, lrs=lrs, wds=wds, momentum=0.9,
                                   num_weights=3,
                                   out=[arrs[0], arrs[4], arrs[8]])
    for i, (w, m, w32) in enumerate(loop):
        assert np.array_equal(arrs[4 * i].asnumpy(), w.asnumpy())
        assert np.array_equal(arrs[4 * i + 2].asnumpy(), m.asnumpy())
        assert np.array_equal(arrs[4 * i + 3].asnumpy(), w32.asnumpy())
