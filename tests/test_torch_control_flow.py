"""The port's symbolic control flow (``sym.contrib.foreach``,
``while_loop``, ``cond``) against the JAX package's on the CPU, as
``tests/test_symbol_control_flow.py`` drives it: each graph bound in both
packages on the same numpy-seeded values gives the same outputs (rtol
1e-5 / atol 1e-6) and the same gradients through ``backward`` (rtol 1e-4
/ atol 1e-5); ``while_loop``'s outputs come in ``max_iterations`` rows,
zero past the last step run, and its trip count is the data's. Shapes of
the control-flow nodes come from the shape rules over their subgraphs.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import sym as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, sym

CPU = mx.cpu()


def _foreach_closure(S):
    data, init, w = S.var("data"), S.var("init"), S.var("w")

    def body(d, s):
        out = d * w + s
        return out, out

    outs, final = S.contrib.foreach(body, data, init)
    return S.Group([outs, final])


def _foreach_two_states(S):
    data, h, c = S.var("data"), S.var("h"), S.var("c")

    def body(d, states):
        h_, c_ = states
        nh = S.tanh(d + h_) * c_
        return [nh, nh * 2.0], [nh, c_ + 1.0]

    outs, states = S.contrib.foreach(body, data, [h, c])
    return S.Group(outs + states)


def _while(S):
    x, k = S.var("x"), S.var("k")
    outs, finals = S.contrib.while_loop(
        lambda v: S.sum(v) < 100.0,
        lambda v: (v * k, v * k), [x], max_iterations=12)
    return S.Group([outs, finals[0]])


def _cond(S):
    a, b = S.var("a"), S.var("b")
    return S.contrib.cond(lambda x, y: S.sum(x) < S.sum(y),
                          lambda x, y: x * 2.0 + y,
                          lambda x, y: y * 3.0 - x, inputs=[a, b])


CASES = {
    "foreach_closure": (_foreach_closure, {"data": (5, 3), "init": (3,),
                                           "w": (3,)}),
    "foreach_two_states": (_foreach_two_states, {"data": (4, 2, 3),
                                                 "h": (2, 3),
                                                 "c": (2, 3)}),
    "while_loop": (_while, {"x": (2,), "k": (2,)}),
    "cond_then": (_cond, {"a": (3,), "b": (3,)}),
    "cond_else": (_cond, {"a": (3,), "b": (3,)}),
}


def _values(name, shapes):
    rs = np.random.RandomState(0)
    vals = {n: rs.rand(*s).astype("float32") + 0.5 for n, s in shapes.items()}
    if name == "while_loop":
        vals["k"] = np.array([1.5, 2.0], "float32")
    if name == "cond_else":
        vals["a"] = vals["a"] + 10.0
    return vals


def _run(pkg, net, vals, ograds):
    S_nd = jnd if pkg is jmx else nd
    kw = {} if pkg is jmx else {"ctx": CPU}
    ctx = jmx.cpu() if pkg is jmx else CPU
    ex = net.bind(ctx, args={n: S_nd.array(v, **kw) for n, v in vals.items()},
                  args_grad={n: S_nd.zeros(v.shape, **kw)
                             for n, v in vals.items()})
    outs = [np.asarray(o.asnumpy()) for o in ex.forward(is_train=True)]
    ex.backward([S_nd.array(g, **kw) for g in ograds])
    grads = {n: np.asarray(g.asnumpy()) for n, g in ex.grad_dict.items()}
    return outs, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_control_flow_matches_the_jax_package(name):
    make, shapes = CASES[name]
    vals = _values(name, shapes)
    jnet, tnet = make(jsym), make(sym)
    out_shapes = jnet.infer_shape(**shapes)[1]
    assert tnet.infer_shape(**shapes)[1] == out_shapes
    rs = np.random.RandomState(1)
    ograds = [rs.randn(*s).astype("float32") for s in out_shapes]
    jouts, jgrads = _run(jmx, jnet, vals, ograds)
    touts, tgrads = _run(mx, tnet, vals, ograds)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_while_loop_pads_rows_and_counts_the_datas_steps():
    outs, finals = sym.contrib.while_loop(
        lambda v: sym.sum(v) < 10.0,
        lambda v: (v + 1.0, v + 1.0), [sym.var("v")], max_iterations=16)
    o, f = sym.Group([outs, finals[0]]).eval(
        ctx=CPU, v=nd.array([0.0], ctx=CPU))
    assert float(f.asnumpy()[0]) == 10.0
    got = o.asnumpy().ravel()
    np.testing.assert_array_equal(got[:10], np.arange(1.0, 11.0))
    np.testing.assert_array_equal(got[10:], np.zeros(6))


def test_foreach_gradient_reaches_the_closure_weight():
    """d/dw of sum of outs: out1 = w, out2 = 2w + out1, out3 = 3w + out2;
    douts/dw = 1 + (2 + 1) + (3 + 2 + 1) = 10, as in the JAX package's
    own test."""
    data, init, w = sym.var("data"), sym.var("init"), sym.var("w")
    outs, _ = sym.contrib.foreach(lambda d, s: (d * w + s, d * w + s),
                                  data, init)
    ex = outs.simple_bind(CPU, data=(3,), init=(1,), w=(1,))
    ex.forward(is_train=True, data=nd.array([1.0, 2.0, 3.0], ctx=CPU),
               init=nd.array([0.0], ctx=CPU), w=nd.array([2.0], ctx=CPU))
    ex.backward(out_grads=nd.ones((3, 1), ctx=CPU))
    assert abs(float(ex.grad_dict["w"].asnumpy()[0]) - 10.0) < 1e-4
