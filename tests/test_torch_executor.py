"""The port's Executor against the JAX package's on the CPU, with the same
values carried across (numpy-seeded):

- ``bench.py``'s ``conv_net`` (BatchNorm: aux states) at a narrow input,
  and a narrow ``lm_block`` whose attention is a ``_fused_attention``
  node (the port's CPU route is the kernels' plain version, the JAX
  package's the dense composition): forward in inference and in
  training, and backward with ``grad_req`` write, add and null and with
  given head gradients. Every output and gradient there passes through
  convolutions or matrix products, whose sums the two libraries order
  differently: rtol 1e-4 / atol 1e-5;
- the aux states after one ``forward(is_train=True)`` equal the JAX
  package's after its forward, not after its backward: a named test
  shows the JAX package's ``backward`` moving BatchNorm's statistics a
  second time (its fault, ROADMAP "Faults of the JAX package") and the
  port's moving them once, and differentiating the forward it ran;
- Dropout is compared at p = 0 and in inference; a sampler by shape,
  dtype and moments (torch cannot draw JAX's numbers);
- ``reshape``, ``copy_params_from``, ``output_dict``,
  ``set_monitor_callback``, ``compile_signature``, and the refusal of
  ``MXNET_GRAPH_OPT`` > 0.

Each graph is bound once per file on each side (the JAX executor jits).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import sym as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, sym

import test_torch_symbol as graphs

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
CPU = mx.cpu()


def _narrow_conv_net(S):
    net, _ = graphs.conv_net(S)
    return net, {"data": (2, 3, 16, 16)}


GRAPHS = {"conv_net": _narrow_conv_net,
          "lm_block_fused": graphs.lm_block_fused}


def _values(net, shapes, seed):
    """N(0, 1) data, N(0, 0.1^2) parameters (a Xavier-like scale at these
    widths), positive moving variances."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    args = {n: (rs.randn(*s) * (1.0 if n == "data" else 0.1))
            .astype("float32")
            for n, s in zip(net.list_arguments(), arg_shapes)}
    aux = {n: (rs.rand(*s) + (0.5 if "var" in n else 0.0)).astype("float32")
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(pkg, net, args, aux, grad_req):
    """An executor of ``net`` over fresh copies of the values; every
    argument but ``data`` takes a gradient by ``grad_req``."""
    n_ = jnd if pkg is jmx else nd
    kw = {} if pkg is jmx else {"ctx": CPU}
    reqs = {n: ("null" if n == "data" else grad_req) for n in args}
    grads = {n: n_.array(np.full(v.shape, 0.25, "float32"), **kw)
             for n, v in args.items() if reqs[n] != "null"}
    return net.bind(CPU if pkg is mx else jmx.cpu(),
                    args={n: n_.array(v, **kw) for n, v in args.items()},
                    args_grad=grads, grad_req=reqs,
                    aux_states={n: n_.array(v, **kw)
                                for n, v in aux.items()})


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def case(request):
    make = GRAPHS[request.param]
    (jnet, shapes), (tnet, _) = graphs._build(jmx, make), \
        graphs._build(mx, make)
    args, aux = _values(jnet, shapes, 0)
    ograds = [np.random.RandomState(1).randn(*s).astype("float32")
              for s in jnet.infer_shape(**shapes)[1]]
    return jnet, tnet, args, aux, ograds


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.asnumpy(), np.asarray(j.asnumpy()),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("is_train", [False, True])
def test_forward_matches(case, is_train):
    jnet, tnet, args, aux, _ = case
    je = _bind(jmx, jnet, args, aux, "write")
    te = _bind(mx, tnet, args, aux, "write")
    for t, j in zip(te.forward(is_train=is_train),
                    je.forward(is_train=is_train)):
        _close(t, j, GRAD_RTOL, GRAD_ATOL)
    for n in aux:  # after the forward, before any backward
        _close(te.aux_dict[n], je.aux_dict[n], GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
@pytest.mark.parametrize("head", ["ones", "given"])
def test_backward_matches(case, grad_req, head):
    jnet, tnet, args, aux, ograds = case
    je = _bind(jmx, jnet, args, aux, grad_req)
    te = _bind(mx, tnet, args, aux, grad_req)
    je.forward(is_train=True)
    te.forward(is_train=True)
    if head == "given":
        je.backward([jnd.array(g) for g in ograds])
        te.backward([nd.array(g, ctx=CPU) for g in ograds])
    else:
        je.backward()
        te.backward()
    assert sorted(te.grad_dict) == sorted(je.grad_dict)
    if grad_req == "null":
        assert not te.grad_dict
    for n in je.grad_dict:
        _close(te.grad_dict[n], je.grad_dict[n], GRAD_RTOL, GRAD_ATOL)


def test_forward_backward_and_output_dict(case):
    jnet, tnet, args, aux, _ = case
    je = _bind(jmx, jnet, args, aux, "write")
    te = _bind(mx, tnet, args, aux, "write")
    te.forward_backward()
    je.forward_backward()
    for n in je.grad_dict:
        _close(te.grad_dict[n], je.grad_dict[n], GRAD_RTOL, GRAD_ATOL)
    assert list(te.output_dict) == list(je.output_dict)


def _bn_graph(S):
    return S.BatchNorm(S.var("data"), momentum=0.9, name="bn")


def test_jax_backward_moves_the_statistics_twice_and_the_port_once():
    """A BatchNorm(momentum=0.9) on data whose channel means mu are about
    5, moving statistics from 0: after ``forward(is_train=True)`` the
    moving mean is 0.1 mu in both packages; after ``backward()`` the JAX
    package's is 0.19 mu (its backward runs the training forward again and
    applies its aux update a second time), the port's stays 0.1 mu."""
    rs = np.random.RandomState(3)
    x = (rs.randn(8, 3, 4, 4) + 5.0).astype("float32")
    mu = x.mean(axis=(0, 2, 3))
    aux = {"bn_moving_mean": np.zeros(3, "float32"),
           "bn_moving_var": np.ones(3, "float32")}
    args = {"data": x, "bn_gamma": np.ones(3, "float32"),
            "bn_beta": np.zeros(3, "float32")}
    je = _bind(jmx, _bn_graph(jsym), args, aux, "write")
    te = _bind(mx, _bn_graph(sym), args, aux, "write")
    je.forward(is_train=True)
    te.forward(is_train=True)
    for e in (je, te):
        np.testing.assert_allclose(
            np.asarray(e.aux_dict["bn_moving_mean"].asnumpy()), 0.1 * mu,
            rtol=1e-5)
    je.backward()
    te.backward()
    np.testing.assert_allclose(je.aux_dict["bn_moving_mean"].asnumpy(),
                               0.19 * mu, rtol=1e-5)
    np.testing.assert_allclose(te.aux_dict["bn_moving_mean"].asnumpy(),
                               0.1 * mu, rtol=1e-5)


def test_backward_differentiates_the_forward_it_ran():
    """Dropout's gradient is taken under the mask that made the outputs;
    a backward with no training forward before it runs one itself."""
    x = np.random.RandomState(4).rand(64, 32).astype("float32") + 1.0
    net = sym.Dropout(sym.var("data"), p=0.5, name="drop")
    ex = net.simple_bind(CPU, data=x.shape)
    out = ex.forward(is_train=True, data=nd.array(x, ctx=CPU))[0].asnumpy()
    ex.backward()
    g = ex.grad_dict["data"].asnumpy()
    np.testing.assert_array_equal(g, (out != 0) * 2.0)
    ex2 = net.simple_bind(CPU, data=x.shape)
    ex2.arg_dict["data"][:] = nd.array(x, ctx=CPU)
    ex2.backward()
    np.testing.assert_array_equal(ex2.grad_dict["data"].asnumpy(),
                                  (ex2.outputs[0].asnumpy() != 0) * 2.0)


def test_dropout_at_zero_and_in_inference_is_the_identity_in_both():
    x = np.random.RandomState(5).randn(4, 6).astype("float32")
    for p, train in ((0.0, True), (0.5, False)):
        jo = jsym.Dropout(jsym.var("data"), p=p).eval(
            data=jnd.array(x)) if not train else None
        te = sym.Dropout(sym.var("data"), p=p).simple_bind(CPU, data=x.shape)
        out = te.forward(is_train=train, data=nd.array(x, ctx=CPU))[0]
        np.testing.assert_array_equal(out.asnumpy(), x)
        if jo is not None:
            np.testing.assert_array_equal(np.asarray(jo[0].asnumpy()), x)


def test_sampler_matches_by_shape_dtype_and_moments():
    net = sym.random_normal(loc=1.0, scale=2.0, shape=(200, 100))
    out = net.eval(ctx=CPU)[0]
    jout = jsym.random_normal(loc=1.0, scale=2.0, shape=(200, 100)).eval()[0]
    assert out.shape == tuple(jout.shape) and out.dtype == jout.dtype
    a = out.asnumpy()
    assert abs(a.mean() - 1.0) < 0.05 and abs(a.std() - 2.0) < 0.05


def test_simple_bind_allocates_as_the_jax_package():
    """Arguments in type_dict's dtype else fp32; aux states and gradients
    fp32; grad_req as a dict names the arguments that take one."""
    net = sym.FullyConnected(sym.var("data"), num_hidden=3, name="fc")
    for S, ctx in ((jsym, jmx.cpu()), (sym, CPU)):
        n = S.FullyConnected(S.var("data"), num_hidden=3, name="fc")
        ex = n.simple_bind(ctx, grad_req={"fc_weight": "write"},
                           type_dict={"data": "float16"}, data=(2, 5))
        assert str(ex.arg_dict["data"].dtype) == "float16"
        assert str(ex.arg_dict["fc_weight"].dtype) == "float32"
        assert sorted(ex.grad_dict) == ["fc_weight"]
        assert str(ex.grad_dict["fc_weight"].dtype) == "float32"
    ex = net.simple_bind(CPU, data=(2, 5))
    assert ex.arg_dict["data"].ctx == CPU


def test_reshape_copy_params_monitor_and_compile_signature():
    net = sym.SoftmaxOutput(sym.FullyConnected(sym.var("data"), num_hidden=3,
                                               name="fc"), name="sm")
    ex = net.simple_bind(CPU, data=(4, 5))
    w = np.arange(15, dtype="float32").reshape(3, 5) / 15
    ex.copy_params_from({"fc_weight": nd.array(w, ctx=CPU)})
    with pytest.raises(mx.MXNetError, match="not in arguments"):
        ex.copy_params_from({"nope": nd.array(w, ctx=CPU)})
    ex.copy_params_from({"nope": nd.array(w, ctx=CPU)},
                        allow_extra_params=True)
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append(name))
    ex.forward(data=nd.array(np.ones((4, 5)), ctx=CPU))
    assert seen == ["sm_output"]
    big = ex.reshape(data=(8, 5), sm_label=(8,))
    assert big.arg_dict["data"].shape == (8, 5)
    assert big.arg_dict["fc_weight"] is ex.arg_dict["fc_weight"]
    before = mx.random.generator("cpu").get_state()
    assert big.compile_signature(is_train=True) is big
    assert torch.equal(mx.random.generator("cpu").get_state(), before)
    assert big.outputs == [] and big.opt_report is None
    assert '"fc"' in big.debug_str()


def test_graph_opt_refuses_naming_its_queue_item(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPH_OPT", "1")
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        sym.relu(sym.var("x")).simple_bind(CPU, x=(2,))
