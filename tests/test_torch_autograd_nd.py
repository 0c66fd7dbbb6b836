"""The port's autograd over NDArrays, and the slice as a whole, against
the JAX package on the CPU.

- gradients of a set of ops, the loss layers with their own backward
  among them, on ``tests/test_op_sweep.py``'s gradient shapes and
  parameters: rtol 1e-4 / atol 1e-5 (fp32 on both sides; the two
  libraries sum in different orders);
- ``autograd.grad`` (and a second derivative with ``create_graph``),
  ``mark_variables``, ``Function``, ``grad_req="add"``, head gradients,
  and hand-written SGD outside ``record`` (``w[:] = w - lr * w.grad`` and
  ``nd.sgd_update(..., out=w)``), which torch would refuse on a leaf that
  requires a gradient unless the op runs outside torch's recording, as
  the reference's does: rtol 1e-5 / atol 1e-6;
- a LeNet-sized user ``HybridBlock`` whose ``hybrid_forward(F, x,
  ...)`` calls ``F.Convolution``, ``F.Pooling`` and ``F.FullyConnected``,
  trained for two steps of ``examples/image_classification/
  train_gluon.py``'s loop (NDArray batches, ``record``,
  ``loss.backward()``, ``Trainer.step``, ``metric.Accuracy``) in both
  packages, the JAX side eager: the losses within rtol 1e-5, the weights
  after two steps within rtol 1e-4 / atol 1e-6, the accuracy equal.
"""
import numpy as np
import pytest
import torch

import test_op_sweep as sweep
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import metric as jmetric
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, metric, nd

from test_torch_resnet_train import keep_zeros

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.asnumpy(), np.asarray(j.asnumpy()),
                               rtol=rtol, atol=atol)


# (op, inputs (shapes), the inputs differentiated, params)
_LABEL4 = np.array([0, 3, 1, 2], "float32")
GRAD_CASES = {
    "SoftmaxOutput": ([(4, 5), _LABEL4], [0], {}),
    "LinearRegressionOutput": ([(4, 5), (4, 5)], [0], {}),
    "LogisticRegressionOutput": ([(4, 5), (4, 5)], [0], {}),
    "MAERegressionOutput": ([(4, 5), (4, 5)], [0], {}),
    "SVMOutput": ([(4, 5), _LABEL4], [0], {}),
    "make_loss": ([(3, 4)], [0], {}),
    "BlockGrad": ([(3, 4)], [0], {}),
    "pick": ([(4, 5), _LABEL4], [0], {}),
    "Embedding": ([_LABEL4, (5, 3)], [1], {"input_dim": 5,
                                            "output_dim": 3}),
    "softmax_cross_entropy": ([(4, 5), _LABEL4], [0], {}),
    "LeakyReLU": ([(3, 4)], [0], sweep._GRAD_KWARGS["LeakyReLU"]),
    "FullyConnected": (sweep._GRAD_SHAPES["FullyConnected"], [0, 1, 2],
                       sweep._GRAD_KWARGS["FullyConnected"]),
    "Convolution": (sweep._GRAD_SHAPES["Convolution"], [0, 1, 2],
                    sweep._GRAD_KWARGS["Convolution"]),
    "Pooling": (sweep._GRAD_SHAPES["Pooling"], [0],
                sweep._GRAD_KWARGS["Pooling"]),
    "softmax": ([(3, 4)], [0], {}),
    "smooth_l1": ([(3, 4)], [0], {}),
}


def _inputs(spec, seed):
    rs = np.random.RandomState(seed)
    return [s if isinstance(s, np.ndarray)
            else rs.uniform(-0.8, 0.8, s).astype("float32") for s in spec]


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_op_gradient_matches_the_jax_package(name):
    """The gradient of ``sum(out * r)`` for a seeded ``r`` (a loss layer's
    is its own, whatever ``r``)."""
    spec, which, params = GRAD_CASES[name]
    ins = _inputs(spec, 3)
    jargs = [jnd.array(a) for a in ins]
    for i in which:
        jargs[i].attach_grad()
    with jag.record():
        jout = _outs(getattr(jnd, name)(*jargs, **params))[0]
        r = np.random.RandomState(5).uniform(-1, 1, jout.shape) \
            .astype("float32")
        (jout * jnd.array(r)).sum().backward()
    with mx.cpu():
        targs = [nd.array(a) for a in ins]
        for i in which:
            targs[i].attach_grad()
        with autograd.record():
            tout = _outs(getattr(nd, name)(*targs, **params))[0]
            (tout * nd.array(r)).sum().backward()
    _close(tout, jout)
    for i in which:
        _close(targs[i].grad, jargs[i].grad, GRAD_RTOL, GRAD_ATOL)


def test_grad_returns_gradients_and_second_derivatives():
    x0 = np.array([0.5, -1.0, 2.0], "float32")
    jx = jnd.array(x0)
    jx.attach_grad()
    with jag.record():
        jy = (jx * jx * jx).sum()
        jg = jag.grad(jy, [jx], create_graph=True)[0]
        jz = (jg * jg).sum()
    jz.backward()
    with mx.cpu():
        tx = nd.array(x0)
        tx.attach_grad()
        with autograd.record():
            ty = (tx * tx * tx).sum()
            tg = autograd.grad(ty, [tx], create_graph=True)[0]
            tz = (tg * tg).sum()
        tz.backward()
        assert isinstance(tg, nd.NDArray)
        other = nd.array([1.0])
        with autograd.record():
            w = (tx * 2).sum()
        unused = autograd.grad(w, [tx, other.attach_grad() or other])
    _close(tg, jg)
    _close(tx.grad, jx.grad)
    assert unused[1].asnumpy().tolist() == [0.0]
    with pytest.raises(mx.MXNetError, match="record"):
        autograd.grad(ty, [tx], create_graph=True)


def test_mark_variables_writes_into_the_given_buffers():
    x0 = np.array([1.0, 2.0], "float32")
    jx, jg = jnd.array(x0), jnd.zeros((2,))
    jag.mark_variables([jx], [jg])
    with jag.record():
        (jx * 3 + jx * jx).sum().backward()
    with mx.cpu():
        tx, tg = nd.array(x0), nd.zeros((2,))
        autograd.mark_variables([tx], [tg])
        with autograd.record():
            (tx * 3 + tx * tx).sum().backward()
        assert tx.grad is not None
    _close(tg, jx.grad)
    np.testing.assert_allclose(tg.asnumpy(), [5.0, 7.0])


def test_grad_req_add_accumulates_and_a_held_grad_sees_each_backward():
    with mx.cpu():
        x = nd.array([1.0, 2.0])
        x.attach_grad("add")
        for _ in range(2):
            with autograd.record():
                (x * x).sum().backward()
        assert x.grad.asnumpy().tolist() == [4.0, 8.0]
        y = nd.array([1.0, 2.0])
        y.attach_grad()
        held = y.grad
        with autograd.record():
            (y * 5).sum().backward()
        assert held.asnumpy().tolist() == [5.0, 5.0]
        with autograd.record():
            z = y * y
        z.backward(nd.array([1.0, 0.5]))
        assert y.grad.asnumpy().tolist() == [2.0, 2.0]


class _JScaledSquare(jag.Function):
    def forward(self, x):
        self.save_for_backward(x)
        return x * x

    def backward(self, dy):
        (x,) = self.saved_tensors
        return dy * x * 3   # deliberately not 2x: the custom rule is used


class _TScaledSquare(autograd.Function):
    def forward(self, x):
        self.save_for_backward(x)
        return x * x

    def backward(self, dy):
        (x,) = self.saved_tensors
        return dy * x * 3


def test_function_runs_its_own_backward():
    x0 = np.array([1.0, -2.0, 0.5], "float32")
    jx = jnd.array(x0)
    jx.attach_grad()
    with jag.record():
        jy = _JScaledSquare()(jx)
        (jy * 2).sum().backward()
    with mx.cpu():
        tx = nd.array(x0)
        tx.attach_grad()
        with autograd.record():
            ty = _TScaledSquare()(tx)
            (ty * 2).sum().backward()
        plain = _TScaledSquare()(tx)
    _close(ty, jy)
    _close(tx.grad, jx.grad)
    assert plain.asnumpy().tolist() == ty.asnumpy().tolist()


def test_get_symbol_waits_for_the_symbolic_stack():
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        autograd.get_symbol(None)


def test_hand_written_sgd_outside_record_matches_the_jax_package():
    rs = np.random.RandomState(8)
    w0, x0 = rs.randn(3, 4).astype("float32"), rs.randn(4).astype("float32")
    jw, jx = jnd.array(w0), jnd.array(x0)
    jw.attach_grad()
    with mx.cpu():
        tw, tx = nd.array(w0), nd.array(x0)
        tw.attach_grad()
    for step in range(2):
        with jag.record():
            jnd.dot(jw, jx).square().sum().backward()
        with mx.cpu(), autograd.record():
            nd.dot(tw, tx).square().sum().backward()
        if step == 0:
            jw[:] = jw - 0.1 * jw.grad
            with mx.cpu():
                tw[:] = tw - 0.1 * tw.grad
        else:
            jnd.sgd_update(jw, jw.grad, lr=0.1, wd=0.01, out=jw)
            with mx.cpu():
                nd.sgd_update(tw, tw.grad, lr=0.1, wd=0.01, out=tw)
    _close(tw, jw)
    assert tw.grad_req == "write" and tw._data.is_leaf


def _lenet_body(F, x, c1_weight, c1_bias, fc_weight, fc_bias):
    h = F.Convolution(x, c1_weight, c1_bias, kernel=(3, 3), num_filter=4)
    h = F.Activation(h, act_type="relu")
    h = F.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
    return F.FullyConnected(h, fc_weight, fc_bias, num_hidden=10)


_SHAPES = {"c1_weight": (4, 1, 3, 3), "c1_bias": (4,),
           "fc_weight": (10, 100), "fc_bias": (10,)}


class _JLeNet(jgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        with self.name_scope():
            for k, s in _SHAPES.items():
                setattr(self, k, self.params.get(k, shape=s))

    def hybrid_forward(self, F, x, c1_weight, c1_bias, fc_weight, fc_bias):
        return _lenet_body(F, x, c1_weight, c1_bias, fc_weight, fc_bias)


class _TLeNet(gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        with self.name_scope():
            for k, s in _SHAPES.items():
                setattr(self, k, self.params.get(k, shape=s))

    def hybrid_forward(self, F, x, c1_weight, c1_bias, fc_weight, fc_bias):
        return _lenet_body(F, x, c1_weight, c1_bias, fc_weight, fc_bias)


def _weights():
    rs = np.random.RandomState(21)
    return {k: (rs.randn(*s) * 0.3).astype("float32")
            for k, s in _SHAPES.items()}


def _batches(steps=2, batch=8, classes=10, size=12):
    """``train_gluon.py``'s synthetic batches: class k brightens a
    k-dependent stripe."""
    rs = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        x = rs.rand(batch, 1, size, size).astype("float32") * 0.3
        y = rs.randint(0, classes, batch)
        for i, cls in enumerate(y):
            x[i, :, cls * size // classes:cls * size // classes + 3] += 0.5
        out.append((x, y.astype("float32")))
    return out


def _train(pkg_nd, pkg_ag, pkg_gluon, pkg_metric, net, batches):
    trainer = pkg_gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = pkg_gluon.loss.SoftmaxCrossEntropyLoss()
    acc = pkg_metric.Accuracy()
    losses = []
    for x_np, y_np in batches:
        x, y = pkg_nd.array(x_np), pkg_nd.array(y_np)
        with pkg_ag.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        trainer.step(x_np.shape[0])
        acc.update(y, out)
        losses.append(float(loss.mean().asscalar()))
    return losses, acc.get()


def test_user_hybrid_block_trains_as_in_the_jax_package():
    w = _weights()
    batches = _batches()
    jnet = _JLeNet()
    jnet.initialize(keep_zeros)   # every value is set below
    for k, v in w.items():
        getattr(jnet, k).set_data(jnd.array(v))
    jloss, jacc = _train(jnd, jag, jgluon, jmetric, jnet, batches)
    tnet = _TLeNet()
    tnet.initialize(ctx=mx.cpu())
    for k, v in w.items():
        getattr(tnet, k).set_data(torch.from_numpy(v))
    with mx.cpu():
        tloss, tacc = _train(nd, autograd, gluon, metric, tnet, batches)
        out = tnet(nd.array(batches[0][0]))
    assert isinstance(out, nd.NDArray) and out.shape == (8, 10)
    assert not out._data.requires_grad    # outside record: not recorded
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL)
    assert tacc == jacc
    for k in _SHAPES:
        np.testing.assert_allclose(
            getattr(tnet, k).data().asnumpy(),
            np.asarray(getattr(jnet, k).data().asnumpy()), rtol=1e-4,
            atol=RTOL / 10)


def test_block_keeps_torch_in_torch_out():
    tnet = _TLeNet()
    tnet.initialize(ctx=mx.cpu())
    x = torch.rand(2, 1, 12, 12)
    out = tnet(x)
    assert isinstance(out, torch.Tensor) and out.shape == (2, 10)
