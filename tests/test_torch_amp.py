"""Dynamic loss scaling and the autograd deposit rule against the JAX
package.

- ``LossScaler``: the scale sequence over a fixed sequence of overflow
  flags, exactly (powers of two);
- ``has_overflow``: an inf or a NaN in any gradient, exactly;
- the skip loop (``scale_loss`` -> ``backward`` -> ``has_overflow`` ->
  ``update_scale`` -> ``step``, skipped on an overflow) on a small dense
  model over 4 steps with one forced overflow: the scales exactly, the
  weights and losses to rtol 1e-5 / atol 1e-6 (the same fp32 formulas,
  summed in other orders by XLA and ATen);
- ``autograd.backward`` deposits as the reference does: two backward
  passes without a step leave the second pass's gradient under
  ``grad_req="write"`` and their sum under ``"add"``, and a leaf the
  second pass does not reach keeps its gradient; to 1e-6 (one product
  and one sum).
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jax_amp
from mxnet_tpu import autograd as jax_autograd
from mxnet_tpu import gluon as jax_gluon
from mxnet_tpu_torch import amp, autograd
from mxnet_tpu_torch.gluon import Trainer, collect_params
from mxnet_tpu_torch.gluon import loss as torch_loss
from mxnet_tpu_torch.gluon.nn import Dense, HybridSequential

from test_torch_resnet_train import keep_zeros

RTOL, ATOL = 1e-5, 1e-6
FLAGS = [False, False, False, True, False, True, True, False, False, False,
         False, False, False, True, False]


@pytest.mark.parametrize("kw", [dict(scale_window=3),
                                dict(init_scale=4.0, scale_factor=4.0,
                                     scale_window=2),
                                {}])
def test_loss_scaler_matches_jax(kw):
    """Halve on an overflow (never below 1), grow after ``scale_window``
    clean steps; the default window of 2000 never grows here."""
    jsc, tsc = jax_amp.LossScaler(**kw), amp.LossScaler(**kw)
    seq = []
    for flag in FLAGS:
        jsc.update_scale(flag)
        tsc.update_scale(flag)
        assert tsc.loss_scale == jsc.loss_scale
        seq.append(tsc.loss_scale)
    if kw.get("scale_window") == 3:
        assert max(seq) > 2 ** 16 and min(seq) < 2 ** 16
    if kw.get("init_scale") == 4.0:
        assert min(seq) == 1


@pytest.mark.parametrize("bad", [None, float("inf"), float("-inf"),
                                 float("nan")])
@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_has_overflow_matches_jax(dtype, bad):
    rng = np.random.RandomState(0)
    grads = [rng.randn(4, 5).astype(dtype), rng.randn(7).astype(dtype),
             np.full(3, 60000.0, dtype)]
    if bad is not None:
        grads[1][3] = bad
    tparams = []
    for g in grads:
        p = torch.nn.Parameter(torch.zeros(g.shape, dtype=getattr(torch,
                                                                  dtype)))
        p.grad = torch.from_numpy(g)
        tparams.append(p)
    tparams.append(torch.nn.Parameter(torch.zeros(2)))  # no gradient
    # the JAX scaler reads each parameter's ``_grad``
    jparams = [types.SimpleNamespace(_grad=mx.nd.array(g, dtype=dtype))
               for g in grads] + [types.SimpleNamespace(_grad=None)]
    want = jax_amp.LossScaler().has_overflow(jparams)
    assert want == (bad is not None)
    assert amp.LossScaler().has_overflow(tparams) == want


def test_amp_cast_policy_waits_for_the_nd_slice():
    for fn, args in ((amp.init, ()), (amp.convert_model, (None, {}, {})),
                     (amp.convert_hybrid_block, (None,))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(*args)


IN, HID, OUT, N, STEPS = 6, 8, 3, 10, 4


def _data():
    rng = np.random.RandomState(1)
    x = rng.randn(STEPS, N, IN).astype("float32")
    x[1, 2, 0] = np.inf  # the second step overflows
    y = rng.randint(0, OUT, (STEPS, N)).astype("float32")
    weights = {"0.weight": rng.randn(HID, IN).astype("float32") * 0.3,
               "0.bias": rng.randn(HID).astype("float32") * 0.1,
               "1.weight": rng.randn(OUT, HID).astype("float32") * 0.3,
               "1.bias": rng.randn(OUT).astype("float32") * 0.1}
    return x, y, weights


def _jax_loop():
    x, y, weights = _data()
    net = jax_gluon.nn.HybridSequential()
    net.add(jax_gluon.nn.Dense(HID, activation="relu", in_units=IN),
            jax_gluon.nn.Dense(OUT, in_units=HID))
    net.initialize(keep_zeros)   # every value is set below
    params = net._collect_params_with_prefix()
    for n, p in params.items():
        p.set_data(mx.nd.array(weights[n]))
    trainer = jax_gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    jax_amp.init_trainer(trainer)
    scaler = trainer._amp_loss_scaler
    loss_fn = jax_gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for s in range(STEPS):
        with jax_autograd.record():
            loss = loss_fn(net(mx.nd.array(x[s])), mx.nd.array(y[s]))
            with jax_amp.scale_loss(loss, trainer) as scaled:
                pass
        jax_autograd.backward(scaled)
        overflow = scaler.has_overflow(net.collect_params().values())
        scaler.update_scale(overflow)
        if not overflow:
            trainer.step(N)
        out.append((overflow, scaler.loss_scale,
                    {n: p.data().asnumpy() for n, p in params.items()}))
    return out


def _port_loop():
    x, y, weights = _data()
    net = HybridSequential()
    net.add(Dense(HID, activation="relu", in_units=IN, device="cpu"),
            Dense(OUT, in_units=HID, device="cpu"))
    params = collect_params(net)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(torch.from_numpy(weights[n]))
    trainer = Trainer(params, "sgd", {"learning_rate": 0.1,
                                      "momentum": 0.9})
    amp.init_trainer(trainer)
    scaler = trainer._amp_loss_scaler
    loss_fn = torch_loss.SoftmaxCrossEntropyLoss()
    out = []
    for s in range(STEPS):
        with autograd.record():
            loss = loss_fn(net(torch.from_numpy(x[s])),
                           torch.from_numpy(y[s]))
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        autograd.backward(scaled)
        overflow = scaler.has_overflow(params.values())
        scaler.update_scale(overflow)
        if not overflow:
            trainer.step(N)
        out.append((overflow, scaler.loss_scale,
                    {n: p.detach().numpy().copy()
                     for n, p in params.items()}))
    return out


def test_skip_loop_matches_jax():
    """The second step's input holds an inf: its gradients are NaN, the
    step is skipped and the scale halves; the third step's backward
    writes fresh gradients (the repaired deposit rule), so training
    resumes in both packages alike."""
    jax_run, port_run = _jax_loop(), _port_loop()
    assert [r[0] for r in jax_run] == [False, True, False, False]
    assert [r[:2] for r in port_run] == [r[:2] for r in jax_run]
    assert port_run[1][1] == 2 ** 15
    for (_, _, tw), (_, _, jw) in zip(port_run, jax_run):
        for n in jw:
            assert np.isfinite(tw[n]).all()
            np.testing.assert_allclose(tw[n], jw[n], rtol=RTOL, atol=ATOL)
    # the skipped step changed nothing
    for n in port_run[0][2]:
        assert np.array_equal(port_run[0][2][n], port_run[1][2][n])


def test_unscale_divides_by_the_loss_scale():
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), 6.0)
    trainer = Trainer([p], "sgd")
    amp.init_trainer(trainer)
    trainer._amp_loss_scaler.loss_scale = 4.0
    amp.unscale(trainer)
    assert torch.equal(p.grad, torch.full((3,), 1.5))


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_backward_deposits_as_jax_does(grad_req):
    """Two backward passes without a step: under "write" the gradient is
    the second pass's (the port summed both before the repair), under
    "add" their sum; ``u``, which only the first pass reaches, keeps its
    first gradient in both packages."""
    rng = np.random.RandomState(2)
    w0, u0 = rng.randn(5).astype("float32"), rng.randn(5).astype("float32")
    xs = [rng.randn(5).astype("float32") for _ in range(2)]
    jw, ju = mx.nd.array(w0), mx.nd.array(u0)
    jw.attach_grad(grad_req)
    ju.attach_grad()
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tu = torch.nn.Parameter(torch.from_numpy(u0.copy()))
    tw.grad_req = grad_req
    for k, x in enumerate(xs):
        with jax_autograd.record():
            jy = (jw * jw * mx.nd.array(x)).sum()
            if k == 0:
                jy = jy + (ju * 3.0).sum()
        jy.backward()
        with autograd.record():
            ty = (tw * tw * torch.from_numpy(x)).sum()
            if k == 0:
                ty = ty + (tu * 3.0).sum()
        autograd.backward(ty)
    want = 2 * w0 * xs[1] + (2 * w0 * xs[0] if grad_req == "add" else 0)
    np.testing.assert_allclose(jw.grad.asnumpy(), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.asnumpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tu.grad.numpy(), ju.grad.asnumpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tu.grad.numpy(), np.full(5, 3.0))
