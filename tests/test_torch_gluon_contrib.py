"""The port's ``gluon.contrib`` against the JAX package's, on the CPU: the
cases of ``tests/test_gluon_contrib.py``, each also held against the JAX
package on the same numpy-seeded inputs and weights (fp32, rtol 1e-5 /
atol 1e-6, or 1e-4 / 1e-5 where the layer sums: the convolutions, the
Dense branches, BatchNorm and the Estimator's training).

The contributed recurrent cells' cases are
``tests/test_torch_gluon_contrib_rnn.py``'s. The last case of
``tests/test_gluon_contrib.py``, the Inception v3 and MobileNet v2 zoo
variants, is ``tests/test_torch_model_zoo.py``'s.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.convert import params_from_mxnet_tpu

EXACT = dict(rtol=1e-5, atol=1e-6)
SUMS = dict(rtol=1e-4, atol=1e-5)
CPU = mx.cpu()


def _carry(jblock, tblock):
    named = {k: v.data().asnumpy()
             for k, v in jblock._collect_params_with_prefix().items()}
    tblock.load_state_dict(params_from_mxnet_tpu(named, tblock))


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype("float32")


def _both(build, x, train=False, forward=None):
    """``build(gluon)`` in both packages, the port's resolved on a first
    forward and given the JAX package's weights; the outputs of
    ``forward(block, input)`` (the block's call by default)."""
    forward = forward or (lambda b, a: b(a))
    jb, tb = build(jgluon), build(gluon)
    jb.initialize()
    with jag.record(train_mode=train):
        jout = forward(jb, jnd.array(x))
    with CPU:
        tb.initialize(ctx=CPU)
        with autograd.pause():
            forward(tb, nd.array(x))
        _carry(jb, tb)
        with autograd.record(train_mode=train):
            tout = forward(tb, nd.array(x))
    return jb, tb, jout, tout


def _close(t, j, tol=EXACT):
    t = [t] if not isinstance(t, (list, tuple)) else t
    j = [j] if not isinstance(j, (list, tuple)) else j
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **tol)


def test_hybrid_concurrent_concats_branches():
    def build(g):
        c = g.contrib.nn.HybridConcurrent(axis=1)
        c.add(g.nn.Dense(4, flatten=False), g.contrib.nn.Identity(),
              g.nn.Dense(3, flatten=False))
        return c
    x = _rand(2, 5)
    _, _, jout, tout = _both(build, x)
    assert tout.shape == (2, 4 + 5 + 3)
    assert np.array_equal(tout.asnumpy()[:, 4:9], x)
    _close(tout, jout, SUMS)


def test_concurrent_block_variant():
    def build(g):
        c = g.contrib.nn.Concurrent(axis=-1)
        c.add(g.contrib.nn.Identity(), g.nn.Dense(3))
        return c
    _, _, jout, tout = _both(build, _rand(2, 3))
    assert tout.shape == (2, 6)
    _close(tout, jout, SUMS)


def test_pixel_shuffle_2d_matches_numpy():
    f1, f2 = 2, 3
    x = np.arange(1 * 2 * f1 * f2 * 4 * 5, dtype="float32").reshape(
        (1, 2 * f1 * f2, 4, 5))
    want = x.reshape((1, 2, f1, f2, 4, 5)).transpose(
        (0, 1, 4, 2, 5, 3)).reshape((1, 2, 4 * f1, 5 * f2))
    with CPU:
        got = gluon.contrib.nn.PixelShuffle2D((f1, f2))(nd.array(x))
    assert np.array_equal(got.asnumpy(), want)
    jgot = jgluon.contrib.nn.PixelShuffle2D((f1, f2))(jnd.array(x))
    assert np.array_equal(got.asnumpy(), jgot.asnumpy())


@pytest.mark.parametrize("cls,factor,shape,out", [
    ("PixelShuffle1D", 3, (2, 6, 8), (2, 2, 24)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 4), (1, 2, 4, 6, 8))])
def test_pixel_shuffle_1d_3d_shapes(cls, factor, shape, out):
    x = _rand(*shape)
    with CPU:
        got = getattr(gluon.contrib.nn, cls)(factor)(nd.array(x))
    assert got.shape == out
    jgot = getattr(jgluon.contrib.nn, cls)(factor)(jnd.array(x))
    assert np.array_equal(got.asnumpy(), jgot.asnumpy())


def test_sparse_embedding_grad_flows():
    tok = np.array([[1, 2], [3, 1]])

    def run(g, ns, ag, init):
        emb = g.contrib.nn.SparseEmbedding(10, 4)
        init(emb)
        with ag.record():
            out = emb(ns.array(tok, dtype="int32"))
            loss = (out * ns.array(_rand(2, 2, 4, seed=1))).sum()
        loss.backward()
        return emb, out
    jemb, jout = run(jgluon, jnd, jag, lambda e: e.initialize())
    with CPU:
        temb, tout = run(gluon, nd, autograd, lambda e: (
            e.initialize(ctx=CPU),
            e.weight.set_data(jemb.weight.data().asnumpy())))
    g = temb.weight.grad()
    assert g.stype == "row_sparse"
    assert sorted(g.indices.asnumpy().tolist()) == [1, 2, 3]
    gd = g.asnumpy()
    assert tout.shape == (2, 2, 4)
    assert np.abs(gd[1]).sum() > 0 and np.abs(gd[9]).sum() == 0
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **EXACT)
    np.testing.assert_allclose(gd, jemb.weight.grad().asnumpy(), **EXACT)
    # the Trainer's lazy SGD touches only the gradient's rows
    with CPU:
        before = temb.weight.data().asnumpy()
        gluon.Trainer(temb.collect_params(), "sgd",
                      {"learning_rate": 0.5, "wd": 0.1}).step(1)
        moved = np.abs(temb.weight.data().asnumpy() - before).sum(1) > 0
    assert moved.tolist() == [False, True, True, True] + [False] * 6


def test_sync_batch_norm_forward():
    x = _rand(4, 3, 5, 5)
    jb, tb, jout, tout = _both(
        lambda g: g.contrib.nn.SyncBatchNorm(in_channels=3, num_devices=2),
        x, train=True)
    got = tout.asnumpy()
    assert got.shape == x.shape and abs(got.mean()) < 1e-2
    _close(tout, jout, SUMS)
    # one more update of the statistics the JAX layer's forward left
    np.testing.assert_allclose(
        tb.running_mean.detach().numpy(),
        jb.running_mean.data().asnumpy() * 0.9
        + x.mean(axis=(0, 2, 3)) * 0.1, **SUMS)


def test_deformable_convolution_zero_offsets_match_plain_conv():
    x = _rand(2, 4, 7, 7)
    with CPU:
        layer = gluon.contrib.cnn.DeformableConvolution(
            5, kernel_size=3, padding=1)
        layer.initialize(ctx=CPU)
        out = layer(nd.array(x))
        ref = nd.Convolution(nd.array(x), layer.weight, layer.bias,
                             kernel=(3, 3), pad=(1, 1), stride=(1, 1),
                             num_filter=5)
    assert out.shape == (2, 5, 7, 7)
    assert layer.param("weight").shape == (5, 4, 3, 3)
    np.testing.assert_allclose(out.asnumpy(), ref.asnumpy(), atol=1e-4)


def test_deformable_convolution_op_matches_jax():
    """Offsets up to a few pixels (reads past the edges included), with
    stride, dilation, groups and deformable groups, through the op in both
    packages (the JAX side one compiled program), and the gradients of
    the data, offsets, weight and bias."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.extra_ops import deformable_convolution as jdc
    rs = np.random.RandomState(3)
    N, C, Hh, W, F, k, stride, dilate, groups, dg = 2, 4, 7, 6, 6, 3, 2, \
        2, 2, 2
    Ho = (Hh + 2 - dilate * (k - 1) - 1) // stride + 1
    Wo = (W + 2 - dilate * (k - 1) - 1) // stride + 1
    args = [rs.randn(N, C, Hh, W), rs.randn(N, 2 * dg * k * k, Ho, Wo) * 1.5,
            rs.randn(F, C // groups, k, k), rs.randn(F)]
    args = [a.astype("float32") for a in args]
    kw = dict(kernel=(k, k), stride=(stride, stride),
              dilate=(dilate, dilate), pad=(1, 1), num_filter=F,
              num_group=groups, num_deformable_group=dg)

    def jloss(*a):
        out = jdc(*a, **kw)
        return jnp.sum(out * out), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(*map(jnp.asarray, args))
    with CPU:
        targs = [nd.array(a) for a in args]
        for a in targs:
            a.attach_grad()
        with autograd.record():
            tout = nd.contrib.DeformableConvolution(*targs, **kw)
            (tout * tout).sum().backward()
    np.testing.assert_allclose(tout.asnumpy(), np.asarray(jout), **SUMS)
    for t, j in zip(targs, jgrads):
        g, h = t.grad.asnumpy(), np.asarray(j)
        assert np.linalg.norm(g - h) <= 1e-4 * np.linalg.norm(h)


def test_interval_sampler():
    from mxnet_tpu.gluon.contrib.data import IntervalSampler as J
    T_ = gluon.contrib.data.IntervalSampler
    assert list(T_(10, 3)) == [0, 3, 6, 9, 1, 4, 7, 2, 5, 8]
    assert list(T_(10, 3, rollover=False)) == [0, 3, 6, 9]
    assert len(T_(10, 3)) == 10
    assert len(T_(10, 3, rollover=False)) == 4
    for args in ((10, 3), (7, 7), (9, 2, False)):
        assert list(T_(*args)) == list(J(*args))
        assert len(T_(*args)) == len(J(*args))


def _toy_data(ns, n=64):
    rs = np.random.RandomState(0)
    x = rs.rand(n, 8).astype("float32")
    y = (x.sum(axis=1) > 4).astype("float32")
    return ns.array(x), ns.array(y)


def _net(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(16, activation="relu", in_units=8),
            g.nn.Dense(2, in_units=16))
    return net


def _fit(g, ns, metric_ns, tmp, net):
    """3 epochs with a CheckpointHandler, then early stopping on a
    metric that never improves; returns the accuracy and the stopper."""
    est_mod = g.contrib.estimator
    loader = g.data.DataLoader(g.data.ArrayDataset(*_toy_data(ns)),
                               batch_size=16)
    acc = metric_ns.Accuracy()
    est = est_mod.Estimator(net, g.loss.SoftmaxCrossEntropyLoss(),
                            train_metrics=[acc])
    ckpt = est_mod.CheckpointHandler(str(tmp), monitor=est.loss_metric,
                                     epoch_period=1)
    est.fit(loader, epochs=3, event_handlers=[ckpt])
    stopper = est_mod.EarlyStoppingHandler(monitor=est.loss_metric,
                                           mode="max", patience=1)
    est2 = est_mod.Estimator(net, g.loss.SoftmaxCrossEntropyLoss(),
                             train_metrics=[metric_ns.Accuracy()])
    est2.fit(loader, epochs=50, event_handlers=[stopper])
    return acc, stopper


def test_estimator_fit_and_early_stopping(tmp_path):
    jnet = _net(jgluon)
    jnet.initialize()
    init = {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}
    jacc, jstop = _fit(jgluon, jnd, jmx.metric, tmp_path / "jax", jnet)
    with CPU:
        tnet = _net(gluon)
        tnet.initialize(ctx=CPU)
        tnet.load_state_dict(params_from_mxnet_tpu(init, tnet))
        tacc, tstop = _fit(gluon, nd, mx.metric, tmp_path / "port", tnet)
    assert tacc.get()[1] > 0.5
    saved = sorted(os.listdir(tmp_path / "port"))
    assert saved == sorted(os.listdir(tmp_path / "jax"))
    assert "model-epoch3.params" in saved
    assert tstop.stopped_epoch is not None and tstop.stopped_epoch < 50
    assert tstop.stopped_epoch == jstop.stopped_epoch
    assert tacc.get()[1] == pytest.approx(jacc.get()[1], abs=1e-6)
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jp[name].data().asnumpy(), **SUMS)
