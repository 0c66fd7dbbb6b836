"""The port's Module API against the JAX package's on the CPU:

- ``train_mnist.py``'s LeNet and MLP, from the same parameters
  (``set_params`` on both sides, numpy-seeded), trained with SGD and
  momentum for 3 batches (``forward_backward``/``update``/
  ``update_metric``): the parameters after each batch, the metric, then
  ``score`` and ``predict``, agree within rtol 1e-4 / atol 1e-5 (the
  convolutions and products sum in different orders);
- ``fit`` with ``Speedometer`` and ``do_checkpoint`` runs its epochs;
- checkpoints (the symbol's JSON and ``.params``) written by either
  package load in the other (``Module.load``), and
  ``save_optimizer_states``/``load_optimizer_states`` (the port's own
  file) resume momentum;
- ``BucketingModule`` over two buckets trains as the JAX package's does,
  and a ``SequentialModule`` of two modules as one JAX Module over the
  chained graph (the JAX package's own cannot bind);
- ``reshape`` keeps the trained parameters, ``get_input_grads`` and the
  several-context path with ``kvstore=None`` behave as the JAX
  package's, and a kvstore that would be needed raises naming its item.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import sym as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym

import test_torch_symbol as graphs

RTOL, ATOL = 1e-4, 1e-5
CPU = mx.cpu()
BATCH = 8
N_BATCHES = 3
OPT = {"learning_rate": 0.05, "momentum": 0.9}  # train_mnist.py's


def _data(shape, n, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, *shape[1:]).astype("float32")
    y = rs.randint(0, 10, n).astype("float32")
    return x, y


def _init_params(net, data_shape, seed):
    """Numpy-seeded parameters N(0, 0.1^2) for every argument of ``net``
    but the data and the label, zero aux states, in the shapes of the
    port's symbolic inference (no module bound and nothing drawn to learn
    them; the JAX package's inference gives the same shapes)."""
    label = (data_shape[0],)
    arg_shapes, _, aux_shapes = net.infer_shape(data=data_shape,
                                                softmax_label=label)
    shapes = {n: s for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    rs = np.random.RandomState(seed)
    return ({n: (rs.randn(*s) * 0.1).astype("float32")
             for n, s in sorted(shapes.items())},
            {n: np.zeros(s, "float32")
             for n, s in zip(net.list_auxiliary_states(), aux_shapes)})


def _nd(pkg, v):
    return jmx.nd.array(v) if pkg is jmx else mx.nd.array(v, ctx=CPU)


def _module(pkg, net, it, args, auxs):
    kw = {} if pkg is jmx else {"context": CPU}
    m = pkg.mod.Module(net, **kw)
    m.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    m.set_params({n: _nd(pkg, v) for n, v in args.items()},
                 {n: _nd(pkg, v) for n, v in auxs.items()})
    m.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    return m


def _train(pkg, net, x, y, args, auxs):
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    m = _module(pkg, net, it, args, auxs)
    metric = pkg.metric.Accuracy()
    history = []
    for batch in it:
        m.forward_backward(batch)
        m.update()
        m.update_metric(metric, batch.label)
        history.append({n: np.asarray(a.asnumpy())
                        for n, a in m.get_params()[0].items()})
    it.reset()
    score = m.score(it, "acc")
    pred = np.asarray(m.predict(it).asnumpy())
    return history, metric.get(), score, pred


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port runs on the calling thread alone: now and then, in the
    first forward of a process that has the JAX package loaded, one of
    torch's intra-op worker threads computed its share of LeNet's first
    ``tanh`` some 2**-14 off (one eighth of the elements, the rest
    exact), which put ``predict`` up to 4x past RTOL/ATOL. The count is
    put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["lenet", "mlp"])
def trained(request):
    make = graphs.GRAPHS[request.param]
    (jnet, shapes), (tnet, _) = graphs._build(jmx, make), \
        graphs._build(mx, make)
    x, y = _data(shapes["data"], BATCH * N_BATCHES, 0)
    args, auxs = _init_params(tnet, (BATCH,) + shapes["data"][1:], 1)
    want = _train(jmx, jnet, x, y, args, auxs)
    with mx.cpu():
        got = _train(mx, tnet, x, y, args, auxs)
    return got, want


@pytest.mark.parametrize("step", range(N_BATCHES))
def test_parameters_after_each_batch_match(trained, step):
    (got, *_), (want, *_) = trained
    assert sorted(got[step]) == sorted(want[step])
    for n in want[step]:
        np.testing.assert_allclose(got[step][n], want[step][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_metric_score_and_predict_match(trained):
    (_, metric, score, pred), (_, jmetric, jscore, jpred) = trained
    assert metric == jmetric
    assert score == jscore
    np.testing.assert_allclose(pred, jpred, rtol=RTOL, atol=ATOL)


def _small_net(S):
    net = S.FullyConnected(S.var("data"), num_hidden=3, name="fc")
    return S.SoftmaxOutput(net, name="softmax")


def _small_data(seed=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(16, 4).astype("float32")
    return x, np.argmax(x[:, :3], axis=1).astype("float32")


def test_fit_runs_with_speedometer_and_checkpoints(tmp_path, caplog):
    x, y = _small_data()
    prefix = str(tmp_path / "fit")
    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=4)
        m = mx.mod.Module(_small_net(sym), context=CPU)
        with caplog.at_level(logging.INFO):
            m.fit(it, num_epoch=3, optimizer_params=dict(OPT),
                  initializer=mx.init.Xavier(),
                  batch_end_callback=mx.callback.Speedometer(4, 2),
                  epoch_end_callback=mx.callback.do_checkpoint(prefix))
        acc = m.score(it, "acc")[0][1]
    assert acc > 0.6
    assert any("samples/sec" in r.getMessage() for r in caplog.records)
    assert (tmp_path / "fit-0003.params").exists()
    assert (tmp_path / "fit-symbol.json").exists()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_both_ways(tmp_path, writer):
    x, y = _small_data()
    rs = np.random.RandomState(4)
    args = {"fc_weight": rs.randn(3, 4).astype("float32"),
            "fc_bias": rs.randn(3).astype("float32")}
    prefix = str(tmp_path / "ck")
    wpkg, rpkg = (jmx, mx) if writer == "jax" else (mx, jmx)
    with mx.cpu():
        S = jsym if wpkg is jmx else sym
        it = wpkg.io.NDArrayIter(x, y, batch_size=4)
        m = _module(wpkg, _small_net(S), it, args, {})
        m.save_checkpoint(prefix, 2)
        want = np.asarray(m.predict(it).asnumpy())
        kw = {} if rpkg is jmx else {"context": CPU}
        r = rpkg.mod.Module.load(prefix, 2, **kw)
        rit = rpkg.io.NDArrayIter(x, y, batch_size=4)
        r.bind(data_shapes=rit.provide_data, label_shapes=rit.provide_label,
               for_training=False)
        got = np.asarray(r.predict(rit).asnumpy())
        for n, v in args.items():
            np.testing.assert_array_equal(
                np.asarray(r.get_params()[0][n].asnumpy()), v)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_optimizer_states_resume_momentum(tmp_path):
    x, y = _small_data()
    args = {"fc_weight": np.full((3, 4), 0.1, "float32"),
            "fc_bias": np.zeros(3, "float32")}
    prefix = str(tmp_path / "st")

    def step(m, it):
        it.reset()
        m.forward_backward(next(it))
        m.update()

    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=16)
        a = _module(mx, _small_net(sym), it, args, {})
        step(a, it)
        a.save_checkpoint(prefix, 1, save_optimizer_states=True)
        step(a, it)
        b = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=CPU)
        b.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        b.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
        step(b, it)
        np.testing.assert_allclose(b.get_params()[0]["fc_weight"].asnumpy(),
                                   a.get_params()[0]["fc_weight"].asnumpy(),
                                   rtol=1e-6, atol=1e-7)


def _bucket_gen(S):
    def sym_gen(seq_len):
        pooled = S.sum(S.var("data"), axis=1, keepdims=True)
        fc = S.FullyConnected(pooled, num_hidden=4, name="fc")
        return S.SoftmaxOutput(fc, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def _run_buckets(pkg):
    S = jsym if pkg is jmx else sym
    kw = {} if pkg is jmx else {"context": CPU}
    m = pkg.mod.BucketingModule(_bucket_gen(S), default_bucket_key=10, **kw)
    m.bind(data_shapes=[("data", (2, 10))],
           label_shapes=[("softmax_label", (2,))])
    m.set_params({"fc_weight": _nd(pkg, np.full((4, 1), 0.1, "float32")),
                  "fc_bias": _nd(pkg, np.zeros(4, "float32"))}, {})
    m.init_optimizer(optimizer_params=dict(OPT))
    rs = np.random.RandomState(6)
    outs = []
    for key in (10, 5, 10, 5):
        batch = pkg.io.DataBatch(
            data=[_nd(pkg, rs.rand(2, key).astype("float32"))],
            label=[_nd(pkg, np.array([1, 3], "float32"))], bucket_key=key,
            provide_data=[("data", (2, key))],
            provide_label=[("softmax_label", (2,))])
        m.forward(batch)
        m.backward()
        m.update()
        outs.append(np.asarray(m.get_outputs()[0].asnumpy()))
    return outs, np.asarray(m.get_params()[0]["fc_weight"].asnumpy())


def test_bucketing_module_matches():
    want = _run_buckets(jmx)
    with mx.cpu():
        got = _run_buckets(mx)
    for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def _seq_params(pkg):
    rs = np.random.RandomState(8)
    return {"fc1_weight": _nd(pkg, rs.randn(5, 4).astype("float32")),
            "fc1_bias": _nd(pkg, np.zeros(5, "float32")),
            "fc2_weight": _nd(pkg, rs.randn(3, 5).astype("float32")),
            "fc2_bias": _nd(pkg, np.zeros(3, "float32"))}


def _fc1(S, data):
    return S.Activation(S.FullyConnected(data, num_hidden=5, name="fc1"),
                        act_type="relu")


def _fc2(S, data):
    return S.SoftmaxOutput(S.FullyConnected(data, num_hidden=3, name="fc2"),
                           name="softmax")


def _params_of(m):
    return {n: np.asarray(a.asnumpy()) for n, a in m.get_params()[0].items()}


def test_sequential_module_matches_the_jax_module_of_the_chain():
    """Two modules chained (the second takes the labels, auto-wired) train
    as one JAX Module over the composed graph does. The JAX package's own
    SequentialModule cannot bind: its Module.output_shapes reads the last
    forward's outputs, which do not exist yet (ROADMAP, "Faults of the JAX
    package"); the port infers them."""
    x, y = _small_data()
    jit = jmx.io.NDArrayIter(x, y, batch_size=8)
    whole = jmx.mod.Module(_fc2(jsym, _fc1(jsym, jsym.var("data"))))
    whole.bind(data_shapes=jit.provide_data, label_shapes=jit.provide_label)
    whole.set_params(_seq_params(jmx), {})
    whole.init_optimizer(optimizer_params=dict(OPT))
    for batch in jit:
        whole.forward_backward(batch)
        whole.update()
    want = _params_of(whole)
    with mx.cpu():
        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(_fc1(sym, sym.var("data")), label_names=None,
                              context=CPU))
        seq.add(mx.mod.Module(_fc2(sym, sym.var("hidden")),
                              data_names=("hidden",), context=CPU),
                take_labels=True, auto_wiring=True)
        it = mx.io.NDArrayIter(x, y, batch_size=8)
        seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        assert seq.output_shapes == [("softmax_output", (8, 3))]
        seq.set_params(_seq_params(mx), {})
        seq.init_optimizer(optimizer_params=dict(OPT))
        for batch in it:
            seq.forward(batch)
            seq.backward()
            seq.update()
        got = _params_of(seq)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-6)


def test_reshape_preserves_trained_params():
    x, y = _small_data(5)
    with mx.cpu():
        it = mx.io.NDArrayIter(x[:8], y[:8], batch_size=8)
        m = mx.mod.Module(_small_net(sym), context=CPU)
        m.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        m.init_params(mx.init.Constant(0.1))
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.5})
        m.forward(next(it))
        m.backward()
        m.update()
        trained = m.get_params()[0]["fc_weight"].asnumpy()
        assert not np.allclose(trained, 0.1)
        m.reshape(data_shapes=[("data", (4, 4))],
                  label_shapes=[("softmax_label", (4,))])
        np.testing.assert_array_equal(
            m.get_params()[0]["fc_weight"].asnumpy(), trained)
        np.testing.assert_array_equal(
            m._exec_group.execs[0].arg_dict["fc_weight"].asnumpy(), trained)
        assert m._exec_group.execs[0].arg_dict["data"].shape == (4, 4)


def test_input_grads_and_several_contexts_match_the_jax_package():
    """Two contexts (both the CPU) and kvstore=None: each executor takes
    half the batch and updates its own copy, get_params averages them."""
    x, y = _small_data()
    args = {"fc_weight": np.full((3, 4), 0.2, "float32"),
            "fc_bias": np.zeros(3, "float32")}
    res = {}
    for pkg in (jmx, mx):
        S = jsym if pkg is jmx else sym
        ctxs = [jmx.cpu(), jmx.cpu()] if pkg is jmx else [CPU, CPU]
        with mx.cpu():
            it = pkg.io.NDArrayIter(x, y, batch_size=8)
            m = pkg.mod.Module(_small_net(S), context=ctxs)
            m.bind(data_shapes=it.provide_data,
                   label_shapes=it.provide_label, inputs_need_grad=True)
            m.set_params({n: _nd(pkg, v) for n, v in args.items()}, {})
            m.init_optimizer(kvstore=None, optimizer_params=dict(OPT))
            batch = next(it)
            m.forward_backward(batch)
            g = np.asarray(m.get_input_grads()[0].asnumpy())
            m.update()
            res[pkg] = (g, np.asarray(
                m.get_params()[0]["fc_weight"].asnumpy()))
    for a, b in zip(res[mx], res[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_kvstore_that_would_be_needed_raises_naming_its_item():
    with mx.cpu():
        it = mx.io.NDArrayIter(*_small_data(), batch_size=8)
        m = mx.mod.Module(_small_net(sym), context=[CPU, CPU])
        m.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        m.init_params()
        with pytest.raises(NotImplementedError, match="Queue A item 6"):
            m.init_optimizer(kvstore="local")
        with pytest.raises(NotImplementedError, match="Queue A item 6"):
            mx.model._create_kvstore("dist_sync", 1, {})


def test_feedforward_fits_predicts_saves_and_loads(tmp_path):
    """The pre-Module API over the port's Module: ``create`` fits,
    ``predict`` returns numpy, ``save``/``load`` round-trip the weights."""
    x, y = _small_data()
    with mx.cpu():
        model = mx.model.FeedForward.create(
            _small_net(sym), x, y, ctx=CPU, num_epoch=4,
            numpy_batch_size=8, learning_rate=0.5,
            initializer=mx.init.Xavier())
        pred = model.predict(x)
        assert pred.shape == (16, 3)
        acc = model.score(mx.io.NDArrayIter(x, y, batch_size=8))
        model.save(str(tmp_path / "ff"), 4)
        back = mx.model.FeedForward.load(str(tmp_path / "ff"), 4, ctx=CPU,
                                         numpy_batch_size=8)
        np.testing.assert_allclose(back.predict(x), pred, rtol=1e-6)
    assert acc > 0.5


def test_executor_manager_runs_a_batch_as_its_group():
    x, y = _small_data()
    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=8)
        net = _small_net(sym)
        mgr = mx.executor_manager.DataParallelExecutorManager(
            net, [CPU], it)
        rs = np.random.RandomState(2)
        args = {"fc_weight": mx.nd.array(rs.randn(3, 4), ctx=CPU),
                "fc_bias": mx.nd.zeros((3,), ctx=CPU)}
        mgr.set_params(args, {})
        batch = next(it)
        mgr.load_data_batch(batch)
        mgr.forward(is_train=True)
        mgr.backward()
        metric = mx.metric.Accuracy()
        mgr.update_metric(metric, batch.label)
        ex = net.simple_bind(CPU, data=(8, 4), softmax_label=(8,))
        ex.copy_params_from(args)
        ex.forward_backward(data=batch.data[0], softmax_label=batch.label[0])
    np.testing.assert_allclose(mgr.grad_arrays[0][0].asnumpy(),
                               ex.grad_dict["fc_weight"].asnumpy(),
                               rtol=1e-6)
    assert mx.executor_manager._split_input_slice(10, [1, 1]) == \
        [slice(0, 5), slice(5, 10)]
    assert metric.num_inst == 8


def test_callbacks_log_and_checkpoint(tmp_path, caplog):
    x, y = _small_data()
    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=4)
        m = mx.mod.Module(_small_net(sym), context=CPU)
        cb = mx.callback.module_checkpoint(m, str(tmp_path / "mc"), 2,
                                           save_optimizer_states=True)
        with caplog.at_level(logging.INFO):
            m.fit(it, num_epoch=2, optimizer_params=dict(OPT),
                  batch_end_callback=[mx.callback.log_train_metric(2),
                                      mx.callback.ProgressBar(4)],
                  epoch_end_callback=cb)
    assert (tmp_path / "mc-0002.params").exists()
    assert (tmp_path / "mc-0002.states").exists()
    msgs = [r.getMessage() for r in caplog.records]
    assert any("Train-accuracy" in msg for msg in msgs)
    assert any(msg.startswith("[") and "%" in msg for msg in msgs)
