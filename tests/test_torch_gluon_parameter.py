"""Gluon's parameters and deferred initialization in the port against the
JAX package's, on the CPU.

- ``collect_params()``: a ``ParameterDict`` keyed by the JAX package's
  prefixed names, in its order, for a ``HybridSequential`` under
  ``name_scope``, ResNet-18 v1 and MobileNet v2 1.0; ``select`` matched
  as there; ``_collect_params_with_prefix()`` gives the structural names;
  ``.params`` files cross both ways bit for bit;
- deferred initialization: ``data()`` before the first forward raises
  ``DeferredInitializationError`` with the JAX package's message (and a
  never-initialized parameter the JAX package's ``MXNetError``);
  ``initialize`` twice changes nothing and ``force_reinit`` redraws;
  ``cast`` before the shapes resolve (BatchNorm stays fp32);
  ``load_parameters`` into a deferred net resolves it; a Trainer and a
  fused step built before the first forward; resolution inside
  ``autograd.record()`` records nothing; ``export`` before the first
  forward raises as the JAX package's does;
- the Trainer honours ``grad_req="null"``, ``lr_mult`` and ``wd_mult``
  set through ``ParameterDict.setattr`` and on a ``Parameter``: one SGD
  update against the JAX package's, rtol 1e-4 / atol 1e-4 (fp32, as
  ``tests/test_torch_vision.py`` states);
- ``ParameterDict.get``/``get_constant``/``update``/``zero_grad``/
  ``reset_ctx``/``save``/``load``, ``Parameter.set_data``/``grad``/
  ``var``, ``register_child`` and ``summary``.

Weights are carried from one package to the other by structural name
(``convert.params_from_mxnet_tpu``'s naming) after each side resolved its
shapes; the JAX side's values are set from numpy, not drawn.
"""
import os
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import (DeferredInitializationError, Parameter,
                                   ParameterDict)
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

from test_torch_resnet_train import keep_zeros

RTOL, ATOL = 1e-4, 1e-4
CPU = mx.cpu()


def _mlp(pkg, prefix="net_"):
    """Dense(8, relu) -> BatchNorm -> Dense(3), no input sizes, under
    ``name_scope``."""
    nn = (jgluon if pkg is jmx else gluon).nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu"), nn.BatchNorm(),
                nn.Dense(3))
    return net


def _x(shape=(4, 5), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _seeded(params, seed=1):
    """Numpy values for ``{name: Parameter}`` (running variances > 0)."""
    rng = np.random.RandomState(seed)
    return {n: (np.abs(rng.randn(*p.shape)) + 0.5 if n.endswith("var")
                else rng.randn(*p.shape) * 0.3).astype("float32")
            for n, p in sorted(params.items())}


def _jax_resolved(net, x):
    """The JAX net initialized with zeros and resolved by one forward."""
    net.initialize(keep_zeros)
    net(jmx.nd.array(x))
    return net._collect_params_with_prefix()


def _pair(seed=1):
    """The MLP in both packages, resolved, carrying the same values."""
    x = _x()
    jnet = _mlp(jmx)
    jp = _jax_resolved(jnet, x)
    named = _seeded(jp, seed)
    for n, p in jp.items():
        p.set_data(jmx.nd.array(named[n]))
    tnet = _mlp(mx)
    tnet.initialize(ctx=CPU)
    tnet(torch.from_numpy(x))
    tnet.load_state_dict(params_from_mxnet_tpu(named, tnet))
    return jnet, tnet, x


@pytest.mark.parametrize("which", ["sequential", "resnet18_v1",
                                   "mobilenetv2_1.0"])
def test_collect_params_keys_equal_the_jax_packages(which):
    if which == "sequential":
        jnet, tnet = _mlp(jmx, None), _mlp(mx, None)
    else:
        jnet, tnet = jvision.get_model(which), tvision.get_model(which)
    # a top-level block's prefix counts the blocks of its kind made
    # before it in the process: the keys are compared under it
    hint = re.sub(r"\d+_$", "", jnet.prefix)
    assert re.sub(r"\d+_$", "", tnet.prefix) == hint
    jkeys = [k[len(jnet.prefix):] for k in jnet.collect_params()]
    got = tnet.collect_params()
    assert isinstance(got, ParameterDict)
    assert [k[len(tnet.prefix):] for k in got] == jkeys
    assert all(isinstance(p, Parameter) and p.name == n
               and n.startswith(tnet.prefix) for n, p in got.items())
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())


@pytest.mark.parametrize("select", [".*gamma|.*beta", ".*dense1_.*",
                                    ".*running_var"])
def test_select_matches_as_in_the_jax_package(select):
    assert list(_mlp(mx).collect_params(select)) == \
        list(_mlp(jmx).collect_params(select))


def test_params_files_cross_both_ways_bit_for_bit(tmp_path):
    jnet, tnet, x = _pair()
    tfile, jfile = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tnet.save_parameters(tfile)
    jnet.save_parameters(jfile)
    assert open(tfile, "rb").read() == open(jfile, "rb").read()
    jnet2 = _mlp(jmx)
    jnet2.load_parameters(tfile)
    tnet2 = _mlp(mx)
    tnet2.load_parameters(jfile, ctx=CPU)
    for n, p in jnet2._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(),
            tnet2._collect_params_with_prefix()[n].data().asnumpy())


def test_data_before_the_first_forward_raises_the_jax_message():
    jnet, tnet = _mlp(jmx), _mlp(mx)
    for net, err in ((jnet, jmx.base.MXNetError), (tnet, MXNetError)):
        with pytest.raises(err) as never:
            net.collect_params()["net_dense0_weight"].data()
        net.initialize(**({"ctx": CPU} if net is tnet else {}))
        with pytest.raises(err) as deferred:
            net.collect_params()["net_dense0_weight"].data()
        if net is jnet:
            want = (str(never.value), str(deferred.value))
            assert type(deferred.value).__name__ == \
                "DeferredInitializationError"
        else:
            assert isinstance(deferred.value, DeferredInitializationError)
            assert (str(never.value), str(deferred.value)) == want
    # the running statistics resolve with the gamma
    tnet(torch.from_numpy(_x()))
    assert tnet.collect_params()["net_batchnorm0_running_var"].shape == (8,)


def test_forward_without_initialize_raises_as_the_jax_package():
    with pytest.raises(MXNetError, match="has not been initialized. You "
                       "should initialize parameters with Block.initialize"):
        _mlp(mx)(torch.from_numpy(_x()))


def test_initialize_twice_keeps_values_and_force_reinit_redraws():
    tnet = _mlp(mx)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(torch.from_numpy(_x()))
    before = {n: p.data().asnumpy().copy()
              for n, p in tnet.collect_params().items()}
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    for n, p in tnet.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), before[n])
    tnet.initialize(mx.init.Xavier(), ctx=CPU, force_reinit=True)
    w = tnet.collect_params()["net_dense0_weight"].data().asnumpy()
    assert not np.array_equal(w, before["net_dense0_weight"])
    # own initializers win: the biases stay zeros, the gammas ones
    assert not tnet.collect_params()["net_dense0_bias"].data().asnumpy() \
        .any()
    assert (tnet.collect_params()["net_batchnorm0_gamma"].data().asnumpy()
            == 1).all()


def test_cast_before_resolution_keeps_batchnorm_fp32():
    jnet, tnet = _mlp(jmx), _mlp(mx)
    jnet.initialize(keep_zeros)
    tnet.initialize(ctx=CPU)
    jnet.cast("float16")
    tnet.cast("float16")
    jnet(jmx.nd.array(_x(), dtype="float16"))
    tnet(torch.from_numpy(_x()).half())
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert {n: str(p.data().dtype) for n, p in jp.items()} == \
        {n: str(p.data().dtype) for n, p in tp.items()}
    assert tp["net_dense0_weight"].tensor.dtype == torch.float16
    assert tp["net_batchnorm0_running_mean"].tensor.dtype == torch.float32


def test_load_parameters_into_a_deferred_net_resolves_it(tmp_path):
    jnet, _, x = _pair()
    f = str(tmp_path / "j.params")
    jnet.save_parameters(f)
    tnet = _mlp(mx)
    tnet.initialize(ctx=CPU)      # deferred: the file's shapes resolve it
    tnet.load_parameters(f)
    fresh = _mlp(mx)              # never initialized: made on ctx
    fresh.load_parameters(f, ctx=CPU)
    with autograd.predict_mode():
        want = jnet(jmx.nd.array(x)).asnumpy()
        for net in (tnet, fresh):
            assert net.collect_params()["net_dense0_weight"].shape == (8, 5)
            got = net(torch.from_numpy(x)).detach().numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _sgd_pair(mults=False):
    """One SGD step (momentum, wd) of the MLP in both packages, each
    Trainer made before the first forward; with ``mults``, the betas
    frozen by ``setattr('grad_req', 'null')``, ``lr_mult`` 2 on the first
    Dense weight and ``wd_mult`` 0 on the last."""
    x = _x()
    y = np.array([0, 2, 1, 2], "float32")
    out = []
    for pkg in (jmx, mx):
        with (CPU if pkg is mx else jmx.cpu()):
            out.append(_sgd_run(pkg, x, y, mults))
    return out


def _sgd_run(pkg, x, y, mults):
    glu = jgluon if pkg is jmx else gluon
    ag = jag if pkg is jmx else autograd
    net = _mlp(pkg)
    net.initialize(keep_zeros if pkg is jmx else None)
    params = net.collect_params()
    if mults:
        net.collect_params(".*beta").setattr("grad_req", "null")
        params["net_dense0_weight"].lr_mult = 2.0
        params["net_dense1_weight"].wd_mult = 0.0
    trainer = glu.Trainer(params, "sgd", {"learning_rate": 0.1,
                                          "momentum": 0.9, "wd": 0.01})
    with ag.pause():
        net(pkg.nd.array(x))        # resolves the shapes
    jp = net._collect_params_with_prefix()
    named = _seeded(jp, 3)
    for n, p in jp.items():
        p.set_data(pkg.nd.array(named[n]))
    loss_fn = glu.loss.SoftmaxCrossEntropyLoss()
    with ag.record():
        loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
    loss.backward()
    trainer.step(4)
    return {n: p.data().asnumpy() for n, p in jp.items()}


@pytest.mark.parametrize("mults", [False, True], ids=["plain", "mults"])
def test_trainer_made_before_resolution_steps_as_the_jax_package(mults):
    jw, tw = _sgd_pair(mults)
    assert list(jw) == list(tw)
    for n in jw:
        np.testing.assert_allclose(tw[n], jw[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_resolution_inside_record_records_nothing():
    net = _mlp(mx)
    net.initialize(ctx=CPU)
    x = nd.array(_x(), ctx=CPU)
    with autograd.record():
        loss = net(x).sum()
    w = net.collect_params()["net_dense0_weight"].tensor
    assert w.is_leaf and w.grad_fn is None
    loss.backward()
    assert w.grad is not None and w.grad.shape == (8, 5)


def test_fused_step_before_the_first_forward_matches_the_eager_step():
    """The fused step resolves deferred shapes at its first step, as the
    JAX package's does (one forward of the first sample, not recorded);
    from the same seed its step equals the eager loop's (CPU: the step
    function runs eagerly)."""
    x = torch.from_numpy(_x((4, 5), 2))
    y = torch.tensor([0., 2., 1., 2.])
    out = []
    for fused in (False, True):
        mx.random.seed(7)
        net = _mlp(mx)
        net.initialize(mx.init.Xavier(), ctx=CPU)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        if fused:
            step = trainer.fuse_step(net, loss_fn)
            step.step(x, y)
        else:
            with autograd.pause():
                net(x[:1])           # the fused step's resolving forward
            with autograd.record():
                loss = loss_fn(net(x), y)
            autograd.backward(loss)
            trainer.step(4)
        out.append({n: p.data().asnumpy()
                    for n, p in net.collect_params().items()})
    for n in out[0]:
        np.testing.assert_array_equal(out[1][n], out[0][n], err_msg=n)


def test_export_before_the_first_forward_raises_and_after_it_works(tmp_path):
    net = _mlp(mx)
    net.initialize(ctx=CPU)
    net.hybridize()                   # before the first forward too
    with pytest.raises(MXNetError, match="run one forward pass"):
        net.export(str(tmp_path / "m"))
    net(torch.from_numpy(_x()))
    net.export(str(tmp_path / "m"))
    assert os.path.exists(str(tmp_path / "m-0000.params"))


def test_parameter_dict_api():
    pd = ParameterDict("blk_")
    w = pd.get("w", shape=(2, 0), init="ones", allow_deferred_init=True)
    assert pd.get("w") is w and w.name == "blk_w"
    pd.get("w", shape=(2, 3))               # fills the unknown dimension
    assert w.shape == (2, 3)
    c = pd.get_constant("c", np.arange(3, dtype="float32"))
    assert c.grad_req == "null"
    with pytest.raises(KeyError):
        pd.get_constant("missing")
    pd.initialize(ctx=CPU)
    np.testing.assert_array_equal(w.data().asnumpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(c.data().asnumpy(), np.arange(3))
    other = ParameterDict()
    other.update({"blk_w": Parameter("blk_w", shape=(1,))})
    with pytest.raises(ValueError, match="same name"):
        pd.update(other)
    w.grad()[:] = 5.0
    pd.zero_grad()
    assert not w.grad().asnumpy().any()
    pd.setattr("lr_mult", 0.5)
    assert w.lr_mult == 0.5 and w.tensor.lr_mult == 0.5
    pd.reset_ctx(CPU)
    assert w.list_ctx() == [CPU]
    assert w.var().name == "blk_w"
    w.set_data(nd.array(np.full((2, 3), 2.0), ctx=CPU))
    assert (w.data().asnumpy() == 2).all()


def test_parameter_dict_save_and_load_as_the_jax_package(tmp_path):
    jp = jgluon.ParameterDict("blk_")
    jp.get("w", shape=(2, 3)).initialize(init=jmx.init.One())
    f = str(tmp_path / "pd.params")
    jp.save(f, strip_prefix="blk_")
    tp = ParameterDict("blk_")
    tp.get("w", shape=(2, 3))
    tp.load(f, ctx=CPU, restore_prefix="blk_")
    np.testing.assert_array_equal(tp["blk_w"].data().asnumpy(),
                                  np.ones((2, 3)))
    f2 = str(tmp_path / "pd2.params")
    tp.save(f2, strip_prefix="blk_")
    assert open(f, "rb").read() == open(f2, "rb").read()


def test_register_child_and_summary(capsys):
    net = gluon.nn.HybridSequential(prefix="top_")
    extra = gluon.nn.Dense(2, in_units=3, device="cpu", prefix="extra_")
    net.register_child(extra)
    net.register_child(gluon.nn.Dense(4), "named")
    assert list(dict(net.named_children())) == ["0", "named"]
    net.initialize(ctx=CPU)
    net.summary(torch.zeros(1, 3))
    out = capsys.readouterr().out
    assert "extra" in out and "Parameters in total: 20" in out
