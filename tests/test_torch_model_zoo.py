"""The port's vision zoo against the JAX package's, on the CPU.

- ``get_model`` builds every name of the JAX package's zoo, without a
  device or input sizes, with the JAX package's ``collect_params()`` keys
  (its prefixed names) in its order;
- ``densenet121`` and ``inceptionv3`` at full width and their published
  input, resolved by one forward: densenet121's shapes equal the JAX
  package's symbolic inference (Inception v3's are given to the JAX side
  from the port's, as the JAX package's symbolic trace does not run
  through its ``HybridConcurrent``), and from the same numpy-seeded
  weights the predict-mode logits at batch 1 equal the JAX package's
  (rtol 1e-4 / atol 1e-4; fp32, as ``tests/test_torch_vision.py``
  states). The JAX side runs the forward as one compiled program
  (``functional_call`` under ``jax.jit``), so that it stays cheap;
- Inception v3's member cut in depth: its logits and one SGD update in
  fp64 (``family_step_matches``; ``test_torch_model_zoo_train.py`` holds
  the other families' and says how, and why in fp64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ndarray.ndarray import _wrap as jax_wrap

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

RTOL, ATOL = 1e-4, 1e-4
RTOL64, ATOL64 = 1e-9, 1e-9    # the fp64 training steps
CPU = mx.cpu()
CLASSES = 10
B, LR, WD = 4, 0.1, 1e-4
# the two families whose smallest variant's update is held on a member
# cut in depth (test_torch_model_zoo_train.py), at their published input
FULL = {"densenet121": 224, "inceptionv3": 299}


def zoo_weights(shapes, seed):
    """Numpy values in the JAX naming that keep activations near unit
    scale: He-normal convolution weights, 1/sqrt(fan in) Dense weights,
    small biases and betas, gammas around 1, running statistics around
    0 and 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            w = rng.randn(*shape) * np.sqrt((2.0 if len(shape) > 2 else 1.0)
                                            / fan_in)
        elif name.endswith("gamma"):
            w = 1 + 0.1 * rng.randn(*shape)
        elif name.endswith("running_var"):
            w = 1 + 0.2 * rng.rand(*shape)
        else:
            w = 0.05 * rng.randn(*shape)
        out[name] = w.astype("float32")
    return out


def port_resolved(make, size):
    """A port model built by ``make()`` and resolved by one forward."""
    with CPU:
        net = make()
        net.initialize()
        with autograd.pause():
            net(torch.zeros(1, 3, size, size))
    return net


def jax_with(make, named):
    """A JAX model built by ``make()`` whose parameters hold ``named``
    (structural names), set as its deferred initialization would leave
    them but without a zeros program per shape: this side only runs
    through ``functional_call``, which reads each parameter's data."""
    net = make()
    for n, p in net._collect_params_with_prefix().items():
        p.shape = named[n].shape
        p._data = jmx.nd.array(named[n], dtype=named[n].dtype.name)
    return net


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_get_model_builds_every_name_with_the_jax_keys(name):
    # under the model's own prefix, which counts the models made before
    got, want = tvision.get_model(name), jvision.get_model(name)
    assert [k[len(got.prefix):] for k in got.collect_params()] == \
        [k[len(want.prefix):] for k in want.collect_params()]


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_logits_match_the_jax_package(name):
    size = FULL[name]
    kw = {"classes": CLASSES}
    tnet = port_resolved(lambda: tvision.get_model(name, **kw), size)
    named = zoo_weights({n: tuple(p.shape) for n, p in
                         tnet._collect_params_with_prefix().items()}, 3)
    jnet = jax_with(lambda: jvision.get_model(name, **kw), named)
    if name != "inceptionv3":
        # the JAX package's own symbolic inference agrees on every shape
        s = jnet(jmx.sym.var("data"))
        args, _, aux = s.infer_shape(data=(1, 3, size, size))
        by_name = dict(zip(s.list_arguments(), args))
        by_name.update(zip(s.list_auxiliary_states(), aux))
        assert {p.name: tuple(by_name[p.name])
                for p in jnet.collect_params().values()} == \
            {n: p.shape for n, p in tnet.collect_params().items()}
    tnet.load_state_dict(params_from_mxnet_tpu(named, tnet))
    x = np.random.RandomState(4).randn(1, 3, size, size).astype("float32")
    params = {n: p.data()._data
              for n, p in jnet._collect_params_with_prefix().items()}
    run = jax.jit(lambda pv, xv: functional_call(jnet, pv, [xv])[0][0])
    want = np.asarray(run(params, jmx.nd.array(x)._data))
    with torch.no_grad(), autograd.predict_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (1, CLASSES)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _inception_cut(vision):
    nn = (jgluon if vision is jvision else gluon).nn
    net = nn.HybridSequential(prefix="inc_")
    with net.name_scope():
        net.add(vision._inc_conv(32, 3, 2), vision._inc_conv(32, 3),
                vision._inc_conv(64, 3, pad=1),
                nn.MaxPool2D(pool_size=3, strides=2),
                vision._inc_conv(80, 1), vision._inc_conv(192, 3),
                nn.MaxPool2D(pool_size=3, strides=2), vision._inc_A(32),
                vision._inc_B(), vision._inc_C(128), vision._inc_D(),
                vision._inc_E(), nn.GlobalAvgPool2D(), nn.Dense(CLASSES))
    return net


FAMILIES = {
    "vgg11": (lambda v: v.get_model("vgg11", classes=CLASSES), 32),
    "alexnet": (lambda v: v.get_model("alexnet", classes=CLASSES), 64),
    "squeezenet1.1": (lambda v: v.get_model("squeezenet1.1",
                                            classes=CLASSES), 128),
    "mobilenet0.25": (lambda v: v.get_model("mobilenet0.25",
                                            classes=CLASSES), 224),
    "mobilenetv2_0.25": (lambda v: v.get_model("mobilenetv2_0.25",
                                               classes=CLASSES), 224),
    "densenet_one_layer_per_block": (
        lambda v: v.DenseNet(64, 32, [1, 1, 1, 1], classes=CLASSES), 224),
    "inception3_one_block_each": (_inception_cut, 139),
}


def _no_dropout(net, jax_side):
    for block in (_jax_blocks(net) if jax_side else net.modules()):
        if type(block).__name__ == "Dropout":
            if jax_side:
                block._rate = 0.0
            else:
                block.rate = 0.0


def _jax_blocks(block):
    yield block
    for child in block._children.values():
        yield from _jax_blocks(child)


def _jax_step(jnet, x, y):
    """The JAX package's training forward and backward as one program:
    (logits, per-sample losses, {name: gradient}, {name: new running
    statistic})."""
    params = jnet._collect_params_with_prefix()
    trained = [n for n, p in params.items() if p.grad_req != "null"]
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()

    @jax.jit
    def fb(tv, fixed, xv, yv):
        def f(tv):
            outs, aux = functional_call(jnet, {**fixed, **tv}, [xv],
                                        training=True)
            loss = loss_fn(jax_wrap(outs[0]), jax_wrap(yv))._data
            return jnp.sum(loss), (outs[0], loss, aux)
        (_, out), grads = jax.value_and_grad(f, has_aux=True)(tv)
        return out, grads

    tv = {n: params[n].data()._data for n in trained}
    fixed = {n: p.data()._data for n, p in params.items() if n not in tv}
    (logits, loss, aux), grads = fb(tv, fixed, jnp.asarray(x),
                                    jnp.asarray(y))
    return (np.asarray(logits), np.asarray(loss),
            {n: np.asarray(g) for n, g in grads.items()},
            {n: np.asarray(v) for n, v in aux.items()})


def family_step_matches(name):
    """One training step of ``FAMILIES[name]`` in both packages in fp64:
    see ``test_torch_model_zoo_train.py``'s docstring."""
    make, size = FAMILIES[name]
    rng = np.random.RandomState(5)
    x = rng.randn(B, 3, size, size)
    y = rng.randint(0, CLASSES, B).astype("float64")
    with CPU:
        tnet = make(tvision)
        _no_dropout(tnet, False)
        tnet.initialize()
        trainer = gluon.Trainer(tnet.collect_params(), "sgd", {
            "learning_rate": LR, "momentum": 0.9, "wd": WD})
        with autograd.pause():
            tnet(mx.nd.zeros((1, 3, size, size)))     # resolves
        tparams = tnet._collect_params_with_prefix()
        named = {n: v.astype("float64") for n, v in zoo_weights(
            {n: p.shape for n, p in tparams.items()}, 6).items()}
        tnet.load_state_dict(params_from_mxnet_tpu(named, tnet))
        tnet.cast("float64")
        with autograd.record():
            logits = tnet(mx.nd.array(x, dtype="float64"))
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(logits,
                                                        mx.nd.array(y))
        loss.backward()
        trainer.step(B)
    jax.config.update("jax_enable_x64", True)
    try:
        jnet = jax_with(lambda: make(jvision), named)
        _no_dropout(jnet, True)
        jlogits, jloss, grads, aux = _jax_step(jnet, x, y)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert jlogits.dtype == np.float64
    np.testing.assert_allclose(logits.asnumpy(), jlogits, rtol=RTOL64,
                               atol=ATOL64)
    np.testing.assert_allclose(loss.asnumpy(), jloss, rtol=RTOL64,
                               atol=ATOL64)
    assert set(grads) | set(aux) <= set(tparams)
    for n, p in tparams.items():
        got = p.data().asnumpy()
        if n in grads:
            w = named[n]
            np.testing.assert_allclose(got - w, -LR * (grads[n] / B + WD * w),
                                       rtol=RTOL64, atol=ATOL64, err_msg=n)
        else:
            np.testing.assert_allclose(got, aux.get(n, named[n]),
                                       rtol=RTOL64, atol=ATOL64, err_msg=n)


def test_inception3_member_step_matches_the_jax_package():
    family_step_matches("inception3_one_block_each")
