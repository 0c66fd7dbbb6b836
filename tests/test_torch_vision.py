"""The port's ResNet model zoo against the JAX package's, on the CPU.

- the parameter names of all ten ``resnet{18,34,50,101,152}_v{1,2}``;
- ``resnet50_v1``'s 299 names and shapes (the JAX side's from its own
  symbolic shape inference at 1 x 3 x 32 x 32, the shapes a first forward
  would resolve, without compiling every op), carried by ``convert.py``
  both ways;
- narrow ResNets (v1: BottleneckV1, v2: BottleneckV2; one block per stage,
  16-256 channels) built in both packages from the same numpy-seeded
  weights: logits in train mode (batch statistics), the running
  statistics that forward writes, and logits in predict mode (running
  statistics), rtol 1e-4 / atol 1e-4. Both sides compute in fp32, but
  XLA:CPU and ATen sum convolutions and batch statistics in different
  orders: each layer's error is a few fp32 roundings of its activations'
  scale, and over ~15 layers it reaches ~1e-5 of the logits' scale (max
  |logit| ~2-5), which a logit near zero carries too (1.3e-5 seen at
  -0.08), hence an absolute limit at that scale;
- ``Dense``'s default flatten of a 4-D input, ``cast("float16")`` keeping
  BatchNorm in fp32, and ``get_model``.

The JAX side runs each model once per module, each mode's forward as one
program through ``functional_call`` (its hybridize machinery), which
hands back the running statistics a training forward writes: the JAX
package's own hybridized call drops them (ROADMAP Queue C), and they are
compared here.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jax_gnn
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch.convert import (mxnet_tpu_shapes, params_from_mxnet_tpu,
                                     params_to_mxnet_tpu)
from mxnet_tpu_torch.gluon import collect_params
from mxnet_tpu_torch.gluon import nn as torch_gnn
from mxnet_tpu_torch.gluon.model_zoo import vision as torch_vision

from test_torch_resnet_train import jax_resolve_shapes, keep_zeros

RTOL, ATOL = 1e-4, 1e-4
NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
CLASSES, BATCH, SIZE = 10, 4, 32
RESNETS = [f"resnet{n}_v{v}" for v in (1, 2) for n in (18, 34, 50, 101, 152)]


def resnet_weights(shapes, seed):
    """Seeded weights in the JAX naming that keep activations at unit
    scale: He-normal convolution and Dense weights, small biases and
    betas, gammas around 1, running means around 0 and variances around
    1 (so that predict mode differs from train mode)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            w = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("gamma"):
            w = 1 + 0.1 * rng.randn(*shape)
        elif name.endswith("running_var"):
            w = 1 + 0.2 * rng.rand(*shape)
        else:   # bias, beta, running_mean
            w = 0.05 * rng.randn(*shape)
        out[name] = w.astype("float32")
    return out


def jax_narrow(version, seed=0, batch=BATCH):
    """A narrow JAX ResNet, shapes resolved by the JAX package's symbolic
    shape inference at the test's input shape, seeded weights set;
    returns (net, weights)."""
    cls = jax_vision.ResNetV1 if version == 1 else jax_vision.ResNetV2
    block = jax_vision.BottleneckV1 if version == 1 else \
        jax_vision.BottleneckV2
    net = cls(block, *NARROW, classes=CLASSES)
    net.initialize(keep_zeros)
    jax_resolve_shapes(net, (batch, 3, SIZE, SIZE))
    params = net._collect_params_with_prefix()
    named = resnet_weights({n: tuple(p.shape) for n, p in params.items()},
                           seed)
    for n, p in params.items():
        p.set_data(mx.nd.array(named[n]))
    return net, named


def port_narrow(version, named, dtype=torch.float32):
    cls = torch_vision.ResNetV1 if version == 1 else torch_vision.ResNetV2
    block = torch_vision.BottleneckV1 if version == 1 else \
        torch_vision.BottleneckV2
    net = cls(block, *NARROW, classes=CLASSES, device="cpu")
    net.load_state_dict(params_from_mxnet_tpu(named, net))
    return net


def images(seed=5, batch=BATCH):
    return np.random.RandomState(seed).uniform(
        -1, 1, (batch, 3, SIZE, SIZE)).astype("float32")


@pytest.mark.parametrize("name", RESNETS)
def test_resnet_parameter_names_match_jax(name):
    want = list(jax_vision.get_model(name)._collect_params_with_prefix())
    got = list(collect_params(torch_vision.get_model(name, device="cpu")))
    assert got == want


@pytest.fixture(scope="module")
def jax_resnet50_shapes():
    net = jax_vision.resnet50_v1()
    net.initialize(keep_zeros)
    jax_resolve_shapes(net, (1, 3, 32, 32))
    return {n: tuple(p.shape)
            for n, p in net._collect_params_with_prefix().items()}


def test_resnet50_v1_names_and_shapes_carry_both_ways(jax_resnet50_shapes):
    net = torch_vision.resnet50_v1(device="cpu")
    shapes = mxnet_tpu_shapes(net)
    assert len(shapes) == 299
    assert shapes == jax_resnet50_shapes
    # 53 convolution weights, the 32 biases of BottleneckV1's 1x1
    # convolutions, output's two; 53 BatchNorms of four parameters
    convs = [n for n in shapes if len(shapes[n]) == 4]
    biases = [n for n in shapes if n.endswith(".bias")]
    assert (len(convs), len(biases)) == (53, 33)
    assert sum(n.endswith(("gamma", "beta", "running_mean", "running_var"))
               for n in shapes) == 212
    named = resnet_weights(shapes, 3)
    net.load_state_dict(params_from_mxnet_tpu(named, net))
    back = params_to_mxnet_tpu(net)
    assert sorted(back) == sorted(named)
    for n in named:
        np.testing.assert_array_equal(back[n], named[n], err_msg=n)
    for n, p in collect_params(net).items():
        want_grad = not n.endswith(("running_mean", "running_var"))
        assert p.requires_grad == want_grad, n


@pytest.fixture(scope="module")
def jax_narrow_runs():
    """Per version: the weights, train-mode logits and running stats after
    that forward, then predict-mode logits."""
    x = mx.nd.array(images())._data
    runs = {}
    forward = jax.jit(functional_call, static_argnums=(0,),
                      static_argnames=("training",))
    for version in (1, 2):
        net, named = jax_narrow(version)
        params = net._collect_params_with_prefix()
        pvals = {n: p.data()._data for n, p in params.items()}
        outs, aux = forward(net, pvals, [x], training=True)
        train = np.asarray(outs[0])
        for n, v in aux.items():
            params[n].data()._rebind(v)
        stats = {n: p.data().asnumpy() for n, p in params.items()
                 if n.endswith(("running_mean", "running_var"))}
        pvals = {n: p.data()._data for n, p in params.items()}
        predict = np.asarray(forward(net, pvals, [x], training=False)[0][0])
        runs[version] = dict(named=named, train=train, stats=stats,
                             predict=predict)
    return runs


@pytest.mark.parametrize("version", [1, 2])
def test_narrow_resnet_train_mode_logits_and_stats_match_jax(
        jax_narrow_runs, version):
    run = jax_narrow_runs[version]
    net = port_narrow(version, run["named"])
    with autograd.record():
        out = net(torch.from_numpy(images()))
    assert out.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(out.detach().numpy(), run["train"],
                               rtol=RTOL, atol=ATOL)
    got = params_to_mxnet_tpu(net)
    for n, want in run["stats"].items():
        assert not np.array_equal(want, run["named"][n]), n
        np.testing.assert_allclose(got[n], want, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("version", [1, 2])
def test_narrow_resnet_predict_mode_logits_match_jax(jax_narrow_runs,
                                                     version):
    """Predict mode after the train-mode forward, which moved the running
    statistics on both sides."""
    run = jax_narrow_runs[version]
    net = port_narrow(version, run["named"])
    x = torch.from_numpy(images())
    with autograd.record():
        net(x)
    with torch.no_grad():
        out = net(x)
        with autograd.predict_mode():
            again = net(x)
    np.testing.assert_allclose(out.numpy(), run["predict"], rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(out, again)
    assert not np.allclose(run["predict"], run["train"], rtol=RTOL,
                           atol=ATOL)


@pytest.mark.parametrize("flatten", [True, False])
def test_dense_flatten_matches_jax(flatten):
    """``Dense`` flattens an (N, C, H, W) input by default, as ResNet's
    head relies on; ``flatten=False`` acts on the last axis."""
    rng = np.random.RandomState(7)
    x = rng.randn(3, 8, 2, 2).astype("float32")
    in_units = 32 if flatten else 2
    w = rng.randn(5, in_units).astype("float32")
    b = rng.randn(5).astype("float32")
    jd = jax_gnn.Dense(5, flatten=flatten, in_units=in_units,
                       activation="tanh")
    jd.initialize(keep_zeros)   # its values are set below
    jd.weight.set_data(mx.nd.array(w))
    jd.bias.set_data(mx.nd.array(b))
    want = jd(mx.nd.array(x)).asnumpy()
    td = torch_gnn.Dense(5, in_units=in_units, flatten=flatten,
                         activation="tanh", device="cpu")
    td.load_state_dict({"weight": torch.from_numpy(w),
                        "bias": torch.from_numpy(b)})
    got = td(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == ((3, 5) if flatten else (3, 8, 2, 5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cast_float16_keeps_batchnorm_fp32_as_jax():
    jnet = jax_vision.ResNetV1(jax_vision.BottleneckV1, *NARROW,
                               classes=CLASSES)
    jnet.initialize(keep_zeros)
    jax_resolve_shapes(jnet, (1, 3, SIZE, SIZE))
    jnet.cast("float16")
    want = {n: str(p.data().dtype)
            for n, p in jnet._collect_params_with_prefix().items()}
    net = torch_vision.ResNetV1(torch_vision.BottleneckV1, *NARROW,
                                classes=CLASSES, device="cpu")
    params = collect_params(net)
    before = {n: id(p) for n, p in params.items()}
    net.cast("float16")
    got = {n: str(p.dtype).replace("torch.", "")
           for n, p in collect_params(net).items()}
    assert got == want
    assert {n: id(p) for n, p in collect_params(net).items()} == before
    assert sum(v == "float16" for v in got.values()) == 27
    with autograd.record():
        out = net(torch.from_numpy(images()).half())
    assert out.dtype == torch.float16 and torch.isfinite(out).all()


def test_get_model_builds_resnets_and_names_what_waits():
    net = torch_vision.get_model("ResNet18_v2", classes=7, device="cpu")
    assert isinstance(net, torch_vision.ResNetV2)
    assert net.output.weight.shape == (7, 512)
    assert isinstance(torch_vision.get_model("vgg16"), torch_vision.VGG)
    with pytest.raises(ValueError, match="not supported"):
        torch_vision.get_model("resnet19_v1")
    # no in_channels: the weight waits for the first forward
    conv = torch_gnn.Conv2D(8, 3, device="cpu")
    assert conv.param("weight").shape == (8, 0, 3, 3)
    with pytest.raises(MXNetError, match="pretrained"):
        torch_vision.resnet18_v1(pretrained=True, device="cpu")
