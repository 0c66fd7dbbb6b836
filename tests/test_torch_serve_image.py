"""An image model served through the port's ``ServingEngine`` against the
JAX package's, on the CPU.

A narrow Gluon conv net with BatchNorm (its weights and running
statistics drawn with numpy from a seed, carried across with
``convert.params_from_mxnet_tpu``) is served in both packages on fixed
(3, 12, 12) items over batch rungs 1, 2, 4: every request's output
within 1e-5 of the JAX package's in fp32 (rtol 1e-5: the padded rung
changes nothing for a net in inference mode, where BatchNorm uses its
running statistics), 0 signatures after warmup, and a parameter update
between dispatches shows in the next response.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.serve import ServingEngine as JServingEngine
from mxnet_tpu.serve.buckets import parse_bucket_spec as jparse

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.serve import ServingEngine
from mxnet_tpu_torch.serve.buckets import parse_bucket_spec

ITEM = (3, 12, 12)
TOL = dict(rtol=1e-5, atol=1e-5)


def _net(nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.Conv2D(8, 3, strides=2),
            nn.BatchNorm(), nn.Activation("relu"), nn.GlobalAvgPool2D(),
            nn.Dense(5))
    return net


@pytest.fixture(scope="module")
def nets():
    jnet = _net(jnn)
    jnet.initialize()
    jnet(jmx.nd.zeros((1,) + ITEM))
    rs = np.random.RandomState(0)
    for name, p in sorted(jnet._collect_params_with_prefix().items()):
        shape = p.data().shape
        if name.endswith("running_var"):
            value = rs.uniform(0.5, 2.0, shape)
        elif name.endswith(("gamma", "running_mean")):
            value = 1.0 + 0.3 * rs.randn(*shape)
        else:
            value = 0.3 * rs.randn(*shape)
        p.set_data(jmx.nd.array(value.astype("float32")))
    named = {k: v.data().asnumpy()
             for k, v in jnet._collect_params_with_prefix().items()}
    with mx.cpu():
        tnet = _net(tnn)
        tnet.initialize(ctx=mx.cpu())
        tnet(mx.nd.zeros((1,) + ITEM))
    tnet.load_state_dict(params_from_mxnet_tpu(named, tnet))
    jnet.hybridize()
    tnet.hybridize()
    return jnet, tnet


def _requests():
    rs = np.random.RandomState(1)
    return [rs.rand(n, *ITEM).astype("float32") for n in (1, 3, 2, 4, 1)]


def test_served_outputs_match_the_jax_package(nets):
    jnet, tnet = nets
    jeng = JServingEngine(jnet, input_specs=[ITEM],
                          ladder=jparse("1,2,4"))
    teng = ServingEngine(tnet, input_specs=[ITEM],
                         ladder=parse_bucket_spec("1,2,4"), device="cpu")
    try:
        jeng.warmup()
        assert len(teng.warmup()) == 3
        for x in _requests():
            got, want = teng.predict(x), jeng.predict(x)
            assert got.shape == want.shape == (len(x), 5)
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
            with mx.cpu():
                direct = tnet(mx.nd.array(x)).asnumpy()
            np.testing.assert_allclose(got, direct, **TOL)
        assert teng.stats()["recompiles_after_warmup"] == 0
    finally:
        teng.close()
        jeng.close()


def test_a_parameter_update_shows_in_the_next_response(nets):
    _, tnet = nets
    teng = ServingEngine(tnet, input_specs=[ITEM],
                         ladder=parse_bucket_spec("1,2,4"), device="cpu",
                         batching=False)
    teng.warmup()
    x = _requests()[1]
    before = teng.predict(x)
    bias = tnet[-1].bias
    saved = bias.detach().clone()
    try:
        with torch.no_grad():
            bias.add_(1.5)
        after = teng.predict(x)
    finally:
        with torch.no_grad():
            bias.copy_(saved)
        teng.close()
    np.testing.assert_allclose(after, before + 1.5, **TOL)
    assert teng.stats()["recompiles_after_warmup"] == 0
