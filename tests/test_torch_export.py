"""Gluon's deployment flow in the port against the JAX package's on the
CPU: ``HybridBlock.export`` -> ``SymbolBlock.imports`` / ``Module.load``.

- narrow ResNets of the zoo's blocks (``ResNetV1`` over ``BasicBlockV1``
  and over ``BottleneckV1``, ``ResNetV2`` over ``BottleneckV2``, with
  one stage's worth of blocks each) and a stack of ``Embedding``,
  ``LayerNorm``, ``Dense``, ``GELU``, ``Dropout`` and ``Flatten``, built
  with the same prefix in both packages: the port's exported JSON equals
  the JAX package's node for node, and the ``.params`` files carry the
  same names;
- the port's exported files (of the BottleneckV1 net and the stack), run
  by the JAX package's ``SymbolBlock.imports``, give the port's outputs
  (the port's torch-direct forward), and the JAX package's files run by
  the port's ``SymbolBlock.imports`` give the JAX net's (its forward as
  one program through ``functional_call``): rtol 1e-4 / atol 1e-5, as the
  convolutions and products sum in different orders. Both nets carry
  numpy-seeded values; the JAX nets' shapes come from its symbolic shape
  inference, and its runs are compiled whole, not op by op;
- a port SymbolBlock exports its stored graph again unchanged, and an
  exported net with a ``SoftmaxOutput`` head trains through ``Module``
  as the same net does through the Gluon ``Trainer`` (two SGD steps with
  momentum and weight decay, fp32, the losses and every parameter within
  rtol 1e-4 / atol 1e-5).
"""
import json

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ndarray.ndarray import _wrap as jax_wrap

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, sym
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

from test_torch_resnet_train import jax_resolve_shapes, keep_zeros

RTOL, ATOL = 1e-4, 1e-5
CPU = mx.cpu()
CHANNELS = [4, 8, 16, 32, 64]
LAYERS = [1, 1, 1, 1]


def _resnet(vision, version, block, **kw):
    klass = vision.ResNetV1 if version == 1 else vision.ResNetV2
    return klass(getattr(vision, block), LAYERS, CHANNELS, classes=5,
                 thumbnail=True, prefix=f"resnetv{version}0_", **kw)


def _stack(pkg):
    nn = (jgluon if pkg is jmx else gluon).nn
    dev = {} if pkg is jmx else {"device": "cpu"}
    net = nn.HybridSequential(prefix="stack_")
    with net.name_scope():
        if pkg is jmx:
            net.add(nn.Embedding(50, 16), nn.LayerNorm(in_channels=16),
                    nn.Dense(12, flatten=False, in_units=16), nn.GELU(),
                    nn.Dropout(0.1), nn.Flatten(), nn.Dense(6, in_units=36))
        else:
            net.add(nn.Embedding(50, 16, **dev), nn.LayerNorm(in_channels=16, **dev),
                    nn.Dense(12, flatten=False, in_units=16, **dev), nn.GELU(),
                    nn.Dropout(0.1, **dev), nn.Flatten(),
                    nn.Dense(6, in_units=36, **dev))
    return net


NETS = {
    "resnet_v1_basic": (lambda pkg: _resnet(
        jvision if pkg is jmx else tvision, 1, "BasicBlockV1",
        **({} if pkg is jmx else {"device": "cpu"})), (2, 3, 8, 8)),
    "resnet_v1_bottleneck": (lambda pkg: _resnet(
        jvision if pkg is jmx else tvision, 1, "BottleneckV1",
        **({} if pkg is jmx else {"device": "cpu"})), (2, 3, 8, 8)),
    "resnet_v2_bottleneck": (lambda pkg: _resnet(
        jvision if pkg is jmx else tvision, 2, "BottleneckV2",
        **({} if pkg is jmx else {"device": "cpu"})), (2, 3, 8, 8)),
    "stack": (_stack, (2, 3)),
}


def _input(name, shape):
    rs = np.random.RandomState(0)
    if name == "stack":
        return rs.randint(0, 50, shape).astype("float32")
    return rs.randn(*shape).astype("float32")


def _randomize(net):
    """Every parameter of the port's net numpy-seeded (running variances
    positive), so that both packages run on one set of values."""
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for name, p in net.named_jax_params().items():
            v = rs.rand(*p.shape) + 0.5 if name.endswith("var") \
                else rs.randn(*p.shape) * 0.2
            p.copy_(torch.from_numpy(v.astype("float32")))


_EXPORTS = {}


def _export(name, tmp_path_factory):
    """Each net built and exported in both packages once per module."""
    if name not in _EXPORTS:
        _EXPORTS[name] = _build_and_export(name, tmp_path_factory)
    return _EXPORTS[name]


@pytest.fixture(scope="module", params=sorted(NETS))
def exported(request, tmp_path_factory):
    return _export(request.param, tmp_path_factory)


# the runs across the packages: ResNet-50's block and the stack (the
# other two nets' graphs are held node for node above)
@pytest.fixture(scope="module", params=["resnet_v1_bottleneck", "stack"])
def exported_run(request, tmp_path_factory):
    return _export(request.param, tmp_path_factory)


def _build_and_export(name, tmp_path_factory):
    make, shape = NETS[name]
    d = tmp_path_factory.mktemp(name)
    tnet = make(mx)
    _randomize(tnet)
    with mx.name.NameManager():
        tnet.export(str(d / "t"))
    jnet = make(jmx)
    jnet.initialize(keep_zeros)
    jax_resolve_shapes(jnet, shape)
    rs = np.random.RandomState(3)
    for name, p in jnet._collect_params_with_prefix().items():
        v = rs.rand(*p.shape) + 0.5 if name.endswith("var") \
            else rs.randn(*p.shape) * 0.2
        p.set_data(jmx.nd.array(v.astype("float32")))
    with jmx.name.NameManager():
        jnet.export(str(d / "j"))
    return name, shape, tnet, jnet, d


def test_export_json_is_node_for_node_the_jax_packages(exported):
    _, _, _, _, d = exported
    t = json.load(open(d / "t-symbol.json"))
    j = json.load(open(d / "j-symbol.json"))
    assert t == j


def test_params_files_carry_the_same_names(exported):
    _, _, _, _, d = exported
    t = mx.nd.load(str(d / "t-0000.params"), ctx=CPU)
    j = jmx.nd.load(str(d / "j-0000.params"))
    assert sorted(t) == sorted(j)
    for k in j:
        assert tuple(t[k].shape) == tuple(j[k].shape), k


def test_port_export_runs_in_the_jax_symbol_block(exported_run):
    name, shape, tnet, _, d = exported_run
    x = _input(name, shape)
    block = jgluon.SymbolBlock.imports(str(d / "t-symbol.json"), "data",
                                       str(d / "t-0000.params"))
    # the block's graph as one program (its eager run compiles every op)
    run = jax.jit(lambda xv: block(jax_wrap(xv))._data)
    got = np.asarray(run(jmx.nd.array(x)._data))
    dtype = torch.int64 if name == "stack" else torch.float32
    with torch.no_grad():
        want = tnet(torch.from_numpy(x).to(dtype)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_jax_export_runs_in_the_port_symbol_block(exported_run):
    name, shape, _, jnet, d = exported_run
    x = _input(name, shape)
    block = gluon.SymbolBlock.imports(str(d / "j-symbol.json"), "data",
                                      str(d / "j-0000.params"), ctx=CPU)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    pvals = {n: p.data()._data
             for n, p in jnet._collect_params_with_prefix().items()}
    want = np.asarray(jax.jit(functional_call, static_argnums=(0,))(
        jnet, pvals, [jmx.nd.array(x)._data])[0][0])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    names = [k.split(":", 1)[1] for k in jmx.nd.load(str(d / "j-0000.params"))]
    assert sorted(block.collect_params()) == sorted(names)


def test_symbol_block_exports_its_graph_again(exported, tmp_path):
    _, _, _, _, d = exported
    block = gluon.SymbolBlock.imports(str(d / "t-symbol.json"), "data",
                                      str(d / "t-0000.params"), ctx=CPU)
    block.export(str(tmp_path / "again"))
    assert json.load(open(tmp_path / "again-symbol.json")) == \
        json.load(open(d / "t-symbol.json"))
    a = mx.nd.load(str(tmp_path / "again-0000.params"), ctx=CPU)
    b = mx.nd.load(str(d / "t-0000.params"), ctx=CPU)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k].asnumpy(), b[k].asnumpy())


def test_module_over_an_export_trains_as_the_gluon_trainer(tmp_path):
    """The deployment flow's training half: a narrow ResNet-50-block net,
    exported, loaded by ``sym.load`` with a ``SoftmaxOutput`` appended and
    its ``.params`` through ``Module.set_params``, trains two SGD steps as
    the same net does through ``autograd.record`` and ``Trainer.step``."""
    net = _resnet(tvision, 1, "BottleneckV1", device="cpu")
    _randomize(net)
    prefix = str(tmp_path / "net")
    net.export(prefix)
    rs = np.random.RandomState(2)
    x = rs.randn(4, 3, 8, 8).astype("float32")
    y = np.array([0, 1, 4, 2], "float32")
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
           "rescale_grad": 0.25}
    head = sym.SoftmaxOutput(sym.load(prefix + "-symbol.json"),
                             name="softmax")
    args, auxs = mx.model.load_params(prefix, 0)
    with mx.cpu():
        mod = mx.mod.Module(head, context=CPU)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        mod.set_params(args, auxs)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
        batch = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
        mod_losses = []
        for _ in range(2):
            mod.forward_backward(batch)
            prob = mod.get_outputs()[0].asnumpy()
            mod_losses.append(-np.log(prob[np.arange(4), y.astype(int)])
                              .mean())
            mod.update()
    params = {n: p for n, p in net.named_jax_params().items()
              if p.requires_grad}
    trainer = gluon.Trainer(list(params.values()), "sgd",
                            {k: v for k, v in opt.items()
                             if k != "rescale_grad"})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    gl_losses = []
    for _ in range(2):
        with mx.autograd.record():
            loss = loss_fn(net(xt), yt)
        loss.sum().backward()
        trainer.step(4)
        gl_losses.append(float(loss.detach().mean()))
    np.testing.assert_allclose(mod_losses, gl_losses, rtol=RTOL)
    got_args, got_auxs = mod.get_params()
    for name, p in net.named_jax_params().items():
        got = (got_args[name] if name in got_args
               else got_auxs[name]).asnumpy()
        np.testing.assert_allclose(got, p.detach().numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_symbol_block_makes_missing_parameters_at_its_first_call():
    """A SymbolBlock over a bare graph: its parameters are made from the
    input's shapes at the first call (Uniform), collected by graph name,
    trained as leaves; BatchNorm's moving statistics move in training."""
    net = sym.BatchNorm(sym.FullyConnected(sym.var("data"), num_hidden=3,
                                           name="fc"), name="bn")
    block = gluon.SymbolBlock(net, sym.var("data"), device="cpu")
    assert block.collect_params() == {}
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 5)
                         .astype("float32"))
    with mx.autograd.record():
        out = block(x)
    params = block.collect_params()
    assert {n: tuple(p.shape) for n, p in params.items()} == {
        "fc_weight": (3, 5), "fc_bias": (3,), "bn_gamma": (3,),
        "bn_beta": (3,), "bn_moving_mean": (3,), "bn_moving_var": (3,)}
    assert params["bn_moving_mean"].grad_req == "null"
    assert params["fc_weight"].grad_req == "write" and out.shape == (4, 3)
    assert params["bn_moving_mean"].tensor.abs().sum() > 0
