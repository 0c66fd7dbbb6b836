"""The port's ResNet training path against the JAX package's, on the CPU.

Two fp32 ``Trainer.step``s of a narrow ResNetV1 (BottleneckV1, one block
per stage, 16-256 channels, 10 classes) on 4 images of 32 x 32, built in
both packages from the same numpy-seeded weights::

    with autograd.record():
        loss = loss_fn(net(x), y)
        scaled = loss * scale
    autograd.backward(scaled)
    trainer.step(batch * scale)

with SGD (momentum 0.9, wd 1e-4) under a ``MultiFactorScheduler`` with
linear warmup (the first update at half the rate, the second at the
factor's). The JAX side is the eager ``Trainer.step`` (never the fused
step) after a forward and backward compiled as one program through
``functional_call``, which hands back the BatchNorm running statistics
(the JAX package's own hybridized call drops them, ROADMAP Queue C; they
are compared here); its shapes come from its symbolic shape inference.
Losses, every weight, every momentum and both running statistics of every
BatchNorm agree within rtol 2e-4 / atol 2e-5, as
``tests/test_torch_train.py`` (XLA:CPU and ATen sum in different orders).
The fp16 multi-precision steps are in ``test_torch_resnet_train_fp16.py``
(a JAX run of its own, on another worker).

Then the four learning-rate schedulers over 50 updates, and the
initializers' scales and fan rules, against the JAX package's.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jax_gluon
from mxnet_tpu import initializer as jax_init
from mxnet_tpu import lr_scheduler as jax_lrs
from mxnet_tpu import optimizer as jax_opt
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu_torch import MXNetError, autograd, initializer, lr_scheduler
from mxnet_tpu_torch import optimizer as torch_opt
from mxnet_tpu_torch import random as torch_random
from mxnet_tpu_torch.convert import params_from_mxnet_tpu, params_to_mxnet_tpu
from mxnet_tpu_torch.gluon import Trainer, collect_params
from mxnet_tpu_torch.gluon import loss as torch_loss
from mxnet_tpu_torch.gluon.model_zoo import vision as torch_vision

NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
CLASSES, B, SIZE, STEPS = 10, 4, 32, 2
LR, MOMENTUM, WD, LOSS_SCALE16 = 0.01, 0.9, 1e-4, 8.0
RTOL32, ATOL32 = 2e-4, 2e-5
STATS = ("running_mean", "running_var")


def _weights(shapes, seed=0):
    """He-normal convolution weights, small biases and betas, gammas
    around 1, running statistics around (0, 1), in the JAX naming; the
    classifier's weights N(0, 0.02), so that the first loss is near
    ln(10) and two steps at the test's rate move every weight by a few
    percent (He-normal there gave losses of ~4.5 and updates as large as
    the weights, where fp16 runs part)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name == "output.weight":
            w = rng.randn(*shape) * 0.02
        elif name.endswith("weight"):
            w = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("gamma"):
            w = 1 + 0.1 * rng.randn(*shape)
        elif name.endswith("running_var"):
            w = 1 + 0.2 * rng.rand(*shape)
        else:
            w = 0.05 * rng.randn(*shape)
        out[name] = w.astype("float32")
    return out


def _batch():
    rng = np.random.RandomState(1)
    return (rng.uniform(-1, 1, (B, 3, SIZE, SIZE)).astype("float32"),
            rng.randint(0, CLASSES, B).astype("float32"))


def _scheduler(mod):
    return mod.MultiFactorScheduler(step=[1], factor=0.5, base_lr=LR,
                                    warmup_steps=2)


def keep_zeros(desc, arr):
    """An initializer that leaves the zeros it is given, for a JAX net
    whose values a test sets itself: a random draw compiles a program per
    shape."""


def jax_resolve_shapes(net, data_shape):
    """Give a JAX Gluon net's deferred parameters their shapes from the
    JAX package's symbolic shape inference (abstract evaluation of its
    traced graph: no program is compiled), in place of a first forward
    that compiles every op of the net, and finish their initialization."""
    s = net(mx.sym.var("data"))
    arg_shapes, _, aux_shapes = s.infer_shape(data=data_shape)
    shapes = dict(zip(s.list_arguments(), arg_shapes))
    shapes.update(zip(s.list_auxiliary_states(), aux_shapes))
    for p in net.collect_params().values():
        p.shape = shapes[p.name]
        p._finish_deferred_init()


def jax_train_mode_step(net, loss_fn, scale):
    """The JAX package's training forward and backward of ``net`` as one
    compiled program: ``functional_call`` (its hybridize machinery) under
    ``jax.value_and_grad`` of ``sum(loss_fn(net(x), y) * scale)``. Returns
    ``step(x, y) -> losses`` that writes each gradient into its
    parameter's grad and each running statistic the forward updated into
    the parameter, as an eager recorded step and ``autograd.backward``
    would (the JAX package's own hybridized call drops the latter, ROADMAP
    Queue C). One compile in place of ~900 eager per-op ones."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.gluon.block import functional_call
    from mxnet_tpu.ndarray.ndarray import _wrap
    params = net._collect_params_with_prefix()
    trained = [n for n, p in params.items() if p.grad_req != "null"]

    @jax.jit
    def fb(tv, fixed, xv, yv):
        def f(tv):
            outs, aux = functional_call(net, {**fixed, **tv}, [xv],
                                        training=True)
            loss = loss_fn(_wrap(outs[0]), _wrap(yv))._data
            return jnp.sum(loss * scale), (loss, aux)
        (_, (loss, aux)), grads = jax.value_and_grad(f, has_aux=True)(tv)
        return loss, aux, grads

    def step(x, y):
        tv = {n: params[n].data()._data for n in trained}
        fixed = {n: p.data()._data for n, p in params.items()
                 if n not in tv}
        loss, aux, grads = fb(tv, fixed, x._data, y._data)
        for n, v in aux.items():
            params[n].data()._rebind(v)
        for n in trained:
            params[n].grad()._rebind(grads[n])
        return _wrap(loss)

    return step


def _jax_train(dtype):
    """Two steps of the JAX package's eager ``Trainer.step`` on the narrow
    net, each step's forward and backward one program
    (:func:`jax_train_mode_step`). Against the eager recorded step it
    replaces (the two compared on the CPU): fp32 losses within 1e-5 and
    weights within 2e-5 of their scale, far inside this file's limits; fp16
    losses bit-equal and the fp16 file's distances to fp32 equal to six
    digits (each fp16 op rounds its result in the compiled program as
    when run alone)."""
    x, y = _batch()
    net = jax_vision.ResNetV1(jax_vision.BottleneckV1, *NARROW,
                              classes=CLASSES)
    net.initialize(keep_zeros)
    jax_resolve_shapes(net, x.shape)
    params = net._collect_params_with_prefix()
    named = _weights({n: tuple(p.shape) for n, p in params.items()})
    for n, p in params.items():
        p.set_data(mx.nd.array(named[n]))
    fp16 = dtype == "float16"
    if fp16:
        net.cast("float16")
    scale = LOSS_SCALE16 if fp16 else 1.0
    trainer = jax_gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": LR, "momentum": MOMENTUM, "wd": WD,
        "multi_precision": fp16, "lr_scheduler": _scheduler(jax_lrs)})
    loss_fn = jax_gluon.loss.SoftmaxCrossEntropyLoss()
    step = jax_train_mode_step(net, loss_fn, scale)
    xs, ys = mx.nd.array(x, dtype=dtype), mx.nd.array(y)
    losses = []
    for _ in range(STEPS):
        loss = step(xs, ys)
        trainer.step(B * scale)
        losses.append(loss.asnumpy().astype("float32"))
    index = {p.name: i for i, p in enumerate(net.collect_params().values())}
    states = trainer._updaters[0].states
    weights, moms, masters = {}, {}, {}
    for n, p in params.items():
        weights[n] = p.data().asnumpy()
        st = states.get(index[p.name])
        if st is None:
            continue
        if isinstance(st, tuple):
            masters[n], st = st[0].asnumpy(), st[1]
        moms[n] = st.asnumpy()
    return {"named": named, "losses": losses, "weights": weights,
            "moms": moms, "masters": masters}


@pytest.fixture(scope="module")
def jax_run32():
    return _jax_train("float32")


def _port_train(named, dtype):
    x, y = _batch()
    net = torch_vision.ResNetV1(torch_vision.BottleneckV1, *NARROW,
                                classes=CLASSES, device="cpu")
    net.load_state_dict(params_from_mxnet_tpu(named, net))
    fp16 = dtype == "float16"
    if fp16:
        net.cast("float16")
    scale = LOSS_SCALE16 if fp16 else 1.0
    params = collect_params(net)
    trainer = Trainer(params, "sgd", {
        "learning_rate": LR, "momentum": MOMENTUM, "wd": WD,
        "multi_precision": fp16, "lr_scheduler": _scheduler(lr_scheduler)})
    loss_fn = torch_loss.SoftmaxCrossEntropyLoss()
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    yt = torch.from_numpy(y)
    losses, rates = [], []
    for _ in range(STEPS):
        with autograd.record():
            loss = loss_fn(net(xt), yt)
            scaled = loss * scale
        autograd.backward(scaled)
        trainer.step(B * scale)
        rates.append(trainer.learning_rate)
        losses.append(loss.detach().float().numpy())
    states = trainer._updaters[0].states
    moms, masters = {}, {}
    for i, n in enumerate(params):
        st = states.get(i)
        if st is None:
            continue
        if isinstance(st, tuple):
            masters[n], st = st[0].numpy(), st[1]
        moms[n] = st.numpy()
    return {"losses": losses, "weights": params_to_mxnet_tpu(net),
            "moms": moms, "masters": masters, "rates": rates}


def test_fp32_trainer_steps_match_jax(jax_run32):
    run = jax_run32
    got = _port_train(run["named"], "float32")
    assert got["rates"] == [LR / 2, LR / 2]   # warmup, then factor 0.5
    for a, b in zip(got["losses"], run["losses"]):
        np.testing.assert_allclose(a, b, rtol=RTOL32, atol=ATOL32)
    assert got["losses"][1].mean() < got["losses"][0].mean()
    assert sorted(got["weights"]) == sorted(run["weights"])
    for n, want in run["weights"].items():
        if n.endswith(STATS):
            assert not np.array_equal(want, run["named"][n]), n
        np.testing.assert_allclose(got["weights"][n], want, rtol=RTOL32,
                                   atol=ATOL32, err_msg=n)
    assert sorted(got["moms"]) == sorted(run["moms"])
    assert not any(n.endswith(STATS) for n in got["moms"])
    for n, want in run["moms"].items():
        np.testing.assert_allclose(got["moms"][n], want, rtol=RTOL32,
                                   atol=ATOL32, err_msg=n)


# -- learning-rate schedulers -------------------------------------------

SCHEDULERS = {
    "factor_constant_warmup": ("FactorScheduler", dict(
        step=5, factor=0.8, stop_factor_lr=0.02, base_lr=0.3,
        warmup_steps=3, warmup_mode="constant")),
    "multifactor_linear_warmup": ("MultiFactorScheduler", dict(
        step=[10, 20, 30], factor=0.5, base_lr=0.3, warmup_steps=5,
        warmup_begin_lr=0.01)),
    "poly": ("PolyScheduler", dict(max_update=40, base_lr=0.3, pwr=2,
                                   final_lr=1e-3, warmup_steps=5)),
    "cosine": ("CosineScheduler", dict(max_update=40, base_lr=0.3,
                                       final_lr=1e-3, warmup_steps=5)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_lr_scheduler_matches_jax(case):
    name, kw = SCHEDULERS[case]
    want, got = getattr(jax_lrs, name)(**kw), getattr(lr_scheduler, name)(**kw)
    assert [got(i) for i in range(1, 51)] == [want(i) for i in range(1, 51)]


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_optimizer_rate_under_scheduler_matches_jax(case):
    """The rate the optimizer applies at updates 1-50, with ``base_lr``
    taken from ``learning_rate`` (0.2, not the scheduler's 0.3) and a
    parameter's ``lr_mult``."""
    name, kw = SCHEDULERS[case]

    class P:
        lr_mult, wd_mult = 0.5, 1.0
    want_opt = jax_opt.SGD(learning_rate=0.2, param_dict={0: P()},
                           lr_scheduler=getattr(jax_lrs, name)(**kw))
    got_opt = torch_opt.SGD(learning_rate=0.2, param_dict={0: P()},
                            lr_scheduler=getattr(lr_scheduler, name)(**kw))
    want, got = [], []
    for _ in range(50):
        want.append(want_opt._common(0)[0])
        got.append(got_opt._common(0)[0])
    assert got == want
    with pytest.raises(MXNetError, match="already been defined"):
        got_opt.set_learning_rate(0.1)


# -- initializers -----------------------------------------------------------

def _jax_draw(init, name, shape):
    arr = mx.nd.zeros(shape)
    init(jax_init.InitDesc(name), arr)
    return arr.asnumpy()


def _port_draw(init, name, shape):
    arr = torch.zeros(shape)
    init(name, arr)
    return arr.numpy()


# (port initializer, JAX initializer, weight shape): the shapes of a 3x3
# convolution, a Dense and a 1-D weight (fan_in = fan_out = its length)
RANDOM_INITS = {
    "uniform_0.3": (lambda m: m.Uniform(0.3), (128, 64)),
    "normal_0.5": (lambda m: m.Normal(0.5), (128, 64)),
    "xavier_uniform_avg": (lambda m: m.Xavier(), (64, 32, 3, 3)),
    "xavier_gaussian_in_2": (lambda m: m.Xavier("gaussian", "in", 2),
                             (64, 32, 3, 3)),
    "xavier_gaussian_out_2": (lambda m: m.Xavier("gaussian", "out", 2),
                              (64, 32, 3, 3)),
    "xavier_uniform_in_dense": (lambda m: m.Xavier("uniform", "in", 3),
                                (300, 200)),
    "xavier_gaussian_1d": (lambda m: m.Xavier("gaussian", "avg", 3),
                           (20000,)),
    "msraprelu_in": (lambda m: m.MSRAPrelu("in", 0.25), (64, 32, 3, 3)),
    "msraprelu_avg": (lambda m: m.MSRAPrelu(), (64, 32, 3, 3)),
}


@pytest.mark.parametrize("case", sorted(RANDOM_INITS))
def test_initializer_scale_and_fan_rule_match_jax(case):
    """The streams differ (threefry against torch's), so the draws are
    compared by their distribution: a uniform's largest |value| (within
    1% of its bound at these sizes) and a Gaussian's standard deviation
    (within 3%: the estimate's own error is ~1/sqrt(2n) < 0.6%), and
    both means near 0."""
    make, shape = RANDOM_INITS[case]
    want = _jax_draw(make(jax_init), "conv0_weight", shape)
    got = _port_draw(make(initializer), "features.0.weight", shape)
    assert got.shape == want.shape and got.dtype == want.dtype
    gaussian = case.startswith(("normal", "msra")) or "gaussian" in case
    stat = np.std if gaussian else (lambda a: np.abs(a).max())
    assert stat(got) == pytest.approx(stat(want),
                                      rel=0.03 if gaussian else 0.01)
    for a in (got, want):
        assert abs(a.mean()) < 0.05 * stat(a)


def test_xavier_scale_follows_the_fan_rule():
    init = initializer.Xavier("gaussian", "in", 2)
    assert init.scale((64, 32, 3, 3)) == math.sqrt(2 / (32 * 9))
    assert initializer.Xavier("uniform", "out", 3).scale((64, 32, 3, 3)) \
        == math.sqrt(3 / (64 * 9))
    assert initializer.Xavier().scale((10,)) == math.sqrt(3 / 10)


@pytest.mark.parametrize("name", ["x_weight", "x_bias", "x_gamma", "x_beta",
                                  "x_running_mean", "x_running_var",
                                  "x_other"])
@pytest.mark.parametrize("kind", ["zeros", "ones", "constant"])
def test_fixed_initializers_are_exact_and_dispatch_by_name(kind, name):
    make = {"zeros": lambda m: m.Zero(), "ones": lambda m: m.One(),
            "constant": lambda m: m.Constant(0.25)}[kind]
    want = _jax_draw(make(jax_init), name, (3, 4))
    got = _port_draw(make(initializer), name, (3, 4))
    np.testing.assert_array_equal(got, want)
    assert type(initializer.create(kind)).__name__ == \
        type(make(initializer)).__name__


def test_initialize_prefers_each_parameters_own_initializer():
    """``initialize(Xavier)`` as MXNet's ResNet recipe calls it: weights
    Xavier, biases 0, gammas 1, betas 0, running statistics 0 and 1, as
    in the JAX package; a second call without ``force_reinit`` changes
    nothing, one seed gives one model."""
    init = initializer.Xavier("gaussian", "in", 2)
    nets = []
    for _ in range(2):
        torch_random.seed(3)
        net = torch_vision.ResNetV1(torch_vision.BottleneckV1, *NARROW,
                                    classes=CLASSES, device="cpu")
        net.initialize(init)
        nets.append(params_to_mxnet_tpu(net))
    first = nets[0]
    for n, a in first.items():
        np.testing.assert_array_equal(a, nets[1][n], err_msg=n)
    fixed = {"bias": 0.0, "beta": 0.0, "running_mean": 0.0, "gamma": 1.0,
             "running_var": 1.0}
    for n, a in first.items():
        suffix = n.rsplit(".", 1)[1]
        if suffix in fixed:
            assert (a == fixed[suffix]).all(), n
        elif a.ndim == 4:
            assert np.std(a) == pytest.approx(init.scale(a.shape), rel=0.2)
    w = net.features[0].weight
    before = w.detach().clone()
    net.initialize(initializer.Zero())
    assert torch.equal(w, before)
    net.initialize(initializer.Zero(), force_reinit=True)
    assert (w == 0).all() and (net.features[1].weight == 1).all()
