"""The port's Gluon layers, losses, initializers and utilities against the
JAX package's, on the CPU.

- every layer, built without its input size where it takes one
  (``Dense``, the convolutions and transposed convolutions with
  ``output_padding``, ``groups`` and ``dilation``, the four normalization
  layers) and the new ones (``ReflectionPad2D``, ``LeakyReLU``, ``PReLU``,
  ``ELU``, ``SELU``, ``Swish``, ``GELU``, ``Lambda``, ``HybridLambda``,
  ``Sequential``): the shapes its first forward resolves, then from the
  same numpy-seeded values its output, its input's gradient and its
  parameters' gradients in training mode (and a BatchNorm's running
  statistics), rtol 1e-4 / atol 1e-4 (fp32, as
  ``tests/test_torch_vision.py`` states);
- ``Dense(64)``, ``Conv2D(32, 3)`` and ``BatchNorm()`` built without
  sizes: one SGD step with momentum and weight decay, as in the JAX
  package;
- a stack of the new layers exports the JAX package's graph, node for
  node, and the same parameter names;
- each loss with and without ``sample_weight`` (and
  ``SigmoidBinaryCrossEntropyLoss``'s ``from_sigmoid`` and
  ``pos_weight``);
- the initializers ``Orthogonal`` (orthonormal rows or columns scaled
  by ``scale``, as the JAX package's), ``Bilinear`` and ``LSTMBias``
  (equal to the JAX package's), ``Mixed`` and ``Load``;
- ``gluon.utils``: ``split_data``, ``split_and_load``,
  ``clip_global_norm``, ``check_sha1`` and ``download``'s refusal.
"""
import hashlib
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import initializer as jinit

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd
from mxnet_tpu_torch import initializer as tinit

from test_torch_resnet_train import keep_zeros

RTOL, ATOL = 1e-4, 1e-4
CPU = mx.cpu()

# name -> (build(nn), input shape); no layer is told its input size
LAYERS = {
    "dense": (lambda nn: nn.Dense(6, activation="tanh"), (4, 3, 5)),
    "dense_no_flatten": (lambda nn: nn.Dense(6, flatten=False), (4, 3, 5)),
    "conv1d_groups": (lambda nn: nn.Conv1D(4, 3, padding=1, groups=2),
                      (2, 4, 9)),
    "conv2d_dilated": (lambda nn: nn.Conv2D(4, 3, strides=2, padding=2,
                                            dilation=2, activation="relu"),
                       (2, 3, 9, 9)),
    "conv3d": (lambda nn: nn.Conv3D(4, 2, use_bias=False), (2, 2, 5, 4, 4)),
    "conv1d_transpose": (lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, output_padding=1), (2, 3, 6)),
    "conv2d_transpose": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, groups=2),
        (2, 4, 5, 5)),
    "conv2d_transpose_dilated": (lambda nn: nn.Conv2DTranspose(
        3, 2, strides=1, dilation=2), (2, 2, 4, 4)),
    "conv3d_transpose": (lambda nn: nn.Conv3DTranspose(2, 2, strides=2),
                         (1, 2, 3, 3, 3)),
    "reflection_pad2d": (lambda nn: nn.ReflectionPad2D(2), (2, 3, 5, 5)),
    "batchnorm": (lambda nn: nn.BatchNorm(), (4, 3, 5, 5)),
    "instancenorm": (lambda nn: nn.InstanceNorm(scale=True), (2, 3, 4, 4)),
    "layernorm": (lambda nn: nn.LayerNorm(), (2, 3, 6)),
    "groupnorm": (lambda nn: nn.GroupNorm(num_groups=2), (2, 4, 3, 3)),
    "leaky_relu": (lambda nn: nn.LeakyReLU(0.1), (3, 7)),
    "prelu": (lambda nn: nn.PReLU(in_channels=3), (2, 3, 4)),
    "elu": (lambda nn: nn.ELU(0.5), (3, 7)),
    "selu": (lambda nn: nn.SELU(), (3, 7)),
    "swish": (lambda nn: nn.Swish(1.5), (3, 7)),
    "gelu": (lambda nn: nn.GELU(), (3, 7)),
    "lambda": (lambda nn: nn.Lambda("tanh"), (3, 7)),
    "hybrid_lambda": (lambda nn: nn.HybridLambda(
        lambda F, x: F.relu(x) * 2 + F.sigmoid(x)), (3, 7)),
    "sequential": (lambda nn: _sequential(nn), (3, 7)),
}


def _sequential(nn):
    net = nn.Sequential()
    with net.name_scope():
        net.add(nn.Dense(5, activation="relu"), nn.Dense(2))
    return net


def _values(params, seed):
    rng = np.random.RandomState(seed)
    return {n: (np.abs(rng.randn(*p.shape)) + 0.5 if n.endswith("var")
                else rng.randn(*p.shape) * 0.4).astype("float32")
            for n, p in sorted(params.items())}


def _port_run(make, x, seed=5):
    """Build, resolve with one forward outside recording, set seeded
    values, then one recorded forward and backward of ``sum(y * w)``:
    (shapes, y, dx, param grads, params after)."""
    layer = make(gluon.nn)
    layer.initialize()
    with autograd.pause():
        layer(nd.array(x))
    params = layer._collect_params_with_prefix()
    named = _values(params, seed)
    for n, p in params.items():
        p.set_data(nd.array(named[n]))
    xv = nd.array(x)
    xv.attach_grad()
    with autograd.record():
        y = layer(xv)
        loss = (y * nd.array(_w(y.shape))).sum()
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    return ({n: tuple(p.shape) for n, p in params.items()}, y.asnumpy(),
            xv.grad.asnumpy(), grads,
            {n: p.data().asnumpy() for n, p in params.items()})


def _w(shape):
    return np.random.RandomState(9).randn(*shape).astype("float32")


def _jax_run(make, x, seed=5):
    """The JAX package's side of :func:`_port_run`: shapes from its
    symbolic inference (no program compiled), then the training forward
    and backward as one program (``functional_call`` under
    ``jax.value_and_grad``), which returns the running statistics a
    BatchNorm writes."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.gluon.block import functional_call
    layer = make(jgluon.nn)
    params = layer._collect_params_with_prefix()
    if params:
        s = layer(jmx.sym.var("data"))
        args, _, aux = s.infer_shape(data=x.shape)
        by_name = dict(zip(s.list_arguments(), args))
        by_name.update(zip(s.list_auxiliary_states(), aux))
        for p in params.values():
            p.shape = by_name[p.name]
    named = _values(params, seed)
    for n, p in params.items():   # the values functional_call reads
        p._data = jmx.nd.array(named[n])
    trained = [n for n, p in params.items() if p.grad_req != "null"]

    @jax.jit
    def fb(pv, xv):
        def f(tv, xv):
            outs, aux = functional_call(layer, {**pv, **tv}, [xv],
                                        training=True)
            y = outs[0]
            return jnp.sum(y * jnp.asarray(_w(y.shape))), (y, aux)
        tv = {n: pv[n] for n in trained}
        (_, (y, aux)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(tv, xv)
        return y, gx, gp, aux

    y, gx, gp, aux = fb({n: jnp.asarray(v) for n, v in named.items()},
                        jnp.asarray(x))
    return ({n: tuple(p.shape) for n, p in params.items()}, np.asarray(y),
            np.asarray(gx), {n: np.asarray(g) for n, g in gp.items()},
            {n: np.asarray(aux.get(n, v)) for n, v in named.items()})


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_resolves_and_matches_the_jax_package(name):
    make, shape = LAYERS[name]
    x = np.random.RandomState(4).randn(*shape).astype("float32")
    want = _jax_run(make, x)
    with CPU:
        got = _port_run(make, x)
    assert got[0] == want[0]
    for g, w, what in zip(got[1:], want[1:], ("y", "dx", "grads",
                                               "params")):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), what
            for n in w:
                np.testing.assert_allclose(g[n], w[n], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=what)


def test_embedding_matches_the_jax_package():
    idx = np.array([[0, 3, 9], [2, 2, 7]], "float32")
    out = []
    for pkg in (jmx, mx):
        ag = jag if pkg is jmx else autograd
        with (jmx.cpu() if pkg is jmx else CPU):
            emb = (jgluon if pkg is jmx else gluon).nn.Embedding(10, 4)
            emb.initialize(keep_zeros if pkg is jmx else None)
            p = emb.collect_params()[emb.prefix + "weight"]
            p.set_data(pkg.nd.array(_values({"w": p}, 2)["w"]))
            with ag.record():
                y = emb(pkg.nd.array(idx))
                (y * y).sum().backward()
            out.append((y.asnumpy(), p.grad().asnumpy()))
    for g, w in zip(out[1], out[0]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _sgd_forward(pkg, layer, x):
    """Resolve, set seeded values, and one recorded forward and backward
    of ``sum(y * w)``, eagerly in either package."""
    ag = jag if pkg is jmx else autograd
    with ag.pause():
        layer(pkg.nd.array(x))
    params = layer._collect_params_with_prefix()
    named = _values(params, 5)
    for n, p in params.items():
        p.set_data(pkg.nd.array(named[n]))
    with ag.record():
        y = layer(pkg.nd.array(x))
        loss = (y * pkg.nd.array(_w(y.shape))).sum()
    loss.backward()
    return None, y.asnumpy(), None, None, None


SGD_LAYERS = {"dense": (lambda nn: nn.Dense(64), (4, 10)),
              "conv2d": (lambda nn: nn.Conv2D(32, 3), (2, 3, 6, 6)),
              "batchnorm": (lambda nn: nn.BatchNorm(), (4, 5, 3, 3))}


@pytest.mark.parametrize("name", sorted(SGD_LAYERS))
def test_layer_built_without_sizes_takes_the_jax_sgd_update(name):
    make, shape = SGD_LAYERS[name]
    x = np.random.RandomState(6).randn(*shape).astype("float32")
    out = []
    for pkg in (jmx, mx):
        glu = jgluon if pkg is jmx else gluon
        with (jmx.cpu() if pkg is jmx else CPU):
            layer = make(glu.nn)
            layer.initialize(keep_zeros if pkg is jmx else None)
            trainer = glu.Trainer(layer.collect_params(), "sgd", {
                "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3})
            _, y, _, _, _ = _sgd_forward(pkg, layer, x)
            trainer.step(shape[0])
            out.append((y, {n: p.data().asnumpy() for n, p in
                            layer._collect_params_with_prefix().items()}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=RTOL, atol=ATOL)
    for n, w in out[0][1].items():
        np.testing.assert_allclose(out[1][1][n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def _new_layer_stack(pkg):
    nn = (jgluon if pkg is jmx else gluon).nn
    net = nn.HybridSequential(prefix="new_")
    with net.name_scope():
        net.add(nn.ReflectionPad2D(1), nn.Conv2DTranspose(4, 3, strides=2),
                nn.InstanceNorm(), nn.GroupNorm(num_groups=2),
                nn.LeakyReLU(0.2), nn.PReLU(), nn.ELU(), nn.SELU(),
                nn.Swish(), nn.Conv2D(2, 1), nn.LayerNorm(axis=1),
                nn.Flatten(), nn.Dense(3))
    return net


def test_new_layers_export_the_jax_packages_graph(tmp_path):
    x = np.random.RandomState(1).randn(2, 3, 4, 4).astype("float32")
    files = {}
    for pkg, tag in ((jmx, "j"), (mx, "t")):
        with (jmx.cpu() if pkg is jmx else CPU):
            net = _new_layer_stack(pkg)
            net.initialize(keep_zeros if pkg is jmx else None)
            with (jag if pkg is jmx else autograd).pause():
                net(pkg.nd.array(x))
            with pkg.name.NameManager():
                net.export(str(tmp_path / tag))
            files[tag] = (json.load(open(tmp_path / f"{tag}-symbol.json")),
                          pkg.nd.load(str(tmp_path / f"{tag}-0000.params")))
    assert files["t"][0] == files["j"][0]
    assert sorted(files["t"][1]) == sorted(files["j"][1])


# loss -> (build(loss module), prediction shape, label(rng, shape))
def _signed(rng, shape):
    return np.sign(rng.randn(*shape)).astype("float32")


LOSSES = {
    "l2": (lambda L: L.L2Loss(), (4, 3), None),
    "l1": (lambda L: L.L1Loss(weight=2.0), (4, 3), None),
    "sigmoid_bce": (lambda L: L.SigmoidBinaryCrossEntropyLoss(), (4, 3),
                    lambda r, s: (r.rand(*s) > 0.5).astype("float32")),
    "sigmoid_bce_from_sigmoid": (
        lambda L: L.SigmoidBCELoss(from_sigmoid=True), (4, 3),
        lambda r, s: (r.rand(*s) > 0.5).astype("float32")),
    "softmax_ce": (lambda L: L.SoftmaxCrossEntropyLoss(), (4, 5),
                   lambda r, s: r.randint(0, s[1], s[0]).astype("float32")),
    "kldiv": (lambda L: L.KLDivLoss(from_logits=False), (4, 5),
              lambda r, s: (lambda p: p / p.sum(1, keepdims=True))(
                  r.rand(*s) + 0.1).astype("float32")),
    "huber": (lambda L: L.HuberLoss(rho=0.5), (4, 3), None),
    "hinge": (lambda L: L.HingeLoss(), (4, 3), _signed),
    "squared_hinge": (lambda L: L.SquaredHingeLoss(margin=2), (4, 3),
                      _signed),
    "logistic": (lambda L: L.LogisticLoss(), (4, 3), _signed),
    "logistic_binary": (lambda L: L.LogisticLoss(label_format="binary"),
                        (4, 3), lambda r, s: (r.rand(*s) > 0.5)
                        .astype("float32")),
    "poisson_nll": (lambda L: L.PoissonNLLLoss(compute_full=True), (4, 3),
                    lambda r, s: r.randint(0, 4, s).astype("float32")),
}


def _loss_args(name, rng):
    make, shape, label = LOSSES[name]
    pred = rng.randn(*shape).astype("float32")
    if name == "sigmoid_bce_from_sigmoid":
        pred = 1 / (1 + np.exp(-pred))
    lab = rng.randn(*shape).astype("float32") if label is None \
        else label(rng, shape)
    return make, [pred, lab]


def _loss_value(pkg, make, arrays, sample_weight, pos_weight=None):
    loss = make((jgluon if pkg is jmx else gluon).loss)
    args = [pkg.nd.array(a) for a in arrays]
    args.append(None if sample_weight is None
                else pkg.nd.array(sample_weight))
    if pos_weight is not None:
        args.append(pkg.nd.array(pos_weight))
    return loss(*args).asnumpy()


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "sample_weight"])
@pytest.mark.parametrize("name", sorted(LOSSES) + ["triplet", "cosine",
                                                   "sigmoid_bce_pos_weight"])
def test_loss_matches_the_jax_package(name, weighted):
    rng = np.random.RandomState(len(name))
    kw = {}
    if name == "triplet":
        make = lambda L: L.TripletLoss(margin=0.5)  # noqa: E731
        arrays = [rng.randn(4, 3).astype("float32") for _ in range(3)]
    elif name == "cosine":
        make = lambda L: L.CosineEmbeddingLoss(margin=0.1)  # noqa: E731
        arrays = [rng.randn(4, 3).astype("float32"),
                  rng.randn(4, 3).astype("float32"),
                  np.array([1, -1, 1, -1], "float32")]
    elif name == "sigmoid_bce_pos_weight":
        make = lambda L: L.SigmoidBCELoss()  # noqa: E731
        arrays = [rng.randn(4, 3).astype("float32"),
                  (rng.rand(4, 3) > 0.5).astype("float32")]
        kw = {"pos_weight": np.array([0.5, 2.0, 3.0], "float32")}
    else:
        make, arrays = _loss_args(name, rng)
    sw = None
    if weighted:
        sw = rng.rand(4, 1).astype("float32")
        if name in ("triplet", "cosine"):
            sw = sw[:, 0]
    want = _loss_value(jmx, make, arrays, sw, **kw)
    with CPU:
        got = _loss_value(mx, make, arrays, sw, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_orthogonal_gives_scaled_orthonormal_rows_as_the_jax_package():
    for init_mod, pkg in ((jinit, jmx), (tinit, mx)):
        for shape in ((6, 10), (10, 3, 2)):
            with (jmx.cpu() if pkg is jmx else CPU):
                arr = pkg.nd.zeros(shape)
                init_mod.Orthogonal(scale=2.0)(init_mod.InitDesc("w_weight"),
                                               arr)
            a = arr.asnumpy().reshape(shape[0], -1)
            g = a @ a.T if a.shape[0] <= a.shape[1] else a.T @ a
            np.testing.assert_allclose(g, 4 * np.eye(len(g)), atol=1e-4)
    with CPU:
        arr = nd.zeros((6, 10))
        tinit.Orthogonal(rand_type="normal")("w_weight", arr)
    a = arr.asnumpy()
    np.testing.assert_allclose(a @ a.T, 1.414 ** 2 * np.eye(6), atol=1e-4)


@pytest.mark.parametrize("which", ["bilinear", "lstmbias"])
def test_deterministic_initializers_equal_the_jax_packages(which):
    shape = (3, 2, 4, 4) if which == "bilinear" else (12,)
    out = []
    for init_mod, pkg in ((jinit, jmx), (tinit, mx)):
        with (jmx.cpu() if pkg is jmx else CPU):
            arr = pkg.nd.zeros(shape)
            init = init_mod.Bilinear() if which == "bilinear" \
                else init_mod.LSTMBias(forget_bias=2.0)
            init(init_mod.InitDesc("x_weight"), arr)
            out.append(arr.asnumpy())
    np.testing.assert_array_equal(out[1], out[0])


def test_mixed_and_load_initializers(tmp_path):
    with CPU:
        mixed = tinit.Mixed(["fc_.*", ".*"], [tinit.Constant(3.0), "ones"])
        b, w = nd.zeros((2,)), nd.zeros((2, 2))
        mixed("fc_weight", w)
        mixed("out_weight", b)
        assert (w.asnumpy() == 3).all() and (b.asnumpy() == 1).all()
        with pytest.raises(ValueError, match="did not match"):
            tinit.Mixed(["a"], ["ones"])("b", w)
        f = str(tmp_path / "init.params")
        nd.save(f, {"arg:fc_weight": nd.array(np.full((2, 2), 5.0))})
        load = tinit.Load(f, default_init=tinit.Zero())
        load("fc_weight", w)
        load("fc_bias", b)
        assert (w.asnumpy() == 5).all() and not b.asnumpy().any()
        with pytest.raises(MXNetError, match="shape mismatch"):
            load("fc_weight", nd.zeros((3,)))
        # by name inside a block's initialize
        net = gluon.nn.Dense(2, in_units=2, prefix="fc_")
        net.initialize(tinit.Load({"fc_weight": np.eye(2, dtype="float32")},
                                  default_init="zeros"))
        np.testing.assert_array_equal(net.weight.detach().numpy(), np.eye(2))


def test_split_and_load_and_clip_global_norm_match_the_jax_package():
    from mxnet_tpu.gluon import utils as jutils
    from mxnet_tpu_torch.gluon import utils as tutils
    x = np.arange(30, dtype="float32").reshape(10, 3)
    for even in (True, False):
        n = 2 if even else 3
        want = [s.asnumpy() for s in jutils.split_data(jmx.nd.array(x), n,
                                                       even_split=even)]
        with CPU:
            got = [s.asnumpy() for s in tutils.split_data(
                nd.array(x), n, even_split=even)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="evenly"):
        tutils.split_data(np.zeros((5, 2)), 2)
    parts = tutils.split_and_load(x, [CPU, CPU], batch_axis=1,
                                  even_split=False)
    assert [p.shape for p in parts] == [(10, 1), (10, 2)]
    assert all(p.context == CPU for p in parts)
    arrays = [np.random.RandomState(i).randn(3, 4).astype("float32")
              for i in range(3)]
    jarr = [jmx.nd.array(a) for a in arrays]
    with CPU:
        tarr = [nd.array(a) for a in arrays]
        tn = tutils.clip_global_norm(tarr, 1.0)
    jn = jutils.clip_global_norm(jarr, 1.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-5)
    for t, j in zip(tarr, jarr):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL,
                                   atol=1e-6)


def test_check_sha1_and_download_refusal(tmp_path):
    from mxnet_tpu_torch.gluon import utils as tutils
    f = tmp_path / "data.bin"
    f.write_bytes(b"mxnet")
    assert tutils.check_sha1(str(f), hashlib.sha1(b"mxnet").hexdigest())
    assert not tutils.check_sha1(str(f), "0" * 40)
    assert tutils.download("http://host/data.bin", str(tmp_path)) == str(f)
    with pytest.raises(MXNetError, match="no network path"):
        tutils.download("http://host/other.bin", str(tmp_path))
