"""The port's recurrent stack against the JAX package's, on the CPU.

- the ``RNN`` op for ``rnn_relu``, ``rnn_tanh``, ``lstm`` and ``gru``,
  with one layer one way and two layers both ways, ``state_outputs`` on:
  outputs and final states within 1e-5 (max abs), the gradients with
  respect to the data, the flat parameters and the states within 1e-4
  relative L2, the JAX side's time loop pinned to ``scan``
  (``MXNET_OPTUNE_CHOICE_RNN_<MODE>``) so that it compiles one lowering
  and times nothing; ``nd.RNN`` through the registry and
  ``_rnn_param_concat`` against the op;
- the flat parameter layout (sizes, the input size a length implies, the
  views of each layer and direction) against the JAX package's;
- the Gluon ``RNN``, ``LSTM`` and ``GRU`` layers in both layouts, built
  without their input size, the weights carried by ``convert.py``:
  outputs, states and gradients at the same limits (the cells are
  ``tests/test_torch_rnn_cells.py``'s);
- the layers' dropout between layers: its rate, its scale, its absence
  outside training and its generator;
- the arguments both packages accept and ignore (``projection_size``,
  ``lstm_state_clip_*``, ``use_sequence_length``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.ops import rnn as jrnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.ops import rnn as trnn

OUT_TOL = 1e-5   # max abs, outputs and states
GRAD_TOL = 1e-4  # relative L2, gradients
T, B, I, H = 5, 3, 4, 6
MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")


@pytest.fixture(autouse=True)
def _scan(monkeypatch):
    for mode in MODES:
        monkeypatch.setenv(f"MXNET_OPTUNE_CHOICE_RNN_{mode.upper()}", "scan")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _op_inputs(mode, layers, bidir, seed=0):
    rs = np.random.RandomState(seed)
    ndir = 2 if bidir else 1
    n = trnn.rnn_param_size(mode, layers, I, H, bidir)
    return {"data": rs.randn(T, B, I).astype("float32"),
            "params": (rs.randn(n) * 0.4).astype("float32"),
            "h0": rs.randn(layers * ndir, B, H).astype("float32"),
            "c0": rs.randn(layers * ndir, B, H).astype("float32"),
            "heads": [rs.randn(T, B, ndir * H).astype("float32"),
                      rs.randn(layers * ndir, B, H).astype("float32"),
                      rs.randn(layers * ndir, B, H).astype("float32")]}


def _weighted(outs, heads):
    return sum((o * h).sum() for o, h in zip(outs, heads[:len(outs)]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, True)])
def test_flat_layout_matches_jax(mode, layers, bidir):
    n = trnn.rnn_param_size(mode, layers, I, H, bidir)
    assert n == jrnn.rnn_param_size(mode, layers, I, H, bidir)
    assert trnn.rnn_input_size(n, mode, layers, H, bidir) == I
    with pytest.raises(ValueError):
        trnn.rnn_input_size(n + 1, mode, layers, H, bidir)
    flat = np.arange(n, dtype=np.float32)
    got = trnn.unpack_rnn_params(torch.from_numpy(flat), mode, layers, I, H,
                                 bidir)
    jw, jb = jrnn.unpack_rnn_params(flat, mode, layers, I, H, bidir)
    want = [t for lw, lb in zip(jw, jb) for (wi, wh), (bi, bh) in zip(lw, lb)
            for t in (wi, wh, bi, bh)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the symbolic fused cell names the same slices
    cell = mx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                               bidirectional=bidir)
    sl = cell._slices(I)
    assert [off for _, off, _ in sl] == sorted(off for _, off, _ in sl)
    assert sl[-1][1] + sl[-1][2][0] == n
    assert {shape for _, _, shape in sl} == {tuple(t.shape) for t in got}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, True)])
def test_rnn_op_matches_jax(mode, layers, bidir):
    x = _op_inputs(mode, layers, bidir)
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidir, state_outputs=True)
    lstm = mode == "lstm"
    n_out = 3 if lstm else 2

    def jax_loss(d, p, h, c):
        rest = (c,) if lstm else ()
        outs = jrnn.rnn(d, p, h, *rest, **kw)[:n_out]
        return _weighted(outs, [jnp.asarray(a) for a in x["heads"]]), outs

    names = ["data", "params", "h0", "c0"]
    jargs = [jnp.asarray(x[k]) for k in names]
    (jl, jouts), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True))(*jargs)

    targs = [torch.tensor(x[k], requires_grad=True) for k in names]
    rest = (targs[3],) if lstm else ()
    touts = trnn.rnn(targs[0], targs[1], targs[2], *rest, **kw)[:n_out]
    _weighted(touts, [torch.from_numpy(a) for a in x["heads"]]).backward()
    for t, j in zip(touts, jouts):
        assert max_abs(t.detach().numpy(), j) <= OUT_TOL
    for name, t, j in zip(names, targs, jgrads):
        if name == "c0" and not lstm:
            assert t.grad is None
            continue
        assert rel_l2(t.grad.numpy(), j) <= GRAD_TOL, name

    # nd.RNN (the registry, visible outputs) and _rnn_param_concat
    with mx.cpu():
        args = [nd.array(x[k]) for k in names[:3 + lstm]]
        got = nd.RNN(*args, **kw)
        assert len(got) == n_out
        for g, t in zip(got, touts):
            assert np.array_equal(g.asnumpy(), t.detach().numpy())
        pieces = [nd.array(x["params"][:7]), nd.array(x["params"][7:])]
        assert np.array_equal(nd._rnn_param_concat(*pieces).asnumpy(),
                              x["params"])
        assert np.array_equal(
            nd.RNN(*args, **dict(kw, state_outputs=False)).asnumpy(),
            touts[0].detach().numpy())


def _carry(jblock, tblock):
    named = {k: v.data().asnumpy()
             for k, v in jblock._collect_params_with_prefix().items()}
    tblock.load_state_dict(params_from_mxnet_tpu(named, tblock))


class _JWrap(jgluon.Block):
    def __init__(self, inner, fn):
        super().__init__()
        self.inner = inner
        self._fn = fn

    def forward(self, *args):
        return self._fn(self.inner, *args)


def jax_forward_backward(jblock, fn, inputs, training=True):
    """``fn(jblock, *inputs)`` -> ``[loss, *outputs]`` (NDArrays) run by
    the JAX package as one compiled program (its ``functional_call``
    under ``jax.value_and_grad``): the outputs, the gradients of the loss
    with respect to ``inputs`` and to each parameter (by structural
    name), as numpy arrays. One compile in place of the eager per-op
    ones."""
    from mxnet_tpu.gluon.block import functional_call
    wrap = _JWrap(jblock, fn)
    pv = {n: p.data()._data
          for n, p in wrap._collect_params_with_prefix().items()}

    @jax.jit
    def fb(pv, xs):
        def f(pv, xs):
            outs, _ = functional_call(wrap, pv, list(xs), training=training)
            return outs[0], outs[1:]
        (_, outs), grads = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(pv, xs)
        return outs, grads

    outs, (gp, gx) = fb(pv, [jnp.asarray(a) for a in inputs])
    return ([np.asarray(o) for o in outs], [np.asarray(g) for g in gx],
            {n[len("inner."):]: np.asarray(g) for n, g in gp.items()})


def port_forward_backward(tblock, fn, inputs, training=True):
    """The same through the port's API: NDArrays under
    ``autograd.record``, ``backward``, ``Parameter.grad()``."""
    xs = [nd.array(a) for a in inputs]
    for x in xs:
        x.attach_grad()
    with autograd.record(train_mode=training):
        outs = fn(tblock, *xs)
    outs[0].backward()
    return ([o.asnumpy() for o in outs[1:]], [x.grad.asnumpy() for x in xs],
            {n: p.grad().asnumpy()
             for n, p in tblock._collect_params_with_prefix().items()})


def assert_matches(port, jax_, grads_of=None):
    """Outputs within OUT_TOL, and the gradients of the inputs in
    ``grads_of`` (all by default) and of every parameter within
    GRAD_TOL."""
    (touts, tgx, tgp), (jouts, jgx, jgp) = port, jax_
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert t.shape == j.shape
        assert max_abs(t, j) <= OUT_TOL
    for i in grads_of if grads_of is not None else range(len(tgx)):
        assert rel_l2(tgx[i], jgx[i]) <= GRAD_TOL, i
    assert sorted(tgp) == sorted(jgp)
    for name in tgp:
        assert rel_l2(tgp[name], jgp[name]) <= GRAD_TOL, name


def _squares(out, states):
    return (out * out).sum() + sum((s * s).sum() for s in states)


LAYERS = {"rnn_relu": lambda g, **k: g.rnn.RNN(H, activation="relu", **k),
          "rnn_tanh": lambda g, **k: g.rnn.RNN(H, activation="tanh", **k),
          "lstm": lambda g, **k: g.rnn.LSTM(H, **k),
          "gru": lambda g, **k: g.rnn.GRU(H, **k)}


def _layer_fn(block, x, *states):
    out, st = block(x, list(states))
    return [_squares(out, st), out] + list(st)


@pytest.mark.parametrize("mode,layout", [
    ("rnn_relu", "TNC"), ("rnn_tanh", "NTC"), ("lstm", "TNC"),
    ("lstm", "NTC"), ("gru", "TNC"), ("gru", "NTC")])
def test_gluon_layer_matches_jax(mode, layout):
    bidir, layers = layout == "NTC", 2
    rs = np.random.RandomState(1)
    shape = (T, B, I) if layout == "TNC" else (B, T, I)
    x = rs.randn(*shape).astype("float32")
    n_states = 2 if mode == "lstm" else 1
    states = [rs.randn(layers * (1 + bidir), B, H).astype("float32")
              for _ in range(n_states)]
    kw = dict(num_layers=layers, layout=layout, bidirectional=bidir)
    jl = LAYERS[mode](jgluon, input_size=I, **kw)
    tl = LAYERS[mode](gluon, **kw)
    jl.initialize()
    assert tl.param("l0_i2h_weight").shape[1] == 0
    with mx.cpu():
        tl.initialize(ctx=mx.cpu())
        with autograd.pause():
            tl(nd.array(x))
        assert tl.param("l0_i2h_weight").shape[1] == I
        assert [n[len(tl.prefix):] for n in tl.collect_params()] == \
            [n[len(jl.prefix):] for n in jl.collect_params()]
        _carry(jl, tl)
        port = port_forward_backward(tl, _layer_fn, [x] + states)
        # without states: the outputs alone, from begin_state's zeros
        begin = tl.begin_state(batch_size=B)
        assert np.array_equal(tl(nd.array(x)).asnumpy(),
                              tl(nd.array(x), begin)[0].asnumpy())
    assert [s.shape for s in begin] == [(layers * (1 + bidir), B, H)] \
        * n_states
    for s in port[0][1:]:
        assert s.shape == (layers * (1 + bidir), B, H)
    assert_matches(port, jax_forward_backward(jl, _layer_fn, [x] + states))


def test_layer_dropout_rate_scale_and_generator():
    """Two ``rnn_relu`` layers whose weights pass a positive input through
    unchanged: the second layer sees the first's output after the
    between-layer dropout, so the output over the input is 0 or
    ``1 / (1 - p)``, 0 at rate ``p``; outside training it is the input."""
    p, n, Tn, Bn = 0.5, 16, 8, 64
    eye = torch.eye(n)
    zeros = torch.zeros(n, n)
    with mx.cpu():
        layer = gluon.rnn.RNN(n, num_layers=2, activation="relu",
                              dropout=p, input_size=n)
        layer.initialize(ctx=mx.cpu())
    with torch.no_grad():
        for i in range(2):
            getattr(layer, f"l{i}_i2h_weight").copy_(eye)
            getattr(layer, f"l{i}_h2h_weight").copy_(zeros)
    x = torch.rand(Tn, Bn, n) + 0.5

    def run(train):
        with autograd.record(train_mode=train):
            return layer(x).detach()

    ratio = (run(True) / x).numpy()
    assert np.all(np.isclose(ratio, 0) | np.isclose(ratio, 1 / (1 - p)))
    assert abs((ratio == 0).mean() - p) < 0.03
    assert torch.equal(run(False), x)
    layer.manual_seed(7)
    a = run(True)
    layer.manual_seed(7)
    assert torch.equal(a, run(True))
    # the op's own dropout: between layers only, by its generator
    gen = torch.Generator().manual_seed(3)
    w = [eye, zeros, torch.zeros(n), torch.zeros(n)] * 2
    out, _, _ = trnn.rnn_forward(x, w, torch.zeros(2, Bn, n), None,
                                 "rnn_relu", 2, False, p, True, gen)
    r = (out / x).numpy()
    assert abs((r == 0).mean() - p) < 0.03
    single, _, _ = trnn.rnn_forward(x, w[:4], torch.zeros(1, Bn, n), None,
                                    "rnn_relu", 1, False, p, True, gen)
    assert torch.equal(single, x)


def test_ignored_arguments_change_nothing():
    x = _op_inputs("lstm", 1, False, seed=3)
    base = dict(state_size=H, num_layers=1, mode="lstm",
                state_outputs=True)
    extra = dict(base, projection_size=3, lstm_state_clip_min=-0.01,
                 lstm_state_clip_max=0.01, lstm_state_clip_nan=True,
                 use_sequence_length=True)
    args = [x[k] for k in ("data", "params", "h0", "c0")]
    lengths = np.array([1, 2, 3], "float32")
    jwith = jrnn.rnn(*map(jnp.asarray, args), jnp.asarray(lengths), **extra)
    jwithout = jrnn.rnn(*map(jnp.asarray, args), **base)
    twith = trnn.rnn(*map(torch.from_numpy, args), torch.from_numpy(lengths),
                     **extra)
    twithout = trnn.rnn(*map(torch.from_numpy, args), **base)
    for a, b, c, d in zip(jwith, jwithout, twith, twithout):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert torch.equal(c, d)
        assert max_abs(c.numpy(), a) <= OUT_TOL
    # the layer keeps projection_size and never reads it
    with mx.cpu():
        xs = nd.array(x["data"])
        plain = gluon.rnn.LSTM(H, input_size=I)
        proj = gluon.rnn.LSTM(H, input_size=I, projection_size=2)
        plain.initialize(ctx=mx.cpu())
        proj.initialize(ctx=mx.cpu())
        proj.load_state_dict(plain.state_dict())
        assert np.array_equal(proj(xs).asnumpy(), plain(xs).asnumpy())
    jproj = jgluon.rnn.LSTM(H, input_size=I, projection_size=2)
    assert jproj._projection_size == proj._projection_size == 2
