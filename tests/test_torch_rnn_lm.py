"""The recurrent slice as a whole, on the CPU: ``examples/rnn/word_lm.py``'s
``RNNModel`` (an embedding tied to the decoder through ``params=``, a
2-layer LSTM), narrow (vocabulary 50, width 16, dropout 0), built in both
packages from the script itself, the port's with ``mxnet_tpu`` rebound
(``tests/test_torch_gluon_examples.py::load_ported``), and the same
weights. Two truncated-BPTT steps of plain SGD, the states carried and
detached, the gradients clipped by ``gluon.utils.clip_global_norm`` to a
norm the first step's exceeds, against the JAX package's eager
``Trainer.step``: the losses, the states, the clip's norms and every
weight after each step within 1e-5. The tied weight is one parameter, in
both packages' ``collect_params``.
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

from test_torch_gluon_examples import EXAMPLES, load_ported
from test_torch_rnn import _scan  # noqa: F401  (the JAX side on scan)

TOL = 1e-5
VOCAB, WIDTH, LAYERS, B, T, CLIP = 50, 16, 2, 4, 6, 0.05


def _jax_script():
    path = os.path.join(EXAMPLES, "rnn/word_lm.py")
    spec = importlib.util.spec_from_file_location("jax_word_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train(pkg, script, init, batches):
    """Two steps; returns per step (loss, clip norm, states, weights)."""
    model = script.RNNModel(VOCAB, WIDTH, WIDTH, LAYERS, dropout=0.0,
                            tied=True)
    ctx = jmx.cpu() if pkg is jmx else mx.cpu()
    if pkg is jmx:
        model.initialize()
        for name, p in model._collect_params_with_prefix().items():
            p.set_data(jmx.nd.array(init[name]))
    else:
        from mxnet_tpu_torch.convert import params_from_mxnet_tpu
        model.initialize(ctx=ctx)
        with pkg.autograd.pause():
            model(pkg.nd.array(batches[0][0], ctx=ctx),
                  model.begin_state(B))
        model.load_state_dict(params_from_mxnet_tpu(init, model))
    params = model.collect_params()
    assert sum("weight" in n and "embedding" in n for n in params) == 1
    trainer = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 1.0})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    state = model.begin_state(B)
    trace = []
    for x, y in batches:
        state = [s.detach() for s in state]
        with pkg.autograd.record():
            out, state = model(pkg.nd.array(x, ctx=ctx), state)
            loss = loss_fn(out.reshape((-1, VOCAB)),
                           pkg.nd.array(y, ctx=ctx).reshape((-1,)))
        loss.backward()
        grads = [p.grad() for p in params.values()]
        norm = pkg.gluon.utils.clip_global_norm(grads, CLIP * B * T)
        trainer.step(B * T)
        trace.append((float(loss.mean().asscalar()), float(norm),
                      [s.asnumpy() for s in state],
                      {k: v.data().asnumpy() for k, v in
                       model._collect_params_with_prefix().items()}))
    return trace


def test_word_lm_two_clipped_sgd_steps_match_jax():
    rs = np.random.RandomState(0)
    batches = [(rs.randint(0, VOCAB, (T, B)).astype("float32"),
                rs.randint(0, VOCAB, (T, B)).astype("float32"))
               for _ in range(2)]
    jscript = _jax_script()
    probe = jscript.RNNModel(VOCAB, WIDTH, WIDTH, LAYERS, dropout=0.0)
    probe.initialize()
    init = {n: (rs.uniform(-0.1, 0.1, p.shape)).astype("float32")
            for n, p in probe._collect_params_with_prefix().items()}
    init["decoder.weight"] = init["encoder.weight"]
    want = _train(jmx, jscript, init, batches)
    with mx.cpu():
        got = _train(mx, load_ported("rnn/word_lm.py"), init, batches)
    assert want[0][1] > CLIP * B * T  # the clip acted
    for (tl, tn, ts, tw), (jl, jn, js, jw) in zip(got, want):
        assert tl == pytest.approx(jl, rel=TOL)
        assert tn == pytest.approx(jn, rel=TOL)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        assert sorted(tw) == sorted(jw)
        for name in tw:
            np.testing.assert_allclose(tw[name], jw[name], rtol=TOL,
                                       atol=TOL)
        assert np.array_equal(tw["encoder.weight"], tw["decoder.weight"])
