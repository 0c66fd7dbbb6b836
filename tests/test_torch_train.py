"""The port's training path against the JAX package's, on the CPU.

Losses, the autograd scopes with Dropout, and the whole Gluon step::

    with autograd.record():
        loss = loss_fn(model(tokens).reshape(-1, V), labels.reshape(-1))
        scaled = loss * LOSS_SCALE
    autograd.backward(scaled)
    trainer.step(batch * LOSS_SCALE)

on a small BERTModel (and, in fp32, a small causal TransformerLM with
128-wide heads, the GPT path's head dim) built in both packages from the
same numpy-seeded weights, with the same token ids and labels. The JAX side runs once per
module, each step's forward and backward one compiled program
(``functional_call`` under ``jax.value_and_grad``, as
``test_torch_resnet_train.py``'s), then its eager ``Trainer.step``.
Tolerances:

- losses: rtol/atol 1e-6 (the same fp32 formula);
- fp32 training, two SGD-momentum steps: losses and every weight within
  rtol 2e-4 / atol 2e-5 (XLA:CPU and ATen sum the products in different
  orders, and attention is the flash kernel's plain version here and
  dense ``local_attention`` there);
- fp16 multi-precision training, two steps: losses within 1e-2 (fp16
  logits rounded at other places: the port's attention computes in fp32
  inside, the JAX package's in fp16) and the fp32 master weights within
  atol 1e-3 (an update of |lr * g| up to ~0.05, whose fp16 gradient
  differs by its own rounding).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jax_autograd
from mxnet_tpu import gluon as jax_gluon
from mxnet_tpu.models import transformer as jax_tf
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.convert import (mxnet_tpu_shapes, params_from_mxnet_tpu,
                                     params_to_mxnet_tpu)
from mxnet_tpu_torch.gluon import Trainer, collect_params
from mxnet_tpu_torch.gluon import loss as torch_loss
from mxnet_tpu_torch.gluon.nn import Dropout
from mxnet_tpu_torch.models import BERTModel, TransformerLM

from test_torch_resnet_train import jax_train_mode_step, keep_zeros

V, C, L, H, FFN, T, B = 100, 64, 2, 4, 128, 32, 2
LR, MOMENTUM, LOSS_SCALE, STEPS = 0.1, 0.9, 8.0, 2
RTOL32, ATOL32 = 2e-4, 2e-5
LOSS_TOL16, MASTER_ATOL16 = 1e-2, 1e-3


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, V, (B, T)).astype("int32"),
            rng.randint(0, V, (B, T)).astype("float32"))


def _weights(shapes):
    """N(0, 0.05) matrices and biases, LayerNorm gamma around 1."""
    rng = np.random.RandomState(1)
    out = {}
    for name, shape in sorted(shapes.items()):
        w = rng.randn(*shape).astype("float32") * 0.05
        out[name] = w + 1.0 if name.endswith("gamma") else w
    return out


# the causal model: 2 layers of 2 heads of 128
GPT_CFG = dict(vocab_size=V, units=256, num_layers=2, num_heads=2,
               hidden_size=512, max_len=64, dropout=0.0, causal=True)


def _jax_train(dtype, gpt=False):
    tokens, labels = _batch()
    net = jax_tf.TransformerLM(**GPT_CFG) if gpt else jax_tf.BERTModel(
        vocab_size=V, units=C, num_layers=L, num_heads=H, hidden_size=FFN,
        max_len=64, dropout=0.0)
    net.initialize(keep_zeros)   # every value is set below
    # the deferred dims (input widths) from the port's model of the same
    # configuration: a first eager forward here compiles every op of the
    # net once more. The names must be JAX's own, and the shape setter
    # holds every dim that JAX declares; test_torch_transformer.py holds
    # BERTModel's whole shapes to JAX's after a JAX forward
    port = TransformerLM(**GPT_CFG, device="cpu") if gpt else BERTModel(
        vocab_size=V, units=C, num_layers=L, num_heads=H, hidden_size=FFN,
        max_len=64, dropout=0.0, device="cpu")
    shapes = mxnet_tpu_shapes(port)
    params = net._collect_params_with_prefix()
    assert set(params) == set(shapes)
    for n, p in params.items():
        p.shape = shapes[n]   # asserts the dims JAX knows (not 0) agree
        p._finish_deferred_init()
    named = _weights({n: tuple(p.shape) for n, p in params.items()})
    for n, p in params.items():
        p.set_data(mx.nd.array(named[n]))
    if dtype == "float16":
        net.cast("float16")
    trainer = jax_gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": LR, "momentum": MOMENTUM,
        "multi_precision": dtype == "float16"})
    loss_fn = jax_gluon.loss.SoftmaxCrossEntropyLoss()
    # the recorded forward and backward as one compiled program (the
    # eager loss ops and the hybridized backward compiled ~77 programs a
    # run), then the eager Trainer.step. The global key is made before
    # the trace, so that the (rate 0) dropout layers draw no tracer into it
    mx.random.seed(0)
    step = jax_train_mode_step(
        net, lambda out, y: loss_fn(out.reshape((-1, V)), y), LOSS_SCALE)
    x = mx.nd.array(tokens, dtype="int32")
    y = mx.nd.array(labels.reshape(-1))
    losses = []
    for _ in range(STEPS):
        loss = step(x, y)
        trainer.step(B * T * LOSS_SCALE)
        losses.append(loss.asnumpy().astype("float32"))
    weights = {n: p.data().asnumpy() for n, p in params.items()}
    index = {p.name: i for i, p in enumerate(net.collect_params().values())}
    states = trainer._updaters[0].states
    masters = {n: states[index[p.name]][0].asnumpy()
               for n, p in params.items()} if dtype == "float16" else None
    return {"named": named, "names": list(params), "losses": losses,
            "weights": weights, "masters": masters}


@pytest.fixture(scope="module")
def jax_runs():
    return {dt: _jax_train(dt) for dt in ("float32", "float16")}


def _port_train(named, dtype, gpt=False):
    tokens, labels = _batch()
    torch.manual_seed(0)
    if gpt:
        model = TransformerLM(**GPT_CFG, device="cpu",
                              dtype=getattr(torch, dtype))
    else:
        model = BERTModel(vocab_size=V, units=C, num_layers=L, num_heads=H,
                          hidden_size=FFN, max_len=64, dropout=0.0,
                          device="cpu", dtype=getattr(torch, dtype))
    model.load_state_dict(params_from_mxnet_tpu(named, model))
    params = collect_params(model)
    trainer = Trainer(params, "sgd", {"learning_rate": LR,
                                      "momentum": MOMENTUM,
                                      "multi_precision": dtype == "float16"})
    loss_fn = torch_loss.SoftmaxCrossEntropyLoss()
    tok = torch.from_numpy(tokens).long()
    lab = torch.from_numpy(labels.reshape(-1))
    losses = []
    for _ in range(STEPS):
        with autograd.record():
            loss = loss_fn(model(tok).reshape(-1, V), lab)
            scaled = loss * LOSS_SCALE
        autograd.backward(scaled)
        trainer.step(B * T * LOSS_SCALE)
        losses.append(loss.detach().float().numpy())
    masters = {n: trainer._updaters[0].states[i][0].numpy()
               for i, n in enumerate(params)} if dtype == "float16" else None
    return losses, params_to_mxnet_tpu(model), masters


def test_fp32_sgd_momentum_steps_match_jax(jax_runs):
    run = jax_runs["float32"]
    want_losses, want_w = run["losses"], run["weights"]
    losses, weights, _ = _port_train(run["named"], "float32")
    assert sorted(weights) == sorted(want_w)
    for got, want in zip(losses, want_losses):
        np.testing.assert_allclose(got, want, rtol=RTOL32, atol=ATOL32)
    assert losses[1].mean() < losses[0].mean()
    for name in want_w:
        np.testing.assert_allclose(weights[name], want_w[name], rtol=RTOL32,
                                   atol=ATOL32, err_msg=name)


def test_fp32_causal_wide_head_steps_match_jax():
    """A causal TransformerLM with 128-wide heads (the GPT path's head dim,
    whose backward takes csrc/flash_bwd_tc32_d128.cu on the card), two fp32
    SGD-momentum steps: losses and weights as the BERT model's."""
    run = _jax_train("float32", gpt=True)
    losses, weights, _ = _port_train(run["named"], "float32", gpt=True)
    assert sorted(weights) == sorted(run["weights"])
    for got, want in zip(losses, run["losses"]):
        np.testing.assert_allclose(got, want, rtol=RTOL32, atol=ATOL32)
    assert losses[1].mean() < losses[0].mean()
    for name, want in run["weights"].items():
        np.testing.assert_allclose(weights[name], want, rtol=RTOL32,
                                   atol=ATOL32, err_msg=name)


def test_fp16_multi_precision_steps_match_jax(jax_runs):
    run = jax_runs["float16"]
    want_losses, want_m = run["losses"], run["masters"]
    losses, weights, masters = _port_train(run["named"], "float16")
    for got, want in zip(losses, want_losses):
        np.testing.assert_allclose(got, want, atol=LOSS_TOL16)
    assert all(w.dtype == np.float16 for w in weights.values())
    for name in want_m:
        assert masters[name].dtype == np.float32
        np.testing.assert_allclose(masters[name], want_m[name], rtol=0,
                                   atol=MASTER_ATOL16, err_msg=name)
        np.testing.assert_array_equal(weights[name],
                                      masters[name].astype(np.float16))


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_cross_entropy_matches_jax(sparse, weighted):
    rng = np.random.RandomState(2)
    pred = rng.randn(6, 9).astype("float32")
    label = rng.randint(0, 9, 6).astype("float32") if sparse else \
        np.abs(rng.randn(6, 9)).astype("float32")
    sw = rng.rand(6, 1).astype("float32") if weighted else None
    kw = dict(sparse_label=sparse, weight=0.7 if weighted else None)
    jl = jax_gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    tl = torch_loss.SoftmaxCrossEntropyLoss(**kw)
    want = jl(mx.nd.array(pred), mx.nd.array(label),
              None if sw is None else mx.nd.array(sw)).asnumpy()
    got = tl(torch.from_numpy(pred), torch.from_numpy(label),
             None if sw is None else torch.from_numpy(sw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_softmax_cross_entropy_axis_and_from_logits_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.randn(3, 5, 4).astype("float32")
    label = rng.randint(0, 5, (3, 4)).astype("float32")
    for kw in (dict(axis=1), dict(axis=1, from_logits=True),
               dict(axis=1, batch_axis=1)):
        want = jax_gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
            mx.nd.array(pred), mx.nd.array(label)).asnumpy()
        got = torch_loss.SoftmaxCrossEntropyLoss(**kw)(
            torch.from_numpy(pred), torch.from_numpy(label)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_l2_loss_matches_jax(weighted):
    rng = np.random.RandomState(4)
    pred = rng.randn(5, 3, 2).astype("float32")
    label = rng.randn(5, 6).astype("float32")
    sw = rng.rand(5, 1, 1).astype("float32") if weighted else None
    want = jax_gluon.loss.L2Loss(weight=2.0)(
        mx.nd.array(pred), mx.nd.array(label),
        None if sw is None else mx.nd.array(sw)).asnumpy()
    got = torch_loss.L2Loss(weight=2.0)(
        torch.from_numpy(pred), torch.from_numpy(label),
        None if sw is None else torch.from_numpy(sw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _scopes(ag):
    """(is_recording, is_training) outside and inside nested scopes."""
    seen = [(ag.is_recording(), ag.is_training())]
    with ag.record():
        seen.append((ag.is_recording(), ag.is_training()))
        with ag.pause():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.train_mode():
                seen.append((ag.is_recording(), ag.is_training()))
        with ag.predict_mode():
            seen.append((ag.is_recording(), ag.is_training()))
    with ag.record(train_mode=False):
        seen.append((ag.is_recording(), ag.is_training()))
    seen.append((ag.is_recording(), ag.is_training()))
    return seen


def test_autograd_scopes_match_jax():
    assert _scopes(autograd) == _scopes(jax_autograd)


def test_dropout_acts_exactly_when_training():
    x = torch.ones(4000)
    drop = Dropout(0.5, device="cpu")
    drop.manual_seed(3)
    assert torch.equal(drop(x), x)
    with autograd.record():
        y = drop(x)
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert torch.equal(drop(x), x)
            assert not torch.is_grad_enabled()
    kept = y != 0
    assert 0.45 < kept.float().mean().item() < 0.55
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    with autograd.record(train_mode=False):
        assert torch.equal(drop(x), x)
    with autograd.train_mode():
        assert not torch.equal(drop(x), x)
    drop.manual_seed(3)
    with autograd.record():
        assert torch.equal(drop(x), y)


def test_backward_takes_head_gradients():
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    with autograd.record():
        a, b = w * 3.0, (w * w).sum()
    autograd.backward([a, b], [torch.tensor([1.0, 0.5]), None])
    torch.testing.assert_close(w.grad, torch.tensor([3.0 + 2.0, 1.5 + 4.0]))


def test_collect_params_names_match_jax_and_round_trip(jax_runs):
    def build():
        return BERTModel(vocab_size=V, units=C, num_layers=L, num_heads=H,
                         hidden_size=FFN, max_len=64, device="cpu")

    model = build()
    assert list(collect_params(model)) == jax_runs["float32"]["names"]
    named = params_to_mxnet_tpu(model)
    other = build()
    other.load_state_dict(params_from_mxnet_tpu(named, other))
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)


def _tiny():
    lin = torch.nn.Linear(3, 2)
    return {"w": lin.weight, "b": lin.bias}, lin


def test_trainer_refuses_stale_gradients_and_other_kvstores():
    params, lin = _tiny()
    trainer = Trainer(params, "sgd", {"learning_rate": 0.5})
    with autograd.record():
        loss = lin.weight.sum()  # the bias takes no part
    autograd.backward(loss)
    with pytest.raises(MXNetError, match="`b`"):
        trainer.step(1)
    before = lin.bias.detach().clone()
    trainer.step(1, ignore_stale_grad=True)
    torch.testing.assert_close(lin.weight.grad, None)
    assert torch.equal(lin.bias.detach(), before)
    # a step consumes the gradients it applies
    with pytest.raises(MXNetError, match="has not been updated"):
        trainer.step(1)
    with pytest.raises(NotImplementedError, match="distribution slice"):
        Trainer(params, "sgd", kvstore="dist_sync")
    with pytest.raises(ValueError):
        Trainer([torch.zeros(2)], "sgd")


def test_trainer_step_updates_rescales_and_records():
    params, lin = _tiny()
    lin.bias.requires_grad_(False)  # grad_req="null": left alone
    trainer = Trainer(params, "sgd", {"learning_rate": 0.5,
                                      "rescale_grad": 2.0})
    assert trainer.learning_rate == 0.5
    trainer.set_learning_rate(0.25)
    assert trainer.learning_rate == 0.25
    steps = telemetry.metrics.counter("trainer_step_total").value()
    w0 = lin.weight.detach().clone()
    with autograd.record():
        loss = lin(torch.ones(4, 3)).sum()
    autograd.backward(loss)
    trainer.step(4)
    # grad of sum over 4 rows is 4 per weight; * rescale 2 / batch 4
    torch.testing.assert_close(lin.weight.detach(), w0 - 0.25 * 4 * 0.5)
    assert telemetry.metrics.counter("trainer_step_total").value() == \
        steps + 1
