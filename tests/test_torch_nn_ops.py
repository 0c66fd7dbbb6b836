"""The port's layer ops against the JAX package's, on the CPU.

``convolution``, ``pooling``, ``activation``, ``batch_norm``,
``fully_connected`` and ``flatten`` of ``mxnet_tpu_torch.ops.nn`` against
``mxnet_tpu.ops.nn`` on the same numpy-seeded inputs: forward, and the
gradients against ``jax.vjp`` with the same seeded cotangent. Tolerances:

- fp32 forward rtol 1e-5 / atol 1e-6 and gradients rtol 1e-4 / atol 1e-5
  (both sides compute in fp32; XLA:CPU and ATen sum in different orders);
- ``batch_norm`` on fp16 input: the output within one fp16 ulp, rtol
  2^-10 (both normalize in fp32 and round once to fp16, so two fp32
  values a few ulps apart may round to neighbouring fp16 values), its fp32
  moving statistics within the fp32 limits (both compute them from the
  same fp16 input in fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import nn as jax_nn
from mxnet_tpu.ops import tensor as jax_tensor
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import nn as torch_nn

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BN16_RTOL = 2.0 ** -10


def _rand(rng, shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype("float32")


def _check(jax_fn, torch_fn, args, seed, grad=True, rtol=RTOL, atol=ATOL):
    """Forward of both on ``args`` (numpy), then, with ``grad``, the
    gradients of every argument for one seeded cotangent."""
    jout, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=grad) for a in args]
    tout = torch_fn(*ts)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=rtol, atol=atol)
    if not grad:
        return
    cot = np.random.RandomState(seed + 100).randn(*tout.shape) \
        .astype("float32")
    want = vjp(jnp.asarray(cot))
    tout.backward(torch.from_numpy(cot))
    for i, (t, w) in enumerate(zip(ts, want)):
        # torch leaves no gradient where the output does not depend on an
        # argument (gamma under fix_gamma); JAX gives zeros
        got = np.zeros_like(args[i]) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient of argument {i}")


# (data shape, weight shape, kwargs): ResNet's 1x1, 3x3 and 7x7 s2 p3
# stem, groups, dilation, no bias, 1-D and 3-D
CONV_CASES = {
    "1x1": ((2, 8, 6, 6), (4, 8, 1, 1), {}),
    "3x3_p1": ((2, 4, 7, 7), (6, 4, 3, 3), dict(pad=(1, 1))),
    "7x7_s2_p3": ((2, 3, 13, 13), (5, 3, 7, 7),
                  dict(stride=(2, 2), pad=(3, 3))),
    "3x3_s2_groups2": ((2, 4, 9, 9), (6, 2, 3, 3),
                       dict(stride=(2, 2), pad=(1, 1), num_group=2)),
    "3x3_dilate2": ((1, 3, 9, 9), (4, 3, 3, 3),
                    dict(dilate=(2, 2), pad=(2, 2))),
    "3x3_no_bias": ((2, 3, 6, 6), (4, 3, 3, 3),
                    dict(pad=(1, 1), no_bias=True)),
    "1d_k3_s2": ((2, 3, 11), (4, 3, 3), dict(stride=(2,), pad=(1,))),
    "3d_k3": ((1, 2, 5, 5, 5), (3, 2, 3, 3, 3), dict(pad=(1, 1, 1))),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(case):
    dshape, wshape, kw = CONV_CASES[case]
    rng = np.random.RandomState(len(case))
    no_bias = kw.get("no_bias", False)
    args = [_rand(rng, dshape), _rand(rng, wshape, 0.2)]
    if not no_bias:
        args.append(_rand(rng, (wshape[0],)))
    tkw = dict(kw, kernel=wshape[2:])
    _check(lambda *a: jax_nn.convolution(*a, num_filter=wshape[0], **tkw),
           lambda *a: torch_nn.convolution(*a, **tkw), args, len(case))


# (data shape, kwargs). "full" pads the right edge by what the last window
# needs: 8 + 2 = 10 wide, k 3, s 2 -> 5 windows, one extra pad column;
# width 6, k 2, s 3 -> a last window wholly in the padding (-inf for max,
# 0 for an average over prod(kernel))
POOL_CASES = {
    "max_k3_s2_p1": ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                        pad=(1, 1))),
    "max_full_k3_s2": ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2),
                                          pooling_convention="full")),
    "max_full_window_in_pad": ((1, 2, 6, 6), dict(
        kernel=(2, 2), stride=(3, 3), pooling_convention="full")),
    "max_pad_over_half": ((1, 2, 7, 7), dict(kernel=(3, 3), stride=(2, 2),
                                             pad=(2, 2))),
    "avg_k3_s2_p1_incl": ((2, 3, 9, 9), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg")),
    "avg_k3_s2_p1_excl": ((2, 3, 9, 9), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False)),
    "avg_full_p1_incl": ((2, 3, 8, 8), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full")),
    "avg_full_p1_excl": ((2, 3, 8, 8), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
    "avg_full_window_in_pad_incl": ((1, 2, 6, 6), dict(
        kernel=(2, 2), stride=(3, 3), pool_type="avg",
        pooling_convention="full")),
    "avg_full_rect": ((2, 2, 7, 10), dict(
        kernel=(2, 3), stride=(2, 2), pool_type="avg",
        pooling_convention="full")),
    "sum_k2": ((2, 3, 6, 6), dict(kernel=(2, 2), stride=(2, 2),
                                  pool_type="sum")),
    "global_max": ((2, 3, 5, 7), dict(global_pool=True)),
    "global_avg": ((2, 3, 5, 7), dict(global_pool=True, pool_type="avg")),
    "avg_1d_full_excl": ((2, 3, 10), dict(
        kernel=(3,), stride=(2,), pad=(1,), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
    "max_1d": ((2, 3, 10), dict(kernel=(3,), stride=(2,), pad=(1,))),
    "avg_3d_incl": ((1, 2, 5, 5, 5), dict(
        kernel=(2, 2, 2), stride=(2, 2, 2), pad=(1, 1, 1),
        pool_type="avg")),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    shape, kw = POOL_CASES[case]
    rng = np.random.RandomState(len(case) + 7)
    x = _rand(rng, shape)
    _check(lambda a: jax_nn.pooling(a, **kw),
           lambda a: torch_nn.pooling(a, **kw), [x], len(case))


def test_pooling_full_keeps_the_window_torch_ceil_mode_drops():
    """Width 6, k 2, s 3, ``full``: three windows, the last in the
    padding (max -inf, average 0 over prod(kernel)); torch's ``ceil_mode``
    gives two."""
    x = torch.arange(36, dtype=torch.float32).reshape(1, 1, 6, 6)
    kw = dict(kernel=(2, 2), stride=(3, 3), pooling_convention="full")
    out = torch_nn.pooling(x, **kw)
    assert out.shape == (1, 1, 3, 3)
    assert torch.isinf(out[..., 2]).all() and torch.isinf(out[..., 2, :]).all()
    avg = torch_nn.pooling(x, pool_type="avg", **kw)
    assert (avg[..., 2] == 0).all()
    assert torch.nn.functional.max_pool2d(x, 2, 3, ceil_mode=True).shape \
        == (1, 1, 2, 2)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax(act):
    rng = np.random.RandomState(3)
    x = _rand(rng, (4, 5, 6), 2.0)
    x[np.abs(x) < 1e-3] = 0.5   # no input on relu's kink
    _check(lambda a: jax_nn.activation(a, act_type=act),
           lambda a: torch_nn.activation(a, act_type=act), [x], 3)


def test_activation_rejects_unknown_type():
    with pytest.raises(MXNetError, match="unknown act_type"):
        torch_nn.activation(torch.zeros(2), "swish2")


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected_matches_jax(flatten, no_bias):
    rng = np.random.RandomState(5)
    x = _rand(rng, (3, 4, 2, 5))
    in_units = 40 if flatten else 5
    args = [x, _rand(rng, (6, in_units), 0.3)]
    if not no_bias:
        args.append(_rand(rng, (6,)))
    kw = dict(no_bias=no_bias, flatten=flatten)
    _check(lambda *a: jax_nn.fully_connected(*a, num_hidden=6, **kw),
           lambda *a: torch_nn.fully_connected(*a, **kw), args, 5)


def test_flatten_matches_jax():
    rng = np.random.RandomState(6)
    _check(jax_tensor.flatten, torch_nn.flatten, [_rand(rng, (3, 4, 2, 5))],
           6)


# batch_norm: (training, fix_gamma, use_global_stats)
BN_CASES = {"train": (True, False, False),
            "train_fix_gamma": (True, True, False),
            "predict": (False, False, False),
            "predict_fix_gamma": (False, True, False),
            "train_use_global_stats": (True, False, True)}


def _bn_inputs(seed, shape=(4, 3, 5, 5)):
    rng = np.random.RandomState(seed)
    c = shape[1]
    return (_rand(rng, shape, 2.0) + 0.5, 1 + _rand(rng, (c,), 0.2),
            _rand(rng, (c,), 0.2), _rand(rng, (c,), 0.3),
            np.abs(_rand(rng, (c,))) + 0.5)


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_jax(case):
    """Output, gradients of data/gamma/beta, and the new moving stats."""
    training, fix_gamma, ugs = BN_CASES[case]
    x, g, b, mm, mv = _bn_inputs(len(case))
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma,
              use_global_stats=ugs)
    jres = jax_nn.batch_norm(*map(jnp.asarray, (x, g, b, mm, mv)),
                             _training=training, **kw)
    tres = torch_nn.batch_norm(*map(torch.from_numpy, (x, g, b, mm, mv)),
                               training=training, **kw)
    for got, want in zip(tres[1:], jres[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    _check(lambda d, ga, be: jax_nn.batch_norm(
               d, ga, be, jnp.asarray(mm), jnp.asarray(mv),
               _training=training, **kw)[0],
           lambda d, ga, be: torch_nn.batch_norm(
               d, ga, be, torch.from_numpy(mm), torch.from_numpy(mv),
               training=training, **kw)[0], [x, g, b], len(case))


def test_batch_norm_moving_stats_take_the_biased_variance():
    """``new = m * old + (1 - m) * batch`` with the biased batch variance,
    not torch's running-buffer rule (unbiased, momentum as 1 - m)."""
    x, g, b, mm, mv = map(torch.from_numpy, _bn_inputs(11))
    _, new_mean, new_var = torch_nn.batch_norm(x, g, b, mm, mv, momentum=0.9,
                                               fix_gamma=False, training=True)
    red = (0, 2, 3)
    want_var = 0.9 * mv + 0.1 * x.var(dim=red, unbiased=False)
    torch.testing.assert_close(new_mean, 0.9 * mm + 0.1 * x.mean(dim=red),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(new_var, want_var, rtol=RTOL, atol=ATOL)
    torch_rule = mv.clone()
    torch.nn.functional.batch_norm(x, mm.clone(), torch_rule, g, b,
                                   training=True, momentum=0.1)
    assert not torch.allclose(torch_rule, want_var, rtol=1e-4, atol=0)


def test_batch_norm_fp16_input_keeps_fp32_stats():
    x, g, b, mm, mv = _bn_inputs(12)
    x16 = x.astype("float16")
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=False)
    jres = jax_nn.batch_norm(*map(jnp.asarray, (x16, g, b, mm, mv)),
                             _training=True, **kw)
    tres = torch_nn.batch_norm(*map(torch.from_numpy, (x16, g, b, mm, mv)),
                               training=True, **kw)
    assert tres[0].dtype == torch.float16
    assert tres[1].dtype == tres[2].dtype == torch.float32
    np.testing.assert_allclose(tres[0].float().numpy(),
                               np.asarray(jres[0]).astype("float32"),
                               rtol=BN16_RTOL, atol=ATOL)
    for got, want in zip(tres[1:], jres[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_batch_norm_channel_axis_last_matches_jax():
    """Channels on the last axis, named by its positive index: the JAX
    package reduces over every axis when given ``axis=-1`` (``i != axis``
    over ``range(ndim)``), where the port normalizes the index."""
    x, g, b, mm, mv = _bn_inputs(13, (4, 3, 5))
    x = np.ascontiguousarray(np.moveaxis(x, 1, -1))   # (4, 5, 3)
    kw = dict(eps=1e-3, momentum=0.8, fix_gamma=False, axis=2)
    jres = jax_nn.batch_norm(*map(jnp.asarray, (x, g, b, mm, mv)),
                             _training=True, **kw)
    tres = torch_nn.batch_norm(*map(torch.from_numpy, (x, g, b, mm, mv)),
                               training=True, **kw)
    for got, want in zip(tres, jres):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
