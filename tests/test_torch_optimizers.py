"""Every optimizer and update op of the port against the JAX package's.

Inputs come from a numpy seed and go through both. Tolerances:

- update ops and three updater steps in fp32: rtol 1e-5 / atol 1e-6 (a
  few fp32 operations a step; XLA may contract a multiply and an add into
  one FMA where ATen rounds twice, ~1e-7 relative, and three steps carry
  it);
- fp16 multi-precision: the fp32 master weights to the same limits, the
  fp16 weights to atol 2e-3 (one fp16 ulp at |w| < 2, where a master
  weight that differs in its last bits rounds the other way);
- the port's list-form paths against its own per-parameter loop: bit for
  bit (the same ops in the same order);
- SGLD: its noise-free part to the fp32 limits, its noise's mean and
  standard deviation to 5 standard errors.

The mixed-precision SGD kernel is held to the same plain versions, bit
for bit, on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import optimizer_ops as jax_ops
from mxnet_tpu_torch import config
from mxnet_tpu_torch import optimizer as torch_opt
from mxnet_tpu_torch import random as torch_random
from mxnet_tpu_torch.ops import optimizer_ops as torch_ops
from mxnet_tpu_torch.opt.kernels import (LAUNCHES, mp_sgd_mom_update_multi_kernel,
                                         mp_sgd_mom_update_multi_ref,
                                         mp_sgd_mom_update_ref)

RTOL, ATOL, ATOL16 = 1e-5, 1e-6, 2e-3

# name -> constructor keywords beyond the common ones
OPTIMIZERS = {
    "sgd": dict(momentum=0.9), "nag": dict(momentum=0.9), "adam": {},
    "adamw": dict(eta=0.5), "adagrad": {}, "rmsprop": {},
    "rmsprop_centered": dict(centered=True, clip_weights=2.0),
    "adadelta": {}, "ftrl": {}, "ftml": {}, "signsgd": {},
    "signum": dict(wd_lh=0.01), "adamax": {}, "nadam": {},
    "dcasgd": dict(momentum=0.9), "lbsgd": dict(momentum=0.9), "test": {}}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=atol)


def _make(case, **extra):
    name = case.split("_")[0]
    kw = dict(learning_rate=0.01, wd=0.01, rescale_grad=0.5,
              clip_gradient=1.0, param_idx2name={1: "w1"}, **extra)
    if name == "test":
        kw = {}
    kw.update(OPTIMIZERS[case])
    jopt, topt = mx.optimizer.create(name, **kw), torch_opt.create(name, **kw)
    for o in (jopt, topt):
        o.set_lr_mult({0: 0.5, "w1": 2.0})
        o.set_wd_mult({0: 3.0})
    return jopt, topt


def _tree(state, fn):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_tree(s, fn) for s in state)
    return fn(state)


def _compare_states(ts, js, master=False):
    tn = _tree(ts, lambda t: t.numpy())
    jn = _tree(js, lambda a: a.asnumpy())
    flat_t, flat_j = [], []

    def flat(x, out):
        if isinstance(x, tuple):
            for y in x:
                flat(y, out)
        elif x is not None:
            out.append(x)
    flat(tn, flat_t)
    flat(jn, flat_j)
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        assert str(a.dtype) == str(b.dtype)
        _close(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(case, dtype):
    """Three steps of two parameters through each package's eager
    ``Updater`` (states on first sight), with clipping, weight decay,
    ``rescale_grad`` and per-index ``lr_mult``/``wd_mult``; in fp16 with
    ``multi_precision`` (an fp32 master beside the state)."""
    jopt, topt = _make(case, multi_precision=True)
    jup, tup = mx.optimizer.get_updater(jopt), torch_opt.get_updater(topt)
    rng = np.random.RandomState(len(case))
    ws = [(rng.randn(4, 6) * 0.5).astype(dtype) for _ in range(2)]
    jw = [mx.nd.array(w, dtype=dtype) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    for _ in range(3):
        for i in range(2):
            g = (rng.randn(4, 6) * 3).astype(dtype)
            jup(i, mx.nd.array(g, dtype=dtype), jw[i])
            tup(i, torch.from_numpy(g), tw[i])
    for i in range(2):
        assert tw[i].dtype == getattr(torch, dtype)
        _close(tw[i].numpy(), jw[i].asnumpy(),
               atol=ATOL16 if dtype == "float16" else ATOL)
        _compare_states(tup.states[i], jup.states[i])
    assert topt._index_update_count == jopt._index_update_count
    assert topt.num_update == jopt.num_update


def _op_inputs(n_state, seed=7):
    rng = np.random.RandomState(seed)
    arrays = [(rng.randn(3, 17) * 0.5).astype("float32")]
    arrays.append((rng.randn(3, 17) * 4).astype("float32"))
    # states kept positive where an op takes their square root
    arrays += [np.abs(rng.randn(3, 17)).astype("float32") * 0.1
               for _ in range(n_state)]
    return [torch.from_numpy(a) for a in arrays], \
        [jnp.asarray(a) for a in arrays]


# op -> (number of states, keywords)
OPS = {
    "nag_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01)),
    "adam_update": (2, dict(lr=0.01, beta1=0.8, beta2=0.99, wd=0.01)),
    "adamw_update": (2, dict(lr=0.01, wd=0.02, eta=0.7)),
    "_mp_adamw_update": (2, dict(lr=0.01, wd=0.02, rescale_grad_t=0.25)),
    "ftml_update": (3, dict(lr=0.05, wd=0.01, t=3)),
    "ftrl_update": (2, dict(lr=0.1, lamda1=0.05, beta=1.0, wd=0.01)),
    "rmsprop_update": (1, dict(lr=0.01, gamma1=0.9, wd=0.01,
                               clip_weights=0.6)),
    "rmspropalex_update": (3, dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                   clip_weights=0.6)),
    "signsgd_update": (0, dict(lr=0.1, wd=0.01)),
    "signum_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.02)),
    "adagrad_update": (1, dict(lr=0.1, epsilon=1e-7, wd=0.01)),
    "adadelta_update": (2, dict(rho=0.9, epsilon=1e-5, wd=0.01)),
}


@pytest.mark.parametrize("clip", [-1.0, 1.5])
@pytest.mark.parametrize("op", sorted(OPS))
def test_update_op_matches_jax(op, clip):
    n_state, kw = OPS[op]
    kw = dict(kw, rescale_grad=0.5)
    kw["clip_grad" if op == "ftml_update" else "clip_gradient"] = clip
    t, j = _op_inputs(n_state)
    jfn = getattr(jax_ops, "adamw_update" if op == "_mp_adamw_update"
                  else op)
    got, want = getattr(torch_ops, op)(*t, **kw), jfn(*j, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bad", [None, float("inf"), float("-inf"),
                                 float("nan")])
def test_finite_checks_match_jax(bad):
    rng = np.random.RandomState(0)
    arrays = [rng.randn(5, 3).astype("float16"),
              (rng.randn(40) * 1e30).astype("float32")]
    if bad is not None:
        arrays[1][7] = bad
    t = [torch.from_numpy(a) for a in arrays]
    j = [jnp.asarray(a) for a in arrays]
    want = float(np.asarray(jax_ops.multi_all_finite(*j, num_arrays=2))[0])
    assert want == (1.0 if bad is None else 0.0)
    got = torch_ops.multi_all_finite(*t, num_arrays=2)
    assert got.dtype == torch.float32 and got.tolist() == [want]
    for a, b in zip(t, j):
        assert torch_ops.all_finite(a).tolist() == \
            np.asarray(jax_ops.all_finite(b)).tolist()


def _sgd_lists(seed, sizes=(5, 64, 1, 300)):
    rng = np.random.RandomState(seed)
    w32 = [rng.randn(n).astype("float32") for n in sizes]
    return ([torch.from_numpy(w.astype("float16")) for w in w32],
            [torch.from_numpy((rng.randn(n) * 50).astype("float16"))
             for n in sizes],
            [torch.from_numpy((rng.randn(n) * 0.01).astype("float32"))
             for n in sizes],
            [torch.from_numpy(w) for w in w32])


@pytest.mark.parametrize("clip", [-1.0, 0.5])
def test_multi_plain_version_is_the_per_tensor_one(clip):
    """``mp_sgd_mom_update_multi_ref`` is ``mp_sgd_mom_update_ref`` of
    each tensor with its own lr and wd; the multi wrapper on CPU tensors
    writes exactly that in place and launches nothing."""
    ws, gs, ms, w32s = _sgd_lists(1)
    lrs, wds = [0.1, 0.2, 0.05, 0.3], [0.0, 1e-3, 1e-2, 0.5]
    kw = dict(momentum=0.9, rescale_grad=1 / 8, clip_gradient=clip)
    got = mp_sgd_mom_update_multi_ref(ws, gs, ms, w32s, lrs, wds, **kw)
    for k, res in enumerate(got):
        want = mp_sgd_mom_update_ref(ws[k], gs[k], ms[k], w32s[k],
                                     lr=lrs[k], wd=wds[k], **kw)
        assert all(torch.equal(a, b) for a, b in zip(res, want))
    before = LAUNCHES.count
    mp_sgd_mom_update_multi_kernel(ws, gs, ms, w32s, lrs, wds, **kw)
    assert LAUNCHES.count == before
    for k, res in enumerate(got):
        assert all(torch.equal(a, b)
                   for a, b in zip((ws[k], ms[k], w32s[k]), res))


def test_multi_wrapper_refuses_what_the_kernel_does_not_take():
    from mxnet_tpu_torch import MXNetError
    ws, gs, ms, w32s = _sgd_lists(2)
    with pytest.raises(MXNetError, match="differ in length"):
        mp_sgd_mom_update_multi_kernel(ws, gs, ms, w32s[:2], [0.1] * 4,
                                       [0.0] * 4)
    # a tensor off the CPU sends the call to the kernel's checks
    ms[2] = ms[2].to("meta")
    before = LAUNCHES.count
    with pytest.raises(MXNetError, match="CUDA tensors"):
        mp_sgd_mom_update_multi_kernel(ws, gs, ms, w32s, [0.1] * 4,
                                       [0.0] * 4)
    assert LAUNCHES.count == before


def _params(dtype, n=5, seed=3):
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(3, 4 + i) * 0.5).astype(dtype) for i in range(n)]
    gs = [[(rng.randn(3, 4 + i) * 3).astype(dtype) for i in range(n)]
          for _ in range(3)]
    return ws, gs


@pytest.mark.parametrize("case", ["sgd", "nag", "adam", "adamw", "rmsprop",
                                  "rmsprop_centered", "sgd_mp", "adamw_mp",
                                  "ftml"])
def test_list_form_updater_matches_per_parameter_loop_and_jax(case,
                                                              monkeypatch):
    """The list-form ``Updater`` call (``update_multi`` in chunks of
    ``aggregate_num`` = 2 for optimizers with a ``fused_apply``; one
    multi-tensor update of the fp16 parameters for multi-precision SGD)
    against the port's per-parameter loop, bit for bit, and against the
    JAX package's list-form call."""
    mp = case.endswith("_mp")
    base = case[:-3] if mp else case
    dtype = "float16" if mp else "float32"
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "2")
    config.set_flag("MXNET_OPTIMIZER_AGGREGATION_SIZE", 2)
    try:
        jopt, topt = _make(base, multi_precision=mp)
        _, loop_opt = _make(base, multi_precision=mp)
    finally:
        config.unset_flag("MXNET_OPTIMIZER_AGGREGATION_SIZE")
    assert topt.aggregate_num == jopt.aggregate_num == 2
    chunks = []
    if topt.has_fused_apply:
        real = topt.fused_apply
        topt.fused_apply = lambda *a: chunks.append(len(a[0])) or real(*a)
    ws, grads = _params(dtype)
    idx = list(range(len(ws)))
    jup, tup = mx.optimizer.get_updater(jopt), torch_opt.get_updater(topt)
    lup = torch_opt.get_updater(loop_opt)
    jw = [mx.nd.array(w, dtype=dtype) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    lw = [torch.from_numpy(w.copy()) for w in ws]
    for gs in grads:
        jup(idx, [mx.nd.array(g, dtype=dtype) for g in gs], jw)
        tup(idx, [torch.from_numpy(g) for g in gs], tw)
        for i in idx:
            lup(i, torch.from_numpy(gs[i]), lw[i])
    assert topt.has_fused_apply == (base != "ftml")
    if topt.has_fused_apply and not mp:
        assert chunks == [2, 2, 1] * 3
    else:
        assert chunks == []
    for i in idx:
        assert torch.equal(tw[i], lw[i])
        assert _tree(tup.states[i], lambda t: t.numpy().tobytes()) == \
            _tree(lup.states[i], lambda t: t.numpy().tobytes())
        _close(tw[i].numpy(), jw[i].asnumpy(), atol=ATOL16 if mp else ATOL)
        _compare_states(tup.states[i], jup.states[i])
    assert topt._index_update_count == loop_opt._index_update_count


def test_sgld_noise_free_part_and_noise_moments_match_jax(monkeypatch):
    """SGLD's update is ``w - lr/2 * g + N(0, lr)``. The generators
    differ, so the noise-free part is held to the JAX package's with its
    noise drawn as zeros, and the port's noise (redrawn from its reseeded
    generator) to N(0, lr) by its mean and standard deviation."""
    n, lr = 200_000, 0.04
    rng = np.random.RandomState(4)
    w = (rng.randn(n) * 0.5).astype("float32")
    g = (rng.randn(n) * 3).astype("float32")
    kw = dict(learning_rate=lr, wd=0.01, rescale_grad=0.5, clip_gradient=1.0)
    monkeypatch.setattr(mx.random, "normal",
                        lambda loc, scale, shape, dtype: mx.nd.zeros(
                            shape, dtype=dtype))
    jw = mx.nd.array(w)
    mx.optimizer.create("sgld", **kw).update(0, jw, mx.nd.array(g), None)
    torch_random.seed(11)
    tw = torch.from_numpy(w.copy())
    torch_opt.create("sgld", **kw).update(0, tw, torch.from_numpy(g), None)
    torch_random.seed(11)
    noise = torch.randn(n, generator=torch_random.generator("cpu")) \
        * np.sqrt(lr)
    _close((tw - noise).numpy(), jw.asnumpy())
    se = np.sqrt(lr / n)
    assert abs(noise.mean().item()) < 5 * se
    assert abs(noise.std().item() - np.sqrt(lr)) < 5 * np.sqrt(lr / (2 * n))


def test_sparse_gradients_wait_for_the_nd_slice():
    opt = torch_opt.create("adam")
    w = torch.zeros(4, 3)
    g = torch.zeros(4, 3).to_sparse()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        opt.update(0, w, g, opt.create_state(0, w))


def test_hyperparameter_hooks_match_jax():
    """``fused_hyper`` (Adam's bias correction folded into lr in float64),
    ``fused_signature`` and ``has_fused_apply`` as in the JAX package."""
    for name in sorted(set(c.split("_")[0] for c in OPTIMIZERS)):
        jopt, topt = _make(name)
        assert topt.has_fused_apply == jopt.has_fused_apply, name
        assert topt.fused_signature() == jopt.fused_signature(), name
        for index in (0, 1, 0, 2):
            assert topt.fused_hyper(index) == jopt.fused_hyper(index), name


def test_create_and_state_pickles_round_trip():
    assert isinstance(torch_opt.create("stochasticgradientdescent"),
                      torch_opt.SGD)
    assert isinstance(torch_opt.create("AdamOptimizer"), torch_opt.Adam)
    opt = torch_opt.create("adamw", learning_rate=0.1, multi_precision=True,
                           param_dict={0: types.SimpleNamespace(lr_mult=2)})
    up = torch_opt.get_updater(opt)
    w = torch.ones(3, dtype=torch.float16)
    up(0, torch.full((3,), 0.5, dtype=torch.float16), w)
    other = torch_opt.get_updater(torch_opt.create("sgd"))
    other.set_states(up.get_states(dump_optimizer=True))
    assert isinstance(other.optimizer, torch_opt.AdamW)
    assert other.optimizer.param_dict == {}
    assert other.optimizer._index_update_count == {0: 1}
    for a, b in zip(other.states[0], up.states[0]):
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)
