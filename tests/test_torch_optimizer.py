"""The port's optimizer ops, SGD and Updater against the JAX package's.

Inputs come from a numpy seed and go through both. Tolerances: the update
ops are a few fp32 operations, compared at rtol/atol 1e-6 (XLA may fuse
a multiply and an add into one FMA where ATen rounds twice); fp16 weights
compared as fp16 may then differ by one ulp (atol 1e-3 at |w| < 2). The
mixed-precision kernel itself is held against the same plain version, bit
for bit, on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import optimizer_ops as jax_ops
from mxnet_tpu.opt.kernels import mp_sgd_mom_update_pallas
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import optimizer as torch_opt
from mxnet_tpu_torch.ops import optimizer_ops as torch_ops
from mxnet_tpu_torch.opt.kernels import (LAUNCHES, mp_sgd_mom_update_kernel,
                                         mp_sgd_mom_update_ref)

RTOL = ATOL = 1e-6


def _arrays(seed, n, grad_scale=50.0):
    rng = np.random.RandomState(seed)
    w32 = rng.randn(n).astype("float32")
    grad = (rng.randn(n) * grad_scale).astype("float16")
    mom = (rng.randn(n) * 0.01).astype("float32")
    return w32.astype("float16"), grad, mom, w32


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=atol)


@pytest.mark.parametrize("clip", [-1.0, 0.5])
@pytest.mark.parametrize("n", [1000, 3 * 77])
def test_mp_sgd_plain_version_matches_pallas_kernel(n, clip):
    """n is not a multiple of the Pallas kernel's 128 lanes: its padded
    tail must not show."""
    w, g, m, w32 = _arrays(n, n)
    kw = dict(lr=0.05, momentum=0.9, wd=1e-3, rescale_grad=1 / 32,
              clip_gradient=clip)
    want = mp_sgd_mom_update_pallas(jnp.asarray(w), jnp.asarray(g),
                                    jnp.asarray(m), jnp.asarray(w32),
                                    interpret=True, **kw)
    got = mp_sgd_mom_update_ref(*(torch.from_numpy(a) for a in (w, g, m, w32)),
                                **kw)
    assert got[0].dtype == torch.float16
    assert got[1].dtype == got[2].dtype == torch.float32
    _close(got[0], want[0], atol=1e-3)
    _close(got[1], want[1])
    _close(got[2], want[2])


def test_mp_sgd_wrapper_on_cpu_is_the_plain_version_in_place():
    w, g, m, w32 = (torch.from_numpy(a) for a in _arrays(1, 500))
    kw = dict(lr=0.1, momentum=0.9, rescale_grad=0.5)
    want = mp_sgd_mom_update_ref(w, g, m, w32, **kw)
    before = LAUNCHES.count
    out = mp_sgd_mom_update_kernel(w, g, m, w32, out=(w, m, w32), **kw)
    assert LAUNCHES.count == before
    assert out[0] is w and out[2] is w32
    for a, b in zip((w, m, w32), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["dtype", "size", "device"])
def test_mp_sgd_kernel_wrapper_refuses(what):
    """The kernel takes fp16 weight and grad, fp32 state, all of one size
    and on one CUDA device; a meta tensor stands in for a second device."""
    w, g, m, w32 = (torch.from_numpy(a) for a in _arrays(2, 64))
    match = {"dtype": "the kernel takes torch", "size": "elements",
             "device": "CUDA tensors"}[what]
    if what == "dtype":
        g = g.float()
    elif what == "size":
        m = m[:32]
    # a tensor off the CPU sends the call to the kernel's checks
    w32 = w32.to("meta")
    before = LAUNCHES.count
    with pytest.raises(MXNetError, match=match):
        mp_sgd_mom_update_kernel(w, g, m, w32)
    assert LAUNCHES.count == before


@pytest.mark.parametrize("clip", [-1.0, 2.0])
def test_plain_update_ops_match_jax(clip):
    rng = np.random.RandomState(3)
    w, g, m = (rng.randn(2, 37).astype("float32") for _ in range(3))
    kw = dict(lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=clip)
    t = [torch.from_numpy(a) for a in (w, g, m)]
    j = [jnp.asarray(a) for a in (w, g, m)]
    _close(torch_ops.sgd_update(t[0], t[1], **kw),
           jax_ops.sgd_update(j[0], j[1], **kw))
    for a, b in zip(torch_ops.sgd_mom_update(*t, momentum=0.9, **kw),
                    jax_ops.sgd_mom_update(*j, momentum=0.9, **kw)):
        _close(a, b)
    w16 = w.astype("float16")
    got = torch_ops.mp_sgd_update(torch.from_numpy(w16),
                                  torch.from_numpy(g.astype("float16")),
                                  t[0], **kw)
    want = jax_ops.mp_sgd_update(jnp.asarray(w16),
                                 jnp.asarray(g.astype("float16")), j[0], **kw)
    assert got[0].dtype == torch.float16
    _close(got[0], want[0], atol=1e-3)
    _close(got[1], want[1])


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_state_structure_matches_jax(dtype, momentum):
    """Multi-precision applies to float16 weights only: ``(w32, mom)``
    there (``mom`` None without momentum), the plain state otherwise."""
    w = np.linspace(-1, 1, 12, dtype="float32").reshape(3, 4)
    jopt = mx.optimizer.SGD(momentum=momentum, multi_precision=True)
    topt = torch_opt.SGD(momentum=momentum, multi_precision=True)
    js = jopt.create_state_multi_precision(0, mx.nd.array(w, dtype=dtype))
    ts = topt.create_state_multi_precision(
        0, torch.from_numpy(w).to(getattr(torch, dtype)))

    def shape(s):
        if s is None:
            return None
        if isinstance(s, tuple):
            return tuple(shape(x) for x in s)
        return str(s.dtype).replace("torch.", "")

    assert shape(ts) == shape(js)
    if dtype == "float16":
        np.testing.assert_array_equal(ts[0].numpy(),
                                      js[0].asnumpy().astype("float32"))


def test_lr_wd_multipliers_and_update_counts_match_jax():
    params = {0: types.SimpleNamespace(lr_mult=0.5, wd_mult=2.0)}
    kw = dict(learning_rate=0.1, wd=0.01, clip_gradient=3.0,
              param_idx2name={2: "w2", 3: "w3"}, begin_num_update=4)
    jopt, topt = mx.optimizer.SGD(**kw), torch_opt.SGD(**kw)
    for o in (jopt, topt):
        o.param_dict = params
        o.set_lr_mult({1: 3.0, "w2": 0.25})
        o.set_wd_mult({"w3": 0.0})
    for index in (0, 1, 2, 3, 0, 3, 3):
        assert topt._common(index) == pytest.approx(jopt._common(index))
        assert topt.num_update == jopt.num_update
    assert topt._index_update_count == jopt._index_update_count


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_updater_steps_match_jax(dtype):
    """Three updates of one parameter through ``Updater`` (states created
    on first sight, in place on the port's side) against the JAX
    package's, with clipping and weight decay."""
    rng = np.random.RandomState(5)
    w = (rng.randn(5, 7) * 0.1).astype(dtype)
    grads = [(rng.randn(5, 7) * 20).astype(dtype) for _ in range(3)]
    kw = dict(learning_rate=0.05, momentum=0.9, wd=1e-3, clip_gradient=1.0,
              rescale_grad=1 / 16, multi_precision=True)
    jup = mx.optimizer.get_updater(mx.optimizer.SGD(**kw))
    tup = torch_opt.get_updater(torch_opt.create("sgd", **kw))
    jw, tw = mx.nd.array(w, dtype=dtype), torch.from_numpy(w.copy())
    for g in grads:
        jup(0, mx.nd.array(g, dtype=dtype), jw)
        tup(0, torch.from_numpy(g), tw)
    atol = 1e-3 if dtype == "float16" else ATOL
    _close(tw.numpy(), jw.asnumpy(), atol=atol)
    js, ts = jup.states[0], tup.states[0]
    if dtype == "float16":
        _close(ts[0].numpy(), js[0].asnumpy())
        _close(ts[1].numpy(), js[1].asnumpy())
    else:
        _close(ts.numpy(), js.asnumpy())


def test_create_names_what_is_registered():
    assert isinstance(torch_opt.create("SGD"), torch_opt.SGD)
    with pytest.raises(MXNetError, match="not registered"):
        torch_opt.create("no_such_optimizer")
