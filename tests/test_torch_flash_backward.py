"""The port's flash-attention backward against the JAX package's.

dq, dk and dv come from the port's differentiable ``flash_attention`` on
CPU tensors (its autograd Function, which there runs the backward kernels'
plain version) and from ``jax.vjp`` of the Pallas ``flash_attention`` in
interpret mode (as tests/test_pallas.py runs it on the CPU), on the same
numpy-seeded inputs and output gradient. Tolerance rtol/atol 2e-3, the one
test_pallas.py holds the Pallas backward to against dense attention (fp32,
different summation orders through three products). The kernels
themselves are held against the same plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import flash_attention as jax_flash
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES_DKV, LAUNCHES_DQ,
                                                 _launch_bwd, flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_ref,
                                                 flash_attention_ref_bwd,
                                                 flash_attention_ref_fwd)

RTOL = ATOL = 2e-3

CASES = {
    # name: (B, H, Tq, Tk, D, causal)
    "T256_D64_full": (1, 2, 256, 256, 64, False),
    "T256_D64_causal": (1, 2, 256, 256, 64, True),
    "ragged_T200_D96": (1, 2, 200, 200, 96, False),
    "Tq128_Tk256": (1, 1, 128, 256, 64, False),
}


def _inputs(seed, B, H, Tq, Tk, D):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, Tq, D) * 0.3).astype("float32")
    k = (rng.randn(B, H, Tk, D) * 0.3).astype("float32")
    v = rng.randn(B, H, Tk, D).astype("float32")
    g = rng.randn(B, H, Tq, D).astype("float32")
    return q, k, v, g


def _port_grads(q, k, v, g, causal, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, (qt, kt, vt),
                               torch.from_numpy(g).to(dtype))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_jax(case):
    B, H, Tq, Tk, D, causal = CASES[case]
    q, k, v, g = _inputs(3, B, H, Tq, Tk, D)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, None, 128,
                                               128, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = _port_grads(q, k, v, g, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(causal):
    """The plain backward's formulas equal torch autograd through the
    dense forward (1e-5: fp32, the same products in another order)."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(4, 2, 3, 40, 56, 24))
    for scale in (None, 0.3):
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        ref = flash_attention_ref(qg, kg, vg, causal, scale)
        want = torch.autograd.grad(ref, (qg, kg, vg), g)
        out, lse = flash_attention_ref_fwd(q, k, v, causal, scale)
        got = flash_attention_ref_bwd(q, k, v, out, lse, g, causal, scale)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_fp16_backward_keeps_dtype_and_computes_fp32():
    """fp16 inputs: gradients in fp16, equal to the fp32 computation on the
    same fp16 values (q, k, v, dO and the fp16 forward output) rounded once
    (the kernels' contract)."""
    q, k, v, g = _inputs(5, 1, 2, 64, 64, 32)
    got = _port_grads(q, k, v, g, True, torch.float16)
    q16, k16, v16, g16 = (torch.from_numpy(a).half() for a in (q, k, v, g))
    out16, lse = flash_attention_ref_fwd(q16, k16, v16, True)
    want = flash_attention_ref_bwd(q16.float(), k16.float(), v16.float(),
                                   out16.float(), lse, g16.float(), True)
    for a, b in zip(got, want):
        assert a.dtype == torch.float16
        torch.testing.assert_close(a, b.half())


def test_cpu_backward_launches_nothing():
    q, k, v, g = _inputs(6, 1, 1, 16, 16, 8)
    before = (LAUNCHES_DQ.count, LAUNCHES_DKV.count)
    _port_grads(q, k, v, g, False)
    assert (LAUNCHES_DQ.count, LAUNCHES_DKV.count) == before


def test_no_grad_keeps_nothing():
    """Where no gradient is wanted the forward is not recorded."""
    q = torch.zeros(1, 1, 8, 4, requires_grad=True)
    with torch.no_grad():
        assert flash_attention(q, q, q).grad_fn is None
    assert flash_attention(q.detach(), q.detach(), q.detach()).grad_fn is None


@pytest.mark.parametrize("what", ["device", "mixed", "dtype", "contiguous"])
def test_backward_wrapper_refuses(what):
    """The backward kernels take contiguous CUDA tensors of one dtype on
    one device; anything else raises before a launch. A tensor on the meta
    device stands in for a second device here."""
    q = torch.zeros(1, 2, 8, 16)
    k = v = out = dout = q
    lse = torch.zeros(1, 2, 8)
    if what == "mixed":
        dout = torch.zeros(1, 2, 8, 16, device="meta")
    elif what == "dtype":
        dout = q.double()
    elif what == "contiguous":
        dout = torch.zeros(1, 2, 16, 8).transpose(2, 3)
    before = (LAUNCHES_DQ.count, LAUNCHES_DKV.count)
    with pytest.raises(MXNetError):
        if what == "mixed":
            flash_attention_bwd(q, k, v, out, lse, dout)
        else:
            _launch_bwd(q, k, v, out, lse, dout, False, 0.25)
    assert (LAUNCHES_DQ.count, LAUNCHES_DKV.count) == before
