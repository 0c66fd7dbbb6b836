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

The tensor-core route (``csrc/flash_bwd_tc.cu``) rounds p and dS to the
input type once, as operands of the dV, dK and dQ products. A rounding
model of that (the plain backward with those two roundings) is held here
against the JAX package's fp32 backward under the tolerance chip_smoke.py
holds the card to, so the tolerance is shown to leave room for the rounding.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import BWD_TOL
from mxnet_tpu.ops.pallas_kernels import flash_attention as jax_flash
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES_DKV, LAUNCHES_DQ,
                                                 _bwd_route, _launch_bwd,
                                                 _logits, flash_attention,
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


def _inputs(seed, B, H, Tq, Tk, D, qk_scale=0.3):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, Tq, D) * qk_scale).astype("float32")
    k = (rng.randn(B, H, Tk, D) * qk_scale).astype("float32")
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


def _jax_grads(q, k, v, g, causal):
    """``jax.vjp`` of the Pallas ``flash_attention`` in interpret mode."""
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, None, 128,
                                               128, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_jax(case):
    B, H, Tq, Tk, D, causal = CASES[case]
    q, k, v, g = _inputs(3, B, H, Tq, Tk, D)
    want = _jax_grads(q, k, v, g, causal)
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


def _rounded_operand_bwd(q, k, v, out, lse, dout, causal, dtype):
    """The tensor-core route's arithmetic in fp32: the plain backward with
    p and ds rounded to ``dtype`` before the dV, dK and dQ products and
    every gradient rounded once to ``dtype``."""
    s = 1.0 / np.sqrt(q.shape[-1])
    p = torch.exp(_logits(q, k, causal, s) - lse[..., None])
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dout, v.transpose(-1, -2)) - delta)
    p, ds = p.to(dtype).float(), ds.to(dtype).float()
    dq = torch.matmul(ds, k) * s
    dk = torch.matmul(ds.transpose(-1, -2), q) * s
    dv = torch.matmul(p.transpose(-1, -2), dout)
    return tuple(t.to(dtype) for t in (dq, dk, dv))


_ROUNDED = ("float16", "bfloat16")


@functools.lru_cache(maxsize=None)
def _rounded_case(case):
    """Unit-scale inputs (as the card's checks draw them) rounded to each
    16-bit type (as float32), and the JAX backward of both in one call
    (stacked along the batch)."""
    B, H, Tq, Tk, D, causal = CASES[case]
    raw = [torch.from_numpy(a) for a in _inputs(7, B, H, Tq, Tk, D, 1.0)]
    ins = {dt: [t.to(getattr(torch, dt)).float() for t in raw]
           for dt in _ROUNDED}
    both = _jax_grads(*(np.concatenate([ins[dt][i].numpy()
                                        for dt in _ROUNDED])
                        for i in range(4)), causal)
    return {dt: (ins[dt], [np.asarray(w)[j * B:(j + 1) * B] for w in both])
            for j, dt in enumerate(_ROUNDED)}


@pytest.mark.parametrize("dtype", _ROUNDED)
@pytest.mark.parametrize("case", sorted(CASES))
def test_rounded_operands_hold_the_card_tolerance(case, dtype):
    """The rounding model on ``dtype``-rounded inputs (the forward's output
    rounded too, as the kernel stores it) against the JAX package's fp32
    backward on the same rounded values: elementwise within chip_smoke's
    ``BWD_TOL[dtype]``, the limit the card's tensor-core kernels meet."""
    causal = CASES[case][-1]
    tdt = getattr(torch, dtype)
    (q, k, v, g), want = _rounded_case(case)[dtype]
    out, lse = flash_attention_ref_fwd(q, k, v, causal)
    got = _rounded_operand_bwd(q, k, v, out.to(tdt).float(), lse, g, causal,
                               tdt)
    atol, rtol = BWD_TOL[dtype]
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", [8, 16, 36, 64, 96, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_backward_route(dtype, D, aligned):
    """Tensor cores for 16-bit types with D % 8 == 0 and aligned pointers,
    and for fp32 too (on bf16 planes: csrc/flash_bwd_tc32.cu up to D = 64,
    csrc/flash_bwd_tc32_d128.cu up to 128); the CUDA-core kernels for
    everything else."""
    if D % 8 or not aligned:
        want = "cc"
    elif dtype != torch.float32:
        want = "tc"
    else:
        want = "tc32"
    assert _bwd_route(dtype, D, aligned) == want


@pytest.mark.parametrize("shape", [CASES[c][:5] for c in sorted(CASES)]
                         + [(1, 12, 512, 512, 64)],
                         ids=sorted(CASES) + ["card_rung"])
def test_fp16_atol_covers_the_operand_rounding(shape):
    """Rounding p and ds to fp16 (u = 2^-11) moves an element of dV, dK or
    dQ by at most u * sum|terms| of its product. At unit-scale inputs,
    causal (the largest sums: early rows see few keys, and every row sees
    the first keys) and up to the training rung's T = 512, that bound stays
    under the fp16 atol chip_smoke.py holds the card's tensor-core kernels
    to."""
    B, H, Tq, Tk, D = shape
    q, k, v, g = (torch.from_numpy(a).half().float()
                  for a in _inputs(8, B, H, Tq, Tk, D, 1.0))
    out, lse = flash_attention_ref_fwd(q, k, v, True)
    s = 1.0 / np.sqrt(D)
    p = torch.exp(_logits(q, k, True, s) - lse[..., None])
    ds = p * (torch.matmul(g, v.transpose(-1, -2))
              - (g * out.half().float()).sum(-1, keepdim=True))
    sums = (s * torch.matmul(ds.abs(), k.abs()),
            s * torch.matmul(ds.abs().transpose(-1, -2), q.abs()),
            torch.matmul(p.transpose(-1, -2), g.abs()))
    bound = 2.0 ** -11 * max(t.max().item() for t in sums)
    assert bound <= BWD_TOL["float16"][0]
