"""The tensor-core route of the port's flash-attention forward.

``csrc/flash_fwd_tc.cu`` runs only on the card, where chip_smoke.py and
tests/test_torch_cuda.py hold it against the plain version. Here, on the
CPU, three things are checked:

- which design :func:`_fwd_route` picks for a launch (fp32's tensor-core
  route has its own file, tests/test_torch_flash_forward_tc32.py);
- a rounding model of the kernel (the plain forward with p rounded to the
  input type before the P.V product and the output rounded once) against
  the JAX package's fp32 forward in interpret mode (as
  tests/test_torch_flash_attention.py runs it) on the same rounded inputs,
  within the limit chip_smoke.py holds the card to (``FWD_TOL``);
- that the limit covers the derivation's bound at the card's largest
  shape.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import FP32_TOL, FWD_TOL
from mxnet_tpu.ops.pallas_kernels import _fa_vjp_fwd
from mxnet_tpu_torch.ops.flash_attention import (_fwd_route, _logits,
                                                 flash_attention_ref_fwd)

CASES = {
    # name: (B, H, Tq, Tk, D)
    "T256_D64": (1, 2, 256, 256, 64),
    "odd_T200": (1, 2, 200, 200, 64),
    "head_dim_96": (1, 2, 256, 256, 96),
    "Tq128_Tk384": (1, 2, 128, 384, 64),
}
_ROUNDED = ("float16", "bfloat16")
# u: the unit roundoff of each 16-bit type
_U = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8}


def _unit_inputs(seed, B, H, Tq, Tk, D):
    """Unit-scale q, k, v, as the card's checks draw them."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, H, T, D).astype("float32"))
            for T in (Tq, Tk, Tk)]


def _tc_forward_model(q, k, v, causal, dtype):
    """The tensor-core forward's arithmetic in fp32: fp32 logits, p =
    exp(s - rowmax) in fp32 and rounded to ``dtype`` as the A operand of
    P.V, the row sum l over the fp32 p, the output rounded once."""
    logits = _logits(q, k, causal, 1.0 / np.sqrt(q.shape[-1]))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p.to(dtype).float(), v) / l
    return out.to(dtype), (m + torch.log(l)).squeeze(-1)


@functools.lru_cache(maxsize=None)
def _rounded_case(case, causal):
    """Inputs rounded to each 16-bit type (as float32), and the JAX
    forward (out, lse) of both in one call, stacked along the batch."""
    B, H, Tq, Tk, D = CASES[case]
    raw = _unit_inputs(11, B, H, Tq, Tk, D)
    ins = {dt: [t.to(getattr(torch, dt)).float() for t in raw]
           for dt in _ROUNDED}
    out, res = _fa_vjp_fwd(*(jnp.asarray(np.concatenate(
        [ins[dt][i].numpy() for dt in _ROUNDED])) for i in range(3)),
        causal, None, 128, 128, True)
    out = np.asarray(out)
    lse = np.asarray(res[4]).reshape(2 * B, H, Tq)
    return {dt: (ins[dt], out[j * B:(j + 1) * B], lse[j * B:(j + 1) * B])
            for j, dt in enumerate(_ROUNDED)}


@pytest.mark.parametrize("dtype", _ROUNDED)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rounding_model_holds_the_card_limit(case, causal, dtype):
    """The rounding model on ``dtype``-rounded inputs against the JAX
    package's fp32 forward on the same values: max abs within chip_smoke's
    ``FWD_TOL[dtype]`` (out) and ``FP32_TOL`` (lse), the limits the card's
    tensor-core kernel meets."""
    (q, k, v), want, want_lse = _rounded_case(case, causal)[dtype]
    out, lse = _tc_forward_model(q, k, v, causal, getattr(torch, dtype))
    assert np.abs(out.float().numpy() - want).max() <= FWD_TOL[dtype]
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0,
                               atol=FP32_TOL)


@pytest.mark.parametrize("dtype", _ROUNDED)
def test_limit_covers_the_rounding(dtype):
    """The derivation beside ``FWD_TOL``: rounding p moves an output by at
    most u * sum_{c != argmax} p_c |v_c| / l (p = 1 at the row's maximum is
    exact), and rounding the output by at most u * |out|. At the card's
    training rung (8 x 12 x 512 x 64, unit scale) and causal (whose first
    rows see one or two keys, so out and the sum approach max|v|), the
    largest sum of the two stays under the limit."""
    q, k, v = (t.to(getattr(torch, dtype)).float()
               for t in _unit_inputs(12, 8, 12, 512, 512, 64))
    out, lse = flash_attention_ref_fwd(q, k, v, True)
    p = torch.exp(_logits(q, k, True, 0.125) - lse[..., None])  # p / l
    top = p.argmax(-1, keepdim=True)
    p = p.scatter(-1, top, 0.0)
    bound = _U[dtype] * (torch.matmul(p, v.abs()) + out.abs()).max().item()
    assert bound <= FWD_TOL[dtype]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", [8, 16, 36, 64, 96, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_forward_route(dtype, D, aligned):
    """Tensor cores for 16-bit types with D % 8 == 0 and aligned pointers,
    and for fp32 with D % 8 == 0, D <= 64 and aligned pointers on bf16
    planes ("tc32"); the CUDA-core kernel for everything else."""
    want = "cc"
    if D % 8 == 0 and aligned:
        if dtype != torch.float32:
            want = "tc"
        elif D <= 64:
            want = "tc32"
    assert _fwd_route(dtype, D, aligned) == want
