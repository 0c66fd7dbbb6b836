"""The fp32 tensor-core route of the port's flash-attention backward.

``csrc/flash_bwd_tc32.cu`` (D <= 64) and ``csrc/flash_bwd_tc32_d128.cu``
(64 < D <= 128) compute the fp32 backward on the bf16 tensor cores: every
fp32 operand is split into three bf16 planes (``split_bf16x3``:
``x0 = bf16(x)``, ``x1 = bf16(x - x0)``, ``x2 = bf16(x - x0 - x1)``) and
every product ``a.b`` into the six plane products ``ai.bj`` with
``i + j <= 2``, each exact in fp32, summed in the fp32 accumulator
smallest first; dQ, dK and dV sum one tile of the swept operand (64 rows,
or 32 for D > 64) at a time into a fresh accumulator and add it to the
running fp32 sum. The kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py); this file holds a model of their
arithmetic:

- against the JAX package's fp32 backward (``jax.vjp`` of the Pallas
  ``flash_attention`` in interpret mode, as tests/test_pallas.py runs it),
  within the limit chip_smoke.py holds the card's fp32 backward to
  (``BWD_TOL["float32"]``: 1e-4 max abs);
- against an fp64 evaluation at the training rung's T = 512 (D = 64 and
  128), where its error stays within 2x of plain fp32's and one-pass
  TF32's does not;
- the split: the planes sum back to ``x``;
- the routes: fp32 with ``D % 8 == 0`` takes this design in the backward
  up to D = 128, and its counterparts (csrc/flash_fwd_tc32.cu,
  csrc/flash_fwd_tc32_d128.cu) in the forward.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import BWD_TOL
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES_DKV_TC32,
                                                 LAUNCHES_DQ_TC32,
                                                 LAUNCHES_SPLIT, _bwd_route,
                                                 _fwd_route,
                                                 flash_attention_bwd,
                                                 flash_attention_ref_bwd,
                                                 flash_attention_ref_fwd,
                                                 split_bf16x3,
                                                 split_bf16x3_ref)
from mxnet_tpu.ops.pallas_kernels import flash_attention as jax_flash

CASES = {
    # name: (B, H, Tq, Tk, D)
    "T256_D64": (1, 2, 256, 256, 64),
    "ragged_T200_D96": (1, 2, 200, 200, 96),
    "Tq128_Tk256": (1, 1, 128, 256, 64),
    "T200_D40": (1, 2, 200, 200, 40),
    "ragged_T200_D80": (1, 2, 200, 200, 80),
    "T256_D128": (1, 2, 256, 256, 128),
}

# the six plane products (i, j) of a.b, in the kernel's order: smallest first
TERMS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _inputs(seed, B, H, Tq, Tk, D):
    """Unit-scale q, k, v and dO, as the card's checks draw them."""
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, D).astype("float32")
                 for T in (Tq, Tk, Tk, Tq))


def _planes(x):
    return split_bf16x3_ref(x).float().reshape(3, *x.shape)


def mm_split(a, b, terms=TERMS):
    """``a.b`` as the kernel computes it: the six plane products, each
    exact in fp32, summed in fp32 smallest first (or the given ``terms``)."""
    pa, pb = _planes(a), _planes(b)
    out = torch.matmul(pa[terms[0][0]], pb[terms[0][1]])
    for i, j in terms[1:]:
        out = out + torch.matmul(pa[i], pb[j])
    return out


def mm_split_tiles(a, b, rows):
    """``a.b`` as the kernels sum dQ, dK and dV: the contraction in tiles
    of ``rows`` (64, or 32 for D > 64), each tile's six plane products
    (:func:`mm_split`) in a fresh accumulator, added to the running fp32
    sum in order."""
    out = mm_split(a[..., :rows], b[..., :rows, :])
    for i in range(rows, a.shape[-1], rows):
        out = out + mm_split(a[..., i:i + rows], b[..., i:i + rows, :])
    return out


def _kernel_sum(D):
    """The model of the kernel that serves head dim ``D``: its tile rows."""
    return functools.partial(mm_split_tiles, rows=64 if D <= 64 else 32)


def mm_split2(a, b):
    """``a.b`` on two planes per operand, three plane products: half the
    tensor-core work of :func:`mm_split`."""
    return mm_split(a, b, ((1, 0), (0, 1), (0, 0)))


def _tf32(x):
    """x rounded to TF32's 10 fraction bits (to nearest, ties away)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32(a, b):
    """``a.b`` in one pass of TF32 (the tensor cores' fp32 mode)."""
    return torch.matmul(_tf32(a), _tf32(b))


def bwd_model(q, k, v, out, lse, dout, causal, mm=torch.matmul,
              mm_sum=None):
    """``flash_attention_ref_bwd``'s formulas in the dtype of the inputs,
    every product through ``mm`` (dQ, dK and dV through ``mm_sum`` where
    given)."""
    mm_sum = mm_sum or mm
    s = 1.0 / np.sqrt(q.shape[-1])
    logits = mm(q, k.transpose(-1, -2)) * s
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        keep = torch.arange(Tq)[:, None] >= torch.arange(Tk)[None, :]
        logits = logits.masked_fill(~keep, float("-inf"))
    p = torch.exp(logits - lse[..., None])
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (mm(dout, v.transpose(-1, -2)) - delta)
    return (mm_sum(ds, k) * s, mm_sum(ds.transpose(-1, -2), q) * s,
            mm_sum(p.transpose(-1, -2), dout))


@functools.lru_cache(maxsize=None)
def _jax_case(case, causal):
    """The inputs, and the JAX package's fp32 backward of them."""
    q, k, v, g = _inputs(11, *CASES[case])
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, None, 128,
                                               128, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (q, k, v, g), [np.asarray(w) for w in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_holds_the_card_limit(case, causal):
    """The model of the arithmetic of the kernel that serves the case's
    head dim against the JAX package's fp32 backward on the same inputs:
    within chip_smoke's BWD_TOL["float32"], the limit the card's fp32
    kernels meet."""
    arrays, want = _jax_case(case, causal)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    out, lse = flash_attention_ref_fwd(q, k, v, causal)
    got = bwd_model(q, k, v, out, lse, g, causal, mm_split,
                    _kernel_sum(q.shape[-1]))
    atol, rtol = BWD_TOL["float32"]
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol,
                                   err_msg=f"d{name}")


@functools.lru_cache(maxsize=None)
def _rung_errors(causal):
    """Max abs error of dq, dk, dv against fp64 at the rung's T = 512
    (B = 1, H = 4, D = 64, unit scale), for plain fp32 products, the
    split, two planes with three products and one-pass TF32. Every version gets the same fp32 inputs,
    with out and lse from the fp64 forward rounded to fp32."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(12, 1, 4, 512, 512,
                                                        64))
    logits = torch.matmul(q.double(), k.double().transpose(-1, -2)) / 8.0
    if causal:
        logits = logits.masked_fill(torch.ones(512, 512).triu(1).bool(),
                                    float("-inf"))
    lse = torch.logsumexp(logits, -1)
    out = torch.matmul(torch.exp(logits - lse[..., None]), v.double())
    out, lse = out.float(), lse.float()
    exact = bwd_model(*(t.double() for t in (q, k, v, out, lse, g)), causal)
    errs = {}
    for name, mm in (("fp32", torch.matmul), ("split", mm_split),
                     ("split2", mm_split2), ("tf32", mm_tf32)):
        got = bwd_model(q, k, v, out, lse, g, causal, mm)
        errs[name] = [(a.double() - b).abs().max().item()
                      for a, b in zip(got, exact)]
    return errs


@pytest.mark.parametrize("causal", [False, True])
def test_split_error_within_twice_plain_fp32(causal):
    """Against fp64, each of dq, dk, dv of the split model is within 2x of
    plain fp32 products' error, so the fp32 route keeps fp32's accuracy;
    one-pass TF32 is not (its error is hundreds of times plain fp32's and,
    causal, over the card's 1e-4 limit), nor are two planes with three
    products (several times plain fp32's)."""
    errs = _rung_errors(causal)
    for i, name in enumerate(("dq", "dk", "dv")):
        plain = errs["fp32"][i]
        assert errs["split"][i] <= 2 * plain, (name, errs)
        assert errs["tf32"][i] > 2 * plain, (name, errs)
        assert errs["split2"][i] > 2 * plain, (name, errs)
    if causal:
        assert max(errs["tf32"]) > BWD_TOL["float32"][0]


@functools.lru_cache(maxsize=None)
def _wide_errors(causal):
    """Max abs error of dq, dk, dv against fp64 at T = 512 with D = 128
    (B = 1, H = 2, unit scale) for plain fp32 products and for the model of
    csrc/flash_bwd_tc32_d128.cu (32-row tiles), on the same fp32 inputs,
    out and lse from the fp64 forward rounded to fp32."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(16, 1, 2, 512, 512,
                                                        128))
    logits = torch.matmul(q.double(), k.double().transpose(-1, -2)) \
        / np.sqrt(128)
    if causal:
        logits = logits.masked_fill(torch.ones(512, 512).triu(1).bool(),
                                    float("-inf"))
    lse = torch.logsumexp(logits, -1)
    out = torch.matmul(torch.exp(logits - lse[..., None]), v.double())
    out, lse = out.float(), lse.float()
    exact = bwd_model(*(t.double() for t in (q, k, v, out, lse, g)), causal)
    errs = {}
    for name, mm, mm_sum in (("fp32", torch.matmul, None),
                             ("split", mm_split, _kernel_sum(128))):
        got = bwd_model(q, k, v, out, lse, g, causal, mm, mm_sum)
        errs[name] = [(a.double() - b).abs().max().item()
                      for a, b in zip(got, exact)]
    return errs


@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_split_error_within_twice_plain_fp32(causal):
    """At D = 128, summed in the 32-row tiles of the D > 64 kernel, each of
    dq, dk, dv of the split model stays within 2x of plain fp32 products'
    error against fp64."""
    errs = _wide_errors(causal)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert errs["split"][i] <= 2 * errs["fp32"][i], (name, errs)


# half of bf16's smallest subnormal (2^-133): the planes are multiples of
# it, so what lies below it cannot be kept
FLOOR = 2.0 ** -134
EXTREMES = [0.0, -0.0, 2.0 ** -149, -(2.0 ** -140), 2.0 ** -134,
            1.5 * 2.0 ** -133, 2.0 ** -126, -1.1754942e-38, 3.0e-39,
            2.0 ** -110 * 1.2345678, 1e-30, 1.0, -1.0000001, 65504.0, 1e30,
            -1e38, 3.38e38, 3.3961e38, -3.4e38, 3.4028235e38, -3.4028235e38]


@pytest.mark.parametrize("kind", ["normal", "wide", "extreme"])
def test_split_sums_back_to_x(kind):
    """x0 + x1 + x2 == x within 2^-24 |x| (exactly, for |x| >= 2^-110,
    where the third plane's last bit is still a bf16 value), and within
    bf16's floor below that; every plane is finite, and at the top of
    the range (where bf16(x) overflows) x0 is x truncated."""
    rng = np.random.RandomState(13)
    if kind == "normal":
        x = rng.randn(4096)
    elif kind == "wide":
        x = rng.randn(4096) * 2.0 ** rng.randint(-140, 127, 4096)
    else:
        x = np.array(EXTREMES)
    x = torch.from_numpy(x.astype("float32"))
    planes = split_bf16x3_ref(x)
    assert planes.shape == (3, x.numel()) and planes.dtype == torch.bfloat16
    assert bool(torch.isfinite(planes).all())
    x64 = x.double()
    err = (planes.double().sum(0) - x64).abs()
    assert bool((err <= 2.0 ** -24 * x64.abs() + FLOOR).all())
    big = x64.abs() >= 2.0 ** -110
    assert bool((err[big] == 0).all())
    # each plane is at most half an ulp of the one before (a whole ulp,
    # 2^-7 of it, after a truncated x0)
    for a, b in ((0, 1), (1, 2)):
        lo, hi = planes[b].double().abs(), planes[a].double().abs()
        assert bool((lo <= 2.0 ** -7 * hi + FLOOR).all())


def test_split_of_several_tensors_is_back_to_back():
    """One call splits up to four tensors into one (3, N) tensor, each
    tensor's elements after the one before in every plane; on CPU tensors
    no kernel is launched."""
    rng = np.random.RandomState(14)
    xs = [torch.from_numpy(rng.randn(*s).astype("float32"))
          for s in ((2, 3, 8), (5, 4), (16,), (1, 2, 2, 4))]
    before = LAUNCHES_SPLIT.count
    planes = split_bf16x3(*xs)
    assert LAUNCHES_SPLIT.count == before
    at = 0
    for x in xs:
        n = x.numel()
        assert torch.equal(planes[:, at:at + n].view(torch.int16),
                           split_bf16x3_ref(x).view(torch.int16))
        at += n
    assert planes.shape == (3, at)


@pytest.mark.parametrize("what", ["none", "five", "dtype", "contiguous"])
def test_split_refuses(what):
    x = torch.zeros(8)
    args = {"none": (), "five": (x,) * 5, "dtype": (x.double(),),
            "contiguous": (torch.zeros(4, 4).t(),)}[what]
    with pytest.raises(MXNetError):
        split_bf16x3(*args)


def test_cpu_fp32_backward_takes_the_plain_version():
    """fp32 CPU tensors: the plain backward, and no launch of the split or
    the fp32 tensor-core passes."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(15, 1, 2, 64, 64,
                                                        64))
    out, lse = flash_attention_ref_fwd(q, k, v)
    counters = (LAUNCHES_SPLIT, LAUNCHES_DQ_TC32, LAUNCHES_DKV_TC32)
    before = [c.count for c in counters]
    got = flash_attention_bwd(q, k, v, out, lse, g)
    want = flash_attention_ref_bwd(q, k, v, out, lse, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", [8, 16, 36, 40, 64, 72, 96, 100, 128])
def test_fp32_routes(D, aligned):
    """The backward and the forward send fp32 with D % 8 == 0 (up to 128)
    and aligned pointers to the tensor cores ("tc32") and the rest to the
    CUDA cores."""
    tc = D % 8 == 0 and aligned
    assert _bwd_route(torch.float32, D, aligned) == ("tc32" if tc else "cc")
    assert _fwd_route(torch.float32, D, aligned) == ("tc32" if tc else "cc")
