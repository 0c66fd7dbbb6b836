"""The fp32 tensor-core route of the port's flash-attention forward.

``csrc/flash_fwd_tc32.cu`` computes the fp32 forward on the bf16 tensor
cores: q, k and v are split into three bf16 planes each (``split_bf16x3``),
``S = Q.K^T`` and each 64-key tile's ``P.V`` are the six plane products
``ai.bj`` with ``i + j <= 2``, P is split the same way, the online softmax
runs in base 2 over 64-key tiles, and each tile's ``P.V`` starts a fresh
accumulator that is added to the running output on the CUDA cores. The
kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py);
this file holds a model of its arithmetic:

- against the JAX package's fp32 forward (``_fa_vjp_fwd`` in interpret
  mode, as tests/test_torch_flash_attention.py runs it) on the same
  numpy-seeded inputs, within the limit chip_smoke.py holds the card's
  fp32 forward to (``FWD_TOL["float32"]`` for ``out`` and ``FP32_TOL`` for
  ``lse``, both 1e-4);
- against an fp64 evaluation at the serving and training rung's T = 512,
  where its error stays within 2x of plain fp32's;
- the routes: fp32 with ``D % 8 == 0``, ``D <= 64`` and aligned pointers
  takes this design in the forward, and on CPU tensors nothing launches.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import FP32_TOL, FWD_TOL
from mxnet_tpu.ops.pallas_kernels import _fa_vjp_fwd
from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES, LAUNCHES_SPLIT,
                                                 LAUNCHES_TC32, _fwd_route,
                                                 flash_attention_fwd,
                                                 flash_attention_ref_fwd,
                                                 split_bf16x3_ref)

CASES = {
    # name: (B, H, Tq, Tk, D)
    "T256_D64": (1, 2, 256, 256, 64),
    "ragged_T200_D40": (1, 2, 200, 200, 40),
    "Tq128_Tk320": (1, 2, 128, 320, 64),
}
TILE = 64
# the six plane products (i, j) of a.b, in the kernel's order: smallest first
TERMS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _inputs(seed, B, H, Tq, Tk, D):
    """Unit-scale q, k, v, as the card's checks draw them."""
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype("float32") for T in (Tq, Tk, Tk)]


def mm_split(a, b, terms=TERMS):
    """``a.b`` as the kernel computes it: the plane products, each exact
    in fp32, summed in fp32 smallest first."""
    pa = split_bf16x3_ref(a).float().reshape(3, *a.shape)
    pb = split_bf16x3_ref(b).float().reshape(3, *b.shape)
    out = torch.matmul(pa[terms[0][0]], pb[terms[0][1]])
    for i, j in terms[1:]:
        out = out + torch.matmul(pa[i], pb[j])
    return out


def fwd_model(q, k, v, causal, mm=mm_split):
    """The kernel's forward in fp32, every product through ``mm``: per
    64-key tile S = Q.K^T, the running max m of S*scale*log2(e) (masked
    keys -inf), p = 2^(S*scale*log2(e) - m), l = l*corr + rowsum(p), a
    fresh O_tile = P.V added as O = O*corr + O_tile; then out = O / l and
    lse = (m + log2 l) * ln 2."""
    Tq, Tk = q.shape[2], k.shape[2]
    c = torch.tensor(1.0 / math.sqrt(q.shape[-1]) * math.log2(math.e),
                     dtype=torch.float32)
    m = torch.full(q.shape[:3] + (1,), -math.inf)
    l = torch.zeros(q.shape[:3] + (1,))
    o = torch.zeros(q.shape)
    rows = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, TILE):
        kt, vt = k[:, :, k0:k0 + TILE], v[:, :, k0:k0 + TILE]
        s = mm(q, kt.transpose(-1, -2))
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(cols > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, vt)
        m = m_new
    return o / l, ((m + torch.log2(l)) * math.log(2.0)).squeeze(-1)


@functools.lru_cache(maxsize=None)
def _jax_case(case, causal):
    """The inputs, and the JAX package's fp32 forward (out, lse) of them."""
    B, H, Tq, Tk, D = CASES[case]
    q, k, v = _inputs(21, B, H, Tq, Tk, D)
    out, res = _fa_vjp_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal, None, 128, 128, True)
    return (q, k, v), np.asarray(out), np.asarray(res[4]).reshape(B, H, Tq)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_holds_the_card_limit(case, causal):
    """The model of the kernel's arithmetic against the JAX package's fp32
    forward on the same inputs: ``out`` within chip_smoke's
    ``FWD_TOL["float32"]`` and ``lse`` within ``FP32_TOL``, the limits the
    card's fp32 forward meets."""
    arrays, want, want_lse = _jax_case(case, causal)
    out, lse = fwd_model(*(torch.from_numpy(a) for a in arrays), causal)
    assert np.abs(out.numpy() - want).max() <= FWD_TOL["float32"]
    assert np.abs(lse.numpy() - want_lse).max() <= FP32_TOL


@functools.lru_cache(maxsize=None)
def _rung_errors(causal):
    """Max abs error of out and lse against fp64 at the rung's T = 512
    (B = 1, H = 4, D = 64, unit scale), for the plain fp32 forward and the
    split model, on the same fp32 inputs."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(22, 1, 4, 512, 512, 64))
    logits = torch.matmul(q.double(), k.double().transpose(-1, -2)) / 8.0
    if causal:
        logits = logits.masked_fill(torch.ones(512, 512).triu(1).bool(),
                                    float("-inf"))
    lse = torch.logsumexp(logits, -1)
    exact = (torch.matmul(torch.exp(logits - lse[..., None]), v.double()),
             lse)
    errs = {}
    for name, got in (("fp32", flash_attention_ref_fwd(q, k, v, causal)),
                      ("split", fwd_model(q, k, v, causal))):
        errs[name] = [(a.double() - b.double()).abs().max().item()
                      for a, b in zip(got, exact)]
    return errs


@pytest.mark.parametrize("causal", [False, True])
def test_split_error_within_twice_plain_fp32(causal):
    """Against fp64, ``out`` and ``lse`` of the split model are within 2x
    of the plain fp32 forward's error, so the fp32 route keeps fp32's
    accuracy."""
    errs = _rung_errors(causal)
    for i, name in enumerate(("out", "lse")):
        assert errs["split"][i] <= 2 * errs["fp32"][i], (name, errs)


def test_cpu_fp32_forward_takes_the_plain_version():
    """fp32 CPU tensors: the plain forward, and no launch of the split or
    of any forward kernel."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(23, 1, 2, 64, 64, 64))
    counters = (LAUNCHES, LAUNCHES_TC32, LAUNCHES_SPLIT)
    before = [c.count for c in counters]
    got = flash_attention_fwd(q, k, v, True)
    want = flash_attention_ref_fwd(q, k, v, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", [8, 16, 36, 40, 64, 72, 96, 128])
def test_fp32_forward_route(D, aligned):
    """The forward sends fp32 with D % 8 == 0, D <= 64 and aligned pointers
    to the tensor cores ("tc32") and the rest to the CUDA cores."""
    want = "tc32" if D % 8 == 0 and D <= 64 and aligned else "cc"
    assert _fwd_route(torch.float32, D, aligned) == want
