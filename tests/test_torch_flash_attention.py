"""The port's flash-attention forward against the JAX package's.

Inputs come from a numpy seed and go through both: the JAX Pallas kernel
in interpret mode (as tests/test_pallas.py runs it on the CPU) and the
port's wrapper on CPU tensors, which computes the CUDA kernel's plain
version. Tolerance rtol 2e-4 / atol 2e-4, as test_pallas.py holds the
Pallas kernel against dense attention (fp32, different summation orders).
The kernel itself is held against the same plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import _fa_vjp_fwd
from mxnet_tpu.ops.pallas_kernels import flash_attention as jax_flash
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import flash_attention_fwd as torch_flash_fwd
from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES, _launch,
                                                 flash_attention,
                                                 flash_attention_ref_fwd)
from mxnet_tpu_torch.parallel import local_attention as torch_local

RTOL = ATOL = 2e-4


def _qkv(seed, B, H, Tq, Tk, D, qk_scale=0.5):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, Tq, D) * qk_scale).astype("float32")
    k = (rng.randn(B, H, Tk, D) * qk_scale).astype("float32")
    v = rng.randn(B, H, Tk, D).astype("float32")
    return q, k, v


def _port(q, k, v, causal):
    out, lse = torch_flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal)
    return out.numpy(), lse.numpy()


CASES = {
    # name: (B, H, Tq, Tk, D)
    "T256_D64": (2, 2, 256, 256, 64),
    "odd_T200": (1, 2, 200, 200, 64),
    "head_dim_96": (1, 2, 256, 256, 96),
    "Tq128_Tk384": (1, 2, 128, 384, 64),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_forward_matches_jax(case, causal):
    q, k, v = _qkv(0, *CASES[case])
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     None, 128, 128, True)
    got, _ = _port(q, k, v, causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bq,bk", [(256, 128), (128, 256), (64, 128)])
def test_flash_forward_causal_mixed_blocks(bq, bk):
    """The Pallas kernel's causal block-count regression case: the port
    has no block sizes, so every JAX tiling must give its one answer."""
    q, k, v = _qkv(2, 1, 1, 256, 256, 64)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                     None, bq, bk, True)
    got, _ = _port(q, k, v, True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_lse_matches_jax(case, causal):
    """``lse`` (kept for the backward) equals the Pallas forward's row
    log-sum-exp, (BH, Tq, 1) there and (B, H, Tq) here."""
    B, H, Tq, Tk, D = CASES[case]
    q, k, v = _qkv(1, B, H, Tq, Tk, D)
    _, res = _fa_vjp_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, None, 128, 128, True)
    want = np.asarray(res[4]).reshape(B, H, Tq)
    _, got = _port(q, k, v, causal)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_local_attention(causal):
    """The port's two dense oracles agree (the kernel's plain version and
    ``local_attention``), with and without a given scale."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 3, 40, 56, 24))
    for scale in (None, 0.3):
        out, _ = flash_attention_ref_fwd(q, k, v, causal, scale)
        ref = torch_local(q, k, v, scale=scale, causal=causal)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


def test_plain_version_keeps_dtype_and_computes_fp32():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(4, 1, 2, 32, 32, 16))
    out, lse = flash_attention_ref_fwd(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = flash_attention_ref_fwd(q.float(), k.float(), v.float())
    torch.testing.assert_close(out, ref.to(torch.bfloat16))


def test_cpu_path_launches_nothing():
    q = torch.zeros(1, 1, 8, 16)
    before = LAUNCHES.count
    flash_attention(q, q, q)
    assert LAUNCHES.count == before


def test_shape_mismatch_raises():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(MXNetError):
        flash_attention(q, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8))
    with pytest.raises(MXNetError):
        flash_attention(q[0], q[0], q[0])


@pytest.mark.parametrize("what", ["dtype", "head_dim", "contiguous",
                                  "device"])
def test_kernel_wrapper_refuses(what):
    """What the kernel does not take is refused before any launch (the
    checks run in this order, so each can be reached on the CPU)."""
    q = torch.zeros(1, 2, 8, 16)
    k = v = q
    if what == "dtype":
        q = k = v = q.double()
    elif what == "head_dim":
        q = k = v = torch.zeros(1, 2, 8, 160)
    elif what == "contiguous":
        k = torch.zeros(1, 2, 16, 8).transpose(2, 3)
    before = LAUNCHES.count
    with pytest.raises(MXNetError):
        _launch(q, k, v, False, 0.25)
    assert LAUNCHES.count == before


def test_kernel_build_reports_missing_nvcc(tmp_path, monkeypatch):
    """Kernels build at first use; without nvcc the error says so (and
    nothing half-built is left behind)."""
    from mxnet_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.build_all()
    assert not any((tmp_path / "build").glob("*.so"))
