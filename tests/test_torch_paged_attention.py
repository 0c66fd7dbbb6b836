"""The port's paged attention (``parallel/paged_attention.py``) against the
JAX package's, both formulations (the page-streaming ``scan`` and the
one-gather ``flat``), on f32, bf16 and int8 pools.

Rows of length 0 (exactly zero output), a partial page, a length on a page
boundary and a full window. Tolerances: ``fusion`` (rtol 2e-5, atol 1e-6)
for every pool type, since both packages dequantize the same stored values
to f32 before the same float32 math; the int8 codes of one quantized write
agree to +-1 (a row within an ulp of a .5 boundary may round the other
way: the rows are computed with different summation orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel import paged_attention as jpa
from mxnet_tpu.serve2.decode import _q_write
from mxnet_tpu_torch.opt.verify import tolerance_for
from mxnet_tpu_torch.parallel import paged_attention as tpa
from mxnet_tpu_torch.serve2.decode import _quantize

FUSION = tolerance_for("fusion", "float32")
B, N, PAGE, H, K = 4, 4, 4, 2, 8
S = 32 * PAGE
LENGTHS = np.array([0, 5, 8, 16], "int32")   # dead, partial, boundary, full


def _inputs(kv_dtype, seed=0):
    """Pools as both packages store them: bf16 rounded once (numpy ->
    torch bf16 -> back is the same RNE), int8 codes with f32 scales."""
    rs = np.random.RandomState(seed)
    k = rs.randn(S, H, K).astype("float32")
    v = rs.randn(S, H, K).astype("float32")
    q = rs.randn(B, H, K).astype("float32")
    bt = rs.randint(1, 32, size=(B, N)).astype("int32")
    ks = vs = None
    if kv_dtype == "int8":
        ks = (np.abs(k).max((1, 2)) / 127.0).astype("float32")
        vs = (np.abs(v).max((1, 2)) / 127.0).astype("float32")
        k = np.clip(np.round(k / ks[:, None, None]), -127, 127).astype("int8")
        v = np.clip(np.round(v / vs[:, None, None]), -127, 127).astype("int8")
    return q, k, v, bt, ks, vs


def _torch_pool(x, kv_dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if kv_dtype == "bf16" else t


def _jax_pool(x, kv_dtype):
    return jnp.asarray(x, jnp.bfloat16) if kv_dtype == "bf16" \
        else jnp.asarray(x)


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("form", ["paged_attention", "paged_attention_flat"])
def test_matches_jax(form, kv_dtype):
    q, k, v, bt, ks, vs = _inputs(kv_dtype)
    opt = lambda x, f: None if x is None else f(x)  # noqa: E731
    want = np.asarray(getattr(jpa, form)(
        jnp.asarray(q), _jax_pool(k, kv_dtype), _jax_pool(v, kv_dtype),
        jnp.asarray(bt), jnp.asarray(LENGTHS), page_size=PAGE,
        kscale=opt(ks, jnp.asarray), vscale=opt(vs, jnp.asarray)))
    got = getattr(tpa, form)(
        torch.from_numpy(q), _torch_pool(k, kv_dtype),
        _torch_pool(v, kv_dtype), torch.from_numpy(bt),
        torch.from_numpy(LENGTHS), page_size=PAGE,
        kscale=opt(ks, torch.from_numpy),
        vscale=opt(vs, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, want, rtol=FUSION[0], atol=FUSION[1])
    assert np.array_equal(got[0], np.zeros((H, K), "float32"))
    assert np.isfinite(got).all()


def test_scan_and_flat_agree():
    q, k, v, bt, _, _ = _inputs("f32", seed=1)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(bt), torch.from_numpy(LENGTHS))
    a = tpa.paged_attention(*args, page_size=PAGE)
    b = tpa.paged_attention_flat(*args, page_size=PAGE)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=FUSION[0],
                               atol=FUSION[1])


def test_int8_quantized_write_matches_jax():
    """Codes within +-1 and scales within fusion of the JAX package's
    ``_q_write`` on the same rows; bit-equal on rows computed the same
    way (here: the same float32 inputs)."""
    rs = np.random.RandomState(3)
    rows = rs.randn(6, H, K).astype("float32")
    rows[2] = 0.0                                       # the 1e-8 floor
    slot = jnp.arange(6, dtype=jnp.int32)
    jq, js = _q_write("int8", jnp.zeros((6, H, K), jnp.int8),
                      jnp.zeros((6,), jnp.float32), slot, jnp.asarray(rows))
    tq, ts = _quantize(torch.from_numpy(rows))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    # rows an ulp apart (another summation order) move a code by <= 1
    tq2, _ = _quantize(torch.from_numpy(
        np.nextafter(rows, np.float32(np.inf))))
    assert np.abs(tq2.numpy().astype(int) - np.asarray(jq).astype(int)
                  ).max() <= 1
