"""The port's ``PagedLM`` (``serve2/decode.py``) against the JAX package's
on the same parameters, block tables and inputs: prefill, prefill_ext,
decode (1 and 4 steps a call, rows ending mid-window, a dead row), verify
and copy_page, with f32, bf16 and int8 pools.

Tolerances: logits within the ``fusion`` class (rtol 2e-5, atol 1e-6)
for every pool type — both packages read the same stored values, so only
summation orders differ — with the class's atol, which is stated for
unit-scale values, taken relative to each row's largest magnitude (a
logit near 0 of a row whose largest is ~4 carries the roundings of sums
of ~4: 1.2e-6 seen, against 1e-6 x 4.2); greedy tokens equal; pools
after the writes by the same rule per cached row (a bf16 element rounded
from rows a few ulps apart may take the neighbouring bf16 value, one bf16
ulp, 2**-8 relative; so bf16 pools with rtol 2**-7), and int8 codes
within +-1 with scales within ``fusion`` (a row within an ulp of a .5
boundary rounds either way).

Each JAX ``PagedLM`` is built once per module (its programs compile once)
and its pools are zeroed before each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.parallel.pipeline_lm import init_pipeline_lm as jinit
from mxnet_tpu.serve2 import PagedLM as JPagedLM
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import pipeline_lm_from_mxnet_tpu
from mxnet_tpu_torch.opt.verify import tolerance_for
from mxnet_tpu_torch.serve2 import PagedLM

FUSION = tolerance_for("fusion", "float32")
GEOM = dict(page_size=4, num_pages=16, max_pages_per_seq=4)
ROWS = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], "int32")


@pytest.fixture(scope="module")
def params():
    jp = jinit(0, vocab=32, d_model=16, n_layers=2, n_heads=2, d_head=8,
               d_ff=32, n_experts=2)
    return jp, pipeline_lm_from_mxnet_tpu(jax.tree.map(np.asarray, jp),
                                          "cpu")


@pytest.fixture(scope="module")
def jax_lms(params):
    cache = {}

    def get(kv_dtype="f32", steps=1):
        key = (kv_dtype, steps)
        if key not in cache:
            cache[key] = JPagedLM(params[0], decode_steps=steps,
                                  kv_dtype=kv_dtype,
                                  name=f"j-{kv_dtype}-{steps}", **GEOM)
        lm = cache[key]
        lm.pools = jax.tree.map(jnp.zeros_like, lm.pools)
        return lm
    return get


def _pair(params, jax_lms, kv_dtype="f32", steps=1, **kw):
    return jax_lms(kv_dtype, steps), PagedLM(
        params[1], decode_steps=steps, kv_dtype=kv_dtype, device="cpu",
        **GEOM, **kw)


def _close(got, want, err="", row_axes=1, rtol=FUSION[0]):
    """|got - want| <= rtol |want| + atol max(1, max |want| of the row),
    a row being the last ``row_axes`` axes."""
    got, want = np.asarray(got), np.asarray(want)
    axes = tuple(range(want.ndim - row_axes, want.ndim))
    scale = np.maximum(1.0, np.abs(want).max(axis=axes, keepdims=True))
    bad = np.abs(got - want) > rtol * np.abs(want) + FUSION[1] * scale
    assert not bad.any(), (f"{err}: {bad.sum()} of {bad.size} outside "
                           f"fusion; worst {np.abs(got - want).max()}")


def _pools_close(jlm, tlm):
    for key, jpool in jlm.pools.items():
        j = np.asarray(jpool.astype(jnp.float32)) if key in ("k", "v") \
            and tlm.kv_dtype == "bf16" else np.asarray(jpool)
        t = tlm.pools[key]
        t = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if tlm.kv_dtype == "int8" and key in ("k", "v"):
            assert np.abs(t.astype(int) - j.astype(int)).max() <= 1, key
        elif tlm.kv_dtype == "bf16" and key in ("k", "v"):
            _close(t, j, key, row_axes=2, rtol=2.0 ** -7)
        else:
            _close(t, j, key, row_axes=2 if key in ("k", "v") else 0)


def _prefill_both(jlm, tlm, prompts):
    """Prefill each prompt (padded to 8) into its row of ROWS."""
    nxt = []
    for i, p in enumerate(prompts):
        padded = np.zeros((8,), "int32")
        padded[:len(p)] = p
        jn, jl = jlm.prefill(padded, len(p), ROWS[i])
        tn, tl = tlm.prefill(padded, len(p), ROWS[i])
        _close(tl, jl, f"prefill row {i}")
        assert tn == jn
        nxt.append(tn)
    return nxt


PROMPTS = [[3, 9, 1, 4, 7], [11, 2, 30, 5, 5, 8]]


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_prefill_and_decode_match_jax(params, jax_lms, kv_dtype):
    jlm, tlm = _pair(params, jax_lms, kv_dtype)
    nxt = _prefill_both(jlm, tlm, PROMPTS)
    lengths = np.array([len(p) for p in PROMPTS], "int32")
    tokens = np.array(nxt, "int32")
    for step in range(3):
        args = (ROWS, lengths, tokens, np.ones((2,), "int32"))
        jo, jl = jlm.decode(*args)
        to, tl = tlm.decode(*args)
        assert to.dtype == np.int32 and np.array_equal(to, jo)
        _close(tl, jl, f"{kv_dtype} decode step {step}")
        lengths = lengths + 1
        tokens = to[:, 0]
    _pools_close(jlm, tlm)


def test_decode_four_steps_rows_end_mid_window(params, jax_lms):
    jlm, tlm = _pair(params, jax_lms, "f32", steps=4)
    nxt = _prefill_both(jlm, tlm, PROMPTS)
    bt = np.zeros((4, 4), "int32")
    bt[:2] = ROWS
    lengths = np.array([5, 6, 0, 0], "int32")
    tokens = np.array(nxt + [0, 0], "int32")
    remaining = np.array([4, 2, 0, 0], "int32")   # row 1 ends mid-window
    jo, jl = jlm.decode(bt, lengths, tokens, remaining)
    to, tl = tlm.decode(bt, lengths, tokens, remaining)
    for i in range(2):
        assert np.array_equal(to[i, :remaining[i]], jo[i, :remaining[i]])
        _close(tl[i], jl[i], f"row {i}'s final-step logits")
    _pools_close(jlm, tlm)


def test_prefill_ext_matches_jax(params, jax_lms):
    jlm, tlm = _pair(params, jax_lms, "f32")
    prompt = [3, 9, 1, 4, 7, 2, 8, 5]                 # two full pages
    _prefill_both(jlm, tlm, [prompt])
    # a second sequence shares those two pages and adds a suffix
    row = np.array([1, 2, 9, 10], "int32")
    suffix = [6, 6, 1]
    padded = np.zeros((8,), "int32")
    padded[:3] = suffix
    jn, jl = jlm.prefill_ext(padded, 8, 3, row)
    tn, tl = tlm.prefill_ext(padded, 8, 3, row)
    assert tn == jn
    _close(tl, jl, "prefill_ext")
    _pools_close(jlm, tlm)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_verify_matches_jax(params, jax_lms, kv_dtype):
    jlm, tlm = _pair(params, jax_lms, kv_dtype)
    nxt = _prefill_both(jlm, tlm, PROMPTS)
    cands = np.array([[nxt[0], 5, 7], [nxt[1], 1, 2]], "int32")
    lengths = np.array([5, 6], "int32")
    remaining = np.array([3, 2], "int32")
    jo, ja, jl = jlm.verify(ROWS, lengths, cands, remaining)
    to, ta, tl = tlm.verify(ROWS, lengths, cands, remaining)
    assert np.array_equal(ta, ja)
    for i in range(2):
        assert np.array_equal(to[i, :ta[i]], jo[i, :ja[i]])
    _close(tl, jl, "verify's last logits")
    _pools_close(jlm, tlm)


def test_copy_page_matches_jax(params, jax_lms):
    jlm, tlm = _pair(params, jax_lms, "int8")
    _prefill_both(jlm, tlm, PROMPTS)
    jlm.copy_page(2, 12)
    tlm.copy_page(2, 12)
    _pools_close(jlm, tlm)
    page = GEOM["page_size"]
    for pool in tlm.pools.values():
        assert torch.equal(pool[:, 12 * page:13 * page],
                           pool[:, 2 * page:3 * page])


def test_scan_attention_agrees_with_flat(params):
    lms = [PagedLM(params[1], attention=a, device="cpu", **GEOM)
           for a in ("scan", "flat")]
    assert [lm.attention for lm in lms] == ["scan", "flat"]
    outs = []
    for lm in lms:
        padded = np.zeros((8,), "int32")
        padded[:5] = PROMPTS[0]
        n, _ = lm.prefill(padded, 5, ROWS[0])
        outs.append(lm.decode(ROWS[:1], np.array([5], "int32"),
                              np.array([n], "int32"),
                              np.ones((1,), "int32")))
    assert np.array_equal(outs[0][0], outs[1][0])
    _close(outs[0][1], outs[1][1], "scan vs flat")
    assert PagedLM(params[1], device="cpu", **GEOM).attention == "flat"


def test_geometry_report_and_warmup(params, jax_lms):
    jlm = jax_lms("f32", 1)
    tlm = PagedLM(params[1], kv_dtype="f32", device="cpu", name="t-f32",
                  **GEOM)
    for kv in ("f32", "bf16", "int8"):
        geom = dict(page_size=16, n_layers=24, n_heads=16, d_head=128,
                    kv_dtype=kv)
        assert PagedLM.pool_bytes_for(num_pages=7, **geom) == \
            JPagedLM.pool_bytes_for(num_pages=7, **geom)
        assert PagedLM.pages_for_bytes(8 << 30, **geom) == \
            JPagedLM.pages_for_bytes(8 << 30, **geom)
    assert PagedLM.pages_for_bytes(8 << 30, page_size=16, n_layers=24,
                                   n_heads=16, d_head=128) == 1365
    rep = tlm.warmup((1, 2), (8,), verify_width=3, prefill_ext=True,
                     copy_page=True)
    assert [(r["program"], r["size"]) for r in rep] == [
        ("decode", 1), ("verify", 1), ("decode", 2), ("verify", 2),
        ("prefill", 8), ("prefill_ext", 8), ("copy_page", 0)]
    report = tlm.lint_report()
    assert set(report) == set(jlm.lint_report())
    assert report["donate_mode"] == "in_place" and report["donate_pages"]
    assert report["recompiles_after_warmup"] == 0
    tlm.decode(np.zeros((3, 4), "int32"), np.zeros((3,), "int32"),
               np.zeros((3,), "int32"), np.zeros((3,), "int32"))
    assert tlm.lint_report()["recompiles_after_warmup"] == 1
    ptrs = {k: v.data_ptr() for k, v in tlm.pools.items()}
    assert ptrs == {k: v.data_ptr() for k, v in tlm.pools.items()}
    for call in (lambda: tlm.export_pages([1]),
                 lambda: tlm.import_pages([1], {}),
                 lambda: tlm.warmup((1,), (8,), pagewire_chunk=2)):
        with pytest.raises(MXNetError, match="item 8"):
            call()
    with pytest.raises(MXNetError):
        PagedLM(params[1], kv_dtype="fp8", device="cpu", **GEOM)
    with pytest.raises(MXNetError):
        PagedLM(params[1], attention="ring", device="cpu", **GEOM)
