"""The port's dense LM stack (``parallel/pipeline_lm.py``), the weight
converter and the tolerance classes against the JAX package.

``init_pipeline_lm`` must give bit-equal weights from the same seed (the
same numpy draws, rounded to float32 the same way). The dense forward is
held to the JAX package's within the ``fusion`` class (rtol 2e-5, atol
1e-6): both are float32 with different summation orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.opt import verify as jverify
from mxnet_tpu.parallel import pipeline_lm as jlm
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import pipeline_lm_from_mxnet_tpu
from mxnet_tpu_torch.opt import verify
from mxnet_tpu_torch.parallel import pipeline_lm as tlm

FUSION = verify.tolerance_for("fusion", "float32")


def _widths(n_experts, n_layers=2):
    return dict(vocab=32, d_model=16, n_layers=n_layers, n_heads=2,
                d_head=8, d_ff=32, n_experts=n_experts)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.fixture(scope="module")
def jax_logits():
    return jax.jit(jlm.dense_lm_logits)


@pytest.mark.parametrize("n_experts", [1, 2])
def test_init_pipeline_lm_is_bit_equal(n_experts):
    j = dict(_leaves(jlm.init_pipeline_lm(3, **_widths(n_experts))))
    t = dict(_leaves(tlm.init_pipeline_lm(3, device="cpu",
                                          **_widths(n_experts))))
    assert sorted(j) == sorted(t)
    for name in j:
        assert t[name].dtype == np.float32, name
        assert np.array_equal(j[name], t[name]), name


@pytest.mark.parametrize("n_experts", [1, 2])
def test_dense_lm_logits_within_fusion(n_experts, jax_logits):
    params = jlm.init_pipeline_lm(0, **_widths(n_experts))
    tparams = pipeline_lm_from_mxnet_tpu(
        jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.RandomState(1).randint(0, 32, (2, 9)).astype("int32")
    want = np.asarray(jax_logits(params, jnp.asarray(tokens)))
    got = tlm.dense_lm_logits(tparams, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=FUSION[0], atol=FUSION[1])
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_dense_lm_loss_within_fusion():
    params = jlm.init_pipeline_lm(0, **_widths(2))
    tparams = pipeline_lm_from_mxnet_tpu(
        jax.tree.map(np.asarray, params), "cpu")
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, 32, (2, 7)).astype("int32")
    labels = rs.randint(0, 32, (2, 7)).astype("int32")
    want = float(jax.jit(jlm.dense_lm_loss)(params, tokens, labels))
    got = float(tlm.dense_lm_loss(tparams, tokens, labels))
    assert abs(got - want) <= FUSION[1] + FUSION[0] * abs(want)


def test_truncate_pipeline_lm_shares_leaves():
    params = tlm.init_pipeline_lm(0, device="cpu", **_widths(2, 3))
    draft = tlm.truncate_pipeline_lm(params, 1)
    jdraft = jlm.truncate_pipeline_lm(
        jlm.init_pipeline_lm(0, **_widths(2, 3)), 1)
    assert draft["embed"] is params["embed"]
    assert draft["head"] is params["head"]
    for name, v in draft["layers"].items():
        assert v.shape[0] == 1
        assert v.data_ptr() == params["layers"][name].data_ptr()
        assert np.array_equal(v.numpy(), np.asarray(jdraft["layers"][name]))
    for n in (0, 4):
        with pytest.raises(ValueError):
            tlm.truncate_pipeline_lm(params, n)
        with pytest.raises(ValueError):
            jlm.truncate_pipeline_lm(jdraft, n)


def test_ring_attention_waits_for_the_distribution_slice():
    params = tlm.init_pipeline_lm(0, device="cpu", **_widths(1))
    lp = {k: v[0] for k, v in params["layers"].items()}
    h = torch.zeros(1, 4, 16)
    with pytest.raises(MXNetError, match="item 6"):
        tlm._layer(lp, h, attention="ring")
    with pytest.raises(ValueError):
        tlm._layer(lp, h, attention="dense")


def test_converter_carries_and_checks_every_leaf():
    tree = jax.tree.map(np.asarray,
                        jlm.init_pipeline_lm(0, **_widths(2)))
    params = pipeline_lm_from_mxnet_tpu(tree, "cpu")
    got = dict(_leaves(params))
    for name, v in _leaves(tree):
        assert got[name].dtype == np.float32
        assert np.array_equal(got[name], v), name
    # a missing key, an extra key, a leaf too wide and too narrow
    missing = {**tree, "layers": {k: v for k, v in tree["layers"].items()
                                  if k != "b2"}}
    extra = {**tree, "pos_embed": np.zeros((8, 16), "float32")}
    wide = {**tree, "layers": {**tree["layers"],
                               "wo": np.zeros((2, 2, 8, 17), "float32")}}
    narrow = {**tree, "ln_f": np.ones((15,), "float32")}
    for bad, what in ((missing, "missing"), (extra, "unexpected"),
                      (wide, "layers/wo"), (narrow, "ln_f")):
        with pytest.raises(MXNetError, match=what):
            pipeline_lm_from_mxnet_tpu(bad, "cpu")


def test_tolerance_classes_equal_jax():
    assert verify.TOLERANCE_CLASSES == jverify.TOLERANCE_CLASSES
    for cls in verify.TOLERANCE_CLASSES:
        for dtype in ("float32", "float16", "int8"):
            assert verify.tolerance_for(cls, dtype) == \
                jverify.tolerance_for(cls, dtype)
