"""The port's transformer blocks against the JAX package's, on the CPU.

Weights are made from a numpy seed in the JAX package's naming, set on the
JAX block, and carried to the port through ``convert.params_from_mxnet_tpu``;
the same token ids or activations go through both. Tolerance rtol 1e-4 /
atol 1e-5: both sides compute in fp32, XLA:CPU and ATen sum in different
orders. On the CPU the JAX attention is dense ``local_attention`` and the
port's is the flash kernel's plain version, or ``local_attention`` too
where the head dim is wider than the kernels take.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jax_tf
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import (mxnet_tpu_shapes, params_from_mxnet_tpu,
                                     port_name)
from mxnet_tpu_torch.gluon import nn as torch_nn
from mxnet_tpu_torch.models import transformer as torch_tf
from mxnet_tpu_torch.parallel import local_attention as torch_local

from test_torch_resnet_train import keep_zeros

RTOL, ATOL = 1e-4, 1e-5
V, C, L, H, FFN, MAXLEN = 100, 64, 2, 4, 128, 64


def _weights(shapes, seed):
    """Seeded weights: N(0, 0.1) matrices and biases, LayerNorm gamma
    around 1 (so that a swapped gamma/beta shows)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        w = rng.randn(*shape).astype("float32") * 0.1
        out[name] = w + 1.0 if name.endswith("gamma") else w
    return out


def _jax_shapes(block):
    return {n: tuple(p.shape)
            for n, p in block._collect_params_with_prefix().items()}


def _pair(jax_block, torch_block, seed=0):
    """Give both blocks the same seeded weights and hybridize the JAX one
    (its forward one compiled program, not one per op); returns the
    weights. The JAX block's deferred dims come from the port's block of
    the same configuration (a dim JAX declares must agree; a wrong
    deferred one fails the JAX forward; BERTModel's whole shapes are held
    to JAX's after a JAX forward in
    ``test_parameter_names_line_up_with_jax``), and it starts from zeros
    (``keep_zeros``: a random draw compiles a program per shape)."""
    jax_block.initialize(keep_zeros)
    shapes = mxnet_tpu_shapes(torch_block)
    params = jax_block._collect_params_with_prefix()
    assert set(params) == set(shapes)
    for n, p in params.items():
        p.shape = shapes[n]
        p._finish_deferred_init()
    named = _weights(_jax_shapes(jax_block), seed)
    for n, p in params.items():
        p.set_data(mx.nd.array(named[n]))
    jax_block.hybridize()
    torch_block.load_state_dict(params_from_mxnet_tpu(named, torch_block))
    torch_block.eval()
    return named


def _acts(seed, B=2, T=24):
    return np.random.RandomState(seed).randn(B, T, C).astype("float32")


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax(causal):
    x = _acts(1)
    jb = jax_tf.MultiHeadAttention(C, H)
    jb._causal = causal
    tb = torch_tf.MultiHeadAttention(C, H, causal=causal, device="cpu")
    _pair(jb, tb)
    want = jb(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_qkv_split_layout():
    """The fused qkv projection splits as (B, T, 3, H, D) -> (3, B, H, T, D)
    (mxnet_tpu/models/transformer.py:76-78): the attention function must
    receive exactly the numpy-computed q, k, v."""
    B, T = 2, 5
    x = _acts(2, B, T)
    tb = torch_tf.MultiHeadAttention(C, H, device="cpu")
    seen = {}

    def capture(q, k, v, causal=False):
        seen.update(q=q, k=k, v=v)
        return q

    tb.attention = capture
    with torch.no_grad():
        tb(torch.from_numpy(x))
        w = tb.qkv.weight.numpy()
        b = tb.qkv.bias.numpy()
    qkv = (x @ w.T + b).reshape(B, T, 3, H, C // H).transpose(2, 0, 3, 1, 4)
    for i, name in enumerate("qkv"):
        got = seen[name]
        assert got.shape == (B, H, T, C // H) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), qkv[i], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pre_norm", [True, False])
def test_encoder_layer_matches_jax(pre_norm):
    x = _acts(3)
    jb = jax_tf.TransformerEncoderLayer(C, H, FFN, pre_norm=pre_norm)
    tb = torch_tf.TransformerEncoderLayer(C, H, FFN, pre_norm=pre_norm,
                                          device="cpu")
    _pair(jb, tb)
    want = jb(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _tokens(seed, B=3, T=20):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype("int32")


@pytest.mark.parametrize("kind", ["bert", "causal_lm"])
def test_small_model_matches_jax(kind):
    tok = _tokens(4)
    if kind == "bert":
        jb = jax_tf.BERTModel(vocab_size=V, units=C, num_layers=L,
                              num_heads=H, hidden_size=FFN, max_len=MAXLEN)
        tb = torch_tf.BERTModel(vocab_size=V, units=C, num_layers=L,
                                num_heads=H, hidden_size=FFN,
                                max_len=MAXLEN, device="cpu")
    else:
        jb = jax_tf.TransformerLM(V, C, L, H, FFN, MAXLEN, causal=True)
        tb = torch_tf.TransformerLM(V, C, L, H, FFN, MAXLEN, causal=True,
                                    device="cpu")
    _pair(jb, tb, seed=5)
    want = jb(mx.nd.array(tok, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = tb(torch.from_numpy(tok)).numpy()
    assert got.shape == (3, 20, V)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_model_matches_jax(causal):
    """Head dim 160 (units 320, 2 heads), over the kernels' 128: the port
    takes dense attention for it, as the reference does, and agrees with
    the JAX model."""
    tok = _tokens(9, B=2, T=16)
    jb = jax_tf.TransformerLM(V, 320, 1, 2, FFN, MAXLEN, causal=causal)
    tb = torch_tf.TransformerLM(V, 320, 1, 2, FFN, MAXLEN, causal=causal,
                                device="cpu")
    _pair(jb, tb, seed=10)
    want = jb(mx.nd.array(tok, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = tb(torch.from_numpy(tok)).numpy()
    assert got.shape == (2, 16, V)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("units,heads,dense", [(64, 4, False),
                                               (512, 4, False),
                                               (320, 2, True),
                                               (1024, 4, True)])
def test_attention_picks_dense_where_no_kernel_serves(monkeypatch, units,
                                                      heads, dense):
    """The choice is made by shape before any launch: head dims up to 128
    go to ``flash_attention``, wider ones to ``local_attention``; a
    function the caller assigns is applied at every shape."""
    calls = []

    def spy(q, k, v, causal=False):
        calls.append(q.shape)
        return torch_local(q, k, v, causal=causal)

    monkeypatch.setattr(torch_tf, "local_attention", spy)
    tb = torch_tf.MultiHeadAttention(units, heads, device="cpu")
    x = torch.from_numpy(np.random.RandomState(11).randn(
        1, 8, units).astype("float32"))
    with torch.no_grad():
        tb(x)
        assert len(calls) == int(dense)
        tb.attention = lambda q, k, v, causal=False: q
        tb(x)
    assert len(calls) == int(dense)


def test_parameter_names_line_up_with_jax():
    jb = jax_tf.BERTModel(vocab_size=V, units=C, num_layers=L, num_heads=H,
                          hidden_size=FFN, max_len=MAXLEN)
    jb.initialize(keep_zeros)   # the values are not read here
    jb(mx.nd.array(_tokens(6), dtype="int32"))
    tb = torch_tf.BERTModel(vocab_size=V, units=C, num_layers=L,
                            num_heads=H, hidden_size=FFN, max_len=MAXLEN,
                            device="cpu")
    assert mxnet_tpu_shapes(tb) == _jax_shapes(jb)
    assert {port_name(n) for n in _jax_shapes(jb)} == set(tb.state_dict())


def test_convert_rejects_missing_extra_and_misshaped():
    tb = torch_tf.MultiHeadAttention(C, H, device="cpu")
    named = _weights(mxnet_tpu_shapes(tb), 7)
    params_from_mxnet_tpu(named, tb)
    with pytest.raises(MXNetError, match="no value"):
        params_from_mxnet_tpu({k: v for k, v in named.items()
                               if k != "proj.bias"}, tb)
    with pytest.raises(MXNetError, match="no counterpart"):
        params_from_mxnet_tpu(dict(named, extra=np.zeros(3, "float32")), tb)
    with pytest.raises(MXNetError, match="shape"):
        params_from_mxnet_tpu(dict(named, **{"qkv.bias": np.zeros(
            (5,), "float32")}), tb)


def test_layer_norm_and_gelu_match_jax_ops():
    from mxnet_tpu import nd
    rng = np.random.RandomState(8)
    x = rng.randn(4, 7, C).astype("float32") * 3
    g = rng.randn(C).astype("float32")
    b = rng.randn(C).astype("float32")
    want = nd.LayerNorm(nd.array(x), nd.array(g), nd.array(b)).asnumpy()
    ln = torch_nn.LayerNorm(in_channels=C, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(g))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want = nd.LeakyReLU(nd.array(x), act_type="gelu").asnumpy()
    got = torch_nn.GELU()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_moe_layer_not_ported_and_cuda_default_raises():
    with pytest.raises(NotImplementedError):
        torch_tf.TransformerEncoderLayer(C, H, FFN, num_experts=2,
                                         device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        torch_tf.BERTModel(vocab_size=V, units=C, num_layers=1,
                           num_heads=H, hidden_size=FFN, max_len=MAXLEN)
