"""Tests of the port that need an NVIDIA GPU; each skips without one.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The flash kernel is held against its plain version on the same inputs:
fp32 max abs <= 1e-4 for unit-scale inputs (only the summation order
differs); bf16 against the fp32 plain version on the same bf16-rounded
inputs, <= 2e-2 (the output's own bf16 rounding).
"""
import numpy as np
import pytest
import torch


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def _qkv(seed, B, H, Tq, Tk, D, dtype):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, H, T, D, generator=g).cuda().to(dtype)
                 for T in (Tq, Tk, Tk))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 200, 200, 64),
                                   (1, 2, 128, 384, 96),
                                   (2, 2, 300, 100, 40),
                                   (1, 1, 1, 7, 33)])
def test_kernel_matches_plain_version(shape, causal, dtype, tol):
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES,
                                                     flash_attention_fwd,
                                                     flash_attention_ref_fwd)
    q, k, v = _qkv(0, *shape, dtype)
    before = LAUNCHES.count
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    ref, ref_lse = flash_attention_ref_fwd(q.float(), k.float(), v.float(),
                                           causal)
    assert (out.float() - ref).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops.flash_attention import LAUNCHES, flash_attention
    q = torch.zeros(1, 2, 8, 16, device="cuda")
    before = LAUNCHES.count
    bad = [(q, q.transpose(2, 3).contiguous().transpose(2, 3), q),
           (q.half(), q.half(), q.half()),
           (q, q.cpu(), q)]
    big = torch.zeros(1, 2, 8, 160, device="cuda")
    bad.append((big, big, big))
    for args in bad:
        with pytest.raises(MXNetError):
            flash_attention(*args)
    assert LAUNCHES.count == before


def test_engine_serves_small_bert_through_the_kernel():
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.models import BERTModel
    from mxnet_tpu_torch.ops.flash_attention import LAUNCHES
    from mxnet_tpu_torch.serve import (InputSpec, ServingEngine,
                                       parse_bucket_spec)
    torch.manual_seed(0)
    model = BERTModel(vocab_size=100, units=64, num_layers=2, num_heads=4,
                      hidden_size=128, max_len=64, device="cuda")
    cpu_model = BERTModel(vocab_size=100, units=64, num_layers=2,
                          num_heads=4, hidden_size=128, max_len=64,
                          device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_model.eval()
    engine = ServingEngine(model, input_specs=[InputSpec((32,), "int32")],
                           ladder=parse_bucket_spec("batch:1,2,4;seq:16,32"),
                           batching=False, device="cuda")
    engine.warmup()
    rng = np.random.RandomState(0)
    LAUNCHES.reset()
    for n, t in [(1, 5), (3, 20), (2, 32)]:
        tok = rng.randint(0, 100, (n, t)).astype("int32")
        got = engine.predict(tok)
        seq = 16 if t <= 16 else 32
        padded = np.zeros((n, seq), "int32")
        padded[:, :t] = tok
        with torch.no_grad():
            want = cpu_model(torch.from_numpy(padded))[:, :t].numpy()
        # fp32 on both; cuBLAS and the kernel sum in another order
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert LAUNCHES.count == 2 * 3
    assert engine.stats()["recompiles_after_warmup"] == 0
