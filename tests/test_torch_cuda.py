"""Tests of the port that need an NVIDIA GPU; each skips without one.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The flash kernels are held against their plain versions on the same
inputs: fp32 max abs <= 1e-4 for unit-scale inputs (only the summation
order differs); bf16 and fp16 against the fp32 plain version on the same
rounded inputs, within the output's own rounding (forward: bf16 <= 2e-2;
backward: |err| <= atol + rtol*|ref| with rtol four half-ulps of the type,
fp16 2e-3 and bf16 1.6e-2, and atol 1e-3 / 1e-2 for sums that cancel).
The mixed-precision SGD kernel rounds each operation as its plain version
does, so the two agree bit for bit.
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
           (q.double(), q.double(), q.double()),
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


BWD_TOL = {torch.float32: (1e-4, 0.0), torch.float16: (1e-3, 2e-3),
           torch.bfloat16: (1e-2, 1.6e-2)}


def _bwd_close(got, want, dtype):
    """max abs <= 1e-4 in fp32; elementwise atol + rtol*|want| else."""
    atol, rtol = BWD_TOL[dtype]
    err = (got.float() - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), \
        f"max abs err {err.max().item()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 200, 200, 64),
                                   (1, 2, 128, 384, 96),
                                   (2, 2, 300, 100, 40),
                                   (1, 1, 1, 7, 33)])
def test_backward_kernels_match_plain_version(shape, causal, dtype):
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES_DKV, LAUNCHES_DQ, flash_attention_bwd, flash_attention_fwd,
        flash_attention_ref_bwd)
    q, k, v = _qkv(1, *shape, dtype)
    g = torch.Generator().manual_seed(2)
    dout = torch.randn(q.shape, generator=g).cuda().to(dtype)
    out, lse = flash_attention_fwd(q, k, v, causal)
    before = (LAUNCHES_DQ.count, LAUNCHES_DKV.count)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert (LAUNCHES_DQ.count, LAUNCHES_DKV.count) == (before[0] + 1,
                                                       before[1] + 1)
    want = flash_attention_ref_bwd(q.float(), k.float(), v.float(),
                                   out.float(), lse, dout.float(), causal)
    for got, ref in zip(grads, want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert bool(torch.isfinite(got).all())
        _bwd_close(got, ref, dtype)


def test_backward_takes_a_non_contiguous_output_gradient():
    """autograd hands back dO as a view of ``out.transpose(1, 2)``."""
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    q, k, v = _qkv(3, 2, 4, 96, 96, 32, torch.float32)
    out, lse = flash_attention_fwd(q, k, v)
    dout_t = torch.randn(2, 96, 4, 32, device="cuda").transpose(1, 2)
    assert not dout_t.is_contiguous()
    got = flash_attention_bwd(q, k, v, out, lse, dout_t)
    want = flash_attention_bwd(q, k, v, out, lse, dout_t.contiguous())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_autograd_goes_through_the_backward_kernels():
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_DKV, LAUNCHES_DQ, flash_attention,
        flash_attention_ref)
    q, k, v = (t.requires_grad_() for t in _qkv(4, 2, 3, 130, 130, 64,
                                                torch.float32))
    dout = torch.randn(q.shape, device="cuda")
    counts = (LAUNCHES.count, LAUNCHES_DQ.count, LAUNCHES_DKV.count)
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (LAUNCHES.count, LAUNCHES_DQ.count, LAUNCHES_DKV.count) == \
        tuple(c + 1 for c in counts)
    ref = flash_attention_ref(q, k, v, causal=True)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4
    with torch.inference_mode():
        flash_attention(q.detach(), k.detach(), v.detach())
    assert LAUNCHES.count == counts[0] + 2


def test_attention_layer_gradients_reach_qkv():
    """Regression: the forward's output once had no grad_fn on CUDA, so a
    backward through MultiHeadAttention left qkv without gradients."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.models import MultiHeadAttention
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_ref
    torch.manual_seed(0)
    layer = MultiHeadAttention(64, 4, device="cuda")
    ref_layer = MultiHeadAttention(64, 4, device="cuda")
    ref_layer.load_state_dict(layer.state_dict())
    ref_layer.attention = flash_attention_ref
    x = torch.randn(2, 40, 64, device="cuda")
    g = torch.randn(2, 40, 64, device="cuda")
    layer(x).backward(g)
    ref_layer(x).backward(g)
    for name, p in layer.named_parameters():
        ref = dict(ref_layer.named_parameters())[name].grad
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, ref, rtol=1e-4, atol=1e-5)
    assert layer.qkv.weight.grad.abs().sum().item() > 0


@pytest.mark.parametrize("clip", [-1.0, 1.0])
@pytest.mark.parametrize("n", [1, 7, 768, 1000003])
def test_mp_sgd_kernel_matches_plain_version(n, clip):
    _need_cuda()
    from mxnet_tpu_torch.opt.kernels import (LAUNCHES,
                                             mp_sgd_mom_update_kernel,
                                             mp_sgd_mom_update_ref)
    g = torch.Generator().manual_seed(n)
    w32 = torch.randn(n, generator=g).cuda()
    grad = (torch.randn(n, generator=g) * 300).half().cuda()
    mom = torch.randn(n, generator=g).cuda() * 0.01
    w = w32.half()
    kw = dict(lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=1 / 256,
              clip_gradient=clip)
    before = LAUNCHES.count
    got = mp_sgd_mom_update_kernel(w, grad, mom, w32, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    want = mp_sgd_mom_update_ref(w, grad, mom, w32, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got[0], got[2].half())
    # in place, and from pointers too unaligned for 4-wide accesses
    buf16 = torch.zeros(n + 1, dtype=torch.float16, device="cuda")
    buf32 = torch.zeros(3, n + 1, device="cuda")
    wi, gi, mi, w32i = buf16[1:], grad.clone(), buf32[0, 1:], buf32[1, 1:]
    wi.copy_(w)
    mi.copy_(mom)
    w32i.copy_(w32)
    mp_sgd_mom_update_kernel(wi, gi, mi, w32i, out=(wi, mi, w32i), **kw)
    for a, b in zip((wi, mi, w32i), want):
        assert torch.equal(a, b)


def test_mp_sgd_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.opt.kernels import LAUNCHES, mp_sgd_mom_update_kernel
    w32 = torch.zeros(16, device="cuda")
    w, g = w32.half(), w32.half()
    before = LAUNCHES.count
    for args in [(w.bfloat16(), g.bfloat16(), w32, w32),
                 (w, g, w32[:8], w32),
                 (w, g.cpu(), w32, w32),
                 (w, g, torch.zeros(32, device="cuda")[::2], w32)]:
        with pytest.raises(MXNetError):
            mp_sgd_mom_update_kernel(*args)
    assert LAUNCHES.count == before


def test_trainer_steps_small_fp16_bert_through_the_kernels():
    """record -> backward -> Trainer.step with multi-precision SGD on an
    fp16 model: launches per step are L forward, L dQ, L dK/dV and one
    update per parameter; two steps agree with plain attention and the
    plain update to fp16's precision."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import BERTModel
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_DKV, LAUNCHES_DQ, flash_attention,
        flash_attention_ref)
    from mxnet_tpu_torch.opt import kernels
    V, L = 100, 2

    def build(attention):
        torch.manual_seed(0)
        m = BERTModel(vocab_size=V, units=64, num_layers=L, num_heads=4,
                      hidden_size=128, max_len=64, dropout=0.0,
                      device="cuda", dtype=torch.float16)
        for layer in m.layers:
            layer.attn.attention = attention
        return m

    rng = np.random.RandomState(0)
    tok = torch.from_numpy(rng.randint(0, V, (2, 48))).cuda()
    lab = torch.from_numpy(rng.randint(0, V, (2, 48))).cuda()
    loss_fn = SoftmaxCrossEntropyLoss()
    model, ref = build(flash_attention), build(flash_attention_ref)
    params = collect_params(model)
    trainer = Trainer(params, "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                      "multi_precision": True})
    ref_params = list(collect_params(ref).values())
    ref_state = [(p.detach().float(), torch.zeros_like(p, dtype=torch.float32))
                 for p in ref_params]
    scale = 128.0
    for _ in range(2):
        counters = (LAUNCHES, LAUNCHES_DQ, LAUNCHES_DKV, kernels.LAUNCHES)
        for c in counters:
            c.reset()
        with autograd.record():
            loss = loss_fn(model(tok).reshape(-1, V), lab.reshape(-1))
        autograd.backward(loss * scale)
        assert all(p.grad is not None for p in params.values())
        trainer.step(tok.numel() * scale)
        assert [c.count for c in counters] == [L, L, L, len(params)]
        with autograd.record():
            ref_loss = loss_fn(ref(tok).reshape(-1, V), lab.reshape(-1))
        autograd.backward(ref_loss * scale)
        with torch.no_grad():
            for p, (w32, mom) in zip(ref_params, ref_state):
                nw, nm, nw32 = kernels.mp_sgd_mom_update_ref(
                    p, p.grad, mom, w32, lr=0.1, momentum=0.9,
                    rescale_grad=1 / (tok.numel() * scale))
                p.copy_(nw)
                mom.copy_(nm)
                w32.copy_(nw32)
                p.grad = None
        assert abs(loss.float().mean().item()
                   - ref_loss.float().mean().item()) <= 1e-2
    for i, (w32, _) in enumerate(ref_state):
        got = trainer._updaters[0].states[i][0]
        torch.testing.assert_close(got, w32, rtol=1e-2, atol=1e-3)
