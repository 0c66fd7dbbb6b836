"""Tests of the port that need an NVIDIA GPU; each skips without one.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The flash kernels are held against their plain versions on the same
inputs: fp32 max abs <= 1e-4 for unit-scale inputs (only the summation
order differs); bf16 and fp16 against the fp32 plain version on the same
rounded inputs, within the output's own rounding and, on the tensor-core
route, the rounding of p as an operand (forward: bf16 <= 2e-2, fp16 <=
5e-3, chip_smoke's FWD_TOL; backward: |err| <= atol + rtol*|ref| with rtol four half-ulps of the type,
fp16 2e-3 and bf16 1.6e-2, and atol 1e-3 / 1e-2 for sums that cancel; the
same limits hold the tensor-core route, which also rounds p and dS to the
input type as operands). The fp32 forward and backward with D % 8 == 0
and D <= 128 run on the tensor cores over bf16 planes of their operands
and hold the same 1e-4.
The mixed-precision SGD kernel rounds each operation as its plain version
does, and the fp32 backward's split kernel rounds as its plain version
does, so each agrees with it bit for bit.
"""
import os

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
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 200, 200, 64),
                                   (1, 2, 128, 384, 96),
                                   (2, 2, 300, 100, 40),
                                   (1, 1, 1, 7, 33),
                                   (1, 2, 64, 64, 8),
                                   (2, 2, 200, 200, 128),
                                   (1, 2, 128, 320, 128),
                                   (2, 2, 300, 100, 128),
                                   (1, 2, 40, 70, 96)])
def test_kernel_matches_plain_version(shape, causal, dtype, tol):
    """The three routes: fp16/bf16 with D % 8 == 0 on the tensor-core
    kernel, fp32 with D % 8 == 0 on the fp32 tensor-core kernels (one
    split launch first; csrc/flash_fwd_tc32.cu up to D = 64 and
    csrc/flash_fwd_tc32_d128.cu at D = 96 and 128, each with a block whose
    second q tile lies wholly past Tq: Tq = 300 and 40), D = 33 on the
    CUDA-core one."""
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_SPLIT, LAUNCHES_TC, LAUNCHES_TC32, _fwd_route,
        flash_attention_fwd, flash_attention_ref_fwd)
    q, k, v = _qkv(0, *shape, dtype)
    D = shape[-1]
    route = ("cc" if D % 8 else "tc" if dtype != torch.float32
             else "tc32")
    assert _fwd_route(dtype, D, True) == route
    counters = (LAUNCHES, LAUNCHES_TC, LAUNCHES_TC32, LAUNCHES_SPLIT)
    before = [c.count for c in counters]
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == \
        [1, int(route == "tc"), int(route == "tc32"), int(route == "tc32")]
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
    bad = [(q.double(), q.double(), q.double()),
           (q, q.cpu(), q)]
    big = torch.zeros(1, 2, 8, 160, device="cuda")
    bad.append((big, big, big))
    for args in bad:
        with pytest.raises(MXNetError):
            flash_attention(*args)
    assert LAUNCHES.count == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_attention_takes_non_contiguous_inputs(dtype):
    """q, k, v in the layout a (B, T, H, D) projection gives: forward and
    backward equal the same calls on contiguous copies bit for bit, and the
    plain versions within the forward's and the backward's limits."""
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_fwd, flash_attention_ref_bwd,
        flash_attention_ref_fwd)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, dout = (torch.randn(2, 128, 4, 64, device="cuda", generator=g)
                     .to(dtype).transpose(1, 2) for _ in range(4))
    assert not any(t.is_contiguous() for t in (q, k, v, dout))

    def run(*ts):
        ts = [t.detach().requires_grad_() for t in ts]
        out = flash_attention(*ts)
        return (out,) + torch.autograd.grad(out, ts, dout)

    got = run(q, k, v)
    want = run(*(t.contiguous() for t in (q, k, v)))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out, lse = flash_attention_fwd(q, k, v)
    assert torch.equal(out, got[0])
    f32 = [t.float() for t in (q, k, v)]
    ref, _ = flash_attention_ref_fwd(*f32)
    tol = {torch.float32: 1e-4, torch.float16: 5e-3}[dtype]
    assert (got[0].float() - ref).abs().max().item() <= tol
    ref_grads = flash_attention_ref_bwd(*f32, out.float(), lse,
                                        dout.float())
    for a, b in zip(got[1:], ref_grads):
        _bwd_close(a, b, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 200, 200, 64),
                                   (1, 2, 128, 384, 64),
                                   (2, 2, 300, 100, 40),
                                   (2, 2, 200, 200, 128),
                                   (1, 2, 128, 384, 80),
                                   (2, 2, 300, 100, 128),
                                   (1, 2, 40, 70, 96)])
def test_fp32_tensor_core_forward_feeds_the_backward(shape, causal):
    """fp32 forward and backward through ``flash_attention``, both on the
    fp32 tensor-core route (two splits): the forward's lse within 1e-4 of
    the plain one, and the gradients the backward rebuilds from it within
    1e-4 of the dense oracle's. Tq = 300 and 40 give the forward a block
    whose second q tile lies wholly past Tq."""
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES_DKV_TC32, LAUNCHES_DQ_TC32, LAUNCHES_SPLIT, LAUNCHES_TC32,
        flash_attention, flash_attention_fwd, flash_attention_ref,
        flash_attention_ref_fwd)
    q, k, v = (t.requires_grad_() for t in _qkv(6, *shape, torch.float32))
    g = torch.Generator().manual_seed(7)
    dout = torch.randn(q.shape, generator=g).cuda()
    _, lse = flash_attention_fwd(q.detach(), k.detach(), v.detach(), causal)
    _, ref_lse = flash_attention_ref_fwd(q.detach(), k.detach(), v.detach(),
                                         causal)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    counters = (LAUNCHES_TC32, LAUNCHES_DQ_TC32, LAUNCHES_DKV_TC32,
                LAUNCHES_SPLIT)
    before = [c.count for c in counters]
    out = flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [1, 1, 1, 2]
    ref = flash_attention_ref(q, k, v, causal=causal)
    assert (out - ref).abs().max().item() <= 1e-4
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4


def test_model_takes_dense_attention_where_no_kernel_serves():
    """Head dim 256 (units 1024, 4 heads): the model picks dense attention
    by shape, as the reference does, launches no flash kernel and matches
    dense attention within 1e-4."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.models import TransformerLM
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES,
                                                     flash_attention_ref)
    torch.manual_seed(0)
    model = TransformerLM(vocab_size=100, units=1024, num_layers=2,
                          num_heads=4, max_len=64, device="cuda")
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, 100, (2, 48))
                           ).cuda()
    before = LAUNCHES.count
    with torch.no_grad():
        got = model(tok)
        torch.cuda.synchronize()
        assert LAUNCHES.count == before
        for layer in model.layers:
            layer.attn.attention = flash_attention_ref
        want = model(tok)
    assert got.shape == (2, 48, 100) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-4


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
                                   (1, 1, 1, 7, 33),
                                   (2, 3, 160, 160, 96),
                                   (1, 2, 256, 256, 128),
                                   (1, 2, 100, 260, 16),
                                   (3, 2, 77, 77, 64),
                                   (2, 3, 200, 200, 72),
                                   (2, 2, 300, 100, 96),
                                   (1, 2, 100, 260, 128)])
def test_backward_kernels_match_plain_version(shape, causal, dtype):
    """The three routes: fp16/bf16 with D % 8 == 0 on the tensor-core
    kernels, fp32 with D % 8 == 0 on the fp32 tensor-core kernels (one
    split launch first; D <= 64 and D = 72, 96, 128 on their two files;
    Tq != Tk and ragged T among them), D = 33 on the CUDA-core ones."""
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES_DKV, LAUNCHES_DKV_TC, LAUNCHES_DKV_TC32, LAUNCHES_DQ,
        LAUNCHES_DQ_TC, LAUNCHES_DQ_TC32, LAUNCHES_SPLIT, flash_attention_bwd,
        flash_attention_fwd, flash_attention_ref_bwd)
    q, k, v = _qkv(1, *shape, dtype)
    g = torch.Generator().manual_seed(2)
    dout = torch.randn(q.shape, generator=g).cuda().to(dtype)
    out, lse = flash_attention_fwd(q, k, v, causal)
    counters = (LAUNCHES_DQ, LAUNCHES_DKV, LAUNCHES_DQ_TC, LAUNCHES_DKV_TC,
                LAUNCHES_DQ_TC32, LAUNCHES_DKV_TC32, LAUNCHES_SPLIT)
    before = [c.count for c in counters]
    grads = flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    D = shape[-1]
    tc = int(dtype != torch.float32 and D % 8 == 0)
    tc32 = int(dtype == torch.float32 and D % 8 == 0)
    assert [c.count - b for c, b in zip(counters, before)] == \
        [1, 1, tc, tc, tc32, tc32, tc32]
    want = flash_attention_ref_bwd(q.float(), k.float(), v.float(),
                                   out.float(), lse, dout.float(), causal)
    for got, ref in zip(grads, want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert bool(torch.isfinite(got).all())
        _bwd_close(got, ref, dtype)


def test_fp32_wide_head_backward_takes_non_contiguous_inputs():
    """fp32 with D = 128 in the layout a (B, T, H, D) projection gives:
    the backward through ``flash_attention`` equals the same call on
    contiguous copies bit for bit."""
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES_DKV_TC32,
                                                     flash_attention)
    g = torch.Generator(device="cuda").manual_seed(10)
    q, k, v, dout = (torch.randn(2, 160, 3, 128, device="cuda", generator=g)
                     .transpose(1, 2) for _ in range(4))
    assert not any(t.is_contiguous() for t in (q, k, v, dout))

    def run(*ts):
        ts = [t.detach().requires_grad_() for t in ts]
        out = flash_attention(*ts, causal=True)
        return (out,) + torch.autograd.grad(out, ts, dout)

    before = LAUNCHES_DKV_TC32.count
    got = run(q, k, v)
    want = run(*(t.contiguous() for t in (q, k, v)))
    assert LAUNCHES_DKV_TC32.count == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [4, 4096, 1_000_004])
def test_split_kernel_is_bit_equal_to_plain_version(n):
    """The fp32 backward's split into bf16 planes, on normal values, values
    across the whole range and its edges (+-0, subnormals, the largest
    finite values), one to four tensors per launch."""
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES_SPLIT,
                                                     split_bf16x3,
                                                     split_bf16x3_ref)
    g = torch.Generator().manual_seed(n)
    edges = torch.tensor([0.0, -0.0, 2.0 ** -149, -(2.0 ** -140),
                          2.0 ** -126, 2.0 ** -110, 3.3961e38,
                          -3.4028235e38])
    wide = torch.randn(n, generator=g) * torch.exp2(
        torch.randint(-140, 127, (n,), generator=g).float())
    for xs in ([torch.randn(n, generator=g)],
               [wide, edges, torch.randn(3, n, generator=g),
                torch.randn(4, generator=g)]):
        xs = [x.cuda() for x in xs]
        before = LAUNCHES_SPLIT.count
        got = split_bf16x3(*xs)
        torch.cuda.synchronize()
        assert LAUNCHES_SPLIT.count == before + 1
        want = split_bf16x3_ref(*xs)
        assert got.shape == want.shape == (3, sum(x.numel() for x in xs))
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_split_kernel_refuses_what_it_does_not_take():
    _need_cuda()
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES_SPLIT,
                                                     split_bf16x3)
    x = torch.zeros(16, device="cuda")
    before = LAUNCHES_SPLIT.count
    for args in [(x[:6],), (x[1:5],), (x, x.cpu()), (x.half(),)]:
        with pytest.raises(MXNetError):
            split_bf16x3(*args)
    assert LAUNCHES_SPLIT.count == before


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
    fp16 model: launches per step are L forward, L dQ, L dK/dV (all on the
    tensor-core route) and one B1 launch for every parameter; two steps
    agree with plain attention and the plain update to fp16's precision."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import BERTModel
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_DKV, LAUNCHES_DKV_TC, LAUNCHES_DQ, LAUNCHES_DQ_TC,
        LAUNCHES_TC, flash_attention, flash_attention_ref)
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
        counters = (LAUNCHES, LAUNCHES_DQ, LAUNCHES_DKV, kernels.LAUNCHES,
                    LAUNCHES_TC, LAUNCHES_DQ_TC, LAUNCHES_DKV_TC)
        for c in counters:
            c.reset()
        with autograd.record():
            loss = loss_fn(model(tok).reshape(-1, V), lab.reshape(-1))
        autograd.backward(loss * scale)
        assert all(p.grad is not None for p in params.values())
        trainer.step(tok.numel() * scale)
        # fp16, head dim 16: every attention launch on the tensor-core route
        # one B1 launch updates every fp16 parameter
        assert [c.count for c in counters] == [L, L, L, 1, L, L, L]
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


def test_trainer_steps_small_fp32_bert_through_the_kernels():
    """record -> backward -> Trainer.step with plain SGD on an fp32 model:
    launches per step are L forward, L dQ and L dK/dV (all on the fp32
    tensor-core route, after 2L splits) and no mixed-precision update; two steps agree with dense attention and the same update to
    fp32's precision."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import BERTModel
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_DKV, LAUNCHES_DKV_TC, LAUNCHES_DKV_TC32,
        LAUNCHES_DQ, LAUNCHES_DQ_TC, LAUNCHES_DQ_TC32, LAUNCHES_SPLIT,
        LAUNCHES_TC, LAUNCHES_TC32, flash_attention, flash_attention_ref)
    from mxnet_tpu_torch.opt import kernels
    V, L = 100, 2

    def build(attention):
        torch.manual_seed(0)
        m = BERTModel(vocab_size=V, units=64, num_layers=L, num_heads=4,
                      hidden_size=128, max_len=64, dropout=0.0,
                      device="cuda")
        for layer in m.layers:
            layer.attn.attention = attention
        params = collect_params(m)
        return m, params, Trainer(params, "sgd", {"learning_rate": 0.1,
                                                  "momentum": 0.9})

    rng = np.random.RandomState(0)
    tok = torch.from_numpy(rng.randint(0, V, (2, 48))).cuda()
    lab = torch.from_numpy(rng.randint(0, V, (2, 48))).cuda()
    loss_fn = SoftmaxCrossEntropyLoss()
    runs = [build(flash_attention), build(flash_attention_ref)]
    counters = (LAUNCHES, LAUNCHES_TC, LAUNCHES_TC32, LAUNCHES_DQ,
                LAUNCHES_DKV, LAUNCHES_DQ_TC, LAUNCHES_DKV_TC,
                LAUNCHES_DQ_TC32, LAUNCHES_DKV_TC32, LAUNCHES_SPLIT,
                kernels.LAUNCHES)
    for _ in range(2):
        losses = []
        for model, params, trainer in runs:
            for c in counters:
                c.reset()
            with autograd.record():
                loss = loss_fn(model(tok).reshape(-1, V), lab.reshape(-1))
            autograd.backward(loss)
            assert all(p.grad is not None for p in params.values())
            trainer.step(tok.numel())
            losses.append(loss.mean().item())
            if model is runs[0][0]:
                # fp32, head dim 16: the forward and the backward on the
                # fp32 tensor-core route, one split each
                assert [c.count for c in counters] == [L, 0, L, L, L, 0, 0,
                                                       L, L, 2 * L, 0]
        assert abs(losses[0] - losses[1]) <= 1e-5
    for a, b in zip(runs[0][1].values(), runs[1][1].values()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# the ResNet ops on the card against the same port code on the CPU: fp32
# with TF32 off within 1e-4 of unit-scale outputs (only the summation order
# differs); fp16 on the card against the CPU's fp32 on the same rounded
# inputs within 1e-2 (the output's own fp16 rounding, 2^-11 of values up
# to ~8, plus the card's fp16 products rounding on the way)
OPS_CASES = {
    "conv_7x7_s2_p3": lambda nn, x, w, fc: nn.convolution(
        x, w, kernel=(7, 7), stride=(2, 2), pad=(3, 3), no_bias=True),
    "max_pool_3x3_s2_p1": lambda nn, x, w, fc: nn.pooling(
        x, kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    "avg_pool_full_excl": lambda nn, x, w, fc: nn.pooling(
        x, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full", count_include_pad=False),
    "global_avg_pool": lambda nn, x, w, fc: nn.pooling(
        x, global_pool=True, pool_type="avg"),
    "relu": lambda nn, x, w, fc: nn.activation(x, "relu"),
    "fully_connected_flatten": lambda nn, x, w, fc: nn.fully_connected(
        x, fc),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("case", sorted(OPS_CASES))
def test_resnet_ops_on_the_card_match_the_cpu(case, dtype, tol):
    _need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.ops import nn
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 3, 30, 30, generator=g).to(dtype)
    w = (torch.randn(8, 3, 7, 7, generator=g) * 0.1).to(dtype)
    fc = (torch.randn(5, 3 * 30 * 30, generator=g) * 0.02).to(dtype)
    want = OPS_CASES[case](nn, x.float(), w.float(), fc.float())
    got = OPS_CASES[case](nn, x.cuda(), w.cuda(), fc.cuda())
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float().cpu(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_batch_norm_on_the_card_matches_the_cpu(dtype):
    """Training mode: the output, and the moving statistics in fp32 moved
    by the biased batch variance, as on the CPU."""
    _need_cuda()
    from mxnet_tpu_torch.ops import nn
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(8, 16, 9, 9, generator=g) * 2 + 1).to(dtype)
    gamma, beta = 1 + 0.1 * torch.randn(16, generator=g), \
        0.1 * torch.randn(16, generator=g)
    mean, var = 0.1 * torch.randn(16, generator=g), \
        1 + torch.rand(16, generator=g)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=False, training=True)
    want = nn.batch_norm(x.float(), gamma, beta, mean, var, **kw)
    got = nn.batch_norm(*(t.cuda() for t in (x, gamma, beta, mean, var)),
                        **kw)
    assert got[0].dtype == dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got[0].float().cpu(), want[0], rtol=tol,
                               atol=tol)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def _deferred_net(mx):
    """Dense, Conv2D and BatchNorm built without input sizes."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix="deferred_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Conv2D(8, 3, groups=8),
                nn.BatchNorm(), nn.GlobalAvgPool2D(), nn.Dense(16),
                nn.Dense(4))
    return net


def test_deferred_shapes_resolve_on_the_card():
    """Built without sizes, initialized on gpu(0): the first forward makes
    every parameter on cuda:0 with the CPU build's shapes and names."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from torch.nn.parameter import UninitializedParameter
    nets = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        net = _deferred_net(mx)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        # every weight waits for the input; a Dense bias's shape is known
        waiting = {n for n, p in net.collect_params().items()
                   if isinstance(p.tensor, UninitializedParameter)}
        assert {n for n in net.collect_params()
                if n.endswith(("weight", "gamma", "beta", "mean", "var"))
                } <= waiting
        net(torch.zeros(2, 3, 6, 6, device=ctx.torch_device))
        assert not any(isinstance(p, UninitializedParameter)
                       for p in net.parameters())
        nets[ctx.device_type] = net
    gpu = nets["gpu"].collect_params()
    assert {n: p.shape for n, p in gpu.items()} == \
        {n: p.shape for n, p in nets["cpu"].collect_params().items()}
    assert all(p.tensor.device == torch.device("cuda", 0)
               for p in gpu.values())


def test_cast_before_the_first_forward_keeps_batchnorm_fp32_on_the_card():
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    net = _deferred_net(mx)
    net.initialize(ctx=mx.gpu(0))
    net.cast("float16")
    out = net(torch.zeros(2, 3, 6, 6, device="cuda", dtype=torch.float16))
    assert out.dtype == torch.float16
    for m in net.modules():
        for p in m.parameters(recurse=False):
            want = torch.float32 if isinstance(m, nn.BatchNorm) \
                else torch.float16
            assert p.dtype == want, m.prefix


def test_fused_step_of_a_deferred_net_with_dropout_captures_its_masks():
    """A net built without sizes or a device (its Dropout makes its
    generator at first use) through ``fuse_step`` before the first
    forward: the first step resolves the shapes and registers the
    generator with the graph, so replays draw new masks."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix="drop_")
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu"), nn.Dropout(0.5),
                nn.Dense(4))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    fused = trainer.fuse_step(net, gluon.loss.SoftmaxCrossEntropyLoss())
    x = torch.randn(8, 10, device="cuda")
    y = torch.randint(0, 4, (8,), device="cuda").float()
    losses = [float(fused.step(x, y).mean()) for _ in range(3)]
    assert net[1]._gen is not None and net[1]._gen.device.type == "cuda"
    assert fused.cache_info()["programs"] == 1
    assert all(np.isfinite(losses)) and len(set(losses)) == 3


def test_trainer_made_before_the_first_forward_launches_b1_once_a_step():
    """The Trainer takes the deferred net's parameters before they exist;
    after the first forward each fp16 step is one B1 launch, and the
    weights move."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.opt import kernels
    net = _deferred_net(mx)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("float16")
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "multi_precision": True})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x = torch.randn(4, 3, 6, 6, device="cuda").half()
    y = torch.tensor([0., 1., 2., 3.], device="cuda")
    before = None
    for step in range(3):
        kernels.LAUNCHES.reset()
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss * 8.0)
        if before is None:
            before = {n: p.tensor.detach().clone()
                      for n, p in net.collect_params().items()}
        trainer.step(4 * 8.0)
        assert kernels.LAUNCHES.count == 1, step
    moved = [not torch.equal(p.tensor, before[n])
             for n, p in net.collect_params().items()
             if p.grad_req != "null"]
    assert all(moved)


def test_trainer_steps_narrow_fp16_resnet_through_b1():
    """A narrow ResNetV1 (BottleneckV1, one block per stage, 16-256
    channels) cast to fp16, BatchNorm fp32: record -> backward ->
    Trainer.step with multi-precision SGD launches B1 once a step for
    its 27 fp16 parameters, none of them BatchNorm's; two steps agree with a run
    whose update is B1's plain version (cuDNN's deterministic algorithms
    in both, so that only the update differs, and it rounds alike)."""
    _need_cuda()
    torch.backends.cudnn.deterministic = True
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.ops import optimizer_ops as oops
    from mxnet_tpu_torch.opt import kernels

    def build():
        mx_random.seed(0)
        net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                              [16, 32, 64, 128, 256], classes=10,
                              device="cuda")
        net.initialize(Xavier("gaussian", "in", 2))
        net.cast("float16")
        return net

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (8, 3, 32, 32))).cuda().half()
    y = torch.from_numpy(rng.randint(0, 10, 8).astype("float32")).cuda()
    loss_fn = SoftmaxCrossEntropyLoss()
    net, ref = build(), build()
    params = collect_params(net)
    n16 = sum(p.dtype == torch.float16 for p in params.values())
    assert n16 == 27
    trainer = Trainer(params, "sgd", {"learning_rate": 0.05, "momentum": 0.9,
                                      "wd": 1e-4, "multi_precision": True})
    ref_params = {n: p for n, p in collect_params(ref).items()
                  if p.requires_grad}
    ref_state = {n: (p.detach().float(), torch.zeros_like(p, dtype=torch.float32))
                 for n, p in ref_params.items()}
    scale = 8.0
    for _ in range(2):
        kernels.LAUNCHES.reset()
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss * scale)
        trainer.step(8 * scale)
        assert kernels.LAUNCHES.count == 1
        with autograd.record():
            ref_loss = loss_fn(ref(x), y)
        autograd.backward(ref_loss * scale)
        kw = dict(lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=1 / (8 * scale))
        with torch.no_grad():
            for n, p in ref_params.items():
                w32, mom = ref_state[n]
                if p.dtype == torch.float16:
                    new = kernels.mp_sgd_mom_update_ref(p, p.grad, mom, w32,
                                                        **kw)
                    for dst, src in zip((p, mom, w32), new):
                        dst.copy_(src)
                else:
                    nw, nm = oops.sgd_mom_update(p, p.grad, mom, **kw)
                    p.copy_(nw)
                    mom.copy_(nm)
                p.grad = None
        assert abs(loss.float().mean().item()
                   - ref_loss.float().mean().item()) <= 1e-2
    for i, (n, p) in enumerate(params.items()):
        if not p.requires_grad:
            assert p.dtype == torch.float32
            continue
        got = trainer._updaters[0].states[i][0] \
            if p.dtype == torch.float16 else p.detach()
        want = ref_state[n][0] if p.dtype == torch.float16 else ref_params[n]
        torch.testing.assert_close(got, want.detach(), rtol=1e-2, atol=1e-3)
    torch.backends.cudnn.deterministic = False


def _sgd_list(sizes, seed, unaligned=()):
    """fp16 weights and gradients, fp32 momenta and master weights of
    ``sizes``; the indices in ``unaligned`` are views at an odd element
    offset, too unaligned for the kernel's 16-byte accesses."""
    g = torch.Generator().manual_seed(seed)
    ws, gs, ms, w32s = [], [], [], []
    for i, n in enumerate(sizes):
        off = 1 if i in unaligned else 0
        w32 = torch.zeros(n + off, device="cuda")[off:]
        w32.copy_(torch.randn(n, generator=g))
        m = torch.zeros(n + off, device="cuda")[off:]
        m.copy_(torch.randn(n, generator=g) * 0.01)
        w = torch.zeros(n + off, dtype=torch.float16, device="cuda")[off:]
        w.copy_(w32.half())
        grad = torch.zeros(n + off, dtype=torch.float16, device="cuda")[off:]
        grad.copy_((torch.randn(n, generator=g) * 300).half())
        ws.append(w), gs.append(grad), ms.append(m), w32s.append(w32)
    return ws, gs, ms, w32s


@pytest.mark.parametrize("clip", [-1.0, 1.0])
@pytest.mark.parametrize("case", ["short", "mixed", "above_capacity"])
def test_mp_sgd_multi_kernel_is_bit_equal_to_plain_version(case, clip):
    """One launch updates a list in place, each tensor with its own lr and
    wd, bit-equal to the per-tensor plain version: sizes with and without
    a partial quad and over many blocks, tensors at an odd element
    offset, a short list (the kernel's small table) and a long one; a list
    above the table's capacity takes one launch per capacity's worth."""
    _need_cuda()
    from mxnet_tpu_torch.opt.kernels import (LAUNCHES, capacity,
                                             mp_sgd_mom_update_multi_kernel,
                                             mp_sgd_mom_update_multi_ref)
    cap = capacity()
    assert cap >= 150
    if case == "short":
        sizes, unaligned, launches = [3, 4097, 1_000_003], (0,), 1
    elif case == "mixed":
        sizes = [1, 7, 8, 768, 4097, 1_000_003, 2_359_296, 13]
        unaligned, launches = (1, 5), 1
    else:
        sizes = [(i * 37) % 300 + 1 for i in range(cap + 5)]
        unaligned, launches = (3,), 2
    ws, gs, ms, w32s = _sgd_list(sizes, len(sizes), unaligned)
    lrs = [0.05 * (1 + i % 3) for i in range(len(sizes))]
    wds = [1e-4 * (i % 2) for i in range(len(sizes))]
    kw = dict(momentum=0.9, rescale_grad=1 / 256, clip_gradient=clip)
    want = mp_sgd_mom_update_multi_ref(ws, gs, ms, w32s, lrs, wds, **kw)
    before = LAUNCHES.count
    mp_sgd_mom_update_multi_kernel(ws, gs, ms, w32s, lrs, wds, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + launches
    for got, exp in zip(zip(ws, ms, w32s), want):
        for a, b in zip(got, exp):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_has_overflow_on_cuda_gradients():
    """One reduction over every gradient finds an inf or a NaN in any of
    them, fp16 or fp32, and nothing in finite ones at fp16's extremes."""
    _need_cuda()
    from mxnet_tpu_torch.amp import LossScaler
    big = torch.full((1000,), 65504.0, dtype=torch.float16, device="cuda")
    params = [torch.nn.Parameter(torch.zeros(n, dtype=dt, device="cuda"))
              for n, dt in ((1000, torch.float16), (5, torch.float32),
                            (300_000, torch.float16))]
    for p in params:
        p.grad = torch.ones_like(p)
    params[0].grad = big.clone()
    scaler = LossScaler()
    assert not scaler.has_overflow(params)
    for bad in (float("inf"), float("-inf"), float("nan")):
        for p in params:
            g = p.grad.clone()
            p.grad[-1] = bad
            assert scaler.has_overflow(params), (bad, p.dtype)
            p.grad = g


def test_backward_writes_gradients_on_cuda_tensors():
    """Two backward passes without a step leave the second pass's
    gradient (grad_req "write"); a parameter marked "add" sums both, and
    one the second pass does not reach keeps its gradient."""
    _need_cuda()
    from mxnet_tpu_torch import autograd
    w = torch.nn.Parameter(torch.ones(4, device="cuda"))
    a = torch.nn.Parameter(torch.ones(4, device="cuda"))
    a.grad_req = "add"
    u = torch.nn.Parameter(torch.ones(4, device="cuda"))
    for scale in (2.0, 3.0):
        with autograd.record():
            y = (w * scale).sum() + (a * scale).sum()
            if scale == 2.0:
                y = y + (u * 5.0).sum()
        autograd.backward(y)
    assert torch.equal(w.grad, torch.full_like(w, 3.0))
    assert torch.equal(a.grad, torch.full_like(a, 5.0))
    assert torch.equal(u.grad, torch.full_like(u, 5.0))


# -- the mx.nd surface on the card ---------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_nd_mp_sgd_mom_update_routes_by_dtype(dtype):
    """fp16 weights: one B1 launch a call, bit-equal to the plain update,
    written in place under ``out=``; fp32: the plain formula, no launch."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.opt import kernels as opt_kernels
    g = torch.Generator(device="cuda").manual_seed(3)
    w32 = torch.randn(1000, device="cuda", generator=g)
    ins = [w32.to(dtype), torch.randn(1000, device="cuda",
                                      generator=g).to(dtype),
           torch.randn(1000, device="cuda", generator=g) * 0.1, w32]
    ref = opt_kernels.mp_sgd_mom_update_ref(*ins, lr=0.1, momentum=0.9,
                                            wd=1e-4)
    arrs = [nd.array(t) for t in ins]
    before = opt_kernels.LAUNCHES.count
    with mx.gpu(0):
        nd.mp_sgd_mom_update(*arrs, lr=0.1, momentum=0.9, wd=1e-4,
                             out=arrs[0])
    torch.cuda.synchronize()
    assert opt_kernels.LAUNCHES.count - before == int(dtype == torch.float16)
    for a, r in zip((arrs[0], arrs[2], arrs[3]), ref):
        assert a._data.is_cuda and torch.equal(a._data, r)


def test_nd_multi_mp_sgd_mom_update_is_one_launch():
    _need_cuda()
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.opt import kernels as opt_kernels
    g = torch.Generator(device="cuda").manual_seed(4)
    quads, lrs, wds = [], [0.1, 0.05, 0.2], [0.0, 1e-4, 1e-3]
    for n in (7, 1000, 33):
        w32 = torch.randn(n, device="cuda", generator=g)
        quads.append([w32.half(), torch.randn(n, device="cuda",
                                              generator=g).half(),
                      torch.zeros(n, device="cuda"), w32])
    ref = [opt_kernels.mp_sgd_mom_update_ref(*q, lr=lr, momentum=0.9, wd=wd)
           for q, lr, wd in zip(quads, lrs, wds)]
    arrs = [[nd.array(t) for t in q] for q in quads]
    before = opt_kernels.LAUNCHES.count
    nd.multi_mp_sgd_mom_update(*[a for q in arrs for a in q], lrs=lrs,
                               wds=wds, momentum=0.9, num_weights=3,
                               out=[q[0] for q in arrs])
    torch.cuda.synchronize()
    assert opt_kernels.LAUNCHES.count - before == 1
    for q, r in zip(arrs, ref):
        for a, b in zip((q[0], q[2], q[3]), r):
            assert torch.equal(a._data, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float16, 5e-3),
                                       (torch.float32, 1e-4)])
def test_nd_fused_attention_launches_the_tensor_core_kernels(dtype, tol):
    """The forward on B2's tensor-core route; under ``record`` the
    backward on B3/B4's; within the plain version's limits."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES_DKV_TC, LAUNCHES_DKV_TC32, LAUNCHES_DQ_TC,
        LAUNCHES_DQ_TC32, LAUNCHES_TC, LAUNCHES_TC32,
        flash_attention_ref_bwd, flash_attention_ref_fwd)
    tc = (LAUNCHES_TC, LAUNCHES_DQ_TC, LAUNCHES_DKV_TC) \
        if dtype == torch.float16 else (LAUNCHES_TC32, LAUNCHES_DQ_TC32,
                                        LAUNCHES_DKV_TC32)
    q, k, v = _qkv(5, 2, 3, 128, 128, 64, dtype)
    dout = _qkv(6, 2, 3, 128, 128, 64, dtype)[0]
    before = [c.count for c in tc]
    with mx.gpu(0):
        a = [nd.array(t) for t in (q, k, v)]
        for x in a:
            x.attach_grad()
        with autograd.record():
            out = nd._fused_attention(*a, scale=0.125, causal=True)
        out.backward(nd.array(dout))
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(tc, before)] == [1, 1, 1]
    f32 = [t.float() for t in (q, k, v)]
    ref, lse = flash_attention_ref_fwd(*f32, True, 0.125)
    assert (out._data.float() - ref).abs().max().item() <= tol
    grads = flash_attention_ref_bwd(*f32, ref, lse, dout.float(), True, 0.125)
    atol = 1e-4 if dtype == torch.float32 else 8e-3
    rtol = 0.0 if dtype == torch.float32 else 2e-3
    for x, r in zip(a, grads):
        err = (x.grad._data.float() - r).abs()
        assert bool((err <= atol + rtol * r.abs()).all())


def test_out_of_range_labels_raise_no_device_assert():
    """Labels -1, n and n + 2 on the card: -1 wraps, the others give NaN,
    and the CUDA context survives (a bare gather would assert)."""
    _need_cuda()
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn as gnn
    pred = torch.randn(4, 5, device="cuda")
    label = torch.tensor([0.0, -1.0, 5.0, 7.0], device="cuda")
    loss = gloss.SoftmaxCrossEntropyLoss()(pred, label)
    emb = gnn.Embedding(5, 3, device="cuda")
    rows = emb(label.long())
    picked = nd.pick(nd.array(pred), nd.array(label))
    torch.cuda.synchronize()
    assert torch.isnan(loss).tolist() == [False, False, True, True]
    assert torch.equal(rows[1], emb.weight[4]) and \
        torch.isnan(rows[2:]).all()
    assert torch.isnan(picked._data).tolist() == [False, False, True, True]
    assert torch.ones(2, device="cuda").sum().item() == 2.0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_attention_kernels_launch_as_a_thread_s_first_cuda_work(dtype):
    """A thread that has made no CUDA call yet has no current context
    (autograd's backward thread, when the attention backward is the first
    work it does): the tensor-core kernels bind their tensors' device
    before their driver calls, so they launch there too."""
    _need_cuda()
    import threading
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd, flash_attention_ref_bwd,
        flash_attention_ref_fwd)
    q, k, v = _qkv(7, 2, 3, 128, 128, 64, dtype)
    dout = _qkv(8, 2, 3, 128, 128, 64, dtype)[0]
    got = []

    def work():
        try:
            out, lse = flash_attention_fwd(q, k, v)
            got.append((out, flash_attention_bwd(q, k, v, out, lse, dout)))
        except Exception as e:  # reported by the main thread
            got.append(e)

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert not isinstance(got[0], Exception), got[0]
    out, grads = got[0]
    torch.cuda.synchronize()
    f32 = [x.float() for x in (q, k, v)]
    ref, lse = flash_attention_ref_fwd(*f32)
    tol = 1e-4 if dtype == torch.float32 else 5e-3
    assert (out.float() - ref).abs().max().item() <= tol
    for g, r in zip(grads, flash_attention_ref_bwd(*f32, ref, lse,
                                                   dout.float())):
        assert (g.float() - r).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype,tol", [("float16", 5e-3), ("float32", 1e-4)])
def test_bound_fused_attention_launches_the_kernels(dtype, tol):
    """A ``_fused_attention`` node bound by ``simple_bind`` (q, k, v in
    ``dtype`` through ``type_dict``): ``forward(is_train=True)`` launches
    B2 and ``backward`` B3/B4 once each on the tensor-core route of the
    dtype, within the plain versions' limits."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, sym
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES_DKV_TC, LAUNCHES_DKV_TC32, LAUNCHES_DQ_TC,
        LAUNCHES_DQ_TC32, LAUNCHES_TC, LAUNCHES_TC32,
        flash_attention_ref_bwd, flash_attention_ref_fwd)
    tc = (LAUNCHES_TC, LAUNCHES_DQ_TC, LAUNCHES_DKV_TC) \
        if dtype == "float16" else (LAUNCHES_TC32, LAUNCHES_DQ_TC32,
                                    LAUNCHES_DKV_TC32)
    shape = (2, 3, 128, 64)
    node = sym._fused_attention(sym.var("q"), sym.var("k"), sym.var("v"),
                                scale=0.125, name="att")
    ex = node.simple_bind(mx.gpu(0), type_dict=dict.fromkeys("qkv", dtype),
                          q=shape, k=shape, v=shape)
    tdt = getattr(torch, dtype)
    q, k, v = _qkv(9, 2, 3, 128, 128, 64, tdt)
    dout = _qkv(10, 2, 3, 128, 128, 64, tdt)[0]
    before = [c.count for c in tc]
    out = ex.forward(is_train=True, q=nd.array(q), k=nd.array(k),
                     v=nd.array(v))[0]
    ex.backward(nd.array(dout))
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(tc, before)] == [1, 1, 1]
    f32 = [t.float() for t in (q, k, v)]
    ref, lse = flash_attention_ref_fwd(*f32, False, 0.125)
    assert (out._data.float() - ref).abs().max().item() <= tol
    grads = flash_attention_ref_bwd(*f32, ref, lse, dout.float(), False,
                                    0.125)
    atol = 1e-4 if dtype == "float32" else 8e-3
    rtol = 0.0 if dtype == "float32" else 2e-3
    for name, r in zip("qkv", grads):
        err = (ex.grad_dict[name]._data.float() - r).abs()
        assert bool((err <= atol + rtol * r.abs()).all())


def test_module_on_the_card_keeps_its_arrays_there():
    """``Module(context=mx.gpu(0))`` with a BatchNorm: after ``fit`` every
    argument, gradient, aux state and output of its executor, and the
    parameters ``get_params`` gives, are CUDA tensors."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import sym
    net = sym.SoftmaxOutput(sym.FullyConnected(
        sym.BatchNorm(sym.var("data"), name="bn"), num_hidden=3, name="fc"),
        name="softmax")
    rs = np.random.RandomState(0)
    x = rs.randn(16, 4).astype("float32")
    y = rs.randint(0, 3, 16).astype("float32")
    with mx.gpu(0):
        it = mx.io.NDArrayIter(x, y, batch_size=8)
        mod = mx.mod.Module(net, context=mx.gpu(0))
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1})
    ex = mod._exec_group.execs[0]
    arrays = list(ex.arg_dict.values()) + list(ex.grad_dict.values()) + \
        list(ex.aux_dict.values()) + ex.outputs
    args, auxs = mod.get_params()
    arrays += list(args.values()) + list(auxs.values())
    assert all(a._data.is_cuda for a in arrays)
    assert float(ex.aux_dict["bn_moving_mean"].asnumpy().std()) > 0


def _sparse_case(device, seed=0, m=64, k=300, n=8):
    """A csr batch of Zipf-drawn columns and a dense weight, on
    ``device``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ndarray import sparse
    rs = np.random.RandomState(seed)
    cols = [np.unique(np.minimum(rs.zipf(1.3, 6) - 1, k - 1))
            for _ in range(m)]
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    vals = rs.randn(indptr[-1]).astype("float32")
    w = rs.randn(k, n).astype("float32")
    r = rs.randn(m, n).astype("float32")
    ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
    with ctx:
        x = sparse.csr_matrix((vals, np.concatenate(cols), indptr),
                              shape=(m, k))
        return x, nd.array(w), nd.array(r)


def _csr_dot_run(device):
    """Both products and their right operands' row_sparse gradients."""
    from mxnet_tpu_torch import autograd, nd
    x, w, r = _sparse_case(device)
    w.attach_grad(stype="row_sparse")
    r.attach_grad(stype="row_sparse")
    with autograd.record():
        out = nd.dot(x, w)
        out_t = nd.dot(x, r, transpose_a=True)
        loss = (out * out).sum() + nd.sum(out_t.data * out_t.data)
    loss.backward()
    return {"out": out.asnumpy(), "out_t": out_t.data.asnumpy(),
            "out_t_rows": out_t.indices.asnumpy(),
            "gw": w.grad.data.asnumpy(), "gw_rows": w.grad.indices.asnumpy(),
            "gr": r.grad.asnumpy(), "densified": x.densified(),
            "stypes": (w.grad.stype, out_t.stype)}


def test_csr_dot_both_directions_on_cuda_match_the_cpu():
    """``nd.dot`` of a csr batch (csr x dense -> dense, csr^T x dense ->
    row_sparse) and the backward of both on CUDA tensors, against the
    same port code on the CPU (fp32, summation order only: 1e-5
    relative); the batch is never densified."""
    _need_cuda()
    card, cpu = _csr_dot_run("cuda"), _csr_dot_run("cpu")
    assert card["stypes"] == cpu["stypes"] == ("row_sparse", "row_sparse")
    assert not card["densified"]
    for key in ("out_t_rows", "gw_rows"):
        np.testing.assert_array_equal(card[key], cpu[key])
    for key in ("out", "out_t", "gw", "gr"):
        np.testing.assert_allclose(card[key], cpu[key], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_row_sparse_slot_deposits_on_cuda(grad_req):
    """``attach_grad(stype="row_sparse")`` on a CUDA array: two backwards
    through a sparse Embedding replace (``write``) or merge (``add``) the
    row_sparse gradient, which stays on the card and matches the CPU's."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    def run(ctx):
        with ctx:
            w = nd.array(np.arange(36, dtype="float32").reshape(12, 3))
            w.attach_grad(grad_req, stype="row_sparse")
            for ids in ([[1, 4], [4, 9]], [[9, 2], [0, 0]]):
                with autograd.record():
                    e = nd.Embedding(nd.array(np.asarray(ids, "float32")), w,
                                     input_dim=12, output_dim=3,
                                     sparse_grad=True)
                    loss = (e * e).sum()
                loss.backward()
            g = w.grad
            return g.stype, g.data._data.device.type, \
                g.indices.asnumpy(), g.data.asnumpy()
    card, cpu = run(mx.gpu(0)), run(mx.cpu())
    assert card[0] == "row_sparse" and card[1] == "cuda"
    np.testing.assert_array_equal(card[2], cpu[2])
    np.testing.assert_array_equal(card[2], [0, 1, 2, 4, 9] if grad_req ==
                                  "add" else [0, 2, 9])
    np.testing.assert_allclose(card[3], cpu[3], rtol=1e-6)


def test_row_merge_is_bit_equal_across_runs_on_cuda():
    """The merge of duplicate rows (``merge_rows``: a stable sort, then one
    sequential sum per segment, no atomics) gives the same bits in two
    runs on the card, at 200,000 Zipf-drawn ids of width 16."""
    _need_cuda()
    from mxnet_tpu_torch.ndarray.sparse import merge_rows
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(np.minimum(rs.zipf(1.1, 200_000), 50_000)).cuda()
    vals = torch.from_numpy(rs.randn(200_000, 16).astype("float32")).cuda()
    u1, v1 = merge_rows(vals, ids)
    u2, v2 = merge_rows(vals.clone(), ids.clone())
    assert torch.equal(u1, u2) and torch.equal(v1, v2)
    uc, vc = merge_rows(vals.cpu(), ids.cpu())
    assert torch.equal(u1.cpu(), uc)
    torch.testing.assert_close(v1.cpu(), vc, rtol=1e-5, atol=1e-4)


def test_storage_fallback_warns_on_cuda():
    """A sparse CUDA input to an op with no sparse implementation runs the
    dense op on the card with the fallback warning, once per op."""
    _need_cuda()
    import warnings
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ndarray import sparse
    sparse._fallback_warned.clear()
    with mx.gpu(0):
        a = sparse.row_sparse_array((np.ones((1, 2), "float32"),
                                     np.asarray([1])), shape=(3, 2))
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            out = nd.relu(a)
            nd.relu(a)
    assert sum("dense implementation" in str(w.message) for w in ws) == 1
    assert out._data.is_cuda
    np.testing.assert_array_equal(out.asnumpy(), [[0, 0], [1, 1], [0, 0]])


# -- autoregressive serving (serve2) ----------------------------------------

def _tiny_lm(device):
    from mxnet_tpu_torch.parallel.pipeline_lm import init_pipeline_lm
    return init_pipeline_lm(0, vocab=64, d_model=32, n_layers=2, n_heads=2,
                            d_head=16, d_ff=64, n_experts=2, device=device)


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("form", ["paged_attention", "paged_attention_flat"])
def test_paged_attention_on_cuda_matches_the_cpu(form, kv_dtype):
    """Both formulations on the card against the CPU on the same stored
    pools (fp32 math on both: 1e-5), a row of length 0 exactly zero."""
    _need_cuda()
    from mxnet_tpu_torch.parallel import paged_attention as pa
    g = torch.Generator().manual_seed(0)
    S, H, K = 32 * 4, 2, 16
    q = torch.randn(4, H, K, generator=g)
    k = torch.randn(S, H, K, generator=g)
    v = torch.randn(S, H, K, generator=g)
    ks = vs = None
    if kv_dtype == "int8":
        ks = k.abs().amax((1, 2)) / 127
        vs = v.abs().amax((1, 2)) / 127
        k = torch.round(k / ks[:, None, None]).to(torch.int8)
        v = torch.round(v / vs[:, None, None]).to(torch.int8)
    elif kv_dtype == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    bt = torch.randint(1, 32, (4, 5), generator=g)
    lengths = torch.tensor([0, 3, 8, 20])
    fn = getattr(pa, form)
    cuda = lambda x: None if x is None else x.cuda()  # noqa: E731
    want = fn(q, k, v, bt, lengths, page_size=4, kscale=ks, vscale=vs)
    got = fn(q.cuda(), k.cuda(), v.cuda(), bt.cuda(), lengths.cuda(),
             page_size=4, kscale=cuda(ks), vscale=cuda(vs))
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert not got[0].any()


def test_paged_lm_on_cuda_matches_the_cpu_and_keeps_its_pools():
    """Prefill, decode (4 steps a call) and verify on the card against the
    same calls on the CPU (TF32 off; 1e-4 on logits of a 2-layer model),
    the same greedy tokens, and the pools' storage unchanged."""
    _need_cuda()
    from mxnet_tpu_torch.serve2 import PagedLM
    torch.backends.cuda.matmul.allow_tf32 = False
    params = _tiny_lm("cpu")
    geom = dict(page_size=4, num_pages=16, max_pages_per_seq=4,
                decode_steps=4)
    lms = [PagedLM(params, device=d, **geom) for d in ("cpu", "cuda")]
    ptrs = {k: v.data_ptr() for k, v in lms[1].pools.items()}
    rows = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], "int32")
    outs = []
    for lm in lms:
        first = []
        for i, p in enumerate([[3, 9, 1, 4, 7], [11, 2, 30, 5, 5, 8]]):
            padded = np.zeros((8,), "int32")
            padded[:len(p)] = p
            n, last = lm.prefill(padded, len(p), rows[i])
            first.append((n, last.cpu()))
        toks, logits = lm.decode(rows, np.array([5, 6], "int32"),
                                 np.array([f[0] for f in first], "int32"),
                                 np.array([4, 2], "int32"))
        vo, va, vl = lm.verify(rows, np.array([9, 8], "int32"),
                               np.array([[1, 2, 3], [4, 5, 6]], "int32"),
                               np.array([3, 3], "int32"))
        outs.append((first, toks, logits.cpu(), vo, va, vl.cpu()))
    (f0, t0, l0, o0, a0, v0), (f1, t1, l1, o1, a1, v1) = outs
    for (n0, x0), (n1, x1) in zip(f0, f1):
        assert n0 == n1
        torch.testing.assert_close(x1, x0, rtol=1e-4, atol=1e-4)
    assert np.array_equal(t0[0], t1[0]) and np.array_equal(t0[1, :2],
                                                           t1[1, :2])
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=1e-4)
    assert np.array_equal(a0, a1)
    torch.testing.assert_close(v1, v0, rtol=1e-4, atol=1e-4)
    assert ptrs == {k: v.data_ptr() for k, v in lms[1].pools.items()}


def test_decode_engine_defaults_to_the_card():
    """A DecodeEngine built without ``device`` runs on the card: every
    parameter and pool there, greedy tokens equal to a CPU engine's, the
    pools' storage kept across ticks, no signature after warmup."""
    _need_cuda()
    from mxnet_tpu_torch.serve2 import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    params = _tiny_lm("cuda")
    kw = dict(page_size=4, num_pages=32, max_inflight=4,
              prefill_buckets=[8], max_new_default=6, max_seq_len=24)
    eng = DecodeEngine(params, name="cuda-default", **kw)
    ref = DecodeEngine({k: ({kk: vv.cpu() for kk, vv in v.items()}
                            if isinstance(v, dict) else v.cpu())
                        for k, v in params.items()}, name="cuda-ref",
                       device="cpu", **kw)
    try:
        eng.warmup()
        ref.warmup()
        assert eng.device.type == "cuda"
        assert all(t.is_cuda for t in eng.lm.pools.values())
        assert all(t.is_cuda for t in eng.lm.params["layers"].values())
        ptrs = {k: v.data_ptr() for k, v in eng.lm.pools.items()}
        prompts = [[3, 9, 1, 4, 7], [1, 2, 3], [5, 5, 5, 5, 5, 5, 5]]
        hs = [eng.submit(p) for p in prompts]
        assert eng.run_until_idle(60.0)
        for p, h in zip(prompts, hs):
            assert h.result.tolist() == ref.predict(p).tolist()
        assert ptrs == {k: v.data_ptr() for k, v in eng.lm.pools.items()}
        assert eng.stats()["recompiles_after_warmup"] == 0
    finally:
        eng.close()
        ref.close()


# -- the fused training step (mxnet_tpu_torch.step), one CUDA graph a step ---

def _small_bert_cuda(dropout=0.1):
    """A 2-layer, 64-unit BERT on the card (heads of 16: the fp32
    tensor-core route), its dropout generators seeded."""
    from mxnet_tpu_torch.gluon.nn import Dropout
    from mxnet_tpu_torch.models import BERTModel
    torch.manual_seed(0)
    model = BERTModel(vocab_size=100, units=64, num_layers=2, num_heads=4,
                      hidden_size=128, max_len=32, dropout=dropout,
                      device="cuda")
    for i, d in enumerate(m for m in model.modules()
                          if isinstance(m, Dropout)):
        d.manual_seed(i)
    return model


def _bn_mlp_cuda(rate=0.2, lr=None):
    from mxnet_tpu_torch.gluon.nn import (BatchNorm, Dense, Dropout,
                                          HybridSequential)
    torch.manual_seed(0)
    net = HybridSequential(Dense(32, activation="relu", in_units=10, device="cuda"),
                           BatchNorm(in_channels=32, device="cuda"),
                           Dropout(rate, device="cuda"),
                           Dense(4, in_units=32, device="cuda"))
    net[2].manual_seed(7)
    return net


def _step_batches(which, n):
    rng = np.random.RandomState(0)
    if which == "bert":
        return [tuple(torch.from_numpy(rng.randint(0, 100, (2, 32))).cuda()
                      for _ in range(2)) for _ in range(n)]
    return [(torch.from_numpy(rng.uniform(-1, 1, (8, 10)).astype(
                 "float32")).cuda(),
             torch.from_numpy(rng.uniform(-1, 1, (8, 4)).astype(
                 "float32")).cuda()) for _ in range(n)]


def _fused_vs_eager(which, opt, kwargs, batches, fused, hook=None):
    """Steps over ``batches`` through the eager loop or the fused step;
    ``hook(i, model, trainer)`` runs after step ``i``. Returns the model,
    trainer, losses and the step function."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon import loss as gloss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _small_bert_cuda() if which == "bert" else _bn_mlp_cuda()
    loss_fn = gloss.SoftmaxCrossEntropyLoss() if which == "bert" \
        else gloss.L2Loss()
    trainer = Trainer(collect_params(model), opt, dict(kwargs))
    step = trainer.fuse_step(model, loss_fn) if fused else None
    losses = []
    for i, (x, y) in enumerate(batches):
        if fused:
            loss = step.step(x, y)
        else:
            with autograd.record():
                loss = loss_fn(model(x), y)
            autograd.backward(loss)
            trainer.step(x.shape[0])
        losses.append(loss.detach().clone())
        if hook is not None:
            hook(i, model, trainer)
    torch.cuda.synchronize()
    return model, trainer, losses, step


def _same_run(a, b):
    from mxnet_tpu_torch.gluon import collect_params
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2])), "losses"
    pa, pb = collect_params(a[0]), collect_params(b[0])
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    sa, sb = a[1]._updaters[0].states, b[1]._updaters[0].states
    assert sorted(sa) == sorted(sb)
    for i in sa:
        xs = sa[i] if isinstance(sa[i], tuple) else (sa[i],)
        ys = sb[i] if isinstance(sb[i], tuple) else (sb[i],)
        for x, y in zip(xs, ys):
            assert (x is None and y is None) or torch.equal(x, y), i


@pytest.mark.parametrize("which,opt,kwargs", [
    ("bert", "adamw", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("bert", "sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("bn_mlp", "sgd", {"learning_rate": 0.05, "momentum": 0.9,
                       "wd": 0.01}),
    ("bn_mlp", "adam", {"learning_rate": 0.01})])
def test_fused_step_capture_equals_eager_bit_for_bit(which, opt, kwargs):
    """Three replays of the captured step equal three eager steps from the
    same start, batch and dropout generators, bit for bit: losses,
    weights, BatchNorm's running statistics and optimizer states; the
    warm-up before the capture left no trace."""
    _need_cuda()
    batches = _step_batches(which, 1) * 3
    eager = _fused_vs_eager(which, opt, kwargs, batches, False)
    again = _fused_vs_eager(which, opt, kwargs, batches, False)
    _same_run(eager, again)   # the eager step is bit-reproducible
    fused = _fused_vs_eager(which, opt, kwargs, batches, True)
    _same_run(eager, fused)
    assert fused[3].cache_info()["programs"] == 1


def test_fused_step_lr_change_takes_effect_without_recapture():
    _need_cuda()

    def hook(i, model, trainer):
        if i == 1:
            trainer.set_learning_rate(0.003)

    kw = {"learning_rate": 1e-2, "momentum": 0.9}
    batches = _step_batches("bert", 4)
    eager = _fused_vs_eager("bert", "sgd", kw, batches, False, hook)
    from mxnet_tpu_torch.telemetry import metrics
    misses = metrics.counter("fused_step_cache_misses_total")
    m0 = misses.value()
    fused = _fused_vs_eager("bert", "sgd", kw, batches, True, hook)
    assert misses.value() == m0 + 1   # the first capture only
    _same_run(eager, fused)


def test_fused_step_replays_draw_new_dropout_masks():
    """lr 0 keeps the weights: two replays differ only by their masks,
    which differ, and each equals the eager step's from the same
    generator state."""
    _need_cuda()
    kw = {"learning_rate": 0.0}
    batches = _step_batches("bn_mlp", 1) * 2
    eager = _fused_vs_eager("bn_mlp", "sgd", kw, batches, False)
    fused = _fused_vs_eager("bn_mlp", "sgd", kw, batches, True)
    assert not torch.equal(fused[2][0], fused[2][1])
    _same_run(eager, fused)


def test_fused_step_rekeys_on_new_parameter_storage():
    _need_cuda()
    from mxnet_tpu_torch.telemetry import metrics

    def hook(i, model, trainer):
        if i == 1:   # as load_parameters into another dtype would
            w = model[0].weight
            w.data = w.data.clone()

    kw = {"learning_rate": 0.05, "momentum": 0.9}
    batches = _step_batches("bn_mlp", 4)
    eager = _fused_vs_eager("bn_mlp", "sgd", kw, batches, False, hook)
    m0 = metrics.counter("fused_step_cache_misses_total").value()
    fused = _fused_vs_eager("bn_mlp", "sgd", kw, batches, True, hook)
    assert metrics.counter("fused_step_cache_misses_total").value() == m0 + 2
    _same_run(eager, fused)


def test_fused_step_replays_on_new_inputs_through_the_kernels():
    """Each replay on a new batch equals the eager step on it, bit for bit:
    the attention kernels ran inside the graph. Their launch counters
    count Python calls, so they move at the warm-up and the capture only,
    not at a replay; a replay makes no host synchronisation."""
    _need_cuda()
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_DKV_TC32, LAUNCHES_SPLIT)
    kw = {"learning_rate": 1e-3}
    batches = _step_batches("bert", 4)
    eager = _fused_vs_eager("bert", "adam", kw, batches, False)
    counts = []

    def hook(i, model, trainer):
        counts.append((LAUNCHES.count, LAUNCHES_DKV_TC32.count,
                       LAUNCHES_SPLIT.count))
        if i == 1:
            torch.cuda.set_sync_debug_mode("error")

    try:
        fused = _fused_vs_eager("bert", "adam", kw, batches, True, hook)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same_run(eager, fused)
    assert counts[1] == counts[2] == counts[3]


def test_fused_step_host_sync_in_the_loss_raises():
    """A host synchronisation inside the step cannot be captured: the
    step raises MXNetError naming the capture, runs no eager step in its
    place, and leaves the weights as they were."""
    _need_cuda()
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon import loss as gloss

    class SyncingLoss(gloss.L2Loss):
        def forward(self, pred, label, sample_weight=None):
            loss = super().forward(pred, label, sample_weight)
            if loss.sum().item() < 0:   # a host read of a device value
                loss = loss * 2
            return loss

    net = _bn_mlp_cuda()
    params = collect_params(net)
    before = {n: p.detach().clone() for n, p in params.items()}
    trainer = Trainer(params, "sgd", {"learning_rate": 0.1})
    fused = trainer.fuse_step(net, SyncingLoss())
    x, y = _step_batches("bn_mlp", 1)[0]
    with pytest.raises(MXNetError, match="capture"):
        fused.step(x, y)
    for n, p in params.items():
        assert torch.equal(p, before[n]), n
    assert trainer._optimizer._index_update_count == {}


def test_a_failed_capture_leaves_the_generators_usable():
    """The capture that a host read aborts registered the device's
    generators with its graph; afterwards each draws again outside a
    graph (it raised "Offset increment outside graph capture" before the
    repair), from its state before the warm-up."""
    _need_cuda()
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.random import generator

    class SyncingLoss(gloss.L2Loss):
        def forward(self, pred, label, sample_weight=None):
            loss = super().forward(pred, label, sample_weight)
            if loss.sum().item() < 0:   # a host read of a device value
                loss = loss * 2
            return loss

    net = _bn_mlp_cuda()
    fused = Trainer(collect_params(net), "sgd", {"learning_rate": 0.1}) \
        .fuse_step(net, SyncingLoss())
    x, y = _step_batches("bn_mlp", 1)[0]
    g = generator(torch.device("cuda", 0))
    before = g.get_state()
    default_before = torch.cuda.default_generators[0].get_state()
    with pytest.raises(MXNetError, match="capture"):
        fused.step(x, y)
    assert generator(torch.device("cuda", 0)) is g
    assert torch.equal(g.get_state(), before)
    a = torch.rand(4, device="cuda", generator=g)
    b = torch.rand(4, device="cuda")            # the default generator
    for got, state in ((a, before), (b, default_before)):
        ref = torch.Generator(device="cuda")
        ref.set_state(state)
        assert torch.equal(got, torch.rand(4, device="cuda", generator=ref))


_EAGER_SYNC_PROBE = """
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import config, nd
config.set_flag("MXNET_EAGER_SYNC", sys.argv[1] == "1")
x = nd.array(np.arange(8, dtype=np.float32), ctx=mx.gpu(0))
i = nd.array(np.array([1, 99], dtype=np.float32), ctx=mx.gpu(0))
x.wait_to_read()
i.wait_to_read()
try:
    y = x[i]          # index 99 of 8: a device-side assert, raised late
except RuntimeError:
    print("raised at the op")
    sys.exit(0)
try:
    y.asnumpy()
except RuntimeError:
    print("raised at the read")
    sys.exit(0)
print("not raised")
"""


@pytest.mark.parametrize("sync,where", [("1", "raised at the op"),
                                        ("0", "raised at the read")])
def test_eager_sync_surfaces_a_device_error_at_its_op(sync, where):
    """Under MXNET_EAGER_SYNC the op dispatch waits for the device after
    every op, so an out-of-range index (a device-side assert, which
    leaves the process's CUDA context unusable: hence a process of its
    own) raises at the indexing op; without it the op returns and the
    error comes at the next read."""
    _need_cuda()
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_LAUNCH_BLOCKING", None)
    run = subprocess.run([sys.executable, "-c", _EAGER_SYNC_PROBE, sync],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.stdout.strip().splitlines()[-1:] == [where], \
        (run.stdout, run.stderr[-2000:])


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_rnn_op_on_the_card_matches_the_cpu(mode):
    """The fused RNN op (two bidirectional layers) through cuDNN against
    torch's CPU loop, fp64: outputs, final states and the gradients of the
    data, the flat parameters and the states within 1e-10 of the largest
    magnitude; the profiler sees ``aten::_cudnn_rnn``."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.ops import rnn as ops_rnn
    g = torch.Generator().manual_seed(0)
    T, B, I, H, L = 7, 3, 5, 6, 2
    n = ops_rnn.rnn_param_size(mode, L, I, H, True)
    host = [torch.randn(T, B, I, generator=g, dtype=torch.float64),
            0.3 * torch.randn(n, generator=g, dtype=torch.float64),
            torch.randn(2 * L, B, H, generator=g, dtype=torch.float64),
            torch.randn(2 * L, B, H, generator=g, dtype=torch.float64)]
    lstm = mode == "lstm"
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=True)

    def run(dev):
        args = [a.to(dev).requires_grad_(True) for a in host[:3 + lstm]]
        outs = ops_rnn.rnn(*args, **kw)[:3 if lstm else 2]
        sum((o * o).sum() for o in outs).backward()
        return [o.detach().cpu() for o in outs], [a.grad.cpu() for a in args]

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        card = run("cuda")
    cpu = run("cpu")
    assert any(e.key == "aten::_cudnn_rnn" for e in prof.key_averages())
    for a, b in zip(card[0] + card[1], cpu[0] + cpu[1]):
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


def test_ctc_loss_on_the_card_matches_the_cpu():
    """``CTCLoss`` with frame and label lengths and a row no alignment
    fits, fp64, card against CPU: losses and gradients within 1e-10 of the
    largest magnitude, the impossible row's loss 1e30 and its gradient 0,
    frames past a row's length with a gradient of exactly 0."""
    _need_cuda()
    from mxnet_tpu_torch.ops import ctc as ops_ctc
    g = torch.Generator().manual_seed(1)
    data = torch.randn(12, 4, 6, generator=g, dtype=torch.float64)
    labels = torch.tensor([[1, 2, 3], [4, 4, 0], [2, 5, 1], [1, 2, 3]])
    lengths = [torch.tensor([12, 9, 6, 2]), torch.tensor([3, 2, 3, 3])]

    def run(dev):
        x = data.to(dev).requires_grad_(True)
        loss = ops_ctc.ctc_loss(x, labels.to(dev),
                                *[v.to(dev) for v in lengths],
                                use_data_lengths=True, use_label_lengths=True)
        loss.sum().backward()
        return loss.detach().cpu(), x.grad.cpu()

    (lc, gc), (lh, gh) = run("cuda"), run("cpu")
    assert float(lc[3]) == float(lh[3]) == ops_ctc.IMPOSSIBLE_LOSS
    assert not gc[:, 3].any()
    assert float((lc[:3] - lh[:3]).abs().max()) <= 1e-10 * float(
        lh[:3].abs().max())
    assert float((gc - gh).abs().max()) <= 1e-10 * float(gh.abs().max())
    assert not gc[9:, 1].any() and not gc[6:, 2].any()


# -- the image input pipeline and image serving (slice 18) ------------------------

def _image_records(path, n, seed=0):
    """``n`` JPEG records of random sizes 40-80 px, labels [class, index]."""
    import cv2
    from mxnet_tpu_torch import recordio
    rs = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        h, wd = rs.randint(40, 80, size=2)
        coarse = rs.randint(0, 255, (h // 8 + 2, wd // 8 + 2, 3))
        img = cv2.resize(coarse.astype(np.uint8), (int(wd), int(h)))
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, [float(i % 10), float(i)], i, 0), img,
            quality=90))
    w.close()


def _record_batches(path, ctx, slow=0.0):
    import time
    import mxnet_tpu_torch as mx
    with ctx:
        it = mx.io.ImageRecordIter(
            path_imgrec=path, data_shape=(3, 32, 32), batch_size=4,
            label_width=2, shuffle=True, rand_crop=True, rand_mirror=True,
            resize=36, mean_r=120.0, std_r=60.0, seed=5,
            preprocess_threads=3)
    out = []
    for batch in it:
        if slow:  # a consumer slower than the pipeline and its copies
            time.sleep(slow)
            x = batch.data[0]._data
            for _ in range(20):
                x = x * 1.0001
        out.append((batch.data[0]._data.cpu(), batch.label[0]._data.cpu(),
                    batch.pad, batch.data[0]._data.device))
    return it, out


def test_image_record_iter_on_the_card_equals_the_cpu(tmp_path):
    """The native pipeline's batches on ``cuda:0`` (pinned staging, a side
    stream) bit-equal to the same seeded iterator's with ``ctx=cpu``, the
    labels those written."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    path = str(tmp_path / "a.rec")
    _image_records(path, 30)
    it, card = _record_batches(path, mx.gpu(0))
    assert it.backend == "native" and it.decode_failures == 0
    _, host = _record_batches(path, mx.cpu())
    assert len(card) == len(host) == 8 and card[-1][2] == 2
    for (x, y, pad, dev), (hx, hy, hpad, hdev) in zip(card, host):
        assert dev.type == "cuda" and hdev.type == "cpu" and pad == hpad
        assert torch.equal(x, hx) and torch.equal(y, hy)
    seen = torch.cat([y[:4 - pad, 1] for _, y, pad, _ in card])
    assert sorted(seen.tolist()) == list(range(30))


def test_staging_buffer_is_not_overwritten_under_a_slow_consumer(tmp_path):
    """60 batches through three pinned slots to a consumer that sleeps
    and queues work on each batch: every batch equals the CPU run's."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    path = str(tmp_path / "b.rec")
    _image_records(path, 240, seed=1)
    _, card = _record_batches(path, mx.gpu(0), slow=0.01)
    _, host = _record_batches(path, mx.cpu())
    assert len(card) == len(host) == 60
    for (x, y, *_), (hx, hy, *_) in zip(card, host):
        assert torch.equal(x, hx) and torch.equal(y, hy)


def test_image_net_served_on_the_card():
    """A Gluon conv net with BatchNorm served on the card over batch rungs:
    each response equals a direct forward within 1e-5 (fp32, TF32 off), 0
    signatures after warmup, the engine's output on the card's path."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.serve import ServingEngine
    from mxnet_tpu_torch.serve.buckets import parse_bucket_spec
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(5))
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    eng = ServingEngine(net, input_specs=[(3, 16, 16)],
                        ladder=parse_bucket_spec("1,2,4"))
    try:
        eng.warmup()
        rs = np.random.RandomState(0)
        for n in (1, 3, 4, 2):
            x = rs.rand(n, 3, 16, 16).astype("float32")
            got = eng.predict(x)
            want = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert eng.stats()["recompiles_after_warmup"] == 0
    finally:
        eng.close()


# photo-like JPEGs as chip_smoke.py's [image_rec] makes them: smooth random
# colour fields at 300-500 px plus noise, quality 90, 4:2:0
def _photo_jpeg(rs, sides=(300, 500)):
    import cv2
    h, w = (int(v) for v in rs.randint(sides[0], sides[1] + 1, size=2))
    coarse = rs.randint(0, 256, (h // 12 + 2, w // 12 + 2, 3)).astype(
        np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR) \
        .astype(np.int16) + rs.randint(-44, 45, (h, w, 3))
    ok, buf = cv2.imencode(".jpg", np.clip(img, 0, 255).astype(np.uint8),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    return buf.tobytes()


def _photo_records(path, n, seed=0):
    from mxnet_tpu_torch import recordio
    rs = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        w.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(i % 10), i, 0), _photo_jpeg(rs)))
    w.close()


def test_nvjpeg_codec_matches_opencv():
    """The nvJPEG codec, built explicitly, against OpenCV's libjpeg-turbo
    on photo-like JPEGs, at chip_smoke.py's IMAGE_CODEC_* limits (derived
    there): RGB within IMAGE_CODEC_MAX counts and IMAGE_CODEC_MEAN on
    average, luma within IMAGE_CODEC_LUMA_MAX and 4:4:4 images (no chroma
    upsampling) within IMAGE_CODEC_444_MAX; a swap of R and B lies far
    outside the mean limit."""
    _need_cuda()
    import cv2
    import importlib.util
    from mxnet_tpu_torch import native
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lim = {k: getattr(smoke, f"IMAGE_CODEC_{k}")
           for k in ("MAX", "MEAN", "444_MAX", "LUMA_MAX")}
    native.build("nvjpeg")
    rs = np.random.RandomState(7)
    for _ in range(8):
        jpeg = _photo_jpeg(rs)
        ours = native.decode(jpeg, codec="nvjpeg").astype(np.int16)
        ref = cv2.imdecode(np.frombuffer(jpeg, np.uint8),
                           cv2.IMREAD_COLOR)[:, :, ::-1].astype(np.int16)
        assert ours.shape == ref.shape
        d = np.abs(ours - ref)
        assert d.max() <= lim["MAX"] and d.mean() <= lim["MEAN"]
        assert np.abs(ours[:, :, ::-1] - ref).mean() > 3 * lim["MEAN"]
        luma = native.decode(jpeg, 1, codec="nvjpeg")[:, :, 0]
        gray = cv2.imdecode(np.frombuffer(jpeg, np.uint8),
                            cv2.IMREAD_GRAYSCALE)
        assert np.abs(luma.astype(np.int16) - gray).max() <= lim["LUMA_MAX"]
        ok, j444 = cv2.imencode(
            ".jpg", np.ascontiguousarray(ref[:, :, ::-1]).astype(np.uint8),
            [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
        ours = native.decode(j444.tobytes(), codec="nvjpeg").astype(np.int16)
        ref = cv2.imdecode(j444, cv2.IMREAD_COLOR)[:, :, ::-1]
        assert np.abs(ours - ref).max() <= lim["444_MAX"]


def _need_nvjpeg_pipeline():
    _need_cuda()
    from mxnet_tpu_torch import native
    if native.codec() != "nvjpeg":
        pytest.skip("the native pipeline decodes with libjpeg here")


_FAULT_PROBE = """
import sys
import numpy as np
import torch
from mxnet_tpu_torch import MXNetError, native, recordio
path = sys.argv[1]
w = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
small = np.full((64, 64, 3), 128, np.uint8)
big = np.full((6000, 6000, 3), 90, np.uint8)  # 108 MB decoded
for i, img in enumerate((small, small, big)):
    w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                     img, quality=90))
w.close()
free, _ = torch.cuda.mem_get_info()
hog = torch.empty(free - (64 << 20), dtype=torch.uint8, device="cuda")
pipe = native.NativeImagePipeline(path, 3, data_shape=(3, 32, 32),
                                  num_workers=1)
for _ in range(2):  # the fault stays after a reset
    try:
        list(pipe)
        print("no error")
    except MXNetError as e:
        print("raised:", e)
    pipe.reset()
print("decode_failures:", pipe.decode_failures)
"""


def test_nvjpeg_decoder_fault_raises_and_is_no_bad_record(tmp_path):
    """An image too large for the card's free memory (the rest held by
    torch) is a decoder fault: the pipeline raises ``MXNetError`` naming
    it, again after a reset, and counts no bad record (a bad record is
    zeroed and training goes on). In a process of its own, which holds
    the card's memory."""
    _need_nvjpeg_pipeline()
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _FAULT_PROBE, str(tmp_path / "big.rec")],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": root})
    lines = out.stdout.splitlines()
    assert len(lines) == 3, out.stdout + out.stderr
    for line in lines[:2]:
        assert line.startswith("raised: the native image pipeline stopped: "
                               "nvjpeg codec: cudaMalloc"), line
    assert lines[2] == "decode_failures: 0"


def test_nvjpeg_pipeline_without_a_device_raises(tmp_path):
    """With no device visible the decoders cannot be made: the pipeline
    raises at construction, naming the failed call."""
    _need_nvjpeg_pipeline()
    import subprocess
    import sys
    path = str(tmp_path / "a.rec")
    _photo_records(path, 2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("from mxnet_tpu_torch import MXNetError, native\n"
            "try:\n"
            f"    native.NativeImagePipeline({path!r}, 2)\n"
            "except MXNetError as e:\n"
            "    print('raised:', e)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=root,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": root})
    assert "raised: the native image pipeline stopped: nvjpeg codec" \
        in out.stdout, out.stdout + out.stderr


def test_fused_step_captures_while_an_image_record_iter_decodes(tmp_path):
    """Fused steps captured (a new capture at every batch) while the
    native pipeline's workers decode ahead and its staging thread copies
    and allocates: every capture succeeds, no record fails, and the
    batches the steps read equal the same seeded iterator's with
    ``ctx=cpu``. Under CUDA's global capture mode the other threads' calls
    invalidated a capture in whole runs of this file."""
    _need_cuda()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import Trainer, nn
    from mxnet_tpu_torch.gluon import loss as gloss
    path = str(tmp_path / "f.rec")
    _photo_records(path, 192, seed=2)

    def record_iter(ctx):
        with ctx:
            return mx.io.ImageRecordIter(
                path_imgrec=path, data_shape=(3, 32, 32), batch_size=16,
                resize=40, rand_crop=True, rand_mirror=True, shuffle=True,
                seed=3, preprocess_threads=4)
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Dense(10, in_units=8))
    net.initialize(ctx=mx.gpu(0))
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01})
    loss_fn = gloss.SoftmaxCrossEntropyLoss()
    it = record_iter(mx.gpu(0))
    seen, losses = [], []
    for batch in it:
        x, y = batch.data[0]._data, batch.label[0]._data
        step = trainer.fuse_step(net, loss_fn)
        losses.append(step.step(x, y).detach())
        seen.append((x.cpu(), y.cpu()))
    torch.cuda.synchronize()
    assert it.decode_failures == 0 and len(seen) == 12
    assert all(bool(torch.isfinite(v).all()) for v in losses)
    for (x, y), b in zip(seen, record_iter(mx.cpu())):
        assert torch.equal(x, b.data[0]._data)
        assert torch.equal(y, b.label[0]._data)
