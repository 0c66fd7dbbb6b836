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
    from mxnet_tpu_torch.gluon import Trainer
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
    params = net.collect_params()
    n16 = sum(p.dtype == torch.float16 for p in params.values())
    assert n16 == 27
    trainer = Trainer(params, "sgd", {"learning_rate": 0.05, "momentum": 0.9,
                                      "wd": 1e-4, "multi_precision": True})
    ref_params = {n: p for n, p in ref.collect_params().items()
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
