#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``mxnet_tpu_torch`` (and nothing of JAX or ``mxnet_tpu``) end to
end, failing on the first phase that fails:

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device is a failure;
2. build — every kernel under ``mxnet_tpu_torch/csrc/`` with ``nvcc``;
3. kernel check — the flash-attention forward against its plain version
   on the card, at the serving and training paths' shapes and edge cases,
   in fp32, bf16 and fp16, timed beside its plain version,
   ``scaled_dot_product_attention`` (a yardstick only) and its bound;
4. backward check — the dQ and dK/dV kernels against the plain backward,
   timed beside it, the backward of ``scaled_dot_product_attention`` and
   their bounds;
5. optimizer check — the mixed-precision SGD kernel against its plain
   version at the sizes of BERT-base's parameters, bit for bit;
6. serving slice — BERT-base (full width, fp32, random weights from a
   seed) served by ``ServingEngine``: warmup over the ladder, closed-loop
   load, zero new signatures after warmup, 12 forward launches per
   dispatch, and one request's logits against the same model with dense
   attention;
7. training slice — BERT-base (full width and depth, fp16 weights,
   dropout 0.1) trained through ``autograd.record`` -> ``backward`` ->
   ``Trainer.step`` with multi-precision SGD and a static loss scale:
   12/12/12/150 launches per step, every parameter with a gradient, a
   finite and falling loss, and two steps against a reference run with
   dense attention and the plain update; step time, tokens/s, peak memory
   and a per-step breakdown.

The last three lines are the card (``nvidia-smi``), ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
FP32_TOL = 1e-4   # max abs, unit-scale inputs: only the summation order differs
BF16_TOL = 2e-2   # max abs vs fp32 on the same bf16-rounded inputs: the
                  # output's own bf16 rounding (8-bit mantissa) at |out| ~ 2
SLICE_RTOL = SLICE_ATOL = 1e-3  # 12 fp32 layers over a reordered softmax sum
# backward kernels vs the fp32 plain backward on the same rounded inputs,
# elementwise |err| <= atol + rtol*|ref|: fp32 max abs 1e-4 (summation
# order only); fp16/bf16 rtol four half-ulps of the output type (the one
# rounding when stored), atol for sums that cancel
BWD_TOL = {"float32": (1e-4, 0.0), "float16": (1e-3, 2e-3),
           "bfloat16": (1e-2, 1.6e-2)}
# training: BERT-base, B x T token ids, fp16 weights, multi-precision SGD
TRAIN_B, TRAIN_T, TRAIN_STEPS, REF_STEPS = 8, 512, 8, 2
TRAIN_LR, TRAIN_MOMENTUM, LOSS_SCALE = 0.2, 0.9, 8.0
# against the reference run (dense attention, plain update), which shares
# every fp16 product and dropout mask: only the attention kernels' summation
# order and rounding differ. Loss: a few fp16 ulps of a ~10.5 mean.
# Master weights: the update (w32 after - before) agrees to 2e-2 relative
# L2 over the model and to 1e-1 for each parameter.
TRAIN_LOSS_TOL, TRAIN_UPD_TOL, TRAIN_UPD_TOL_EACH = 1e-2, 2e-2, 1e-1
SGD_SIZES = (23_440_896, 2_359_296, 768, 1_000_003)
LADDER = "batch:1,2,4,8;seq:128,256,512"
N_REQUESTS, CONCURRENCY = 24, 4
HEADS, HEAD_DIM = 12, 64

# Published dense peaks (NVIDIA data sheets): fp32 without tensor cores,
# bf16 on tensor cores, device-memory bytes/s. Matched on the card's name.
PEAKS = (
    ("H100 PCIe", {"float32": 51.2e12, "bfloat16": 756e12, "float16": 756e12,
                   "bytes": 2.0e12}),
    ("H100 NVL", {"float32": 60e12, "bfloat16": 835e12, "float16": 835e12,
                  "bytes": 3.9e12}),
    ("H100", {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "bytes": 3.35e12}),
)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warm=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. The
    stream is first held by a device-side sleep (~50 ms) while the host
    queues every call, so host launch costs (ctypes, autograd) leave no
    gaps between them: what is timed is the device's work alone."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    # a card the table does not name is bounded by the H100 SXM's peaks
    peaks = next((p for key, p in PEAKS if key in name), PEAKS[-1][1])
    log(f"[device] {card}")
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; peaks used for bounds: {peaks}")
    return card, name, peaks


def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    for name, rep in report.items():
        regs = [ln.strip() for ln in rep["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {rep['seconds']:.2f} s; ptxas: {regs}")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.2f} s")


def attention_bound(B, H, Tq, Tk, D, causal, dtype, peaks):
    """Least time the card needs for the function: flops over the peak for
    the dtype vs bytes (q, k, v read once; out, lse written once) over the
    memory rate. Causal counts only the (q, k) pairs the mask keeps."""
    flops = 4.0 * B * H * D * _pairs(Tq, Tk, causal)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * H * Tq * D + 2 * B * H * Tk * D) * itemsize \
        + 4 * B * H * Tq
    t_ops = flops / peaks[str(dtype).replace("torch.", "")]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernel_check(peaks):
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES,
                                                     flash_attention_fwd,
                                                     flash_attention_ref_fwd)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # (B, H, Tq, Tk, D): the serving path's rungs at the top batch, the
    # edge cases (ragged T, head_dim 96, Tq != Tk), then every other
    # (batch, seq) rung the BERT-base path launches the kernel at
    timed = [(8, HEADS, t, t, HEAD_DIM) for t in (128, 256, 384, 512)] + [
        (8, HEADS, 200, 200, HEAD_DIM), (8, HEADS, 384, 384, 96),
        (8, HEADS, 128, 384, HEAD_DIM)]
    rungs = [(b, HEADS, t, t, HEAD_DIM) for b in (1, 2, 4)
             for t in (128, 256, 512)]
    rows = []
    for shape in timed + rungs:
        B, H, Tq, Tk, D = shape
        is_timed = shape in timed
        dtypes = (torch.float32,)
        if is_timed:
            dtypes += (torch.bfloat16,)
        if shape == (8, HEADS, 512, 512, HEAD_DIM):
            dtypes += (torch.float16,)  # the training path's
        for dtype in dtypes:
            for causal in ((False, True) if is_timed else (False,)):
                q, k, v = (torch.randn(B, H, T, D, device="cuda",
                                       generator=gen).to(dtype)
                           for T in (Tq, Tk, Tk))
                before = LAUNCHES.count
                out, lse = flash_attention_fwd(q, k, v, causal)
                torch.cuda.synchronize()
                launches = LAUNCHES.count - before
                ref, ref_lse = flash_attention_ref_fwd(
                    q.float(), k.float(), v.float(), causal)
                err = (out.float() - ref).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
                ok = (err <= tol and lse_err <= FP32_TOL and launches == 1
                      and bool(torch.isfinite(out).all()))
                row = {"shape": list(shape), "dtype": str(dtype)[6:],
                       "causal": causal, "launches": launches,
                       "max_abs_err": err,
                       "lse_max_abs_err": lse_err, "tol": tol}
                if is_timed:
                    bound_ms, bound_by = attention_bound(
                        B, H, Tq, Tk, D, causal, dtype, peaks)
                    row.update(
                        ms=cuda_ms(lambda: flash_attention_fwd(q, k, v,
                                                               causal)),
                        plain_ms=cuda_ms(lambda: flash_attention_ref_fwd(
                            q, k, v, causal)),
                        library_ms=cuda_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, is_causal=causal)),
                        bound_ms=bound_ms, bound_by=bound_by)
                log("[kernel] flash_fwd " + json.dumps(row))
                if not ok:
                    raise SystemExit(f"chip_smoke: flash_fwd disagrees with "
                                     f"its plain version: {row}")
                rows.append(row)
    return rows


def _pairs(Tq, Tk, causal):
    return sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk


def backward_bounds(B, H, Tq, Tk, D, causal, dtype, peaks):
    """Least times for the dQ pass, the dK/dV pass and both: FA2's count
    (2*D flops per kept (q, k) pair and product: S and dP recomputed by
    both, then dQ; dV and dK) over the dtype's peak, against the bytes of
    q, k, v, o, dO, lse, delta read once and dq, dk, dv written once.
    Returns ``{name: (ms, bound_by)}``."""
    it = torch.empty((), dtype=dtype).element_size()
    BH, pairs = B * H, _pairs(Tq, Tk, causal)
    peak = peaks[str(dtype).replace("torch.", "")]
    q_b, k_b, rows = BH * Tq * D * it, BH * Tk * D * it, 8 * BH * Tq
    work = {  # name: (products, bytes read and written)
        "flash_bwd_dq": (3, 2 * q_b + 2 * k_b + rows + q_b),
        "flash_bwd_dkv": (4, 2 * q_b + 2 * k_b + rows + 2 * k_b),
        "both": (5, 3 * q_b + 2 * k_b + rows + q_b + 2 * k_b)}
    out = {}
    for name, (products, nbytes) in work.items():
        t_ops = 2.0 * products * BH * D * pairs / peak
        t_bytes = nbytes / peaks["bytes"]
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_backward_check(peaks):
    """B3 (dQ) and B4 (dK/dV) against the plain backward on the same
    inputs (the kernel forward's out and lse, one dO), each launched once
    per case; timed at the training rung in every dtype."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES_DKV, LAUNCHES_DQ, _bwd_pass, flash_attention_bwd,
        flash_attention_fwd, flash_attention_ref_bwd)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rung = (8, HEADS, 512, 512, HEAD_DIM)
    cases = [(rung, dt, c) for dt in (torch.float32, torch.float16,
                                      torch.bfloat16) for c in (False, True)]
    cases += [(s, torch.float32, c) for s in ((8, HEADS, 200, 200, HEAD_DIM),
                                              (8, HEADS, 384, 384, 96),
                                              (8, HEADS, 128, 384, HEAD_DIM))
              for c in (False, True)]
    rows = []
    for shape, dtype, causal in cases:
        B, H, Tq, Tk, D = shape
        q, k, v = (torch.randn(B, H, T, D, device="cuda",
                               generator=gen).to(dtype)
                   for T in (Tq, Tk, Tk))
        dout = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        out, lse = flash_attention_fwd(q, k, v, causal)
        before = (LAUNCHES_DQ.count, LAUNCHES_DKV.count)
        grads = flash_attention_bwd(q, k, v, out, lse, dout, causal)
        torch.cuda.synchronize()
        launches = (LAUNCHES_DQ.count - before[0],
                    LAUNCHES_DKV.count - before[1])
        ref = flash_attention_ref_bwd(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(), causal)
        name = str(dtype).replace("torch.", "")
        atol, rtol = BWD_TOL[name]
        errs = [(g.float() - r).abs() for g, r in zip(grads, ref)]
        ok = launches == (1, 1) and all(
            bool((e <= atol + rtol * r.abs()).all())
            and bool(torch.isfinite(g).all())
            for e, g, r in zip(errs, grads, ref))
        row = {"shape": list(shape), "dtype": name, "causal": causal,
               "launches": list(launches),
               "max_abs_err": {n: e.max().item()
                               for n, e in zip(("dq", "dk", "dv"), errs)},
               "tol": {"atol": atol, "rtol": rtol}}
        if shape == rung:
            bounds = backward_bounds(B, H, Tq, Tk, D, causal, dtype, peaks)
            # each pass alone, on the wrapper's delta and outputs
            delta = torch.sum(dout.float() * out.float(), dim=-1)
            args = (q, k, v, dout, lse, delta)
            s = 1 / D ** 0.5
            row.update(
                ms=cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse,
                                                       dout, causal)),
                dq_ms=cuda_ms(lambda: _bwd_pass("dq", *args, grads[:1],
                                                causal, s)),
                dkv_ms=cuda_ms(lambda: _bwd_pass("dkv", *args, grads[1:],
                                                 causal, s)),
                plain_ms=cuda_ms(lambda: flash_attention_ref_bwd(
                    q, k, v, out, lse, dout, causal), iters=5, warm=1),
                library_ms=sdpa_backward_ms(F, q, k, v, dout, causal),
                bound_ms=bounds["both"][0], bound_by=bounds["both"][1],
                dq_bound_ms=bounds["flash_bwd_dq"][0],
                dq_bound_by=bounds["flash_bwd_dq"][1],
                dkv_bound_ms=bounds["flash_bwd_dkv"][0],
                dkv_bound_by=bounds["flash_bwd_dkv"][1])
        log("[kernel] flash_bwd " + json.dumps(row))
        if not ok:
            raise SystemExit(f"chip_smoke: flash backward disagrees with "
                             f"its plain version: {row}")
        rows.append(row)
    return rows


def sdpa_backward_ms(F, q, k, v, dout, causal):
    """The backward of one ``scaled_dot_product_attention`` call on the
    same inputs and dO: a yardstick for B3 and B4 together."""
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    return cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dout,
                                               retain_graph=True))


def phase_sgd_check(peaks):
    """B1 against its plain version at the sizes of BERT-base's parameters
    (the embedding, an FFN matrix, a bias) and an odd size, clip off and
    on: master weight and momentum bit-equal (limit 1e-6 relative), the
    fp16 weight equal to fp16 of the new master weight."""
    from mxnet_tpu_torch.opt.kernels import (LAUNCHES,
                                             mp_sgd_mom_update_kernel,
                                             mp_sgd_mom_update_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for n in SGD_SIZES:
        w32 = torch.randn(n, device="cuda", generator=gen) * 0.02
        grad = (torch.randn(n, device="cuda", generator=gen) * 100).half()
        mom = torch.randn(n, device="cuda", generator=gen) * 1e-3
        w = w32.half()
        for clip in (-1.0, 1.0):
            kw = dict(lr=TRAIN_LR, momentum=TRAIN_MOMENTUM, wd=1e-4,
                      rescale_grad=1 / 64, clip_gradient=clip)
            before = LAUNCHES.count
            got = mp_sgd_mom_update_kernel(w, grad, mom, w32, **kw)
            torch.cuda.synchronize()
            launches = LAUNCHES.count - before
            want = mp_sgd_mom_update_ref(w, grad, mom, w32, **kw)
            rel = max(((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
                      for a, b in zip(got[1:], want[1:]))
            ok = (launches == 1 and rel <= 1e-6
                  and torch.equal(got[0], got[2].half()))
            row = {"n": n, "clip": clip, "launches": launches,
                   "max_rel_err": rel,
                   "max_abs_err": max((a.float() - b.float()).abs().max()
                                      .item() for a, b in zip(got, want)),
                   "bit_equal": all(torch.equal(a, b)
                                    for a, b in zip(got, want))}
            if clip < 0:
                outs = [torch.empty_like(t) for t in (w, mom, w32)]
                row.update(
                    ms=cuda_ms(lambda: mp_sgd_mom_update_kernel(
                        w, grad, mom, w32, out=outs, **kw)),
                    plain_ms=cuda_ms(lambda: mp_sgd_mom_update_ref(
                        w, grad, mom, w32, **kw)),
                    bound_ms=20 * n / peaks["bytes"] * 1e3,
                    bound_by="bytes", library_ms=None)
            log("[kernel] mp_sgd " + json.dumps(row))
            if not ok:
                raise SystemExit(f"chip_smoke: mp_sgd disagrees with its "
                                 f"plain version: {row}")
            rows.append(row)
    return rows


def seeded_weights(model, seed):
    """BERT-style random weights in the JAX package's naming: N(0, 0.02)
    matrices, zero biases, LayerNorm gamma 1 and beta 0."""
    from mxnet_tpu_torch.convert import mxnet_tpu_shapes
    rng = np.random.default_rng(seed)
    named = {}
    for name, shape in sorted(mxnet_tpu_shapes(model).items()):
        if name.endswith("gamma"):
            named[name] = np.ones(shape, np.float32)
        elif name.endswith("bias") or name.endswith("beta"):
            named[name] = np.zeros(shape, np.float32)
        else:
            named[name] = (rng.standard_normal(shape, dtype=np.float32)
                           * 0.02)
    return named


def phase_slice(card):
    from mxnet_tpu_torch.convert import params_from_mxnet_tpu
    from mxnet_tpu_torch.models import BERTModel
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref)
    from mxnet_tpu_torch.serve import (InputSpec, ServingEngine,
                                       parse_bucket_spec, run_loadgen)
    # fp32 products in full fp32 (no TF32), for the model and its reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[slice] torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    model = BERTModel(device="cuda")
    model.load_state_dict(params_from_mxnet_tpu(seeded_weights(model, SEED),
                                                model))
    n_params = sum(p.numel() for p in model.parameters())
    layers = len(model.layers)
    log(f"[slice] BERTModel(): {n_params} parameters, {layers} layers, "
        f"built in {time.perf_counter() - t0:.2f} s")

    ladder = parse_bucket_spec(LADDER)
    top_seq = max(ladder.dim_buckets[1])
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, input_specs=[InputSpec((top_seq,),
                                                         "int32")],
                           ladder=ladder, name="bert-base", device="cuda")
    t0 = time.perf_counter()
    report = engine.warmup()
    warmup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    payloads = [rng.integers(0, 30522, (int(rng.integers(1, 5)),
                                        int(rng.integers(20, 501))),
                             dtype=np.int32) for _ in range(N_REQUESTS)]
    results = {}

    def fire(i):
        results[i] = engine.predict(payloads[i])

    disp0 = engine.stats()["batcher"]["dispatches"]
    LAUNCHES.reset()
    load = run_loadgen(fire, list(range(N_REQUESTS)), concurrency=CONCURRENCY)
    launches = LAUNCHES.count
    stats = engine.stats()
    breakdown = top_rung_breakdown(engine, ladder, top_seq)
    engine.close()
    dispatches = stats["batcher"]["dispatches"] - disp0
    log(f"[slice] served {load['completed']}/{N_REQUESTS} requests in "
        f"{dispatches} dispatches; flash_fwd launches {launches}; "
        f"errors {load['errors']}")
    if load["completed"] != N_REQUESTS or load["errors"]:
        raise SystemExit(f"chip_smoke: requests failed: {load['errors']}")
    if stats["recompiles_after_warmup"] != 0:
        raise SystemExit(f"chip_smoke: {stats['recompiles_after_warmup']} "
                         "new signatures after warmup")
    if launches != layers * dispatches or dispatches == 0:
        raise SystemExit(f"chip_smoke: {launches} flash_fwd launches for "
                         f"{dispatches} dispatches of {layers} layers")
    for i, p in enumerate(payloads):
        out = results[i]
        if out.shape != p.shape + (30522,) or not np.isfinite(out).all():
            raise SystemExit(f"chip_smoke: request {i}: output "
                             f"{out.shape} for input {p.shape}, or not "
                             "finite")

    # one request against the same model with dense attention, on the
    # same padded input the engine ran (rows are independent in BERT)
    p = payloads[0]
    seq = ladder.pad_item_shape(p.shape[1:])[0]
    padded = np.zeros((p.shape[0], seq), np.int32)
    padded[:, :p.shape[1]] = p
    tokens = torch.from_numpy(padded).cuda()
    with torch.inference_mode():
        for layer in model.layers:
            layer.attn.attention = flash_attention_ref
        ref = model(tokens)[:, :p.shape[1]].cpu().numpy()
        for layer in model.layers:
            layer.attn.attention = flash_attention
    err = float(np.abs(results[0] - ref).max())
    log(f"[slice] request 0 {p.shape} vs dense attention: max abs "
        f"{err:.3e} (rtol {SLICE_RTOL}, atol {SLICE_ATOL})")
    if not np.allclose(results[0], ref, rtol=SLICE_RTOL, atol=SLICE_ATOL):
        raise SystemExit("chip_smoke: served logits disagree with the "
                         "dense-attention model")
    summary = {
        "card": card, "requests": N_REQUESTS, "concurrency": CONCURRENCY,
        "dispatches": dispatches, "flash_fwd_launches": launches,
        "throughput_rps": load["throughput_rps"], "p50_ms": load["p50_ms"],
        "p99_ms": load["p99_ms"], "wall_s": load["wall_s"],
        "programs": stats["programs_compiled"],
        "recompiles_after_warmup": stats["recompiles_after_warmup"],
        "warmup_s": warmup_s,
        "warmup_first_ms": report[0]["ms"],
        "avg_padding_ratio": stats.get("avg_padding_ratio"),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "logits_max_abs_err": err}
    log("[slice] " + json.dumps(summary))
    log("[slice] top-rung dispatch breakdown " + json.dumps(breakdown))
    return launches


def _seeded_bert_fp16():
    """BERT-base at full width and depth in fp16, seeded weights and
    dropout masks (each Dropout layer's generator from SEED + its index)."""
    from mxnet_tpu_torch.convert import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.nn import Dropout
    from mxnet_tpu_torch.models import BERTModel
    model = BERTModel(device="cuda", dtype=torch.float16)
    model.load_state_dict(params_from_mxnet_tpu(seeded_weights(model, SEED),
                                                model))
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for i, d in enumerate(drops):
        d.manual_seed(SEED + i)
    return model


def _train_step(model, loss_fn, tokens, labels, update, events=None):
    """One ``record -> backward -> update`` step; returns the mean loss
    (a device tensor). ``events`` (4 CUDA events) mark forward, backward
    and update."""
    from mxnet_tpu_torch import autograd
    vocab = model.head.weight.shape[0]
    if events:
        events[0].record()
    with autograd.record():
        loss = loss_fn(model(tokens).reshape(-1, vocab), labels.reshape(-1))
        scaled = loss * LOSS_SCALE
    if events:
        events[1].record()
    autograd.backward(scaled)
    if events:
        events[2].record()
    update()
    if events:
        events[3].record()
    return loss.detach().float().mean()


def phase_train(card):
    """BERT-base in fp16 trained through the Gluon entry points, then two
    steps of a reference run (dense attention, plain update) from the same
    weights, batch and dropout generators."""
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES, LAUNCHES_DKV,
                                                     LAUNCHES_DQ,
                                                     flash_attention_ref)
    from mxnet_tpu_torch.opt import kernels as opt_kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = _seeded_bert_fp16()
    params = collect_params(model)
    layers, vocab = len(model.layers), model.head.weight.shape[0]
    trainer = Trainer(params, "sgd", {"learning_rate": TRAIN_LR,
                                      "momentum": TRAIN_MOMENTUM,
                                      "multi_precision": True})
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, vocab, (TRAIN_B, TRAIN_T))
                              ).cuda()
    labels = torch.from_numpy(rng.integers(0, vocab, (TRAIN_B, TRAIN_T))
                              ).cuda()
    batch = TRAIN_B * TRAIN_T
    log(f"[train] BERTModel(dtype=float16): {len(params)} parameters "
        f"({sum(p.numel() for p in params.values())} values), {layers} "
        f"layers; batch {TRAIN_B} x {TRAIN_T}; SGD lr {TRAIN_LR} momentum "
        f"{TRAIN_MOMENTUM} multi_precision; loss scale {LOSS_SCALE}; built "
        f"in {time.perf_counter() - t0:.2f} s")

    counters = {"flash_fwd": LAUNCHES, "flash_bwd_dq": LAUNCHES_DQ,
                "flash_bwd_dkv": LAUNCHES_DKV, "mp_sgd": opt_kernels.LAUNCHES}
    want = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "mp_sgd": len(params)}
    totals = dict.fromkeys(counters, 0)
    missing = []

    def update():
        missing.extend(n for n, p in params.items()
                       if p.requires_grad and p.grad is None)
        trainer.step(batch * LOSS_SCALE)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, parts, masters = [], [], [], None
    for step in range(TRAIN_STEPS):
        for c in counters.values():
            c.reset()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        loss = _train_step(model, loss_fn, tokens, labels, update, events)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        parts.append([events[i].elapsed_time(events[i + 1])
                      for i in range(3)])
        losses.append(loss.item())
        counts = {n: c.count for n, c in counters.items()}
        for n in counts:
            totals[n] += counts[n]
        log(f"[train] step {step}: loss {losses[-1]:.6f}, wall "
            f"{walls[-1]:.2f} ms, forward/backward/optimizer "
            f"{[round(x, 3) for x in parts[-1]]} ms, launches {counts}")
        if counts != want:
            raise SystemExit(f"chip_smoke: launches per step {counts}, "
                             f"expected {want}")
        if missing:
            raise SystemExit(f"chip_smoke: no gradient for {missing[:8]}")
        if step == REF_STEPS - 1:
            masters = [trainer._updaters[0].states[i][0].clone()
                       for i in range(len(params))]
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: loss not finite and falling: {losses}")

    # reference run: dense attention, plain update, same start
    ref = _seeded_bert_fp16()
    for layer in ref.layers:
        layer.attn.attention = flash_attention_ref
    ref_params = list(collect_params(ref).values())
    ref_state = [(p.detach().float(), torch.zeros_like(p, dtype=torch.float32))
                 for p in ref_params]
    init = [w32.clone() for w32, _ in ref_state]

    def ref_update():
        with torch.no_grad():
            for p, (w32, mom) in zip(ref_params, ref_state):
                new = opt_kernels.mp_sgd_mom_update_ref(
                    p, p.grad, mom, w32, lr=TRAIN_LR, momentum=TRAIN_MOMENTUM,
                    rescale_grad=1 / (batch * LOSS_SCALE))
                for dst, src_ in zip((p, mom, w32), new):
                    dst.copy_(src_)
                p.grad = None

    ref_losses = [_train_step(ref, loss_fn, tokens, labels, ref_update).item()
                  for _ in range(REF_STEPS)]
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
    diff2 = upd2 = 0.0
    worst = (0.0, "")
    for name, got, (w32, _), w0 in zip(params, masters, ref_state, init):
        d = (got - w32).norm().item()
        u = (w32 - w0).norm().item()
        diff2, upd2 = diff2 + d * d, upd2 + u * u
        if u > 0 and d / u > worst[0]:
            worst = (d / u, name)
    upd_err = (diff2 / upd2) ** 0.5
    log(f"[train] reference run (dense attention, plain update): losses "
        f"{ref_losses}; max loss diff {loss_err:.3e} (limit "
        f"{TRAIN_LOSS_TOL}); master-weight update rel. L2 diff {upd_err:.3e} "
        f"(limit {TRAIN_UPD_TOL}), worst parameter {worst[1]} "
        f"{worst[0]:.3e} (limit {TRAIN_UPD_TOL_EACH})")
    if (loss_err > TRAIN_LOSS_TOL or upd_err > TRAIN_UPD_TOL
            or worst[0] > TRAIN_UPD_TOL_EACH):
        raise SystemExit("chip_smoke: training disagrees with the reference "
                         "run")
    del ref, ref_params, ref_state, init

    # breakdown: medians over the steps after the first
    steady = range(1, TRAIN_STEPS)
    wall_ms = float(np.median([walls[i] for i in steady]))
    fwd_ms, bwd_ms, opt_ms = (float(np.median([parts[i][j] for i in steady]))
                              for j in range(3))
    kernel_ms, ours, top = profiled_step(lambda: _train_step(
        model, loss_fn, tokens, labels, update))
    summary = {
        "card": card, "batch": [TRAIN_B, TRAIN_T], "steps": TRAIN_STEPS,
        "losses": losses, "ref_losses": ref_losses,
        "step_wall_ms_median": wall_ms, "step_wall_ms": walls,
        "step_event_ms_median": fwd_ms + bwd_ms + opt_ms,
        "tokens_per_s": batch / (wall_ms / 1e3),
        "forward_ms": fwd_ms, "backward_ms": bwd_ms, "optimizer_ms": opt_ms,
        "profiled_kernel_ms": kernel_ms,
        "device_busy_share": kernel_ms / wall_ms,
        "top_kernels_ms": top,
        "kernel_ms_in_step": ours,
        "b2_share_of_forward": ours["flash_fwd"] / fwd_ms,
        "b3_b4_share_of_backward":
            (ours["flash_bwd_dq"] + ours["flash_bwd_dkv"]) / bwd_ms,
        "b1_share_of_optimizer": ours["mp_sgd"] / opt_ms,
        "peak_memory_bytes": peak, "launches": totals,
        "loss_max_abs_diff_vs_ref": loss_err,
        "master_update_rel_l2_diff_vs_ref": upd_err,
        "worst_parameter_rel_diff": list(worst)}
    log("[train] " + json.dumps(summary))
    return totals


KERNEL_NAMES = {"flash_fwd": "flash_fwd_kernel",
                "flash_bwd_dq": "flash_bwd_dq_kernel",
                "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                "mp_sgd": "mp_sgd_mom_kernel"}


def profiled_step(step):
    """Device time of the kernels of one more step, from ``torch.profiler``
    (``key_averages``, device-side kernel events only): the total, each of
    the port's kernels summed over its launches, and the eight kernels
    that take most of it as [name, ms, calls]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append([e.key, us / 1e3, e.count])
    rows.sort(key=lambda r: -r[1])
    ours = {name: sum(r[1] for r in rows if sym in r[0])
            for name, sym in KERNEL_NAMES.items()}
    return (sum(r[1] for r in rows), ours,
            [[r[0][:80], r[1], r[2]] for r in rows[:8]])


def top_rung_breakdown(engine, ladder, top_seq):
    """Where one full dispatch at the top rung goes: the host wall time of
    ``predict`` (staging, copies, forward, unpadding) against the device
    time of the model's forward and the host time of copying its logits
    back. Runs after the served load, so its launches are not counted."""
    b = ladder.max_batch
    tokens_np = np.ones((b, top_seq), np.int32)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.predict(tokens_np)
        walls.append((time.perf_counter() - t0) * 1e3)
    tokens = torch.from_numpy(tokens_np).cuda()
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: engine.model(tokens), iters=5, warm=1)
        logits = engine.model(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            logits.cpu()
        d2h_ms = (time.perf_counter() - t0) * 1e3 / 3
    return {"rung": [b, top_seq], "predict_wall_ms": sorted(walls)[1],
            "forward_device_ms": forward_ms, "logits_to_host_ms": d2h_ms,
            "logits_bytes": logits.numel() * logits.element_size()}


def main():
    card, name, peaks = phase_device()
    phase_build()
    rows = phase_kernel_check(peaks)
    bwd_rows = phase_backward_check(peaks)
    sgd_rows = phase_sgd_check(peaks)
    serve_launches = phase_slice(card)
    train_launches = phase_train(card)

    def pick(table, **want):
        return next(r for r in table if "ms" in r
                    and all(r[k] == v for k, v in want.items()))

    fwd32 = pick(rows, shape=[8, HEADS, 512, 512, HEAD_DIM],
                 dtype="float32", causal=False)
    fwd16 = pick(rows, shape=[8, HEADS, 512, 512, HEAD_DIM],
                 dtype="float16", causal=False)
    bwd16 = pick(bwd_rows, dtype="float16", causal=False)
    sgd = pick(sgd_rows, n=max(SGD_SIZES))
    bwd_err = max(max(r["max_abs_err"].values()) for r in bwd_rows
                  if r["dtype"] == "float32")
    common = {"card": card}
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:126",
        "launches": serve_launches + train_launches["flash_fwd"],
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches["flash_fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "ms": fwd32["ms"], "plain_ms": fwd32["plain_ms"],
        "bound_ms": fwd32["bound_ms"], "bound_by": fwd32["bound_by"],
        "library_ms": fwd32["library_ms"],
        "shape": fwd32["shape"], "dtype": "float32",
        "float16": {k: fwd16[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
        **common}]
    for which, line in (("dq", "pallas_kernels.py:257"),
                        ("dkv", "pallas_kernels.py:277")):
        kernels.append({
            "name": f"flash_bwd_{which}", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"mxnet_tpu/ops/{line}",
            "launches": train_launches[f"flash_bwd_{which}"],
            "max_abs_err": bwd_err,
            "ms": bwd16[f"{which}_ms"],
            "plain_ms": bwd16["plain_ms"],
            "bound_ms": bwd16[f"{which}_bound_ms"],
            "bound_by": bwd16[f"{which}_bound_by"],
            "library_ms": bwd16["library_ms"],
            "plain_and_library_cover": "flash_bwd_dq + flash_bwd_dkv",
            "shape": bwd16["shape"], "dtype": "float16", **common})
    kernels.append({
        "name": "mp_sgd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/mp_sgd.cu",
        "replaces": "mxnet_tpu/opt/kernels.py:93",
        "launches": train_launches["mp_sgd"],
        "max_abs_err": max(r["max_abs_err"] for r in sgd_rows),
        "ms": sgd["ms"], "plain_ms": sgd["plain_ms"],
        "bound_ms": sgd["bound_ms"], "bound_by": sgd["bound_by"],
        "library_ms": None,
        "library_none_because": "no single PyTorch call computes the "
                                "update and the cast together",
        "shape": [sgd["n"]], "dtype": "float16/float32", **common})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
