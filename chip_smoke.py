#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``mxnet_tpu_torch`` (and nothing of JAX or ``mxnet_tpu``) end to
end, failing on the first phase that fails:

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device is a failure;
2. build — every kernel under ``mxnet_tpu_torch/csrc/`` with ``nvcc``;
3. kernel check — the flash-attention forward against its plain version
   on the card, at the serving path's shapes and edge cases, in fp32 and
   bf16, timed beside its plain version, ``scaled_dot_product_attention``
   (a yardstick only) and its bound on this card;
4. slice — BERT-base (full width, fp32, random weights from a seed)
   served by ``ServingEngine``: warmup over the ladder, closed-loop load,
   zero new signatures after warmup, 12 kernel launches per dispatch, and
   one request's logits against the same model with dense attention.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
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
LADDER = "batch:1,2,4,8;seq:128,256,512"
N_REQUESTS, CONCURRENCY = 24, 4
HEADS, HEAD_DIM = 12, 64

# Published dense peaks (NVIDIA data sheets): fp32 without tensor cores,
# bf16 on tensor cores, device-memory bytes/s. Matched on the card's name.
PEAKS = (
    ("H100 PCIe", {"float32": 51.2e12, "bfloat16": 756e12, "bytes": 2.0e12}),
    ("H100 NVL", {"float32": 60e12, "bfloat16": 835e12, "bytes": 3.9e12}),
    ("H100", {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12}),
)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warm=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    pairs = sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk
    flops = 4.0 * B * H * D * pairs
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
        for dtype in ((torch.float32, torch.bfloat16) if is_timed
                      else (torch.float32,)):
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
    launches = phase_slice(card)
    main_row = next(r for r in rows if r["shape"] == [8, HEADS, 512, 512,
                                                      HEAD_DIM]
                    and r["dtype"] == "float32" and not r["causal"])
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:126",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "dtype": "float32", "card": card}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
