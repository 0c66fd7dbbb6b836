#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``mxnet_tpu_torch`` (and nothing of JAX or ``mxnet_tpu``) end to
end, failing on the first phase that fails:

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device is a failure;
2. build — every kernel under ``mxnet_tpu_torch/csrc/`` with ``nvcc``;
3. kernel check — the flash-attention forward against its plain version
   on the card on its three routes (fp16/bf16 on the tensor-core kernel,
   fp32 with D % 8 == 0 on the fp32 tensor-core kernels over bf16 planes,
   ``flash_fwd_tc32.cu`` for D <= 64 and ``flash_fwd_tc32_d128.cu`` for
   D = 72-128; odd head dims on the CUDA-core one), at the serving and
   training paths' shapes and edge cases, timed beside the CUDA-core
   kernel on the same inputs, its plain version,
   ``scaled_dot_product_attention`` (a yardstick only) and its bound (fp32
   also at D = 96 and 128 and at the GPT path's shape); every fp32
   tensor-core case also against an fp64 evaluation of the plain forward
   beside the CUDA-core kernel;
4. backward check — the dQ and dK/dV passes against the plain backward
   on their three routes (fp16/bf16 on the tensor cores; fp32 with
   D % 8 == 0 on the tensor cores over bf16 planes, ``flash_bwd_tc32.cu``
   for D <= 64 and ``flash_bwd_tc32_d128.cu`` for D = 72-128; odd head
   dims on the CUDA cores), timed beside the CUDA-core kernels on the same
   inputs, the plain backward, the backward of
   ``scaled_dot_product_attention`` and their bounds (fp32 also at D = 96
   and 128 and at the GPT path's shape); every fp32 tensor-core case also
   against an fp64 evaluation of the plain backward beside the CUDA-core
   kernels; and the fp32 routes' split kernel against its plain version,
   bit for bit;
   then the inputs of two repaired faults: q, k, v in the strided layout a
   (B, T, H, D) projection gives, through the forward and backward, bit
   for bit against contiguous copies; and a model whose head dim (256) no
   kernel takes, which picks dense attention by shape and launches none;
5. optimizer check — the mixed-precision SGD kernel against its plain
   version at the sizes of BERT-base's parameters, bit for bit;
6. serving slice — BERT-base (full width, fp32, random weights from a
   seed) served by ``ServingEngine``: warmup over the ladder, closed-loop
   load, zero new signatures after warmup, 12 forward launches per
   dispatch (all on the fp32 tensor-core route, after 12 splits), and one
   request's logits against the same model with dense attention;
7. training slice — BERT-base (full width and depth, fp16 weights,
   dropout 0.1) trained through ``autograd.record`` -> ``backward`` ->
   ``Trainer.step`` with multi-precision SGD and a static loss scale:
   12/12/12/150 launches per step (all 12 forward, dQ and dK/dV launches
   on the tensor-core route), every parameter with a gradient, a
   finite and falling loss, and two steps against a reference run with
   dense attention and the plain update; step time, tokens/s, peak memory
   and a per-step breakdown;
8. fp32 training slice — the same model in fp32 (the dtype ``BERTModel``
   takes by default), plain SGD with momentum and no loss scale: 12/12/12
   launches per step, every forward, dQ and dK/dV launch on the fp32
   tensor-core route (24 split launches: one per forward, one per
   backward) and no mixed-precision update, then two steps against a
   reference run with dense attention, and the same breakdown;
9. GPT training slice — a causal ``TransformerLM`` at Cerebras-GPT-1.3B's
   published widths (24 layers, 2048 units, 16 heads of 128, FFN 8192,
   vocab 50257, 2048 positions; random weights from a seed) trained in
   fp32 on 2 x 2048 tokens with plain SGD and momentum: one warm step and
   four more, 24/24/24 launches per step (every forward launch on
   ``flash_fwd_tc32_d128.cu`` and every dQ and dK/dV launch on
   ``flash_bwd_tc32_d128.cu``, after 48 splits: one per forward and one
   per backward), then two steps against a reference run with dense
   attention (the kernel run freed first), and the same breakdown;
10. ResNet check — ``resnet50_v1`` (the Gluon model zoo's, 1000 classes,
    full width and depth), two SGD steps at batch 4 on the card and from
    the same weights and batch on the CPU, in fp32 (TF32 off) and fp64:
    losses, the update, the running statistics after each step and
    predict-mode logits; in fp64 the two agree to 1e-9, in fp32 each is
    held to the fp64 run and the card's error may be at most 3x the
    CPU's;
11. ResNet training slice — ``resnet50_v1`` initialised with Xavier
    (Gaussian, fan in, magnitude 2) and cast to fp16 (BatchNorm fp32),
    trained on 256 synthetic 224 x 224 images through ``autograd.record``
    -> ``backward`` -> ``Trainer.step`` with multi-precision SGD under a
    ``MultiFactorScheduler`` with warmup and a static loss scale: one warm
    step and eight more, 87 B1 launches per step (one per fp16
    parameter, none for BatchNorm), every gradient finite, the loss
    falling, the running statistics moved and fp32, two steps against a
    reference run with B1's plain version; images/s, the step's windows,
    device busy share and top kernels, B1's time, peak memory and the
    share of the fp16 tensor-core peak.

The script prints its own wall time. The last three lines are the card
(``nvidia-smi``), ``{"kernels": [...]}`` and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
FP32_TOL = 1e-4   # max abs, unit-scale inputs: only the summation order differs
# forward kernels vs the fp32 plain forward on the same rounded inputs, max
# abs: fp32 summation order only (the bf16x6 products drop terms below
# 2^-26 of each product). fp16/bf16: the output's own
# rounding, u*|out| <= u*max|v| (u = 2^-11 fp16, 2^-8 bf16; out is a convex
# combination of v's rows), and on the tensor-core route the rounding of p
# to the input type as the A operand of O += P.V: at most
# u * sum_c p_c|v_c| / l <= u*max|v| per element, where p at the row's
# maximum rounds to exactly 1 (its exponent is a rounding residual), so the
# sum runs over the other keys. At
# unit-scale inputs (max|v| ~ 5.4 over the card's 8 x 12 x 512 x 64) the two
# together reach 1.9e-3 (fp16) and 1.5e-2 (bf16), on the first causal rows
# (tests/test_torch_flash_forward_tc.py::test_limit_covers_the_rounding);
# the CUDA-core route, with no rounding of p, stays inside the same limits.
FWD_TOL = {"float32": FP32_TOL, "float16": 5e-3, "bfloat16": 2e-2}
SLICE_RTOL = SLICE_ATOL = 1e-3  # 12 fp32 layers over a reordered softmax sum
# backward kernels vs the fp32 plain backward on the same rounded inputs,
# elementwise |err| <= atol + rtol*|ref|: fp32 max abs 1e-4 (summation
# order only); fp16/bf16 rtol four half-ulps of the output type, atol for
# sums that cancel. The tensor-core route (fp16/bf16) also rounds p and ds
# to the input type as operands of dV = p^T.dO, dK = s*ds^T.q, dQ = s*ds.k:
# that adds at most u*sum|terms| to an element (u = 2^-11 in fp16). At
# unit-scale causal inputs sum|terms| reaches ~12 at T = 512 (dV of the
# first keys, which every row sees: sum_q p ~ ln T; |ds| up to ~10 on the
# first rows), so fp16's atol rises from 1e-3 (breached on the card) to
# 8e-3 >= 2^-11 * 16 (tests/test_torch_flash_backward.py::
# test_fp16_atol_covers_the_operand_rounding). bf16 (u = 2^-8) was not
# breached and keeps its limits: its rounding errors, of random sign, stay
# inside them.
BWD_TOL = {"float32": (1e-4, 0.0), "float16": (8e-3, 2e-3),
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
# fp32 training: the same model and batch in fp32, plain SGD with momentum
# (the same update in both runs), no loss scale. Both runs share every fp32
# product (no TF32) and dropout mask; only attention differs, the kernels
# against dense attention, both fp32-grade (within 1e-4 max abs at unit
# scale, a few 1e-6 seen), so two steps move the ~10.4 loss and the update
# by fp32 roundings (~1e-6 relative). The limits are a tenth of the fp16
# phase's: 1e-3 on the loss, 2e-3 / 1e-2 relative L2 on the update (over
# the model / for each parameter).
TRAIN32_STEPS = 4
TRAIN32_LOSS_TOL, TRAIN32_UPD_TOL, TRAIN32_UPD_TOL_EACH = 1e-3, 2e-3, 1e-2
# the GPT path: Cerebras-GPT-1.3B's published widths (Dey et al. 2023,
# arXiv:2304.03208, Table 1): 24 layers, d_model 2048, 16 heads (D = 128),
# FFN 8192, vocab 50257, context 2048; causal, dropout 0, trained in fp32
# with the fp32 phase's SGD and limits on 2 x 2048 tokens, one warm step
# and GPT_STEPS - 1 more
GPT = dict(vocab_size=50257, units=2048, num_layers=24, num_heads=16,
           hidden_size=8192, max_len=2048)
GPT_B, GPT_T, GPT_STEPS = 2, 2048, 5
# the fp32 tensor-core forward's and backward's max abs error against an
# fp64 evaluation of the plain version, over the CUDA-core kernels' on the
# same inputs, for D > 64 (flash_fwd_tc32_d128.cu, flash_bwd_tc32_d128.cu).
# Against the fp32 plain version the ratio is not a measure of accuracy:
# cuBLAS and the CUDA-core kernels sum in the same order, so their roundings
# agree (logged as err_over_cc)
ERR_OVER_CC = 2.0
# B1 at BERT-base's parameter sizes and an odd one; 2,359,296 is also the
# largest ResNet-50 tensor (a 3x3 convolution of 512 -> 512 channels)
SGD_SIZES = (23_440_896, 2_359_296, 768, 1_000_003)
# the ResNet path: resnet50_v1 (the Gluon model zoo's, He et al. 2015,
# arXiv:1512.03385, Table 1: 25,629,032 values in 299 parameters, with
# the zoo's biases on BottleneckV1's 1x1 convolutions), 1000 classes,
# 224 x 224 images; SGD as bench.py's ResNet step (momentum 0.9) with the
# image-classification recipe's weight decay
RESNET_SIZE, RESNET_CLASSES = 224, 1000
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.1, 0.9, 1e-4
# [resnet_check]: two SGD steps at batch 4 on the card and on the CPU from
# the same weights and batch, in fp32 (TF32 off) and in fp64. The fp32
# gradient of this model is ill-conditioned: the gradient that reaches a
# convolution through the BatchNorm after it is a small residual of its
# upstream gradient (the normalisation projects out the mean and the
# normalised direction), so fp32's roundings (6e-8) leave the gradient a
# few percent from its fp64 value, on the CPU and on the card alike and
# in every parameter, and card and CPU cannot agree to fp32's own
# precision. So each device's fp32 run is held to an fp64 run of the same
# port code on the CPU: the card's error (losses, update, running
# statistics after each step, predict-mode logits) at most
# RESNET32_ERR_RATIO times the CPU's, i.e. fp32-grade, as ERR_OVER_CC
# holds the attention kernels. 3: cuDNN's fp32 algorithms split and order
# their sums otherwise than the CPU's, and the second step carries the
# first's error, random in sign, forward. In fp64 the card and the CPU
# compute the same function: every quantity, each parameter's update too
# (the 32 convolution biases a BatchNorm follows left out: their exact
# gradient is zero and each run's update of them is rounding noise),
# within RESNET64_TOL = 1e-9 relative: fp64's roundings (1.1e-16) grown by
# the same conditioning (fp32's 6e-8 grows to a few 1e-2, ~1e6x), with
# 100x to spare.
# The rate is 1e-3, not the main phase's 0.1: at batch 4 the fresh model's
# first update at 0.1 moves the classifier by many times its own scale
# (the loss falls from ~8.7 to ~1.4), which makes the second step a
# measure of the dynamics, not of the port
RESNET_CHECK_B, RESNET_CHECK_STEPS, RESNET_CHECK_LR = 4, 2, 1e-3
RESNET32_ERR_RATIO, RESNET64_TOL = 3.0, 1e-9
# [train_resnet50]: fp16 weights and images, BatchNorm fp32, the published
# batch of 256; one warm step and eight more; 87 fp16 parameters (53
# convolution weights, 32 convolution biases, the classifier's 2), each
# one B1 launch per step. The loss is each sample's summed by backward
# (rescale_grad 1 / (256 * scale)). The static scale is 64: at 128 the
# largest |gradient| of a run reached 41,920, 64% of fp16's 65,504
# (NVIDIA H100 80GB HBM3, 700 W, a debugging run of this phase); every
# step's largest is checked finite and reported
RESNET_B, RESNET_STEPS, RESNET_LOSS_SCALE = 256, 9, 64.0
RESNET_FP16_PARAMS = 87
LADDER = "batch:1,2,4,8;seq:128,256,512"
N_REQUESTS, CONCURRENCY = 24, 4
HEADS, HEAD_DIM = 12, 64

# Published dense peaks (NVIDIA data sheets): fp32 without tensor cores
# (FFMA), bf16 on tensor cores, device-memory bytes/s. Matched on the card's
# name. "float32_tc" is the fastest fp32-grade product the card offers: the
# bf16 tensor cores on three bf16 planes of each fp32 operand, six plane
# products per product (csrc/flash_bwd_tc32.cu), i.e. the 16-bit peak / 6,
# 2.5x the FFMA peak (csrc/flash_fwd_tc32.cu computes the same way). An fp32
# bound is of the work, not of the design, so it takes the larger of the two
# rates (ffma_bound_ms keeps the FFMA one).
PEAKS = (
    ("H100 PCIe", {"float32": 51.2e12, "bfloat16": 756e12, "float16": 756e12,
                   "float32_tc": 756e12 / 6, "bytes": 2.0e12}),
    ("H100 NVL", {"float32": 60e12, "bfloat16": 835e12, "float16": 835e12,
                  "float32_tc": 835e12 / 6, "bytes": 3.9e12}),
    ("H100", {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "float32_tc": 989e12 / 6, "bytes": 3.35e12}),
)


def op_peak(dtype, peaks, ffma=False):
    """FLOP/s of the fastest products of ``dtype`` the card offers: for
    fp32 the larger of the FFMA peak and ``float32_tc`` (only the FFMA
    peak if ``ffma``)."""
    name = str(dtype).replace("torch.", "")
    if name == "float32" and not ffma:
        return max(peaks["float32"], peaks["float32_tc"])
    return peaks[name]


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


def _kernel_symbol(line):
    """The kernel's name in a mangled symbol (its length-prefixed
    identifier ending in ``_kernel``) and the 24 characters after it (the
    template arguments, cut short)."""
    m = re.search(r"_kernel\w{0,24}", line)
    if m is None:
        return line
    for n in range(len("_kernel") + 1, m.start() + len("_kernel")):
        start = m.start() + len("_kernel") - n
        if line[:start].endswith(str(n)):
            return line[start:m.end()]
    return m.group()


def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    for name, rep in report.items():
        # per entry function: registers, spills, static shared memory
        regs = [_kernel_symbol(ln) if "entry function" in ln
                else ln.split(":", 1)[-1].strip()
                for ln in rep["log"].splitlines()
                if "entry function" in ln or "registers" in ln
                or "spill" in ln]
        log(f"[build] {name}: {rep['seconds']:.2f} s; ptxas: {regs}")
    lib = _build.load("flash_bwd_tc32")
    lib.mx_flash_bwd_tc32_smem_bytes.restype = ctypes.c_longlong
    log(f"[build] flash_bwd_tc32: each pass asks for "
        f"{lib.mx_flash_bwd_tc32_smem_bytes()} B of dynamic shared memory")
    lib = _build.load("flash_bwd_tc32_d128")
    lib.mx_flash_bwd_tc32_d128_smem_bytes.restype = ctypes.c_longlong
    log(f"[build] flash_bwd_tc32_d128: each pass asks for "
        f"{lib.mx_flash_bwd_tc32_d128_smem_bytes()} B of dynamic shared "
        f"memory")
    for name in ("flash_fwd_tc32", "flash_fwd_tc32_d128"):
        fn = getattr(_build.load(name), f"mx_{name}_smem_bytes")
        fn.restype = ctypes.c_longlong
        log(f"[build] {name}: the kernel asks for {fn()} B of dynamic "
            f"shared memory")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.2f} s")


def attention_bound(B, H, Tq, Tk, D, causal, dtype, peaks, ffma=False):
    """Least time the card needs for the function: flops over the peak for
    the dtype (:func:`op_peak`) vs bytes (q, k, v read once; out, lse
    written once) over the memory rate. Causal counts only the (q, k) pairs
    the mask keeps."""
    flops = 4.0 * B * H * D * _pairs(Tq, Tk, causal)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * H * Tq * D + 2 * B * H * Tk * D) * itemsize \
        + 4 * B * H * Tq
    t_ops = flops / op_peak(dtype, peaks, ffma)
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fwd_tc32_one_wg(q, k, v, out, lse, causal, scale, planes):
    """The fp32 tensor-core forward for D <= 64 with one consumer warpgroup
    per block (``mx_flash_fwd_tc32_one_wg``, ``csrc/flash_fwd_tc32.cu``):
    no route of the port takes it; it is timed beside the route's two
    warpgroups to measure what the second one buys."""
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops.flash_attention import _FWD_TC32_ARGS, _fn
    lib = _build.load("flash_fwd_tc32")
    fn = _fn(lib, "mx_flash_fwd_tc32_one_wg", _FWD_TC32_ARGS)
    B, H, Tq, D = q.shape
    nq, nk, at = q.numel(), k.numel(), planes.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(at, at + 2 * nq, at + 2 * (nq + nk), planes.shape[1],
             out.data_ptr(), lse.data_ptr(), B * H, Tq, k.shape[2], D,
             float(scale), int(causal), stream)
    _build.check(lib, err, "flash_fwd_tc32_one_wg launch")


def phase_kernel_check(peaks):
    """B2 against its plain version, launched once per case on the route
    ``_fwd_route`` picks: fp32 (tensor cores on bf16 planes, after one
    split launch: ``flash_fwd_tc32.cu`` up to D = 64,
    ``flash_fwd_tc32_d128.cu`` above) at the serving path's rungs and the
    edge cases (ragged T, D = 96, Tq != Tk); bf16 (tensor cores) at the
    same timed shapes; fp16 (tensor cores) at the training rung and the
    edge cases; fp16 with D = 36 (CUDA cores); fp32 with D = 72 and 80 at
    ragged T, D = 128 with Tq != Tk and with a block's second q tile
    wholly past Tq, D = 128 at the training rung's B, H, T and, causal, at
    the GPT path's shape (all on ``flash_fwd_tc32_d128.cu``); fp32 with
    D = 33 and 100 (CUDA cores). Timed cases are timed beside the plain
    version, SDPA and the bound, and the tensor-core ones also on the
    CUDA-core kernel on the same inputs; the fp32 tensor-core ones also
    time the split and the kernel alone. Every fp32 case on the tensor
    cores also runs the CUDA-core kernel on the same inputs and logs both
    kernels' errors against the fp32 plain version and against an fp64
    evaluation of it: the CUDA-core kernel's against fp32 must hold the
    same limits as the route's, the route's error against fp32 must stay within 4x
    of the CUDA-core kernel's (``err_over_cc``) in timed cases and for
    D > 64, and for D > 64 its error against fp64 within ``ERR_OVER_CC``
    of the CUDA-core kernel's. Every case is run and logged before a
    disagreement fails the phase."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_SPLIT, LAUNCHES_TC, LAUNCHES_TC32, _fwd_pass,
        _fwd_route, flash_attention_fwd, flash_attention_ref_fwd,
        split_bf16x3)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # (B, H, Tq, Tk, D): the serving path's rungs at the top batch, the
    # edge cases (ragged T, head_dim 96, Tq != Tk), then every other
    # (batch, seq) rung the BERT-base path launches the kernel at
    rung = (8, HEADS, 512, 512, HEAD_DIM)
    edges = [(8, HEADS, 200, 200, HEAD_DIM), (8, HEADS, 384, 384, 96),
             (8, HEADS, 128, 384, HEAD_DIM)]
    timed = [(8, HEADS, t, t, HEAD_DIM) for t in (128, 256, 384, 512)] + edges
    cases = [(s_, dt, c) for s_ in timed
             for dt in (torch.float32, torch.bfloat16)
             + ((torch.float16,) if s_ == rung or s_ in edges else ())
             for c in (False, True)]
    cases += [((b, HEADS, t, t, HEAD_DIM), torch.float32, False)
              for b in (1, 2, 4) for t in (128, 256, 512)]
    cases += [((8, HEADS, 256, 256, 36), torch.float16, c)
              for c in (False, True)]
    # fp32 with D = 72-128 (flash_fwd_tc32_d128.cu): ragged T, Tq != Tk,
    # the training rung's B, H, T and the GPT path's shape
    cases += [((8, HEADS, 200, 200, d), torch.float32, c) for d in (72, 80)
              for c in (False, True)]
    cases += [((8, HEADS, 128, 384, 128), torch.float32, c)
              for c in (False, True)]
    # a block whose second q tile lies wholly past Tq (300 = 2 * 128 + 44)
    cases += [((8, HEADS, 300, 100, 128), torch.float32, c)
              for c in (False, True)]
    # fp32 with D % 8 != 0 (flash_fwd.cu, the CUDA cores)
    cases += [((8, HEADS, 200, 200, d), torch.float32, c) for d in (33, 100)
              for c in (False, True)]
    wide = [(8, HEADS, 512, 512, 128), (GPT_B, GPT["num_heads"], GPT_T,
                                        GPT_T, 128)]
    cases += [(s_, torch.float32, c) for s_ in wide for c in (False, True)
              if c or s_ == wide[0]]
    timed += wide
    counters = (LAUNCHES, LAUNCHES_TC, LAUNCHES_TC32, LAUNCHES_SPLIT)
    rows, bad = [], []
    for shape, dtype, causal in cases:
        B, H, Tq, Tk, D = shape
        q, k, v = (torch.randn(B, H, T, D, device="cuda",
                               generator=gen).to(dtype)
                   for T in (Tq, Tk, Tk))
        route = _fwd_route(dtype, D, True)  # torch's allocations are aligned
        before = [c.count for c in counters]
        out, lse = flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        launches = [c.count - b for c, b in zip(counters, before)]
        ref, ref_lse = flash_attention_ref_fwd(
            q.float(), k.float(), v.float(), causal)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        name = str(dtype).replace("torch.", "")
        tol = FWD_TOL[name]
        ok = (err <= tol and lse_err <= FP32_TOL
              and launches == [1, int(route == "tc")]
              + [int(route == "tc32")] * 2
              and bool(torch.isfinite(out).all()))
        row = {"shape": list(shape), "dtype": name, "causal": causal,
               "route": route, "launches": launches[0],
               "launches_tc": launches[1], "launches_tc32": launches[2],
               "launches_split": launches[3], "max_abs_err": err,
               "lse_max_abs_err": lse_err, "tol": tol}
        s = 1 / D ** 0.5
        o2, l2 = torch.empty_like(out), torch.empty_like(lse)
        if route == "tc32":  # the CUDA-core kernel's error on the same inputs
            _fwd_pass("cc", q, k, v, o2, l2, causal, s)
            row["cc_max_abs_err"] = (o2 - ref).abs().max().item()
            row["cc_lse_max_abs_err"] = (l2 - ref_lse).abs().max().item()
            row["err_over_cc"] = max(
                err / max(row["cc_max_abs_err"], 1e-30),
                lse_err / max(row["cc_lse_max_abs_err"], 1e-30))
            # both kernels against the plain forward evaluated in fp64
            exact = fwd_fp64(q, k, v, causal)
            for key, got in (("fp64_max_abs_err", (out, lse)),
                             ("cc_fp64_max_abs_err", (o2, l2)),
                             ("plain_fp64_max_abs_err", (ref, ref_lse))):
                row[key] = {n: (g.double() - r).abs().max().item()
                            for n, g, r in zip(("out", "lse"), got, exact)}
            del exact
            row["err_over_cc_fp64"] = max(
                row["fp64_max_abs_err"][n]
                / max(row["cc_fp64_max_abs_err"][n], 1e-30)
                for n in ("out", "lse"))
            # the CUDA-core kernel stays a route (odd D, unaligned
            # tensors) and the yardstick of the ratios: it holds the
            # same limits
            ok = (ok and row["cc_max_abs_err"] <= tol
                  and row["cc_lse_max_abs_err"] <= FP32_TOL)
            if D > 64:
                ok = (ok and row["err_over_cc"] <= 4
                      and row["err_over_cc_fp64"] <= ERR_OVER_CC)
        if shape in timed:
            bound_ms, bound_by = attention_bound(
                B, H, Tq, Tk, D, causal, dtype, peaks)
            if dtype == torch.float32:
                row["ffma_bound_ms"] = attention_bound(
                    B, H, Tq, Tk, D, causal, dtype, peaks, ffma=True)[0]
            if route != "cc":  # the CUDA-core kernel on the same inputs
                row["cc_ms"] = cuda_ms(lambda: _fwd_pass(
                    "cc", q, k, v, o2, l2, causal, s))
            if route == "tc32":  # the split and the kernel alone
                planes = split_bf16x3(q, k, v)
                row.update(
                    split_ms=cuda_ms(lambda: split_bf16x3(q, k, v)),
                    # 4 bytes read and 6 written per element of q, k, v
                    split_bound_ms=10 * sum(t.numel() for t in (q, k, v))
                    / peaks["bytes"] * 1e3,
                    kernel_ms=cuda_ms(lambda: _fwd_pass(
                        "tc32", q, k, v, o2, l2, causal, s, planes)))
                ok = ok and row["err_over_cc"] <= 4
            if route == "tc32" and D <= 64:  # one warpgroup per block
                fwd_tc32_one_wg(q, k, v, o2, l2, causal, s, planes)
                row["one_wg_max_abs_err"] = max(
                    (o2 - ref).abs().max().item(),
                    (l2 - ref_lse).abs().max().item())
                row["one_wg_ms"] = cuda_ms(lambda: fwd_tc32_one_wg(
                    q, k, v, o2, l2, causal, s, planes))
                ok = ok and row["one_wg_max_abs_err"] <= FP32_TOL
            row.update(
                ms=cuda_ms(lambda: flash_attention_fwd(q, k, v, causal)),
                plain_ms=cuda_ms(lambda: flash_attention_ref_fwd(
                    q, k, v, causal)),
                library_ms=cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal)),
                bound_ms=bound_ms, bound_by=bound_by)
        log("[kernel] flash_fwd " + json.dumps(row))
        if not ok:
            bad.append(row)
        rows.append(row)
    for wide_d in (False, True):
        sel = [r for r in rows if "err_over_cc" in r
               and (r["shape"][4] > 64) == wide_d]
        log(f"[kernel] flash_fwd fp32, D {'72-128' if wide_d else '<= 64'}: "
            f"the tensor-core route's max abs error (out or lse) is at most "
            f"{max(r['err_over_cc'] for r in sel):.2f}x the CUDA-core "
            f"route's against the fp32 plain version and "
            f"{max(r['err_over_cc_fp64'] for r in sel):.2f}x against fp64, "
            f"on the same inputs")
    if bad:
        raise SystemExit(f"chip_smoke: flash forward disagrees with its "
                         f"plain version (or, on the fp32 tensor-core route, "
                         f"the CUDA-core kernel does on the same inputs, or "
                         f"the route errs over 4x the CUDA-core kernel when "
                         f"timed or with D > 64, or with D > 64 over "
                         f"{ERR_OVER_CC}x against fp64) in {len(bad)} cases: "
                         f"{bad}")
    return rows


def _pairs(Tq, Tk, causal):
    return sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk


def backward_bounds(B, H, Tq, Tk, D, causal, dtype, peaks, ffma=False):
    """Least times for the dQ pass, the dK/dV pass and both: FA2's count
    (2*D flops per kept (q, k) pair and product: S and dP recomputed by
    both, then dQ; dV and dK) over the dtype's peak (:func:`op_peak`),
    against the bytes of q, k, v, o, dO, lse, delta read once and dq, dk,
    dv written once. Returns ``{name: (ms, bound_by)}``."""
    it = torch.empty((), dtype=dtype).element_size()
    BH, pairs = B * H, _pairs(Tq, Tk, causal)
    peak = op_peak(dtype, peaks, ffma)
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


def _logits_fp64(q, k, causal):
    """Masked ``q.k^T * scale`` of fp64 ``q``, ``k``, ``-inf`` where causal
    masks (the plain versions' ``_logits`` evaluates in fp32)."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * (1 / q.shape[-1] ** 0.5)
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        keep = (torch.arange(Tq, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def fwd_fp64(q, k, v, causal):
    """The plain forward's formulas (``flash_attention_ref_fwd``) evaluated
    in fp64 on the same fp32 inputs: ``(out, lse)``, the yardstick of the
    fp32 routes' accuracy."""
    q, k, v = (t.double() for t in (q, k, v))
    logits = _logits_fp64(q, k, causal)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.matmul(torch.exp(logits - lse[..., None]), v), lse


def bwd_fp64(q, k, v, out, lse, dout, causal):
    """The plain backward's formulas (``flash_attention_ref_bwd``)
    evaluated in fp64 on the same fp32 inputs: the yardstick of the fp32
    routes' accuracy."""
    q, k, v, out, dout = (t.double() for t in (q, k, v, out, dout))
    s = 1 / q.shape[-1] ** 0.5
    logits = _logits_fp64(q, k, causal)
    p = torch.exp(logits - lse.double()[..., None])
    ds = p * (torch.matmul(dout, v.transpose(-1, -2))
              - (dout * out).sum(-1, keepdim=True))
    return (torch.matmul(ds, k) * s, torch.matmul(ds.transpose(-1, -2), q) * s,
            torch.matmul(p.transpose(-1, -2), dout))


def phase_backward_check(peaks):
    """B3 (dQ) and B4 (dK/dV) against the plain backward on the same
    inputs (the kernel forward's out and lse, one dO), each launched once
    per case on the route ``_bwd_route`` picks: fp16/bf16 (tensor cores)
    and fp32 with D % 8 == 0 (tensor cores on bf16 planes, after one split
    launch; ``flash_bwd_tc32.cu`` up to D = 64, ``flash_bwd_tc32_d128.cu``
    above) at the training rung and the edge cases (ragged T, D = 96,
    Tq != Tk), fp16/bf16 at D = 128, fp32 with D = 72 and 80 at ragged T and
    Tq != Tk, fp32 at the training rung's B, H and T with D = 96 and 128,
    fp32 at the GPT path's shape (causal), and one fp16 case with
    D % 8 != 0 (CUDA cores). Every fp32 case on the tensor cores also runs
    the CUDA-core passes on the same inputs and logs both routes' errors
    against the fp32 plain version and against an fp64 evaluation of it
    (:func:`bwd_fp64`); with D > 64 the route's fp64 error must stay within
    ``ERR_OVER_CC`` times the CUDA-core passes'. Timed at the training rung
    in every dtype, at fp32's D = 96 and 128, full and causal, and at the
    GPT path's shape, the tensor-core routes also on the CUDA-core kernels.
    Every case is run and logged before a disagreement fails the phase."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES_DKV, LAUNCHES_DKV_TC, LAUNCHES_DKV_TC32, LAUNCHES_DQ,
        LAUNCHES_DQ_TC, LAUNCHES_DQ_TC32, LAUNCHES_SPLIT, _bwd_pass,
        _bwd_route, flash_attention_bwd, flash_attention_fwd,
        flash_attention_ref_bwd, split_bf16x3)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rung = (8, HEADS, 512, 512, HEAD_DIM)
    every = (torch.float32, torch.float16, torch.bfloat16)
    cases = [(rung, dt, c) for dt in every for c in (False, True)]
    cases += [(s, dt, c) for s in ((8, HEADS, 200, 200, HEAD_DIM),
                                   (8, HEADS, 384, 384, 96),
                                   (8, HEADS, 128, 384, HEAD_DIM))
              for dt in every for c in (False, True)]
    cases += [((4, HEADS, 512, 512, 128), dt, c)
              for dt in (torch.float16, torch.bfloat16) for c in (False, True)]
    cases += [((8, HEADS, t, t2, d), torch.float32, c) for d in (72, 80)
              for t, t2 in ((200, 200), (128, 384)) for c in (False, True)]
    wide = [(8, HEADS, 512, 512, d) for d in (96, 128)]
    cases += [(s, torch.float32, c) for s in wide for c in (False, True)]
    gpt = (GPT_B, GPT["num_heads"], GPT_T, GPT_T, 128)
    cases += [(gpt, torch.float32, True)]
    wide.append(gpt)
    cases += [((8, HEADS, 256, 256, 36), torch.float16, False)]
    counters = (LAUNCHES_DQ, LAUNCHES_DKV, LAUNCHES_DQ_TC, LAUNCHES_DKV_TC,
                LAUNCHES_DQ_TC32, LAUNCHES_DKV_TC32, LAUNCHES_SPLIT)
    names = ("dq", "dk", "dv")
    rows, bad = [], []
    for shape, dtype, causal in cases:
        B, H, Tq, Tk, D = shape
        q, k, v = (torch.randn(B, H, T, D, device="cuda",
                               generator=gen).to(dtype)
                   for T in (Tq, Tk, Tk))
        dout = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        out, lse = flash_attention_fwd(q, k, v, causal)
        route = _bwd_route(dtype, D, True)  # torch's allocations are aligned
        before = [c.count for c in counters]
        grads = flash_attention_bwd(q, k, v, out, lse, dout, causal)
        torch.cuda.synchronize()
        launches = [c.count - b for c, b in zip(counters, before)]
        ref = flash_attention_ref_bwd(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(), causal)
        name = str(dtype).replace("torch.", "")
        atol, rtol = BWD_TOL[name]
        errs = [(g.float() - r).abs() for g, r in zip(grads, ref)]
        # the largest share of its limit any element of dq, dk, dv uses
        share = max((e / (atol + rtol * r.abs())).max().item()
                    for e, r in zip(errs, ref))
        want = ([1, 1] + [int(route == "tc")] * 2
                + [int(route == "tc32")] * 3)
        ok = launches == want and share <= 1.0 and all(
            bool(torch.isfinite(g).all()) for g in grads)
        row = {"shape": list(shape), "dtype": name, "causal": causal,
               "route": route, "launches": launches[:2],
               "launches_tc": launches[2:4], "launches_tc32": launches[4:6],
               "launches_split": launches[6],
               "max_abs_err": {n: e.max().item()
                               for n, e in zip(names, errs)},
               "tol": {"atol": atol, "rtol": rtol}, "limit_share": share}
        # each pass alone, on the wrapper's delta and outputs
        delta = torch.sum(dout.float() * out.float(), dim=-1)
        s = 1 / D ** 0.5
        if route == "tc32":  # the CUDA-core passes' error on the same inputs
            cc = [torch.empty_like(t) for t in (q, k, v)]
            _bwd_pass("dq", "cc", q, k, v, out, dout, lse, delta, cc[:1],
                      causal, s)
            _bwd_pass("dkv", "cc", q, k, v, out, dout, lse, delta, cc[1:],
                      causal, s)
            row["cc_max_abs_err"] = {n: (g - r).abs().max().item()
                                     for n, g, r in zip(names, cc, ref)}
            row["err_over_cc"] = max(
                row["max_abs_err"][n] / max(row["cc_max_abs_err"][n], 1e-30)
                for n in names)
            exact = bwd_fp64(q, k, v, out, lse, dout, causal)
            for key, got in (("fp64_max_abs_err", grads),
                             ("cc_fp64_max_abs_err", cc),
                             ("plain_fp64_max_abs_err", ref)):
                row[key] = {n: (g.double() - r).abs().max().item()
                            for n, g, r in zip(names, got, exact)}
            del exact
            row["err_over_cc_fp64"] = max(
                row["fp64_max_abs_err"][n]
                / max(row["cc_fp64_max_abs_err"][n], 1e-30) for n in names)
            if D > 64:
                ok = ok and row["err_over_cc_fp64"] <= ERR_OVER_CC
        if shape == rung or shape in wide:
            bounds = backward_bounds(B, H, Tq, Tk, D, causal, dtype, peaks)
            planes = split_bf16x3(q, k, v, dout) if route == "tc32" else None

            def one(which, rt):
                return cuda_ms(lambda: _bwd_pass(
                    which, rt, q, k, v, out, dout, lse, delta,
                    grads[:1] if which == "dq" else grads[1:], causal, s,
                    planes))
            if route != "cc":  # the CUDA-core kernels on the same inputs
                row.update(cc_dq_ms=one("dq", "cc"),
                           cc_dkv_ms=one("dkv", "cc"))
            if route == "tc32":
                row["split_ms"] = cuda_ms(lambda: split_bf16x3(q, k, v,
                                                               dout))
            if dtype == torch.float32:
                ffma = backward_bounds(B, H, Tq, Tk, D, causal, dtype, peaks,
                                       ffma=True)
                row.update(
                    ffma_bound_ms=ffma["both"][0],
                    dq_ffma_bound_ms=ffma["flash_bwd_dq"][0],
                    dkv_ffma_bound_ms=ffma["flash_bwd_dkv"][0])
            row.update(
                ms=cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse,
                                                       dout, causal)),
                dq_ms=one("dq", route), dkv_ms=one("dkv", route),
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
            bad.append(row)
        rows.append(row)
    for wide_d in (False, True):
        sel = [r for r in rows if "err_over_cc" in r
               and (r["shape"][4] > 64) == wide_d]
        log(f"[kernel] flash_bwd fp32, D {'72-128' if wide_d else '<= 64'}: "
            f"the tensor-core route's max abs error is at most "
            f"{max(r['err_over_cc'] for r in sel):.2f}x the CUDA-core "
            f"route's against the fp32 plain version and "
            f"{max(r['err_over_cc_fp64'] for r in sel):.2f}x against fp64, "
            f"on the same inputs")
    if bad:
        raise SystemExit(f"chip_smoke: flash backward disagrees with its "
                         f"plain version (or, fp32 with D > 64, errs over "
                         f"{ERR_OVER_CC}x the CUDA-core passes against "
                         f"fp64) in {len(bad)} cases: {bad}")
    return rows


def phase_split_check(peaks):
    """The fp32 tensor-core backward's split kernel against its plain
    version, bit for bit: on the training rung's q, k, v and dO (one
    launch, as the backward makes it), and on values across the whole
    range (+-0, subnormals, the largest finite fp32 values, where bf16
    rounding overflows and the leading plane is truncated). Timed at the
    rung beside the plain version and its bound (4 bytes read and 6
    written per element)."""
    from mxnet_tpu_torch.ops.flash_attention import (LAUNCHES_SPLIT,
                                                     split_bf16x3,
                                                     split_bf16x3_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rung = [torch.randn(8, HEADS, 512, HEAD_DIM, device="cuda",
                        generator=gen) for _ in range(4)]
    edges = torch.tensor([0.0, -0.0, 2.0 ** -149, -(2.0 ** -140),
                          2.0 ** -126, 2.0 ** -110, 1e-30, 1.0, -65504.0,
                          3.38e38, 3.3961e38, -3.4028235e38], device="cuda")
    wide = torch.randn(4096, device="cuda", generator=gen) * torch.exp2(
        torch.randint(-140, 127, (4096,), device="cuda",
                      generator=gen).float())
    rows = []
    for name, xs in (("rung", rung), ("edges", [edges, wide])):
        before = LAUNCHES_SPLIT.count
        got = split_bf16x3(*xs)
        torch.cuda.synchronize()
        launches = LAUNCHES_SPLIT.count - before
        want = split_bf16x3_ref(*xs)
        n = sum(x.numel() for x in xs)
        row = {"inputs": name, "elements": n, "launches": launches,
               "bit_equal": torch.equal(got.view(torch.int16),
                                        want.view(torch.int16)),
               "max_abs_err": (got.float() - want.float()).abs().max().item()}
        if name == "rung":
            row.update(ms=cuda_ms(lambda: split_bf16x3(*xs)),
                       plain_ms=cuda_ms(lambda: split_bf16x3_ref(*xs)),
                       bound_ms=10 * n / peaks["bytes"] * 1e3,
                       bound_by="bytes", library_ms=None)
        log("[kernel] split_bf16x3 " + json.dumps(row))
        if launches != 1 or not row["bit_equal"]:
            raise SystemExit(f"chip_smoke: split_bf16x3 disagrees with its "
                             f"plain version: {row}")
        rows.append(row)
    return rows


def phase_repaired_faults():
    """The inputs of the two attention faults the port repaired, on the
    card: (1) q, k, v in the strided layout a (B, T, H, D) projection gives
    (fp32 and fp16), through ``flash_attention`` and its backward, bit for
    bit against the same calls on contiguous copies and within
    ``FWD_TOL`` / ``BWD_TOL`` of the plain versions; (2) a model whose head
    dim (1024 units / 4 heads = 256) no kernel takes: it picks dense
    attention by shape, as the reference does, launches no flash kernel,
    and matches the same model with the dense oracle within 1e-4."""
    from mxnet_tpu_torch.convert import params_from_mxnet_tpu
    from mxnet_tpu_torch.models import TransformerLM
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, flash_attention, flash_attention_fwd, flash_attention_ref,
        flash_attention_ref_bwd, flash_attention_ref_fwd)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for dtype in (torch.float32, torch.float16):
        q, k, v, dout = (torch.randn(2, 128, 4, HEAD_DIM, device="cuda",
                                     generator=gen).to(dtype).transpose(1, 2)
                         for _ in range(4))

        def run(*ts):
            ts = [t.detach().requires_grad_() for t in ts]
            out = flash_attention(*ts)
            return (out,) + torch.autograd.grad(out, ts, dout)

        got = run(q, k, v)
        equal = all(torch.equal(a, b) for a, b in zip(
            got, run(*(t.contiguous() for t in (q, k, v)))))
        out, lse = flash_attention_fwd(q, k, v)
        f32 = [t.float() for t in (q, k, v)]
        name = str(dtype).replace("torch.", "")
        atol, rtol = BWD_TOL[name]
        err = (got[0].float() - flash_attention_ref_fwd(*f32)[0]).abs().max()
        share = max(((a.float() - b).abs() / (atol + rtol * b.abs())).max()
                    .item() for a, b in zip(got[1:], flash_attention_ref_bwd(
                        *f32, out.float(), lse, dout.float())))
        row = {"layout": "(B, T, H, D) transposed", "shape": list(q.shape),
               "strides": list(q.stride()), "dtype": name,
               "bit_equal_to_contiguous": equal,
               "max_abs_err": err.item(), "tol": FWD_TOL[name],
               "grad_limit_share": share}
        log("[faults] strided q/k/v " + json.dumps(row))
        if not (equal and err.item() <= FWD_TOL[name] and share <= 1.0):
            raise SystemExit(f"chip_smoke: strided q/k/v: {row}")

    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerLM(vocab_size=30522, units=1024, num_layers=2,
                          num_heads=4, hidden_size=4096, device="cuda")
    model.load_state_dict(params_from_mxnet_tpu(seeded_weights(model, SEED),
                                                model))
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 30522, (2, 512))).cuda()
    LAUNCHES.reset()
    with torch.inference_mode():
        got = model(tokens)
        torch.cuda.synchronize()
        launches = LAUNCHES.count
        for layer in model.layers:
            layer.attn.attention = flash_attention_ref
        err = (got - model(tokens)).abs().max().item()
    row = {"model": "TransformerLM(units=1024, num_heads=4, num_layers=2)",
           "head_dim": 256, "tokens": list(tokens.shape),
           "flash_fwd_launches": launches, "max_abs_err_vs_dense": err,
           "tol": FP32_TOL, "finite": bool(torch.isfinite(got).all())}
    log("[faults] head dim 256 " + json.dumps(row))
    if launches != 0 or err > FP32_TOL or not row["finite"]:
        raise SystemExit(f"chip_smoke: head dim 256: {row}")
    del model, got


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
                                                     LAUNCHES_SPLIT,
                                                     LAUNCHES_TC32,
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
    counters = (LAUNCHES, LAUNCHES_TC32, LAUNCHES_SPLIT)
    for c in counters:
        c.reset()
    load = run_loadgen(fire, list(range(N_REQUESTS)), concurrency=CONCURRENCY)
    launches, launches_tc32, splits = (c.count for c in counters)
    stats = engine.stats()
    breakdown = top_rung_breakdown(engine, ladder, top_seq)
    engine.close()
    dispatches = stats["batcher"]["dispatches"] - disp0
    log(f"[slice] served {load['completed']}/{N_REQUESTS} requests in "
        f"{dispatches} dispatches; flash_fwd launches {launches} "
        f"({launches_tc32} on the fp32 tensor-core route, after {splits} "
        f"splits); errors {load['errors']}")
    if load["completed"] != N_REQUESTS or load["errors"]:
        raise SystemExit(f"chip_smoke: requests failed: {load['errors']}")
    if stats["recompiles_after_warmup"] != 0:
        raise SystemExit(f"chip_smoke: {stats['recompiles_after_warmup']} "
                         "new signatures after warmup")
    if (dispatches == 0 or launches != layers * dispatches
            or launches_tc32 != launches or splits != launches):
        raise SystemExit(f"chip_smoke: {launches} flash_fwd launches "
                         f"({launches_tc32} on the fp32 tensor-core route, "
                         f"{splits} splits) for {dispatches} dispatches of "
                         f"{layers} layers")
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
        "flash_fwd_tc32_launches": launches_tc32, "split_launches": splits,
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


def _seeded_bert(dtype):
    """BERT-base at full width and depth in ``dtype``, seeded weights and
    dropout masks (each Dropout layer's generator from SEED + its index)."""
    from mxnet_tpu_torch.convert import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.nn import Dropout
    from mxnet_tpu_torch.models import BERTModel
    model = BERTModel(device="cuda", dtype=dtype)
    model.load_state_dict(params_from_mxnet_tpu(seeded_weights(model, SEED),
                                                model))
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for i, d in enumerate(drops):
        d.manual_seed(SEED + i)
    return model


def _train_step(model, loss_fn, tokens, labels, update, events=None,
                scale=LOSS_SCALE):
    """One ``record -> backward -> update`` step on the loss times
    ``scale``; returns the mean loss (a device tensor). ``events`` (4 CUDA
    events) mark forward, backward and update."""
    from mxnet_tpu_torch import autograd
    if events:
        events[0].record()
    with autograd.record():
        # (B, T, vocab) or (B, classes) logits as rows, held no longer
        # than the loss needs them
        loss = loss_fn(torch.flatten(model(tokens), 0, -2),
                       labels.reshape(-1))
        scaled = loss * scale
    if events:
        events[1].record()
    autograd.backward(scaled)
    if events:
        events[2].record()
    update()
    if events:
        events[3].record()
    return loss.detach().float().mean()


def _train_batch(vocab, B=TRAIN_B, T=TRAIN_T):
    rng = np.random.default_rng(SEED)
    return tuple(torch.from_numpy(rng.integers(0, vocab, (B, T))).cuda()
                 for _ in range(2))


def _train_counters():
    """Every launch counter a training step moves, by name."""
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_DKV, LAUNCHES_DKV_TC, LAUNCHES_DKV_TC32,
        LAUNCHES_DQ, LAUNCHES_DQ_TC, LAUNCHES_DQ_TC32, LAUNCHES_SPLIT,
        LAUNCHES_TC, LAUNCHES_TC32)
    from mxnet_tpu_torch.opt import kernels as opt_kernels
    return {"flash_fwd": LAUNCHES, "flash_bwd_dq": LAUNCHES_DQ,
            "flash_bwd_dkv": LAUNCHES_DKV, "mp_sgd": opt_kernels.LAUNCHES,
            "flash_fwd_tc": LAUNCHES_TC, "flash_fwd_tc32": LAUNCHES_TC32,
            "flash_bwd_dq_tc": LAUNCHES_DQ_TC,
            "flash_bwd_dkv_tc": LAUNCHES_DKV_TC,
            "flash_bwd_dq_tc32": LAUNCHES_DQ_TC32,
            "flash_bwd_dkv_tc32": LAUNCHES_DKV_TC32,
            "split_bf16x3": LAUNCHES_SPLIT}


def _checked(update, params, missing):
    """``update``, after noting in ``missing`` every trainable parameter
    without a gradient."""
    def run():
        missing.extend(n for n, p in params.items()
                       if p.requires_grad and p.grad is None)
        update()
    return run


def _run_steps(tag, steps, step, missing, want, after=None):
    """``steps`` timed steps of ``step(events)``: each step's launches must
    equal ``want``, and ``missing`` (see :func:`_checked`) must stay empty.
    Returns the losses, walls, event windows, launch totals and peak
    memory. ``after(i)`` runs after step ``i``."""
    counters = _train_counters()
    totals = dict.fromkeys(counters, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, parts = [], [], []
    for i in range(steps):
        for c in counters.values():
            c.reset()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        loss = step(events)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        parts.append([events[j].elapsed_time(events[j + 1])
                      for j in range(3)])
        losses.append(loss.item())
        counts = {n: c.count for n, c in counters.items()}
        for n in counts:
            totals[n] += counts[n]
        log(f"[{tag}] step {i}: loss {losses[-1]:.6f}, wall "
            f"{walls[-1]:.2f} ms, forward/backward/optimizer "
            f"{[round(x, 3) for x in parts[-1]]} ms, launches {counts}")
        if counts != want:
            raise SystemExit(f"chip_smoke: {tag}: launches per step "
                             f"{counts}, expected {want}")
        if missing:
            raise SystemExit(f"chip_smoke: {tag}: no gradient for "
                             f"{missing[:8]}")
        if after:
            after(i)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: {tag}: loss not finite and falling: "
                         f"{losses}")
    return losses, walls, parts, totals, torch.cuda.max_memory_allocated()


def _step_breakdown(tag, walls, parts, step, path, tokens=TRAIN_B * TRAIN_T):
    """Medians over the steps after the first, and one more step profiled:
    the device's kernel time, each port kernel's (every kernel of
    ``path`` must show device time), the attention kernels' share of it
    and the eight largest."""
    steady = range(1, len(walls))
    wall_ms = float(np.median([walls[i] for i in steady]))
    fwd_ms, bwd_ms, opt_ms = (float(np.median([parts[i][j] for i in steady]))
                              for j in range(3))
    kernel_ms, ours, top = profiled_step(step)
    if not all(ours[name] > 0 for name in path):
        raise SystemExit(f"chip_smoke: {tag}: the profiler found no device "
                         f"time for a kernel of the step (symbols renamed?): "
                         f"{ours}")
    return {
        "step_wall_ms_median": wall_ms, "step_wall_ms": walls,
        "step_event_ms_median": fwd_ms + bwd_ms + opt_ms,
        "tokens_per_s": tokens / (wall_ms / 1e3),
        "forward_ms": fwd_ms, "backward_ms": bwd_ms, "optimizer_ms": opt_ms,
        "profiled_kernel_ms": kernel_ms,
        "device_busy_share": kernel_ms / wall_ms,
        "top_kernels_ms": top, "kernel_ms_in_step": ours,
        "b2_share_of_forward": ours["flash_fwd"] / fwd_ms,
        "b3_b4_share_of_backward":
            (ours["flash_bwd_dq"] + ours["flash_bwd_dkv"]) / bwd_ms,
        "b1_share_of_optimizer": ours["mp_sgd"] / opt_ms,
        "attention_share_of_device": sum(
            ours[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                              "split_bf16x3")) / kernel_ms}


def _update_diff(got, ref, init, names):
    """Relative L2 difference of two runs' updates (after - init) over the
    model, and the worst parameter's, as (value, name)."""
    diff2 = upd2 = 0.0
    worst = (0.0, "")
    for name, a, b, w0 in zip(names, got, ref, init):
        d = (a.to(b.device) - b).norm().item()
        u = (b - w0.to(b.device)).norm().item()
        diff2, upd2 = diff2 + d * d, upd2 + u * u
        if u > 0 and d / u > worst[0]:
            worst = (d / u, name)
    return (diff2 / upd2) ** 0.5, worst


def phase_train(card):
    """BERT-base in fp16 trained through the Gluon entry points, then two
    steps of a reference run (dense attention, plain update) from the same
    weights, batch and dropout generators."""
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_ref
    from mxnet_tpu_torch.opt import kernels as opt_kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = _seeded_bert(torch.float16)
    params = collect_params(model)
    layers, vocab = len(model.layers), model.head.weight.shape[0]
    trainer = Trainer(params, "sgd", {"learning_rate": TRAIN_LR,
                                      "momentum": TRAIN_MOMENTUM,
                                      "multi_precision": True})
    loss_fn = SoftmaxCrossEntropyLoss()
    tokens, labels = _train_batch(vocab)
    batch = TRAIN_B * TRAIN_T
    log(f"[train] BERTModel(dtype=float16): {len(params)} parameters "
        f"({sum(p.numel() for p in params.values())} values), {layers} "
        f"layers; batch {TRAIN_B} x {TRAIN_T}; SGD lr {TRAIN_LR} momentum "
        f"{TRAIN_MOMENTUM} multi_precision; loss scale {LOSS_SCALE}; built "
        f"in {time.perf_counter() - t0:.2f} s")

    # every forward, dQ and dK/dV launch of the fp16 step takes the
    # tensor-core route
    want = dict.fromkeys(_train_counters(), 0)
    want.update({"flash_fwd": layers, "flash_bwd_dq": layers,
                 "flash_bwd_dkv": layers, "mp_sgd": len(params),
                 "flash_fwd_tc": layers, "flash_bwd_dq_tc": layers,
                 "flash_bwd_dkv_tc": layers})
    masters, missing = [], []
    update = _checked(lambda: trainer.step(batch * LOSS_SCALE), params,
                      missing)

    def step(events=None):
        return _train_step(model, loss_fn, tokens, labels, update, events)

    def after(i):
        if i == REF_STEPS - 1:
            masters.extend(trainer._updaters[0].states[j][0].clone()
                           for j in range(len(params)))

    losses, walls, parts, totals, peak = _run_steps(
        "train", TRAIN_STEPS, step, missing, want, after)

    # reference run: dense attention, plain update, same start
    ref = _seeded_bert(torch.float16)
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
    upd_err, worst = _update_diff(masters, [w for w, _ in ref_state], init,
                                  list(params))
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

    summary = {
        "card": card, "batch": [TRAIN_B, TRAIN_T], "steps": TRAIN_STEPS,
        "losses": losses, "ref_losses": ref_losses,
        **_step_breakdown("train", walls, parts, step,
                          ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                           "mp_sgd")),
        "peak_memory_bytes": peak, "launches": totals,
        "loss_max_abs_diff_vs_ref": loss_err,
        "master_update_rel_l2_diff_vs_ref": upd_err,
        "worst_parameter_rel_diff": list(worst)}
    log("[train] " + json.dumps(summary))
    return totals


def phase_train_fp32(card):
    """BERT-base in fp32 (no loss scale, plain SGD with momentum) trained
    through the Gluon entry points: every forward, dQ and dK/dV launch on
    the fp32 tensor-core route; then two steps of a reference run (dense
    attention, the same update) from the same weights, batch and dropout
    generators."""
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sgd = {"learning_rate": TRAIN_LR, "momentum": TRAIN_MOMENTUM}

    def build(attention=None):
        model = _seeded_bert(torch.float32)
        if attention is not None:
            for layer in model.layers:
                layer.attn.attention = attention
        params = collect_params(model)
        return model, params, Trainer(params, "sgd", dict(sgd))

    t0 = time.perf_counter()
    model, params, trainer = build()
    layers, vocab = len(model.layers), model.head.weight.shape[0]
    loss_fn = SoftmaxCrossEntropyLoss()
    tokens, labels = _train_batch(vocab)
    batch = TRAIN_B * TRAIN_T
    init = [p.detach().clone() for p in params.values()]
    log(f"[train32] BERTModel(): {len(params)} parameters "
        f"({sum(p.numel() for p in params.values())} values), {layers} "
        f"layers, float32; batch {TRAIN_B} x {TRAIN_T}; SGD lr {TRAIN_LR} "
        f"momentum {TRAIN_MOMENTUM}; no loss scale; built in "
        f"{time.perf_counter() - t0:.2f} s")

    # the forward and every backward pass on the fp32 tensor-core route,
    # each after one split, and no mixed-precision update
    want = dict.fromkeys(_train_counters(), 0)
    want.update({"flash_fwd": layers, "flash_fwd_tc32": layers,
                 "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                 "flash_bwd_dq_tc32": layers, "flash_bwd_dkv_tc32": layers,
                 "split_bf16x3": 2 * layers})
    after2, missing = [], []
    update = _checked(lambda: trainer.step(batch), params, missing)

    def step(events=None):
        return _train_step(model, loss_fn, tokens, labels, update, events,
                           scale=1.0)

    def after(i):
        if i == REF_STEPS - 1:
            after2.extend(p.detach().clone() for p in params.values())

    losses, walls, parts, totals, peak = _run_steps(
        "train32", TRAIN32_STEPS, step, missing, want, after)

    ref, ref_params, ref_trainer = build(flash_attention_ref)
    ref_losses = [_train_step(ref, loss_fn, tokens, labels,
                              lambda: ref_trainer.step(batch),
                              scale=1.0).item() for _ in range(REF_STEPS)]
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
    upd_err, worst = _update_diff(after2, [p.detach() for p in
                                           ref_params.values()], init,
                                  list(params))
    log(f"[train32] reference run (dense attention, the same update): "
        f"losses {ref_losses}; max loss diff {loss_err:.3e} (limit "
        f"{TRAIN32_LOSS_TOL}); update rel. L2 diff {upd_err:.3e} (limit "
        f"{TRAIN32_UPD_TOL}), worst parameter {worst[1]} {worst[0]:.3e} "
        f"(limit {TRAIN32_UPD_TOL_EACH})")
    if (loss_err > TRAIN32_LOSS_TOL or upd_err > TRAIN32_UPD_TOL
            or worst[0] > TRAIN32_UPD_TOL_EACH):
        raise SystemExit("chip_smoke: fp32 training disagrees with the "
                         "reference run")
    del ref, ref_params, ref_trainer, init, after2

    summary = {
        "card": card, "batch": [TRAIN_B, TRAIN_T], "steps": TRAIN32_STEPS,
        "dtype": "float32", "losses": losses, "ref_losses": ref_losses,
        **_step_breakdown("train32", walls, parts, step,
                          ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                           "split_bf16x3")),
        "peak_memory_bytes": peak, "launches": totals,
        "loss_max_abs_diff_vs_ref": loss_err,
        "update_rel_l2_diff_vs_ref": upd_err,
        "worst_parameter_rel_diff": list(worst)}
    log("[train32] " + json.dumps(summary))
    return totals


def _seeded_gpt(attention=None):
    """The GPT path's model (``GPT``, causal, fp32, dropout 0) with random
    weights from SEED, drawn on the card: N(0, 0.02) matrices and
    embeddings, zero biases, LayerNorm 1/0. ``attention`` replaces every
    layer's attention function (the dense oracle of the reference run)."""
    from mxnet_tpu_torch.models import TransformerLM
    model = TransformerLM(**GPT, dropout=0.0, causal=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("bias"):
                p.zero_()
            else:  # a LayerNorm's gamma
                p.fill_(1.0)
    if attention is not None:
        for layer in model.layers:
            layer.attn.attention = attention
    return model


def phase_train_gpt32(card):
    """A causal GPT at Cerebras-GPT-1.3B's widths trained in fp32 through
    the Gluon entry points: one warm step and GPT_STEPS - 1 more, each with
    every forward, dQ and dK/dV launch on the fp32 tensor-core route
    (D = 128: ``flash_fwd_tc32_d128.cu`` and ``flash_bwd_tc32_d128.cu``,
    one split per forward and one per backward); the breakdown of one more
    step; then, with the
    kernel run freed (what the comparison needs kept on the host), two steps
    of a reference run with dense attention from the same weights and
    batch."""
    import gc
    from mxnet_tpu_torch.gluon import Trainer, collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    sgd = {"learning_rate": TRAIN_LR, "momentum": TRAIN_MOMENTUM}
    t0 = time.perf_counter()
    model = _seeded_gpt()
    params = collect_params(model)
    trainer = Trainer(params, "sgd", dict(sgd))
    layers, vocab = len(model.layers), GPT["vocab_size"]
    loss_fn = SoftmaxCrossEntropyLoss()
    tokens, labels = _train_batch(vocab, GPT_B, GPT_T)
    batch = GPT_B * GPT_T
    init = [p.detach().cpu() for p in params.values()]
    n_values = sum(p.numel() for p in init)
    log(f"[gpt32] TransformerLM({GPT}, causal=True): {len(params)} "
        f"parameters ({n_values} values), float32; batch {GPT_B} x {GPT_T}; "
        f"SGD lr {TRAIN_LR} momentum {TRAIN_MOMENTUM}; built in "
        f"{time.perf_counter() - t0:.2f} s")

    # the forward, dQ and dK/dV passes on the fp32 tensor-core route (D =
    # 128), one split per forward and one per backward
    want = dict.fromkeys(_train_counters(), 0)
    want.update({"flash_fwd": layers, "flash_fwd_tc32": layers,
                 "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                 "flash_bwd_dq_tc32": layers, "flash_bwd_dkv_tc32": layers,
                 "split_bf16x3": 2 * layers})
    after2, missing = [], []
    update = _checked(lambda: trainer.step(batch), params, missing)

    def step(events=None):
        return _train_step(model, loss_fn, tokens, labels, update, events,
                           scale=1.0)

    def after(i):
        if i == REF_STEPS - 1:
            after2.extend(p.detach().cpu() for p in params.values())

    losses, walls, parts, totals, peak = _run_steps(
        "gpt32", GPT_STEPS, step, missing, want, after)
    breakdown = _step_breakdown("gpt32", walls, parts, step,
                                ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv", "split_bf16x3"), batch)
    names = list(params)
    del model, params, trainer, update, step, after
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    ref = _seeded_gpt(flash_attention_ref)
    ref_params = collect_params(ref)
    ref_trainer = Trainer(ref_params, "sgd", dict(sgd))
    ref_losses = [_train_step(ref, loss_fn, tokens, labels,
                              lambda: ref_trainer.step(batch),
                              scale=1.0).item() for _ in range(REF_STEPS)]
    ref_peak = torch.cuda.max_memory_allocated()
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
    upd_err, worst = _update_diff(after2, [p.detach() for p in
                                           ref_params.values()], init, names)
    log(f"[gpt32] reference run (dense attention, the same update): losses "
        f"{ref_losses}; max loss diff {loss_err:.3e} (limit "
        f"{TRAIN32_LOSS_TOL}); update rel. L2 diff {upd_err:.3e} (limit "
        f"{TRAIN32_UPD_TOL}), worst parameter {worst[1]} {worst[0]:.3e} "
        f"(limit {TRAIN32_UPD_TOL_EACH}); peak memory {ref_peak} B")
    del ref, ref_params, ref_trainer, init, after2
    gc.collect()
    torch.cuda.empty_cache()
    if (loss_err > TRAIN32_LOSS_TOL or upd_err > TRAIN32_UPD_TOL
            or worst[0] > TRAIN32_UPD_TOL_EACH):
        raise SystemExit("chip_smoke: GPT fp32 training disagrees with the "
                         "reference run")

    summary = {
        "card": card, "model": GPT, "causal": True, "parameters": n_values,
        "batch": [GPT_B, GPT_T], "steps": GPT_STEPS, "dtype": "float32",
        "losses": losses, "ref_losses": ref_losses, **breakdown,
        "peak_memory_bytes": peak, "ref_peak_memory_bytes": ref_peak,
        "launches": totals, "loss_max_abs_diff_vs_ref": loss_err,
        "update_rel_l2_diff_vs_ref": upd_err,
        "worst_parameter_rel_diff": list(worst)}
    log("[gpt32] " + json.dumps(summary))
    return totals


def _resnet_batch(batch, dtype, device):
    """Synthetic images uniform(-1, 1) and labels in [0, 1000), from SEED
    with numpy, as bench.py draws them."""
    rng = np.random.RandomState(SEED)
    x = rng.uniform(-1, 1, (batch, 3, RESNET_SIZE, RESNET_SIZE))
    y = rng.randint(0, RESNET_CLASSES, (batch,))
    return (torch.from_numpy(x.astype(np.float32)).to(device, dtype),
            torch.from_numpy(y.astype(np.float32)).to(device))


def _seeded_resnet50(device, dtype=None):
    """``resnet50_v1(classes=1000)`` initialised from SEED by the port's
    initializers with MXNet's ResNet recipe (Xavier, Gaussian, fan in,
    magnitude 2), then cast to ``dtype`` (BatchNorm stays fp32)."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    mx_random.seed(SEED)
    net = resnet50_v1(classes=RESNET_CLASSES, device=device)
    net.initialize(initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2))
    if dtype is not None:
        net.cast(dtype)
    return net


def _noise_biases(net):
    """Names of the convolution biases that a BatchNorm follows: the
    normalization subtracts any per-channel shift, so their exact
    gradient is zero and what each run computes for them is rounding
    noise (BottleneckV1's 32 biases)."""
    from mxnet_tpu_torch.gluon import nn as gnn
    out = set()
    for name, seq in net.named_modules():
        if isinstance(seq, gnn.HybridSequential):
            kids = list(seq.named_children())
            out.update(f"{name}.{na}.bias" for (na, a), (_, b)
                       in zip(kids, kids[1:])
                       if isinstance(a, gnn.Conv2D) and a.bias is not None
                       and isinstance(b, gnn.BatchNorm))
    return out


def _rel_l2(a, b):
    """||a - b|| / ||b|| over lists of tensors (on any devices)."""
    d = sum((x.double().cpu() - z.double().cpu()).norm().item() ** 2
            for x, z in zip(a, b))
    n = sum(z.double().cpu().norm().item() ** 2 for z in b)
    return (d / n) ** 0.5


def phase_resnet_check(card):
    """ResNet-50 v1 at full width, two SGD steps at batch 4 on the card and,
    from the same weights and batch, on the CPU through the same port code
    (the path tier-1 holds against the JAX package), in fp32 and fp64:
    losses, the update, both running statistics after each step and
    predict-mode logits, held as ``RESNET32_ERR_RATIO`` and
    ``RESNET64_TOL`` say."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import port_name
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    state = {k: v.cpu() for k, v in
             _seeded_resnet50("cuda").state_dict().items()}
    model = _seeded_resnet50("cpu")
    names = list(model.collect_params())
    stat_names = [n for n in names if n.endswith(("running_mean",
                                                  "running_var"))]
    trained = [n for n in names if n not in stat_names]
    noise = _noise_biases(model)
    log(f"[resnet_check] resnet50_v1(classes=1000): {len(names)} "
        f"parameters ({sum(p.numel() for p in model.parameters())} values);"
        f" TF32 off; batch {RESNET_CHECK_B} x 3 x {RESNET_SIZE} x "
        f"{RESNET_SIZE}; SGD lr {RESNET_CHECK_LR} momentum "
        f"{RESNET_MOMENTUM} wd {RESNET_WD}; {RESNET_CHECK_STEPS} steps on "
        f"the card and on the CPU in fp32 and fp64; built in "
        f"{time.perf_counter() - t0:.2f} s")
    loss_fn = SoftmaxCrossEntropyLoss()

    def run(device, dtype):
        net = _seeded_resnet50("cpu")
        net.load_state_dict(state)
        net.cast(dtype)
        net.to(device)
        params = net.collect_params()
        trainer = Trainer(params, "sgd", {"learning_rate": RESNET_CHECK_LR,
                                          "momentum": RESNET_MOMENTUM,
                                          "wd": RESNET_WD})
        x, y = _resnet_batch(RESNET_CHECK_B, dtype, device)
        t0 = time.perf_counter()
        losses, stats = [], []
        for _ in range(RESNET_CHECK_STEPS):
            losses.append(_train_step(net, loss_fn, x, y,
                                      lambda: trainer.step(RESNET_CHECK_B),
                                      scale=1.0).double().cpu())
            stats.append([params[n].detach().double().cpu().clone()
                          for n in stat_names])
        with torch.no_grad(), autograd.predict_mode():
            logits = net(x).double().cpu()
        if device == "cuda":
            torch.cuda.synchronize()
        return dict(losses=losses, stats=stats, logits=logits,
                    seconds=time.perf_counter() - t0,
                    weights={n: params[n].detach().double().cpu().clone()
                             for n in names})

    runs = {(dev, dt): run(dev, getattr(torch, dt))
            for dev in ("cuda", "cpu") for dt in ("float32", "float64")}
    init = {n: state[port_name(n)].double() for n in names}
    kept = [n for n in trained if n not in noise]

    def errors(got, ref):
        """Against ``ref``: the losses' max abs difference, the update's
        rel. L2 over the model and the worst parameter's (noise biases
        left out), the running statistics' after each step and the
        predict-mode logits' rel. L2."""
        upd, _ = _update_diff([got["weights"][n] for n in trained],
                              [ref["weights"][n] for n in trained],
                              [init[n] for n in trained], trained)
        _, worst = _update_diff([got["weights"][n] for n in kept],
                                [ref["weights"][n] for n in kept],
                                [init[n] for n in kept], kept)
        return {"loss": max(abs(a - b).item() for a, b in
                            zip(got["losses"], ref["losses"])),
                "update": upd, "worst_parameter": list(worst),
                "stats": max(_rel_l2(a, b) for a, b in
                             zip(got["stats"], ref["stats"])),
                "stats_by_step": [_rel_l2(a, b) for a, b in
                                  zip(got["stats"], ref["stats"])],
                "logits": _rel_l2([got["logits"]], [ref["logits"]])}

    ref = runs[("cpu", "float64")]
    e64 = errors(runs[("cuda", "float64")], ref)
    card32 = errors(runs[("cuda", "float32")], ref)
    cpu32 = errors(runs[("cpu", "float32")], ref)
    ratios = {k: card32[k] / max(cpu32[k], 1e-300)
              for k in ("loss", "update", "stats", "logits")}
    moved = all(not torch.equal(a, init[n].double())
                for a, n in zip(ref["stats"][0], stat_names))
    summary = {
        "card": card, "batch": [RESNET_CHECK_B, 3, RESNET_SIZE, RESNET_SIZE],
        "losses_cuda_fp32": [t.item() for t in
                             runs[("cuda", "float32")]["losses"]],
        "losses_cpu_fp64": [t.item() for t in ref["losses"]],
        "fp64_cuda_vs_cpu": e64, "fp32_cuda_vs_fp64": card32,
        "fp32_cpu_vs_fp64": cpu32, "fp32_error_ratio_cuda_over_cpu": ratios,
        "noise_biases_left_out_of_worst": len(noise),
        "running_stats_moved": moved,
        "seconds": {f"{d}_{t}": r["seconds"] for (d, t), r in runs.items()}}
    log("[resnet_check] " + json.dumps(summary))
    log(f"[resnet_check] limits: fp32 error ratio card / CPU "
        f"{RESNET32_ERR_RATIO}; fp64 card vs CPU {RESNET64_TOL}")
    fp64_ok = all(e64[k] <= RESNET64_TOL for k in ("loss", "update",
                                                     "stats", "logits")) \
        and e64["worst_parameter"][0] <= RESNET64_TOL
    finite = all(torch.isfinite(r["logits"]).all() for r in runs.values())
    if not (fp64_ok and finite and moved
            and max(ratios.values()) <= RESNET32_ERR_RATIO):
        raise SystemExit("chip_smoke: ResNet-50 on the card disagrees with "
                         "the CPU")
    del runs, state, model


def _resnet_macs(net, dtype):
    """Multiply-accumulates of one image's forward through ``net``'s
    convolutions and Dense layers, from the shapes a batch-1 forward
    shows (pooling, BatchNorm and the elementwise work are left out)."""
    from mxnet_tpu_torch.gluon import nn as gnn
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, gnn.Dense):
            total[0] += mod.weight.numel()
        else:
            total[0] += out.numel() * mod.weight[0].numel()
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (gnn.Conv2D, gnn.Dense))]
    with torch.no_grad():
        net(torch.zeros(1, 3, RESNET_SIZE, RESNET_SIZE, device="cuda",
                        dtype=dtype))
    for h in hooks:
        h.remove()
    return total[0]


def phase_train_resnet50(card, peaks):
    """ResNet-50 v1 trained in fp16 with multi-precision SGD (B1) through
    the Gluon entry points at the published batch, then two steps of a
    reference run from the same weights and batch whose update is B1's
    plain version."""
    from mxnet_tpu_torch import lr_scheduler
    from mxnet_tpu_torch.convert import port_name
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import optimizer_ops as oops
    from mxnet_tpu_torch.opt import kernels as opt_kernels
    t0 = time.perf_counter()
    net = _seeded_resnet50("cuda", "float16")
    params = net.collect_params()
    names = list(params)
    init_state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    fp16 = [n for n, p in params.items()
            if p.requires_grad and p.dtype == torch.float16]
    sizes16 = [params[n].numel() for n in fp16]
    # the count from the model's structure: every convolution weight, the
    # convolutions' biases and the classifier's weight and bias are cast
    convs = [m for m in net.modules() if isinstance(m, gnn.Conv2D)]
    by_structure = len(convs) + sum(m.bias is not None for m in convs) + 2
    stat_names = [n for n in names if n.endswith(("running_mean",
                                                  "running_var"))]
    bn_fp32 = [n for n, p in params.items() if p.dtype == torch.float32]
    if not (len(fp16) == by_structure == RESNET_FP16_PARAMS
            and len(bn_fp32) == len(names) - RESNET_FP16_PARAMS):
        raise SystemExit(f"chip_smoke: resnet50_v1 cast to fp16 has "
                         f"{len(fp16)} fp16 parameters ({by_structure} by "
                         f"its structure), expected {RESNET_FP16_PARAMS}")
    sched = lr_scheduler.MultiFactorScheduler(
        step=[6], factor=0.1, base_lr=RESNET_LR, warmup_steps=2)
    trainer = Trainer(params, "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD, "multi_precision": True, "lr_scheduler": sched})
    loss_fn = SoftmaxCrossEntropyLoss()
    x, y = _resnet_batch(RESNET_B, torch.float16, "cuda")
    macs = _resnet_macs(net, torch.float16)
    flops_step = 2 * 3 * macs * RESNET_B
    log(f"[train_resnet50] resnet50_v1(classes=1000) cast to float16: "
        f"{len(names)} parameters ({sum(p.numel() for p in net.parameters())}"
        f" values), {len(fp16)} fp16 ({len(convs)} convolution weights, "
        f"{sum(m.bias is not None for m in convs)} convolution biases, the "
        f"classifier's 2), {len(bn_fp32)} BatchNorm fp32; batch {RESNET_B} x"
        f" 3 x {RESNET_SIZE} x {RESNET_SIZE} fp16; SGD lr {RESNET_LR} "
        f"momentum {RESNET_MOMENTUM} wd {RESNET_WD} multi_precision, "
        f"MultiFactorScheduler(step=[6], factor=0.1, warmup_steps=2); loss "
        f"scale {RESNET_LOSS_SCALE}; {macs} multiply-accumulates per image "
        f"forward, {flops_step:.4e} FLOP per step (2 per MAC, backward 2x "
        f"the forward); built in {time.perf_counter() - t0:.2f} s")

    want = dict.fromkeys(_train_counters(), 0)
    want["mp_sgd"] = RESNET_FP16_PARAMS
    trainable = [p for p in params.values() if p.requires_grad]
    grad_max, rates, masters, missing = [], [], [], []

    def update():
        # the largest |gradient| of the step, read after it: a non-finite
        # value fails the run (a few launches inside the optimizer window)
        g16 = [p.grad for p in trainable if p.dtype == torch.float16]
        g32 = [p.grad for p in trainable if p.dtype == torch.float32]
        grad_max.append(torch.maximum(
            torch.stack(torch._foreach_norm(g16, float("inf"))).float()
            .max(), torch.stack(torch._foreach_norm(g32, float("inf")))
            .max()))
        trainer.step(RESNET_B * RESNET_LOSS_SCALE)
        rates.append(trainer.learning_rate)
    checked = _checked(update, params, missing)

    def step(events=None):
        return _train_step(net, loss_fn, x, y, checked, events,
                           RESNET_LOSS_SCALE)

    def after(i):
        if i == REF_STEPS - 1:
            states = trainer._updaters[0].states
            masters.extend(
                states[j][0].clone() if params[n].dtype == torch.float16
                else params[n].detach().clone()
                for j, n in enumerate(names) if params[n].requires_grad)

    losses, walls, parts, totals, peak = _run_steps(
        "train_resnet50", RESNET_STEPS, step, missing, want, after)
    max_grad = [g.item() for g in grad_max]
    if not all(np.isfinite(max_grad)):
        raise SystemExit(f"chip_smoke: train_resnet50: a gradient held inf "
                         f"or NaN at loss scale {RESNET_LOSS_SCALE}: "
                         f"{max_grad}")
    stats_moved = all(
        params[n].dtype == torch.float32
        and not torch.equal(params[n].detach(), init_state[n])
        for n in stat_names)
    if not stats_moved:
        raise SystemExit("chip_smoke: train_resnet50: a running statistic "
                         "did not move or is not fp32")
    steady = range(1, len(walls))
    wall_ms = float(np.median([walls[i] for i in steady]))
    fwd_ms, bwd_ms, opt_ms = (float(np.median([parts[i][j] for i in steady]))
                              for j in range(3))
    kernel_ms, ours, top = profiled_step(step)
    if ours["mp_sgd"] <= 0:
        raise SystemExit("chip_smoke: train_resnet50: the profiler found no "
                         "device time for mp_sgd")
    summary = {
        "card": card, "batch": [RESNET_B, 3, RESNET_SIZE, RESNET_SIZE],
        "steps": RESNET_STEPS, "dtype": "float16, BatchNorm float32",
        "loss_scale": RESNET_LOSS_SCALE, "losses": losses,
        "learning_rates": rates[:RESNET_STEPS],
        "max_abs_grad_by_step": max_grad,
        "images_per_s": RESNET_B / (wall_ms / 1e3),
        "step_wall_ms_median": wall_ms, "step_wall_ms": walls,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms, "optimizer_ms": opt_ms,
        "profiled_kernel_ms": kernel_ms,
        "device_busy_share": kernel_ms / wall_ms,
        "top_kernels_ms": top, "b1_ms_per_step": ours["mp_sgd"],
        "b1_launches_per_step": RESNET_FP16_PARAMS,
        "b1_values_per_step": sum(sizes16),
        "b1_median_values_per_launch": int(np.median(sizes16)),
        "b1_bound_ms_per_step": 20 * sum(sizes16) / peaks["bytes"] * 1e3,
        "b1_bound_by": "bytes",
        "b1_share_of_optimizer": ours["mp_sgd"] / opt_ms,
        "macs_per_image_forward": macs, "flop_per_step": flops_step,
        "fp16_tensor_core_peak_share":
            flops_step / (wall_ms / 1e3) / peaks["float16"],
        "peak_memory_bytes": peak, "launches": totals}
    if rates[:2] != [RESNET_LR / 2, RESNET_LR]:
        raise SystemExit(f"chip_smoke: train_resnet50: learning rates "
                         f"{rates}, expected {RESNET_LR / 2} (warmup) then "
                         f"{RESNET_LR}")
    del trainer, net, params, trainable
    torch.cuda.empty_cache()

    # reference run: the same start, the plain update (fp16 parameters
    # through B1's plain version, fp32 ones through plain SGD)
    ref = _seeded_resnet50("cuda", "float16")
    ref.load_state_dict(init_state)
    ref_params = ref.collect_params()
    ref_state = {n: (p.detach().float().clone(),
                     torch.zeros_like(p, dtype=torch.float32))
                 for n, p in ref_params.items() if p.requires_grad}
    ref_lrs = iter(rates)

    def ref_update():
        lr = next(ref_lrs)
        kw = dict(lr=lr, momentum=RESNET_MOMENTUM, wd=RESNET_WD,
                  rescale_grad=1 / (RESNET_B * RESNET_LOSS_SCALE))
        with torch.no_grad():
            for n, (w32, mom) in ref_state.items():
                p = ref_params[n]
                if p.dtype == torch.float16:
                    new = opt_kernels.mp_sgd_mom_update_ref(
                        p, p.grad, mom, w32, **kw)
                    for dst, src_ in zip((p, mom, w32), new):
                        dst.copy_(src_)
                else:
                    new_w, new_mom = oops.sgd_mom_update(p, p.grad, mom, **kw)
                    p.copy_(new_w)
                    mom.copy_(new_mom)
                    w32.copy_(new_w)
                p.grad = None

    ref_losses = [_train_step(ref, loss_fn, x, y, ref_update,
                              scale=RESNET_LOSS_SCALE).item()
                  for _ in range(REF_STEPS)]
    trained = [n for n in names if n in ref_state]
    init = [init_state[port_name(n)].float() for n in trained]
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
    upd_err, _ = _update_diff(masters, [ref_state[n][0] for n in trained],
                              init, trained)
    noise = _noise_biases(ref)
    keep = [i for i, n in enumerate(trained) if n not in noise]
    _, worst = _update_diff([masters[i] for i in keep],
                            [ref_state[trained[i]][0] for i in keep],
                            [init[i] for i in keep],
                            [trained[i] for i in keep])
    log(f"[train_resnet50] reference run (plain update): losses "
        f"{ref_losses}; max loss diff {loss_err:.3e} (limit "
        f"{TRAIN_LOSS_TOL}); master-weight update rel. L2 diff "
        f"{upd_err:.3e} (limit {TRAIN_UPD_TOL}), worst parameter "
        f"{worst[1]} {worst[0]:.3e} (limit {TRAIN_UPD_TOL_EACH}; the "
        f"{len(noise)} biases a BatchNorm follows left out)")
    if (loss_err > TRAIN_LOSS_TOL or upd_err > TRAIN_UPD_TOL
            or worst[0] > TRAIN_UPD_TOL_EACH):
        raise SystemExit("chip_smoke: ResNet-50 training disagrees with the "
                         "reference run")
    summary.update({"ref_losses": ref_losses,
                    "loss_max_abs_diff_vs_ref": loss_err,
                    "master_update_rel_l2_diff_vs_ref": upd_err,
                    "worst_parameter_rel_diff": list(worst)})
    log("[train_resnet50] " + json.dumps(summary))
    del ref, ref_params, ref_state, init_state, x, y
    torch.cuda.empty_cache()
    return totals


# each port kernel's symbols in the profiler (substrings): every design of
# the forward and of the backward passes counts under one name
KERNEL_NAMES = {"flash_fwd": ("flash_fwd_kernel", "flash_fwd_tc_kernel",
                              "flash_fwd_tc32_kernel",
                              "flash_fwd_tc32_d128_kernel"),
                "flash_bwd_dq": ("flash_bwd_dq_kernel",
                                 "flash_bwd_tc_dq_kernel",
                                 "flash_bwd_tc32_dq_kernel",
                                 "flash_bwd_tc32_d128_dq_kernel"),
                "flash_bwd_dkv": ("flash_bwd_dkv_kernel",
                                  "flash_bwd_tc_dkv_kernel",
                                  "flash_bwd_tc32_dkv_kernel",
                                  "flash_bwd_tc32_d128_dkv_kernel"),
                "split_bf16x3": ("split_bf16x3_kernel",),
                "mp_sgd": ("mp_sgd_mom_kernel",)}


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
    ours = {name: sum(r[1] for r in rows if any(s in r[0] for s in syms))
            for name, syms in KERNEL_NAMES.items()}
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
    t_start = time.perf_counter()
    card, name, peaks = phase_device()
    phase_build()
    rows = phase_kernel_check(peaks)
    bwd_rows = phase_backward_check(peaks)
    split_rows = phase_split_check(peaks)
    phase_repaired_faults()
    sgd_rows = phase_sgd_check(peaks)
    serve_launches = phase_slice(card)
    train = phase_train(card)
    train32 = phase_train_fp32(card)
    gpt = phase_train_gpt32(card)
    phase_resnet_check(card)
    resnet = phase_train_resnet50(card, peaks)

    def pick(table, **want):
        return next(r for r in table if "ms" in r
                    and all(r[k] == v for k, v in want.items()))

    fwd32 = pick(rows, shape=[8, HEADS, 512, 512, HEAD_DIM],
                 dtype="float32", causal=False)
    fwd16 = pick(rows, shape=[8, HEADS, 512, 512, HEAD_DIM],
                 dtype="float16", causal=False)
    bwd16 = pick(bwd_rows, dtype="float16", causal=False)
    bwd32 = pick(bwd_rows, shape=[8, HEADS, 512, 512, HEAD_DIM],
                 dtype="float32", causal=False)
    gpt_shape = [GPT_B, GPT["num_heads"], GPT_T, GPT_T, 128]
    fwd_gpt = pick(rows, shape=gpt_shape, dtype="float32", causal=True)
    fwd128 = pick(rows, shape=[8, HEADS, 512, 512, 128], dtype="float32",
                  causal=False)
    bwd_gpt = pick(bwd_rows, shape=gpt_shape, dtype="float32", causal=True)
    split = pick(split_rows, inputs="rung")
    sgd = pick(sgd_rows, n=max(SGD_SIZES))
    sgd_resnet = pick(sgd_rows, n=2_359_296)

    def bwd_err(which, key="max_abs_err", wide=False, **want):
        """The largest error of the pass's outputs over the cases that
        match ``want``, with D > 64 (``wide``) or D <= 64."""
        grads = ("dq",) if which == "dq" else ("dk", "dv")
        return max(r[key][g] for r in bwd_rows for g in grads
                   if key in r and (r["shape"][4] > 64) == wide
                   and all(r[k] == v for k, v in want.items()))

    def launches(name):
        return {"train_fp16": train[name], "train_fp32": train32[name],
                "train_gpt_fp32": gpt[name]}
    common = {"card": card}

    def fwd_err(key, wide, **want):
        """The largest of ``key`` over the fp32 tensor-core forward's cases
        that match ``want``, with D > 64 (``wide``) or D <= 64."""
        return max(max(r[key].values()) if isinstance(r[key], dict)
                   else r[key] for r in rows if key in r
                   and (r["shape"][4] > 64) == wide
                   and all(r[k] == v for k, v in want.items()))
    # the fp16 training path's design (tensor cores), with the fp32 design
    # (tensor cores on bf16 planes, flash_fwd_tc32.cu; the serving and fp32
    # training paths') beside
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_fwd_tc.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:126",
        "launches": serve_launches + train["flash_fwd"]
        + train32["flash_fwd"] + gpt["flash_fwd"],
        "launches_by_path": {"serve": serve_launches,
                             **launches("flash_fwd")},
        "launches_tensor_core": train["flash_fwd_tc"],
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["route"] == "tc"),
        "ms": fwd16["ms"], "cuda_core_ms": fwd16["cc_ms"],
        "plain_ms": fwd16["plain_ms"],
        "bound_ms": fwd16["bound_ms"], "bound_by": fwd16["bound_by"],
        "library_ms": fwd16["library_ms"],
        "shape": fwd16["shape"], "dtype": "float16",
        "float32": {
            "source": "mxnet_tpu_torch/csrc/flash_fwd_tc32.cu",
            "route": "cuda",
            "launches": serve_launches + train32["flash_fwd"],
            "launches_tc32": serve_launches + train32["flash_fwd_tc32"],
            "max_abs_err": fwd_err("max_abs_err", False, route="tc32"),
            "cuda_core_max_abs_err": fwd_err("cc_max_abs_err", False),
            "err_over_cc": fwd_err("err_over_cc", False),
            "head_dims": "D <= 64, D % 8 == 0",
            "ms": fwd32["ms"], "kernel_ms": fwd32["kernel_ms"],
            "split_ms": fwd32["split_ms"],
            "split_bound_ms": fwd32["split_bound_ms"],
            "cuda_core_ms": fwd32["cc_ms"],
            "one_warpgroup_kernel_ms": fwd32["one_wg_ms"],
            "cuda_core_source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
            **{k: fwd32[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                     "ffma_bound_ms", "library_ms")}},
        # fp32 with D = 72-128 (the GPT path's), timed at its shape and at
        # the training rung's B, H, T with D = 128
        "float32_d128": {
            "source": "mxnet_tpu_torch/csrc/flash_fwd_tc32_d128.cu",
            "route": "cuda", "head_dims": "64 < D <= 128, D % 8 == 0",
            "launches": gpt["flash_fwd"],
            "launches_by_path": {"train_gpt_fp32": gpt["flash_fwd"]},
            "launches_tc32": gpt["flash_fwd_tc32"],
            "max_abs_err": fwd_err("max_abs_err", True, route="tc32"),
            "cuda_core_max_abs_err": fwd_err("cc_max_abs_err", True),
            "err_over_cc": fwd_err("err_over_cc", True),
            "fp64_max_abs_err": fwd_err("fp64_max_abs_err", True),
            "cuda_core_fp64_max_abs_err": fwd_err("cc_fp64_max_abs_err",
                                                  True),
            "err_over_cc_fp64": fwd_err("err_over_cc_fp64", True),
            "shape": gpt_shape, "causal": True,
            "kernel_ms": fwd_gpt["kernel_ms"], "ms": fwd_gpt["ms"],
            "split_ms": fwd_gpt["split_ms"],
            "cuda_core_ms": fwd_gpt["cc_ms"],
            "cuda_core_source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
            **{k: fwd_gpt[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                       "ffma_bound_ms", "library_ms")},
            "d128_t512": {k: fwd128[k] for k in (
                "shape", "kernel_ms", "ms", "split_ms", "cc_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}},
        **common}]
    for which, line in (("dq", "pallas_kernels.py:257"),
                        ("dkv", "pallas_kernels.py:277")):
        # the fp16 training path's design (tensor cores), with the fp32
        # training path's (tensor cores on bf16 planes) beside it
        kernels.append({
            "name": f"flash_bwd_{which}", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_bwd_tc.cu",
            "replaces": f"mxnet_tpu/ops/{line}",
            "launches": train[f"flash_bwd_{which}"]
            + train32[f"flash_bwd_{which}"] + gpt[f"flash_bwd_{which}"],
            "launches_by_path": launches(f"flash_bwd_{which}"),
            "launches_tensor_core": train[f"flash_bwd_{which}_tc"],
            "max_abs_err": bwd_err(which, route="tc"),
            "ms": bwd16[f"{which}_ms"],
            "cuda_core_ms": bwd16[f"cc_{which}_ms"],
            "plain_ms": bwd16["plain_ms"],
            "bound_ms": bwd16[f"{which}_bound_ms"],
            "bound_by": bwd16[f"{which}_bound_by"],
            "library_ms": bwd16["library_ms"],
            "plain_and_library_cover": "flash_bwd_dq + flash_bwd_dkv",
            "shape": bwd16["shape"], "dtype": "float16",
            "float32": {
                "source": "mxnet_tpu_torch/csrc/flash_bwd_tc32.cu",
                "route": "cuda",
                "launches": train32[f"flash_bwd_{which}_tc32"],
                "max_abs_err": bwd_err(which, route="tc32"),
                "cuda_core_max_abs_err": bwd_err(which, "cc_max_abs_err",
                                                 route="tc32"),
                "head_dims": "D <= 64, D % 8 == 0",
                "ms": bwd32[f"{which}_ms"],
                "cuda_core_ms": bwd32[f"cc_{which}_ms"],
                "cuda_core_source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
                "plain_ms": bwd32["plain_ms"],
                "bound_ms": bwd32[f"{which}_bound_ms"],
                "bound_by": bwd32[f"{which}_bound_by"],
                "ffma_bound_ms": bwd32[f"{which}_ffma_bound_ms"],
                "library_ms": bwd32["library_ms"]},
            # fp32 with D = 72-128 (the GPT path's), timed at its shape
            "float32_d128": {
                "source": "mxnet_tpu_torch/csrc/flash_bwd_tc32_d128.cu",
                "route": "cuda",
                "launches": gpt[f"flash_bwd_{which}_tc32"],
                "max_abs_err": bwd_err(which, route="tc32", wide=True),
                "cuda_core_max_abs_err": bwd_err(
                    which, "cc_max_abs_err", route="tc32", wide=True),
                "fp64_max_abs_err": bwd_err(
                    which, "fp64_max_abs_err", route="tc32", wide=True),
                "cuda_core_fp64_max_abs_err": bwd_err(
                    which, "cc_fp64_max_abs_err", route="tc32", wide=True),
                "ms": bwd_gpt[f"{which}_ms"],
                "cuda_core_ms": bwd_gpt[f"cc_{which}_ms"],
                "cuda_core_source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
                "plain_ms": bwd_gpt["plain_ms"],
                "bound_ms": bwd_gpt[f"{which}_bound_ms"],
                "bound_by": bwd_gpt[f"{which}_bound_by"],
                "ffma_bound_ms": bwd_gpt[f"{which}_ffma_bound_ms"],
                "library_ms": bwd_gpt["library_ms"],
                "head_dims": "64 < D <= 128, D % 8 == 0",
                "shape": gpt_shape, "causal": True},
            **common})
    kernels.append({
        "name": "split_bf16x3", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_bwd_tc32.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:243",
        "part_of": "flash_fwd, flash_bwd_dq and flash_bwd_dkv in float32",
        "launches": serve_launches + train32["split_bf16x3"]
        + gpt["split_bf16x3"],
        "max_abs_err": max(r["max_abs_err"] for r in split_rows),
        "ms": split["ms"], "plain_ms": split["plain_ms"],
        "bound_ms": split["bound_ms"], "bound_by": split["bound_by"],
        "library_ms": None,
        "library_none_because": "no single PyTorch call splits a tensor "
                                "into bf16 planes",
        "shape": [split["elements"]], "dtype": "float32 -> 3 x bfloat16",
        **common})
    kernels.append({
        "name": "mp_sgd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/mp_sgd.cu",
        "replaces": "mxnet_tpu/opt/kernels.py:95",
        "launches": train["mp_sgd"] + resnet["mp_sgd"],
        "launches_by_path": {"train_fp16": train["mp_sgd"],
                             "train_resnet50_fp16": resnet["mp_sgd"]},
        "max_abs_err": max(r["max_abs_err"] for r in sgd_rows),
        "ms": sgd["ms"], "plain_ms": sgd["plain_ms"],
        "bound_ms": sgd["bound_ms"], "bound_by": sgd["bound_by"],
        "largest_resnet50_tensor": {k: sgd_resnet[k] for k in (
            "n", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "library_none_because": "no single PyTorch call computes the "
                                "update and the cast together",
        "shape": [sgd["n"]], "dtype": "float16/float32", **common})
    log(f"[time] chip_smoke ran for {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
