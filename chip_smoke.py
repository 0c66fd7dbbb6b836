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
5. optimizer check — the mixed-precision SGD kernel (B1) against its
   plain version at the sizes of BERT-base's parameters, bit for bit, and
   its list form on the fp16 parameter lists of BERT-base (150 tensors)
   and ResNet-50 (87), one of them at an odd element offset, clip off and
   on: one launch per list, bit-equal, timed against one launch per
   tensor, its bound and ``torch._fused_sgd_`` (another function, for
   context);
6. serving slice — BERT-base (full width, fp32, random weights from a
   seed) served by ``ServingEngine``: warmup over the ladder, closed-loop
   load, zero new signatures after warmup, 12 forward launches per
   dispatch (all on the fp32 tensor-core route, after 12 splits), and one
   request's logits against the same model with dense attention;
7. training slice — BERT-base (full width and depth, fp16 weights,
   dropout 0.1) trained through ``autograd.record`` -> ``backward`` ->
   ``Trainer.step`` with multi-precision SGD and a static loss scale:
   12/12/12/1 launches per step (all 12 forward, dQ and dK/dV launches
   on the tensor-core route; one B1 launch for the 150 parameters), every
   parameter with a gradient, a finite and falling loss, and two steps
   against a reference run with dense attention and the plain update;
   step time, tokens/s, peak memory, the optimizer's host time and a
   per-step breakdown; then the same model trained the way BERT's users
   train it (``[train_bert_adamw_fp16]``): AdamW (multi-precision) under
   dynamic loss scaling (``amp``) from 2**16, skipping each step whose
   gradient overflowed, until 4 updates were applied: every skipped step
   non-finite and without effect, the scale sequence the rule's, the
   step after a skip depositing its own gradient, the first update
   AdamW's in fp64, 12/12/12/0 launches, the loss falling; and
   (``[checkpoint]``) ``save_parameters`` + ``save_states`` after the
   second update, loaded into a fresh model and trainer that make the
   last two updates bit-equal to the uninterrupted run; then timed steps
   and a profiled one;
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
    step and eight more, one B1 launch per step (for the 87 fp16
    parameters, none of them BatchNorm's), every gradient finite, the loss
    falling, the running statistics moved and fp32, two steps against a
    reference run with B1's plain version; images/s, the step's windows,
    device busy share and top kernels, B1's time, peak memory and the
    share of the fp16 tensor-core peak.
12. nd ops (``[nd_ops]``) — every registered dense op of ``mx.nd`` (one
    name per function; not the control-flow graph nodes) on the card and
    on the CPU on the same fp32 inputs (TF32 off): every output on the
    card, shapes and dtypes equal, values within rtol 1e-5 / atol 1e-6
    (rtol 1e-4 / atol 1e-5 where the op sums), samplers by shape, dtype
    and finiteness; the counts of ops and stubs;
    ``nd.mp_sgd_mom_update`` (with ``out=``) and
    ``nd.multi_mp_sgd_mom_update`` on BERT-base's 150 fp16 tensors: 150
    and 1 B1 launches, bit-equal to B1's plain version;
    ``nd._fused_attention`` at (8, 12, 512, 512, 64) in fp16 and fp32: the
    forward on B2's tensor-core route and, under ``record``, the backward
    on B3/B4's, within ``FWD_TOL`` / ``BWD_TOL`` of the plain version; and
    the host cost of an nd call against the bare torch call (printed,
    not gated);
13. index fault (``[index_fault]``) — labels and indices -1, n and n + 2
    through ``SoftmaxCrossEntropyLoss``, the ``Embedding`` layer,
    ``nd.pick`` and ``nd.Embedding`` on the card: no device-side assert,
    the CPU path's values (-1 wraps, the others NaN);
14. ``train_gluon.py``'s loop (``[train_gluon_nd]``) — ``get_model(
    "resnet50_v1", classes=1000)`` with the classifier replaced by a user
    ``HybridBlock`` whose ``hybrid_forward`` calls ``F.FullyConnected``,
    Xavier, fp16 (BatchNorm fp32), ``Trainer("sgd", multi_precision)``,
    256 NDArray images on ``mx.gpu(0)``: ``record`` ->
    ``loss.backward()`` -> ``trainer.step(256)`` ->
    ``metric.Accuracy().update`` for one warm step and eight more; one B1
    launch a step, every output an NDArray on the card, the loss finite
    and falling, the metric's count equal to a torch recount; its median
    step and images/s beside ``[train_resnet50]``'s;
15. the symbolic encoder (``[module_encoder]``) — a 12-layer encoder at
    BERT-base's widths built with ``sym`` as bench.py's ``lm_block``
    (q/k/v ``FullyConnected(flatten=False)``, reshaped to (B, H, T, D),
    one ``_fused_attention`` node a layer, GELU FFN, LayerNorm, an
    ``Embedding`` in and a ``SoftmaxOutput`` over the 30522-token
    vocabulary out), N(0, 0.02) weights through ``set_params``, trained
    by ``Module.fit`` on the card in fp32 (TF32 off) for one warm step
    and four more: 12/12/12 launches a step on the fp32 tensor-core
    route after 24 splits, the loss finite and falling, no aux state,
    every array on the card; two steps of the same graph with
    attention's dense spelling from the same start within [train32]'s
    limits; the step time, tokens/s, peak memory and a profiled step's
    top ten kernels beside [train32]'s step; then one ``_fused_attention``
    node bound in fp16 (``simple_bind(type_dict=...)``) at (8, 12, 512,
    64): ``forward(is_train=True)`` and ``backward`` launch B2/B3/B4 once
    each on the 16-bit tensor-core route, within ``FWD_TOL`` /
    ``BWD_TOL``;
16. ResNet-50 through Module (``[module_resnet50]``) — the zoo's
    ``resnet50_v1`` (Xavier as [train_resnet50] seeds it) exported, its
    JSON loaded by ``sym.load`` with a ``SoftmaxOutput`` appended and its
    ``.params`` through ``set_params``, bound at (256, 3, 224, 224) in
    fp32: one step by hand whose stem BatchNorm is held to its closed
    form (one update), then ``Module.fit`` over an ``NDArrayIter`` on the
    card for one warm batch and five more (loss finite and falling,
    every array on the card), three fp32 steps of the same net through
    the Gluon Trainer for the Module's cost, and two SGD steps at batch 4
    through ``Module`` and through the Gluon Trainer from
    [resnet_check]'s weights, batch and rate: in fp32 within
    ``MODULE_GLUON_RATIO`` times [resnet_check]'s fp32 error (losses,
    statistics), in fp64 within ``RESNET64_TOL`` (losses, update, worst
    parameter, statistics), a limit that a skipped or momentum-less
    second update, planted from the Module's own weights, must fail;
17. ``train_mnist.py``'s loop (``[module_lenet]``, BASELINE config 1) —
    its LeNet and synthetic digits copied here, ``Module.fit`` on the
    card with ``Speedometer`` and ``do_checkpoint`` for 10 epochs, then
    ``Module.load`` of the last checkpoint scores the same accuracy,
    which beats chance by 0.2;
18. the fused training step (``mxnet_tpu_torch.step``: one captured CUDA
    graph per input signature, replayed each step) — each phase runs the
    eager loop twice and the fused step once from the same start, batch
    and generator states for 3 steps, the rate halved after step 2: the
    eager runs bit-equal to each other, the fused run bit-equal to them
    (losses, weights, running statistics, optimizer states), one capture
    for the run (the rate change re-keys nothing), the kernels of a
    replayed step counted by ``torch.profiler``; then 4 timed steps of
    each and a profiled one (step time, busy share, peak memory, capture
    seconds, reported, not gated). ``[fused_bert]``: BERT-base fp32
    (dropout 0.1) at 8 x 512 through ``Trainer(..., "adamw")`` and
    ``trainer.fuse_step(model, SoftmaxCrossEntropyLoss())``, 12/12/12
    attention launches and 24 splits per replay, all on the fp32
    tensor-core route; after 2 steps within [train32]'s limits of a
    reference run with plain attention; the replay's device-to-device
    copies (the write-back among them) timed by the profiler.
    ``[fused_resnet50]``: the zoo's ResNet-50 v1 in fp32 at batch 256,
    SGD with momentum and weight decay, BatchNorm's running statistics
    updated inside the graph, no attention launch, run twice: with
    cuDNN's default algorithms, which are not bit-reproducible run to run
    (reported), the fused step held to the eager loop within
    [train32]'s limits; with its deterministic ones, bit-equal; each
    timed. ``[fused_symbol]``: a
    symbol-mode ``StepFunction`` with AdamW over [module_encoder]'s
    encoder against ``Executor.forward``/``backward`` and the same
    optimizer, 12/12/12 launches and 24 splits per replay, its step time
    beside [module_encoder]'s;
19. the sparse slice — ``[sparse_linear]``: ``linear_classification.py``'s
    loop at LIBSVM Avazu's width (a csr batch of 8192 rows over 1,000,001
    features, 15 Zipf-drawn features a row, built from its payload on the
    card), ``w.attach_grad(stype="row_sparse")``, ``nd.dot(csr, w)`` and
    AdaGrad's lazy update, 1 + 8 steps run twice (bit-equal), the first
    two also on the CPU; each step's gradient held to an fp64
    recomputation, the rows no batch touched to their initial bits, no
    batch densified, no storage-fallback warning, peak memory under 2 GB;
    step time, samples/s, host syncs per step and a profiled step;
    ``[sparse_embedding]``: a sparse-gradient ``nd.Embedding`` of the One
    Billion Word vocabulary (793,471 x 512 fp32) trained by lazy Adam and
    lazy SGD with momentum, each step's gradient held to the per-id sums
    and its touched rows to the dense optimizer's, the untouched rows of
    the table and states to their bits, the lazy update timed beside the
    dense one; ``[sparse_params]``: those arrays (row_sparse weight rows,
    gradient, a csr slice) saved and loaded on the card, bit-equal, the
    file's bytes those of a CPU save but for the device type.
    This slice runs no TPU kernel (the JAX package computes sparse work
    with gathers and segment sums outside Pallas), so it adds no entry to
    the kernels line.
20. autoregressive LM serving (``serve2``) on ``parallel/pipeline_lm.py``'s
    stack at Cerebras-GPT-1.3B's widths (24 x 2048, 16 heads of 128, FFN
    8192, vocab 50257, one expert), fp32, TF32 off, random weights drawn
    on the card from SEED: ``[decode_serve]`` — one ``DecodeEngine``
    (16-slot pages, f32 pools of 8 GiB, 8 in flight, prefill rungs
    128/256/512, 64 new tokens, 4 decode steps a call) under 8 closed-loop
    clients sending 32 prompts of 64-480 tokens: everything on the card,
    the pools never reallocated, no signature after warmup, no page in use
    after ``drain`` and a clean servelint audit; the paged logits of one
    prefill and 8 decode steps against ``dense_lm_logits`` within the
    ``fusion`` class or ``DECODE_ERR_RATIO`` times the oracle's own fp32
    error against fp64; four requests' tokens teacher-forced through the
    oracle (a token off its argmax only within the phase's logit limit);
    time to first token and per output token (p50/p99), output tokens/s,
    the decode call's ms at each batch rung, host syncs per tick, a
    profiled window's busy share and top ten kernels, peak memory, the
    decode step against its weight-read bound; then a 40-page engine that
    must preempt. ``[decode_prefix]`` — 16 requests sharing a 256-token
    prefix through the prefix cache, equal to the cache-off run (or
    diverging first at a near-tie within that limit), prefill tokens
    avoided, a copy-on-write copy. ``[decode_spec]`` — a 4-layer draft, 4
    draft tokens a tick, trajectories as the plain engine's; acceptance
    rate and tokens/s. ``[decode_quant]`` — bf16 and int8 pools at the
    f32 pool's bytes, logits within ``quant_bf16`` / ``quant_int8`` of
    the f32 pool's, the int8 pool >= 3.5x the f32 pool's pages.
    ``[decode_router]`` — a ``Router`` over 2 replicas sharing the
    weights: a rolling reload under load dropping nothing, a replica whose
    scheduler dies mid-load (its breaker opens, its requests fail over),
    and one HTTP ``POST`` on 127.0.0.1 equal to a direct ``predict``.
    This path reaches no TPU kernel either (the JAX package's prefill is
    dense einsums and its paged attention ``lax.scan`` code), so the
    kernels line is unchanged.
21. recurrent networks (after the zoo phases, TF32 off): ``[rnn_lm]`` —
    ``word_lm.py``'s tied LSTM LM at Zaremba et al.'s medium widths (2 x
    650, dropout 0.5, 35 steps, batch 20, vocabulary 10,000) trained with
    clipped SGD for 1 + 8 steps: the first loss within 5% of ln(10,000),
    the loss falling, the tied weight updated once a step, states (2, 20,
    650), the profiler's ``aten::_cudnn_rnn`` once per layer (dropout runs
    the layers one call each) and no per-step op, then the card against
    the CPU at batch 2 (fp64 within 1e-9, fp32 within 3x the CPU's own
    error); step ms, tokens/s, busy share, peak memory, top kernels and
    the weight-copy time. ``[rnn_ctc]`` — a 5-layer bidirectional LSTM of
    250 under ``CTCLoss`` at 32 utterances of 150-600 frames: the loss
    falling, padded frames' logit gradients 0, one cuDNN RNN call for the
    five layers and torch's CTC kernels in the trace, fp64 card against
    CPU within 1e-9. ``[rnn_bucketing]`` — ``lstm_bucketing.py``'s
    defaults through ``mx.rnn`` and ``BucketingModule.fit``: an executor
    per bucket, one storage per parameter across them, perplexity
    falling, a ``FusedRNNCell`` against its ``unfuse()`` stack and its
    checkpoint round trip bit-equal. ``[gluon_contrib]`` — every contrib
    layer and cell on the card against the CPU, ``SparseEmbedding``'s
    row-sparse gradient and lazy update, ``DeformableConvolution`` with
    zero offsets against ``Conv2D``, ``Estimator.fit`` with a checkpoint
    and early stopping. No TPU kernel lies on this path (the JAX package
    runs RNNs and CTC as ``lax.scan``), so the kernels line is unchanged.
22. the image input pipeline (after the recurrent phases, torch on one CPU
    thread): ``[image_rec]`` — a ``.rec`` file of 2,560 synthetic JPEGs
    (sides 300-500, quality 90, mean 90-130 KB) written with the port's
    ``recordio``, read by ``mx.io.ImageRecordIter`` on the native pipeline
    (its codec reported; a Python pipeline fails the phase) with ImageNet
    training's augmentation at batch 256 on every usable core: one epoch
    to the card alone (images/s), bit-equal to ``ctx=cpu``'s batches, each
    label read back once, the deterministic pass within 1 count of a numpy
    resize/crop/normalise of the same decoded pixels; then
    ``[train_resnet50]``'s fp16 net fed by it for 1 + 8 steps (one B1
    launch a step, the loss falling, statistics moving) beside steps on a
    batch held on the card: fed and resident step ms, the host's wait for
    a batch, busy shares, peak memory. ``[image_dataset]`` — the same file
    as ``ImageRecordDataset`` with Gluon transforms under
    ``DataLoader(thread_pool=True)``: the loader's images/s, each label
    once, 3 steps of the same net. ``[image_serve]`` — the net in fp16
    through ``ServingEngine`` over rungs 1-64, 64 requests of 1-8 images
    from 4 clients: requests/s, p50/p99, images/s, 0 signatures after
    warmup, every response within 1e-2 of the largest logit of a direct
    forward, a bias step seen by the next response. B1's entry in the
    kernels line counts the two phases' launches.

The script prints its own wall time. The last three lines are the card
(``nvidia-smi``), ``{"kernels": [...]}`` (B2/B3/B4's
``launches_by_path`` with ``module_encoder_fp32``,
``symbol_fused_attention_fp16`` and the fused paths' launches at their
capture, and ``launches_per_replayed_step`` of the fused paths; the
split's the same) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

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
# [zoo_inception3] / [zoo_mobilenet_v2]: two zoo families built as a user
# builds them (get_model with no device and no input sizes, initialize on
# the card, cast to fp16 and the Trainer both before the first forward),
# trained in fp16 with multi-precision SGD (one B1 launch a step) for
# 1 + 8 steps on batches of gluon.data.DataLoader over an ArrayDataset of
# synthetic uint8 HWC images (label k of ZOO_LABELS brightens band k)
# through ToTensor and Normalize: Inception v3 at 299 x 299, batch 32 (the
# reference's per-GPU batch for it, BASELINE.md:38), and MobileNet v2 1.0
# at 224 x 224, batch 256 (ResNet-50's [train_resnet50] batch). The loss
# scale is [train_resnet50]'s; the export check holds the exported graph's
# fp16 logits to ZOO_EXPORT_TOL of the largest logit, and [zoo_mobilenet_v2]
# also takes one step at batch ZOO_CHECK_B in fp32 and fp64 on the card and
# the CPU, held as [resnet_check] holds ResNet-50
ZOO_PHASES = (("zoo_inception3", "inceptionv3", 299, 32),
              ("zoo_mobilenet_v2", "mobilenetv2_1.0", 224, 256))
ZOO_STEPS, ZOO_LR, ZOO_LABELS, ZOO_WORKERS = 9, 0.05, 10, 4
ZOO_MEAN, ZOO_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
ZOO_EXPORT_TOL, ZOO_CHECK_B, ZOO_CHECK_LR = 1e-2, 4, 1e-3
# [rnn_lm]: a word LM at Zaremba et al. 2014's medium widths (arXiv:
# 1409.2329 section 4: 2 x 650 LSTM, dropout 0.5 on the non-recurrent
# connections, 35 unrolled steps, batch 20, weights uniform in [-0.05,
# 0.05], SGD at 1.0, gradients clipped at a global norm of 5), built as
# examples/rnn/word_lm.py builds it (the decoder tied to the embedding),
# on Zipf-drawn streams of a 10,000-word vocabulary (PTB's size) from SEED:
# one warm step and RNN_LM_STEPS more, the states carried and detached.
# The card-vs-CPU check: RNN_LM_CHECK_STEPS steps at batch RNN_LM_CHECK_B
# with dropout 0; fp64 within RNN_LM_FP64_TOL (fp64 rounding over the
# ~1e4 operations behind each value is ~1e-12 of values ~10), fp32 within
# RNN_ERR_RATIO times the CPU's own fp32 error ([resnet_check]'s rule)
RNN_LM = dict(vocab=10_000, width=650, layers=2, dropout=0.5, bptt=35,
              batch=20, init=0.05, lr=1.0, clip=5.0)
RNN_LM_STEPS = 8
RNN_LM_CHECK_B, RNN_LM_CHECK_STEPS, RNN_LM_FP64_TOL = 2, 2, 1e-9
RNN_ERR_RATIO = 3.0
# [rnn_ctc]: an acoustic model at Graves et al. 2013's CTC-5L-250H widths
# (arXiv:1303.5778: 5 bidirectional LSTM layers of 250, 123 input
# features, 61 phones and the blank), built as
# examples/speech_recognition/lstm_ctc.py builds it, under CTCLoss with
# frame and label lengths: 32 utterances of 150-600 frames (TIMIT's range
# at 10 ms), zero-padded, 20-75 phones each, SGD at 1e-4 with momentum
# 0.9 (the paper's), CTC_STEPS steps; frames are each phone's template
# plus noise, from SEED. The card-vs-CPU check runs the trained weights in
# fp64 on CTC_CHECK_B utterances that span the timed range (the longest,
# 600 frames with 75 phones; the shortest, 150 with 20; two drawn between):
# losses and logit gradients within CTC_FP64_TOL of the largest magnitude
# (fp64 rounding of ~1e5-term sums, ~1e-12)
CTC = dict(features=123, hidden=250, layers=5, phones=62, batch=32,
           frames=(150, 600), labels=(20, 75), lr=1e-4, momentum=0.9)
CTC_STEPS, CTC_CHECK_B, CTC_FP64_TOL = 9, 4, 1e-9
# [rnn_bucketing]: upstream MXNet's example/rnn/bucketing/
# lstm_bucketing.py defaults (2 LSTM layers of 200, embedding 200,
# buckets 10-60, batch 32, SGD at 0.01, wd 1e-5, Perplexity ignoring 0)
# through the port's mx.rnn and BucketingModule, one epoch of
# BUCKETING["sentences"] Zipf-drawn sentences of 5-60 words from SEED
# (every bucket at least twice). FUSED_TOL: a FusedRNNCell (cuDNN) against
# its unfuse() stack (per-step products) on the same fp32 weights U(-0.07,
# 0.07) at the largest bucket: each gate sums 400 products of magnitude
# <= 0.07, whose two orders differ by ~sqrt(400) * 2^-24 * 28 ~ 3e-5 at
# most in practice, carried through 60 steps whose state map contracts
# (forget gates ~0.5): 1e-4 on outputs in (-1, 1)
BUCKETING = dict(layers=2, hidden=200, embed=200, vocab=10_000,
                 buckets=(10, 20, 30, 40, 50, 60), batch=32, lr=0.01,
                 wd=1e-5, sentences=640)
FUSED_TOL = 1e-4
# [gluon_contrib]: (rtol, atol) for the layers that sum (the products,
# convolutions and normalizations); the others within 1e-5 / 1e-6
CONTRIB_SUMS = (1e-4, 1e-5)
# [image_rec]: a .rec file of IMAGE_RECORDS synthetic JPEGs from SEED at
# ImageNet-like sizes (sides IMAGE_SIDES, quality 90): a smooth random field
# (a random grid every IMAGE_CELL pixels, bilinear) plus uniform noise of
# +-IMAGE_NOISE counts, which puts the mean file in IMAGE_KB (ImageNet
# train's JPEGs average ~110 KB); class k of IMAGE_CLASSES brightens the
# k-th horizontal band, so the loss can fall on fresh batches; each label
# is [class, record index]. ImageRecordIter as ImageNet training reads it
# (resize the shorter side to 256, random 224 crop, mirror, the ImageNet
# mean/std) feeds [train_resnet50]'s fp16 net for 1 + 8 steps at the rate
# IMAGE_LR (momentum, wd and loss scale as [train_resnet50]'s; its 0.1,
# warmed up over 2 steps, took the loss from 7.7 to 109 in 9 steps on
# these fresh batches on an H100 80GB HBM3 at 700 W, and 0.01 from 7.7 to
# 2.9 by step 3, then up to 5.3), then IMAGE_RESIDENT_STEPS
# steps on a batch held on the card, for the fed step's distance to the
# device-resident one. The iterator is reset after the first step, whose
# ~15 s of cuDNN autotuning would let the pipeline decode ~7 batches
# ahead (its ready window and the staging queue) and hide its rate. Each
# decode thread builds a whole batch, so after the reset the first
# batches still arrive together: the fed rate is also reported over the
# whole fed window (steps 1-8, the cold start included). The deterministic pass
# (centre crop, no mirror) is held to a numpy resize/crop/normalise of the
# same decoded pixels within IMAGE_DET_COUNTS count over the std: the
# pipeline's bilinear weights and its +0.5 rounding to uint8 are float32
# as numpy's, so only the order of four products can differ
IMAGE_RECORDS, IMAGE_SIDES, IMAGE_QUALITY = 2560, (300, 500), 90
IMAGE_CELL, IMAGE_NOISE, IMAGE_CLASSES = 12, 44, 10
IMAGE_KB = (90.0, 130.0)
IMAGE_MEAN, IMAGE_STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)
IMAGE_RESIZE, IMAGE_STEPS, IMAGE_RESIDENT_STEPS = 256, 9, 3
IMAGE_LR = 0.005
IMAGE_DET_N, IMAGE_DET_COUNTS = 16, 1.0
# The pipeline's codec (nvJPEG on the card) against OpenCV's libjpeg-turbo,
# an independent decoder, on the first IMAGE_CODEC_N records. The two
# upsample 4:2:0 chroma differently, and these images' chroma is noisy:
# over all 2,560 records (NVIDIA H100 80GB HBM3, 700 W; nvJPEG of CUDA
# 12.8, OpenCV 4.13) the RGB pixels differed by at most 61 counts (55 over
# the first 128) and by 6.07 on average, the same pixels re-encoded 4:4:4
# (no upsampling) by at most 4, the one-channel output (luma: no chroma)
# by at most 1. The limits are those maxima and that mean with 30% over
# (6 and 2 for the small ones); R and B swapped differ by 39.3 on average,
# which the mean limit must stay under
IMAGE_CODEC_N = 128
IMAGE_CODEC_MAX, IMAGE_CODEC_MEAN = 80, 8.0
IMAGE_CODEC_444_MAX, IMAGE_CODEC_LUMA_MAX = 6, 2
# [image_dataset]: ImageRecordDataset under DataLoader(thread_pool=True)
# feeds the same net IMAGE_DATASET_STEPS steps
IMAGE_DATASET_STEPS = 3
# [image_serve]: the trained net in fp16 over batch rungs 1-64, closed loop:
# IMAGE_SERVE_REQUESTS requests of 1-8 images from IMAGE_SERVE_CLIENTS
# clients; each response within ZOO_EXPORT_TOL of the largest logit of a
# direct forward of the same images (fp16 logits ~10 carry ~1e-2 of
# rounding, and cuDNN picks other algorithms per batch size); a bias step
# of IMAGE_BIAS_STEP on the classifier shows in the next response within
# the same limit
IMAGE_SERVE_RUNGS = "1,2,4,8,16,32,64"
IMAGE_SERVE_REQUESTS, IMAGE_SERVE_CLIENTS = 64, 4
IMAGE_BIAS_STEP = 1.0
# [train_bert_adamw_fp16]: BERT-base fp16 (dropout 0.1, 8 x 512 tokens)
# with BERT's optimizer (Devlin et al. 2018, appendix A.2: Adam with
# decoupled weight decay 0.01, beta2 0.999; epsilon 1e-6 as in
# google-research's optimization.py, which takes lr * (m / (sqrt(v) + eps)
# + 0.01 * w) off each weight), multi-precision, under dynamic loss scaling
# from 2**16, until ADAMW_UPDATES updates were applied (at most
# ADAMW_MAX_STEPS steps); the checkpoint is taken after update CKPT_AT.
# MXNet's AdamW (eta 1) takes lr * m / (sqrt(v) + eps) + wd * w off, its
# decay not scaled by lr, so BERT's decay of 0.01 at lr 1e-4 is wd 1e-6
# (on every parameter here; BERT leaves LayerNorms and biases out)
ADAMW = dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-6,
             wd=1e-6, multi_precision=True)
ADAMW_UPDATES, ADAMW_MAX_STEPS, CKPT_AT = 4, 24, 2
# steps timed after the checks (and the checkpoint comparison) are done
ADAMW_TIMED_STEPS = 6
# The first update (w32' - w, with the masters starting as the fp16
# weights) against AdamW evaluated in fp64 from the same fp16 gradients, in
# relative L2 over the model; and the Adam term alone, lr * m / (sqrt(v) +
# eps) (the update with the fp64 decay wd * w added back), against its fp64
# value, so that the small decay term cannot carry the check. The fp32
# evaluation rounds ~8 times on the way to the update (<= 2^-24 relative
# each, ~5e-7 of it together); storing w32' rounds once more, by <= 2^-24
# of |w32'|. On the first step |m / sqrt(v)| is ~(1 - b1) / sqrt(1 - b2) =
# 3.16 wherever the gradient is well above eps, so the update is ~3.2e-4:
# against BERT's weights (std 0.02) that rounding is ~4e-6 of it, against
# a LayerNorm gamma of 1 ~2e-4, but the 25 gammas' 19,200 values (of the
# model's 1.3e8) carry ~1% of the update's norm, adding ~2e-6. So ~1e-5
# over the model at the most; 1e-4 leaves 10x.
ADAMW_FP64_TOL = 1e-4
# After a skipped step, the gradient the next backward deposits against a
# second backward of the same graph from no gradient at all: the same
# kernels on the same inputs give the same bits (0 expected); 1e-3 leaves
# room for any reduction whose order varies, while the fault repaired in
# autograd.backward (adding into .grad) leaves the skipped step's inf/NaN
# there, or twice the gradient (a distance of 1)
ADAMW_REPLAY_TOL = 1e-3
# BERT-base's parameters, every one fp16 in the fp16 phases: 12 layers of 12
# (attention qkv and proj, two LayerNorms, two FFN layers, each weight and
# bias), the two embeddings, the last LayerNorm and the head's two
TRAIN_FP16_PARAMS = 150
# [module_encoder]: a symbolic encoder at BERT-base's widths (Devlin et al.
# 2018: 12 layers, 768 units, 12 heads of 64, FFN 3072, WordPiece vocab
# 30522), 8 x 512 tokens, trained through Module.fit in fp32 with
# [train32]'s SGD (the loss a mean over tokens: rescale_grad 1 / 4096),
# one warm step and ENC_TIMED_STEPS more; held to the dense spelling of
# attention after REF_STEPS steps by [train32]'s limits
ENC_LAYERS, ENC_UNITS, ENC_HEADS = 12, 768, 12
ENC_FFN, ENC_VOCAB = 3072, 30522
ENC_B, ENC_T, ENC_TIMED_STEPS = 8, 512, 4
# [module_resnet50]: the exported zoo net through Module.fit at batch 256,
# fp32, one warm step and MODULE_RESNET_TIMED_STEPS more, after one step by
# hand whose stem BatchNorm is held to its closed form: new = momentum *
# old + (1 - momentum) * the batch's statistic (biased variance), computed
# here from the stem convolution's output. Max abs 1e-5: both sides sum
# ~3.2e6 fp32 values per channel in different orders (~1e-7 relative of
# statistics of order 1); a second update would leave the moving variance
# 0.09 * |1 - var| (~3e-2) off.
MODULE_RESNET_TIMED_STEPS, BN_ONCE_TOL = 5, 1e-5
# Module against the Gluon Trainer, two SGD steps at batch 4 from
# [resnet_check]'s weights, batch and rate. In fp32, each path's error
# against fp64 is at most RESNET32_ERR_RATIO times [resnet_check]'s card
# fp32 error e (the same ops on the same card; only the loss layer's
# rounding differs), so the two differ by at most (1 + ratio) * e in the
# losses and the running statistics. The update is not held in fp32:
# there e is ~31% of it, over the parameters with a gradient as over the
# whole model (fp32 does not determine this two-step update better), so
# no limit derived from e can reject a faulty second update. It is held
# in fp64, as [resnet_check] holds the card to the CPU: losses, update,
# worst parameter (noise biases left out) and statistics within
# RESNET64_TOL, and two faults planted in the Module's second update
# (skipped; without momentum) must fail that limit.
MODULE_GLUON_RATIO = 1.0 + RESNET32_ERR_RATIO
# [module_lenet]: train_mnist.py's synthetic digits and recipe (batch 64,
# lr 0.05, momentum 0.9) for 10 epochs (the example's default is 5, where
# this LeNet has only begun to learn: the JAX package and the port both
# score ~0.37 on the CPU); the score must beat chance (0.1) by 0.2
LENET_EXAMPLES, LENET_BATCH, LENET_EPOCHS, LENET_MARGIN = 2000, 64, 10, 0.2
# the fused step ([fused_bert], [fused_resnet50], [fused_symbol]): the
# eager loop twice and the fused step once from the same start, batch and
# generator states for FUSED_STEPS steps, the rate halved after FUSED_LR_AT
# (a per-step scalar: no new capture), then FUSED_TIMED timed steps of
# each and a profiled one
FUSED_STEPS, FUSED_LR_AT, FUSED_TIMED = 3, 2, 4
# where the eager step is not bit-reproducible (ResNet-50 on cuDNN's
# default algorithms), a parameter whose update two eager runs already
# put further apart than [train32]'s 1e-2 (the stem's convolution weight
# or BatchNorm gamma, 4.4e-2 and 4.7e-2 in two calls on the card: their
# gradients cancel over the 3.2M positions of the stem's output, summed
# in any order) is held to FUSED_NOISE_RATIO times that distance; a
# missed or doubled update is ~1 off
FUSED_NOISE_RATIO = 3.0
LADDER = "batch:1,2,4,8;seq:128,256,512"
# [sparse_linear]: example/sparse/linear_classification's widths (LIBSVM's
# Avazu: 1,000,001 features, batches of 8192), synthetic: each row holds one
# active feature (value 1) in each of 15 equal fields, drawn from a Zipf law
# of exponent 1.1 over the field's ids. AdaGrad (the example's default, lr
# 0.5), 1 + 8 steps. The gradient within 1e-5 (max abs over max abs) of an
# fp64 recomputation, the first two steps within 1e-5 of the CPU run of
# the same code; peak memory of the phase under 2 GB (one dense batch
# alone would be 8192 x 1,000,001 x 4 B = 32.8 GB)
AVAZU_FEATURES, AVAZU_FIELDS, AVAZU_BATCH = 1_000_001, 15, 8192
AVAZU_ZIPF, SPARSE_LINEAR_STEPS, SPARSE_LINEAR_LR = 1.1, 9, 0.5
SPARSE_LINEAR_TOL, SPARSE_LINEAR_PEAK = 1e-5, 2e9
# [sparse_embedding]: the One Billion Word LM's vocabulary at width 512
# (Jozefowicz et al. 2016; BASELINE config 5), 128 x 20 ids a step drawn
# from a Zipf law of exponent 1.0 over the frequency-ordered vocabulary,
# 1 + 6 steps each of lazy Adam and lazy SGD with momentum 0.9; the
# gradient within 1e-6 (max abs over max abs) of the per-id sums in fp64,
# each step's touched rows within 1e-6 of the dense optimizer's on them
EMB_VOCAB, EMB_DIM, EMB_BATCH, EMB_BPTT = 793_471, 512, 128, 20
EMB_ZIPF, EMB_STEPS, EMB_TOL = 1.0, 7, 1e-6
N_REQUESTS, CONCURRENCY = 24, 4
HEADS, HEAD_DIM = 12, 64


def _params_of(net):
    """``{structural name: tensor}`` of a port model (``0.weight``,
    ``features.1.running_var``): the names ``convert.py`` and ``.params``
    files use."""
    from mxnet_tpu_torch.gluon.parameter import collect_params
    return collect_params(net)


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


def _fp16_shapes(which):
    """Shapes of the fp16 parameters a training step of the path hands
    B1: BERT-base built in fp16 (150), ResNet-50 v1 cast to fp16 (87, its
    BatchNorm fp32)."""
    from mxnet_tpu_torch.models import BERTModel
    model = BERTModel(device="cuda", dtype=torch.float16) \
        if which == "bert" else _seeded_resnet50("cuda", "float16")
    shapes = [tuple(p.shape) for p in model.parameters()
              if p.requires_grad and p.dtype == torch.float16]
    del model
    torch.cuda.empty_cache()
    return shapes


def phase_sgd_multi_check(peaks):
    """B1's list form on the fp16 parameter lists of BERT-base and
    ResNet-50 (real shapes, random values, a distinct lr and wd per
    tensor, one tensor a view at an odd element offset), clip off and on:
    one launch per list, every output bit-equal to the per-tensor plain
    version. Timed against the same list through one list-of-one launch
    per tensor (the per-parameter path of earlier slices) and the bytes
    bound; ``torch._fused_sgd_`` over fp32 master weights, momenta and
    gradients, a function that writes no fp16 copy, for context."""
    from mxnet_tpu_torch.opt.kernels import (
        LAUNCHES, capacity, mp_sgd_mom_update_kernel,
        mp_sgd_mom_update_multi_kernel, mp_sgd_mom_update_multi_ref)
    rows = {}
    for which, want_n in (("bert", TRAIN_FP16_PARAMS),
                          ("resnet50", RESNET_FP16_PARAMS)):
        shapes = _fp16_shapes(which)
        if len(shapes) != want_n:
            raise SystemExit(f"chip_smoke: mp_sgd_multi: {which} has "
                             f"{len(shapes)} fp16 parameters, expected "
                             f"{want_n}")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        sizes = [int(np.prod(sh)) for sh in shapes]
        odd = 5  # this tensor is a view at an odd element offset

        def buf(n, dtype, k):
            off = 1 if k == odd else 0
            return torch.empty(n + off, dtype=dtype, device="cuda")[off:]

        ws, gs, ms, w32s = [], [], [], []
        for k, n in enumerate(sizes):
            w32 = buf(n, torch.float32, k)
            w32.copy_(torch.randn(n, device="cuda", generator=gen) * 0.02)
            m = buf(n, torch.float32, k)
            m.copy_(torch.randn(n, device="cuda", generator=gen) * 1e-3)
            g = buf(n, torch.float16, k)
            g.copy_(torch.randn(n, device="cuda", generator=gen) * 100)
            w = buf(n, torch.float16, k)
            w.copy_(w32)
            ws.append(w), gs.append(g), ms.append(m), w32s.append(w32)
        lrs = [TRAIN_LR * (1 + k % 5) / 5 for k in range(len(sizes))]
        wds = [1e-4 * (k % 3) for k in range(len(sizes))]
        row = {"list": which, "tensors": len(sizes), "values": sum(sizes),
               "median_values": int(np.median(sizes)),
               "unaligned_tensor": odd, "capacity": capacity()}
        for clip in (-1.0, 1.0):
            kw = dict(momentum=TRAIN_MOMENTUM, rescale_grad=1 / 64,
                      clip_gradient=clip)
            want = mp_sgd_mom_update_multi_ref(ws, gs, ms, w32s, lrs, wds,
                                               **kw)
            got = ([w.clone() for w in ws], [m.clone() for m in ms],
                   [w.clone() for w in w32s])
            before = LAUNCHES.count
            mp_sgd_mom_update_multi_kernel(got[0], gs, got[1], got[2], lrs,
                                           wds, **kw)
            torch.cuda.synchronize()
            launches = LAUNCHES.count - before
            bit_equal = all(torch.equal(a, b) for k in range(len(sizes))
                            for a, b in zip((got[0][k], got[1][k],
                                             got[2][k]), want[k]))
            err = max((a.float() - b.float()).abs().max().item()
                      for k in range(len(sizes))
                      for a, b in zip((got[0][k], got[1][k], got[2][k]),
                                      want[k]))
            row[f"clip_{clip}"] = {"launches": launches,
                                   "bit_equal": bit_equal,
                                   "max_abs_err": err}
            if launches != 1 or not bit_equal:
                raise SystemExit(f"chip_smoke: mp_sgd_multi on {which}, "
                                 f"clip {clip}: {launches} launches, "
                                 f"bit-equal {bit_equal} (max abs {err})")
            del want, got
        # timing: in place at a small rate, so the values stay finite
        kw = dict(momentum=TRAIN_MOMENTUM, rescale_grad=1 / 64)
        small = [1e-4] * len(sizes)

        def multi():
            mp_sgd_mom_update_multi_kernel(ws, gs, ms, w32s, small, wds,
                                           **kw)

        def singles():
            for k in range(len(sizes)):
                mp_sgd_mom_update_kernel(ws[k], gs[k], ms[k], w32s[k],
                                         lr=1e-4, wd=wds[k],
                                         out=(ws[k], ms[k], w32s[k]), **kw)

        def host_ms(fn, reps=20):
            """Host time of one call (launch cost, the device not
            waited for)."""
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda.synchronize()
            return t

        p32 = [w.clone() for w in w32s]
        g32 = [g.float() for g in gs]
        m32 = [m.clone() for m in ms]

        def fused_sgd():
            torch._fused_sgd_(p32, g32, m32, weight_decay=1e-4,
                              momentum=TRAIN_MOMENTUM, lr=1e-4, dampening=0.0,
                              nesterov=False, maximize=False,
                              is_first_step=False)

        bound = 20 * sum(sizes) / peaks["bytes"] * 1e3
        row.update(
            ms=cuda_ms(multi), single_launches_ms=cuda_ms(singles, iters=5),
            host_ms=host_ms(multi), single_launches_host_ms=host_ms(singles,
                                                                    5),
            plain_ms=cuda_ms(lambda: mp_sgd_mom_update_multi_ref(
                ws, gs, ms, w32s, small, wds, **kw), iters=3, warm=1),
            bound_ms=bound, bound_by="bytes",
            fused_sgd_fp32_context_ms=cuda_ms(fused_sgd),
            fused_sgd_note="torch._fused_sgd_ over fp32 master weights, "
                           "momenta and gradients: 20 bytes an element as "
                           "well, but no fp16 copy and fp32 gradients; not "
                           "the same function")
        row["bound_share"] = bound / row["ms"]
        row["single_launches_bound_share"] = bound / row["single_launches_ms"]
        log("[kernel] mp_sgd_multi " + json.dumps(row))
        rows[which] = row
        del ws, gs, ms, w32s, p32, g32, m32
        torch.cuda.empty_cache()
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


def _host_timed(fn, out):
    """``fn`` that appends its host time (ms) to ``out``: the launches'
    cost, the device not waited for."""
    def run():
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return run


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
    # one B1 launch a step updates all 150 fp16 parameters
    want.update({"flash_fwd": layers, "flash_bwd_dq": layers,
                 "flash_bwd_dkv": layers, "mp_sgd": 1,
                 "flash_fwd_tc": layers, "flash_bwd_dq_tc": layers,
                 "flash_bwd_dkv_tc": layers})
    if len(params) != TRAIN_FP16_PARAMS:
        raise SystemExit(f"chip_smoke: train: {len(params)} parameters, "
                         f"expected {TRAIN_FP16_PARAMS}")
    masters, missing, opt_host = [], [], []
    update = _checked(_host_timed(lambda: trainer.step(batch * LOSS_SCALE),
                                  opt_host), params, missing)

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
        "optimizer_host_ms_median": float(np.median(opt_host[1:])),
        "optimizer_host_ms": opt_host,
        "peak_memory_bytes": peak, "launches": totals,
        "loss_max_abs_diff_vs_ref": loss_err,
        "master_update_rel_l2_diff_vs_ref": upd_err,
        "worst_parameter_rel_diff": list(worst)}
    log("[train] " + json.dumps(summary))
    return totals


def _adamw_trainer(params):
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon import Trainer
    trainer = Trainer(params, "adamw", dict(ADAMW))
    amp.init_trainer(trainer)
    return trainer


def _adamw_step(model, trainer, plist, loss_fn, tokens, labels, events=None,
                replay=None, host=None, before_update=None):
    """One step of the dynamic-loss-scaling loop: ``scale_loss`` ->
    ``backward`` -> ``has_overflow`` -> ``update_scale`` -> ``step``,
    skipped on an overflow. Returns the mean loss (a device tensor) and
    the overflow flag. ``events`` (5 CUDA events) mark forward, backward,
    the overflow check and the update. With ``replay`` (a dict), the
    backward keeps its graph, the gradients it deposited are kept aside
    and the backward runs again from no gradient at all; ``replay["match"]`` is what :func:`_grad_match` says of the
    two, and ``replay["counts"]`` the launch counts before the second
    backward. ``host`` (a list) gets
    the host time of ``trainer.step``; ``before_update`` runs just before
    it."""
    from mxnet_tpu_torch import amp, autograd
    scaler = trainer._amp_loss_scaler
    if events:
        events[0].record()
    with autograd.record():
        loss = loss_fn(torch.flatten(model(tokens), 0, -2),
                       labels.reshape(-1))
        with amp.scale_loss(loss, trainer) as scaled:
            pass
    if events:
        events[1].record()
    autograd.backward(scaled, retain_graph=replay is not None)
    if replay is not None:
        replay["counts"] = {n: c.count for n, c in _train_counters().items()}
        deposited = [p.grad.clone() for p in plist]
        for p in plist:
            p.grad = None
        autograd.backward(scaled)
        replay["match"] = _grad_match(deposited, [p.grad for p in plist])
        del deposited
    if events:
        events[2].record()
    overflow = scaler.has_overflow(plist)
    if events:
        events[3].record()
    scaler.update_scale(overflow)
    if not overflow:
        if before_update is not None:
            before_update()
        t0 = time.perf_counter()
        trainer.step(TRAIN_B * TRAIN_T)
        if host is not None:
            host.append((time.perf_counter() - t0) * 1e3)
    if events:
        events[4].record()
    return loss.detach().float().mean(), overflow


def _adamw_state(plist, states):
    """Clones of the weights and of every optimizer state (fp32 master,
    mean, variance), by parameter."""
    out = [p.detach().clone() for p in plist]
    for i in sorted(states):
        w32, (mean, var) = states[i]
        out += [w32.clone(), mean.clone(), var.clone()]
    return out


def _grad_match(got, fresh):
    """Relative L2 distance of two gradient lists over the elements finite
    in both, and whether each is non-finite exactly where the other is
    (a step after a skip may overflow again, at a lower scale)."""
    pairs, same = [], True
    for a, b in zip(got, fresh):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        same = same and torch.equal(fa, fb)
        both = fa & fb
        pairs.append((torch.where(both, a, 0), torch.where(both, b, 0)))
    return _rel_l2_sum(pairs)[0], same


def _rel_l2_sum(pairs):
    """sqrt(sum ||a - b||^2 / sum ||b||^2) over ``(a, b)`` pairs, in fp64,
    and the worst pair's own ratio with its index."""
    d2 = r2 = 0.0
    worst = (0.0, -1)
    for k, (a, b) in enumerate(pairs):
        d = (a.double() - b.double()).norm().item()
        r = b.double().norm().item()
        d2, r2 = d2 + d * d, r2 + r * r
        if r > 0 and d / r > worst[0]:
            worst = (d / r, k)
    return (d2 / r2) ** 0.5, worst


def phase_train_adamw(card):
    """BERT-base in fp16 trained the way its users do: AdamW
    (multi-precision) under dynamic loss scaling, until ADAMW_UPDATES
    updates were applied; after the CKPT_AT-th, ``save_parameters`` and
    ``save_states`` for the checkpoint phase. Checks: each skipped step
    overflowed and changed nothing; the scale sequence is the LossScaler
    rule replayed on the host; the step after a skip deposits its own
    gradient only; the first update is AdamW's in fp64 from the same
    gradients; 12/12/12 attention launches on the tensor-core route and
    no B1; the loss finite and falling."""
    from mxnet_tpu_torch.gluon import collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.nn import Dropout
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = _seeded_bert(torch.float16)
    params = collect_params(model)
    plist = list(params.values())
    layers, vocab = len(model.layers), model.head.weight.shape[0]
    trainer = _adamw_trainer(params)
    scaler = trainer._amp_loss_scaler
    loss_fn = SoftmaxCrossEntropyLoss()
    tokens, labels = _train_batch(vocab)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    log(f"[train_bert_adamw_fp16] BERTModel(dtype=float16): {len(plist)} "
        f"parameters ({sum(p.numel() for p in plist)} values), {layers} "
        f"layers, dropout 0.1; batch {TRAIN_B} x {TRAIN_T}; AdamW {ADAMW}; "
        f"amp.init_trainer (loss scale {scaler.loss_scale}); built in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = _train_counters()
    want = dict.fromkeys(counters, 0)
    want.update({"flash_fwd": layers, "flash_bwd_dq": layers,
                 "flash_bwd_dkv": layers, "flash_fwd_tc": layers,
                 "flash_bwd_dq_tc": layers, "flash_bwd_dkv_tc": layers})
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckpt = {"dir": ckpt_dir,
            "params": os.path.join(ckpt_dir, "bert.params"),
            "states": os.path.join(ckpt_dir, "bert.states")}
    steps, applied, prev_overflow = [], 0, False
    fp64 = None
    totals = dict.fromkeys(counters, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(ADAMW_MAX_STEPS):
        if applied == ADAMW_UPDATES:
            break
        for c in counters.values():
            c.reset()
        states = trainer._updaters[0].states
        before = _adamw_state(plist, states)
        n_states = len(states)
        replay = {} if prev_overflow else None
        first = applied == 0
        if first:
            # the update's inputs, for the fp64 evaluation below
            w0 = [p.detach().clone() for p in plist]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        scale = scaler.loss_scale
        opt_host, fp64_in = [], []
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        loss, overflow = _adamw_step(
            model, trainer, plist, loss_fn, tokens, labels, events, replay,
            host=opt_host, before_update=(lambda: fp64_in.extend((
                [p.grad.clone() for p in plist],
                trainer._scale / (TRAIN_B * TRAIN_T)))) if first else None)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_step) * 1e3
        counts = replay["counts"] if replay is not None else \
            {n: c.count for n, c in counters.items()}
        for n in totals:
            totals[n] += counts[n] if n != "mp_sgd" else counters[n].count
        rec = {"step": i, "loss": loss.item(), "overflow": overflow,
               "loss_scale": scale, "next_scale": scaler.loss_scale,
               "wall_ms": wall,
               "windows_ms": [events[j].elapsed_time(events[j + 1])
                              for j in range(4)],
               "trainer_step_host_ms": opt_host[0] if opt_host else None,
               "checked_after_skip": replay is not None}
        if counts != want or counters["mp_sgd"].count != 0:
            raise SystemExit(f"chip_smoke: train_bert_adamw_fp16: step {i} "
                             f"launches {counts}, expected {want}")
        if not np.isfinite(rec["loss"]):
            raise SystemExit(f"chip_smoke: train_bert_adamw_fp16: step {i}: "
                             f"loss {rec['loss']}")
        if overflow:
            # (1) a skipped step had a non-finite gradient and changed
            # nothing: weights, masters and states bit-unchanged
            bad = [n for n, p in params.items()
                   if not torch.isfinite(p.grad).all().item()]
            after = _adamw_state(plist, trainer._updaters[0].states)
            same = len(trainer._updaters[0].states) == n_states and all(
                torch.equal(a, b) for a, b in zip(before, after))
            rec["non_finite_gradients"] = len(bad)
            if not bad or not same:
                raise SystemExit(f"chip_smoke: train_bert_adamw_fp16: "
                                 f"skipped step {i}: {len(bad)} non-finite "
                                 f"gradients, state unchanged {same}")
            del after
        else:
            applied += 1
        if replay is not None:
            # (3) after a skip, the deposited gradient is this step's own
            # (a second backward of the same graph from no gradient); the
            # old add-into-.grad rule would have left the skipped step's
            # inf/NaN in it
            rel, finite = replay["match"]
            rec["after_skip_grad_rel_l2_vs_fresh"] = rel
            if not (rel <= ADAMW_REPLAY_TOL and finite):
                raise SystemExit(f"chip_smoke: train_bert_adamw_fp16: step "
                                 f"{i} after a skip: the deposited gradient "
                                 f"is {rel:.3e} (rel. L2) from its own, "
                                 f"non-finite where it is: {finite}")
            del replay
        if first and not overflow:
            # (4) the first update against AdamW in fp64 from the same
            # fp16 gradients and weights (the masters start as the fp16
            # weights); the update, w32' - w0, in relative L2
            grads, rs = fp64_in
            states = trainer._updaters[0].states
            b1, b2, eps, lr, wd = (ADAMW[k] for k in (
                "beta1", "beta2", "epsilon", "learning_rate", "wd"))

            def adam_term(k):
                g = grads[k].double() * rs
                m, v = (1 - b1) * g, (1 - b2) * g * g
                return -lr * m / (v.sqrt() + eps)

            def update(k):
                return states[k][0].double() - w0[k].double()
            rel, worst = _rel_l2_sum(
                (update(k), adam_term(k) - wd * w0[k].double())
                for k in range(len(plist)))
            rel_adam, _ = _rel_l2_sum(
                (update(k) + wd * w0[k].double(), adam_term(k))
                for k in range(len(plist)))
            fp64 = {"update_rel_l2_vs_fp64": rel,
                    "adam_term_rel_l2_vs_fp64": rel_adam,
                    "worst_parameter": [worst[0], list(params)[worst[1]]],
                    "limit": ADAMW_FP64_TOL}
            log(f"[train_bert_adamw_fp16] first update vs AdamW in fp64: "
                f"{json.dumps(fp64)}")
            if max(rel, rel_adam) > ADAMW_FP64_TOL:
                raise SystemExit("chip_smoke: train_bert_adamw_fp16: the "
                                 "first update is not AdamW's")
            del grads, w0
        del fp64_in, before
        log(f"[train_bert_adamw_fp16] step {i}: " + json.dumps(rec))
        steps.append(rec)
        prev_overflow = overflow
        if not overflow and applied == CKPT_AT:
            t_save = time.perf_counter()
            model.save_parameters(ckpt["params"])
            trainer.save_states(ckpt["states"])
            ckpt.update(
                save_s=time.perf_counter() - t_save,
                params_bytes=os.path.getsize(ckpt["params"]),
                states_bytes=os.path.getsize(ckpt["states"]),
                weights={n: p.detach().clone() for n, p in params.items()},
                generators=[d._gen.get_state() for d in drops],
                scaler=dict(vars(scaler)), step=i)
    if applied != ADAMW_UPDATES:
        raise SystemExit(f"chip_smoke: train_bert_adamw_fp16: {applied} "
                         f"updates in {ADAMW_MAX_STEPS} steps")
    # (2) the scale sequence is the LossScaler rule replayed on the host
    s, clean, replayed = 2.0 ** 16, 0, []
    for r in steps:
        if r["overflow"]:
            s, clean = max(s / 2, 1), 0
        else:
            clean += 1
            if clean == 2000:
                s, clean = s * 2, 0
        replayed.append(s)
    if replayed != [r["next_scale"] for r in steps] or \
            steps[0]["loss_scale"] != 2.0 ** 16:
        raise SystemExit(f"chip_smoke: train_bert_adamw_fp16: scales "
                         f"{[r['next_scale'] for r in steps]}, the rule "
                         f"gives {replayed}")
    # (6) the loss falls over the applied updates
    losses = [r["loss"] for r in steps if not r["overflow"]]
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: train_bert_adamw_fp16: loss over the "
                         f"applied updates {losses}")
    summary = {
        "card": card, "batch": [TRAIN_B, TRAIN_T], "optimizer": ADAMW,
        "steps": len(steps), "updates": applied,
        "skipped_steps": [r["step"] for r in steps if r["overflow"]],
        "steps_checked_after_skip": [r["step"] for r in steps
                                     if r["checked_after_skip"]],
        "loss_scales": [r["loss_scale"] for r in steps],
        "losses_applied": losses, "first_update_vs_fp64": fp64,
        "step_wall_ms": [r["wall_ms"] for r in steps],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": totals}
    run = {"model": model, "trainer": trainer, "params": params,
           "plist": plist, "loss_fn": loss_fn, "tokens": tokens,
           "labels": labels, "ckpt": ckpt, "summary": summary,
           "drops": drops}
    return run


def phase_checkpoint(card, run):
    """Resume from the AdamW phase's checkpoint (taken after its
    CKPT_AT-th update) into a fresh model and trainer, with the dropout
    generators and the loss scaler set where the first run's stood (what
    neither file holds, as in the reference), and make the same updates
    on the same batch: weights, fp32 masters, means and variances
    bit-equal to the uninterrupted run. The saved ``.params`` decode with
    the port's reader to the tensors saved."""
    from mxnet_tpu_torch.gluon import collect_params
    from mxnet_tpu_torch.gluon.nn import Dropout
    from mxnet_tpu_torch.ndarray import serialization
    ckpt = run["ckpt"]
    decoded = serialization.load(ckpt["params"], device="cuda")
    if sorted(decoded) != sorted(ckpt["weights"]) or not all(
            decoded[n].dtype == w.dtype and torch.equal(decoded[n], w)
            for n, w in ckpt["weights"].items()):
        raise SystemExit("chip_smoke: checkpoint: the .params file does "
                         "not decode to the saved tensors")
    del decoded
    t0 = time.perf_counter()
    fresh = _seeded_bert(torch.float16)
    fresh.load_parameters(ckpt["params"])
    for d, st in zip([m for m in fresh.modules()
                      if isinstance(m, Dropout)], ckpt["generators"]):
        d._gen.set_state(st)
    params = collect_params(fresh)
    plist = list(params.values())
    trainer = _adamw_trainer(params)
    trainer.load_states(ckpt["states"])
    vars(trainer._amp_loss_scaler).update(ckpt["scaler"])
    load_s = time.perf_counter() - t0
    applied, steps = CKPT_AT, 0
    while applied < ADAMW_UPDATES and steps < ADAMW_MAX_STEPS:
        _, overflow = _adamw_step(fresh, trainer, plist, run["loss_fn"],
                                  run["tokens"], run["labels"])
        applied += not overflow
        steps += 1
    torch.cuda.synchronize()
    ref_states = run["trainer"]._updaters[0].states
    got_states = trainer._updaters[0].states
    want_t = _adamw_state(run["plist"], ref_states)
    got_t = _adamw_state(plist, got_states)
    equal = (sorted(ref_states) == sorted(got_states)
             and len(want_t) == len(got_t)
             and all(torch.equal(a, b) for a, b in zip(want_t, got_t)))
    counts_equal = trainer.optimizer._index_update_count == \
        run["trainer"].optimizer._index_update_count
    summary = {
        "card": card, "saved_after_update": CKPT_AT,
        "saved_at_step": ckpt["step"], "resumed_steps": steps,
        "params_bytes": ckpt["params_bytes"],
        "states_bytes": ckpt["states_bytes"], "save_s": ckpt["save_s"],
        "load_s": load_s, "tensors_compared": len(got_t),
        "bit_equal": equal, "update_counts_equal": counts_equal,
        "loss_scale": trainer._amp_loss_scaler.loss_scale}
    log("[checkpoint] " + json.dumps(summary))
    shutil.rmtree(ckpt["dir"], ignore_errors=True)
    if not (equal and counts_equal):
        raise SystemExit("chip_smoke: checkpoint: the resumed run differs "
                         "from the uninterrupted one")
    del fresh, trainer, want_t, got_t, params, plist
    torch.cuda.empty_cache()


def _leaf_walk_ms(run, reps=5):
    """Host time of the walk ``autograd.backward`` makes over the step's
    graph to find the leaves it writes (the median of ``reps``), on the
    graph of one more forward, which is then dropped."""
    from mxnet_tpu_torch import autograd
    model, loss_fn = run["model"], run["loss_fn"]
    with autograd.record():
        loss = loss_fn(torch.flatten(model(run["tokens"]), 0, -2),
                       run["labels"].reshape(-1))
    torch.cuda.synchronize()
    nodes, times = set(), []
    for _ in range(reps):
        t0 = time.perf_counter()
        leaves = autograd._reached_leaves([loss])
        times.append((time.perf_counter() - t0) * 1e3)
    stack = [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and fn not in nodes:
            nodes.add(fn)
            stack.extend(nxt for nxt, _ in fn.next_functions)
    del loss
    return {"leaf_walk_host_ms": float(np.median(times)),
            "leaf_walk_graph_nodes": len(nodes),
            "leaf_walk_leaves": len(leaves)}


def phase_adamw_profile(run):
    """ADAMW_TIMED_STEPS more steps of the AdamW run, timed (in the run
    above most steps are skipped, and each step after a skip runs a second
    backward for its check), then one more under the profiler: the
    device's kernel time against the applied steps' median wall, and the
    kernels that take the most."""
    summary = run["summary"]
    args = (run["model"], run["trainer"], run["plist"], run["loss_fn"],
            run["tokens"], run["labels"])
    recs = []
    for _ in range(ADAMW_TIMED_STEPS):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        host = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, overflow = _adamw_step(*args, events, host=host)
        torch.cuda.synchronize()
        recs.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                     "overflow": overflow,
                     "windows_ms": [events[j].elapsed_time(events[j + 1])
                                    for j in range(4)],
                     "trainer_step_host_ms": host[0] if host else None})
    applied = [r for r in recs if not r["overflow"]]
    if not applied:
        raise SystemExit("chip_smoke: train_bert_adamw_fp16: every timed "
                         "step overflowed")

    def med(f):
        return float(np.median([f(r) for r in applied]))
    wall = med(lambda r: r["wall_ms"])
    walk = _leaf_walk_ms(run)
    kernel_ms, ours, top = profiled_step(lambda: _adamw_step(*args))
    summary.update(
        timed_steps=recs, applied_step_wall_ms_median=wall,
        tokens_per_s=TRAIN_B * TRAIN_T / (wall / 1e3),
        forward_ms=med(lambda r: r["windows_ms"][0]),
        backward_ms=med(lambda r: r["windows_ms"][1]),
        overflow_check_ms=med(lambda r: r["windows_ms"][2]),
        optimizer_ms=med(lambda r: r["windows_ms"][3]),
        trainer_step_host_ms=med(lambda r: r["trainer_step_host_ms"]),
        profiled_kernel_ms=kernel_ms, device_busy_share=kernel_ms / wall,
        kernel_ms_in_step=ours, top_kernels_ms=top, **walk)
    if not all(ours[n] > 0 for n in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")) or ours["mp_sgd"]:
        raise SystemExit(f"chip_smoke: train_bert_adamw_fp16: profiled "
                         f"kernel time {ours}")
    log("[train_bert_adamw_fp16] " + json.dumps(summary))
    run.clear()
    torch.cuda.empty_cache()
    return summary


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
    return totals, summary


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
    names = list(_params_of(model))
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
        params = _params_of(net)
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
        rel. L2 over the model and over the parameters with a gradient
        (noise biases left out: ``update_kept``) and the worst of those,
        the running statistics' after each step and the predict-mode
        logits' rel. L2."""
        upd, _ = _update_diff([got["weights"][n] for n in trained],
                              [ref["weights"][n] for n in trained],
                              [init[n] for n in trained], trained)
        upd_kept, worst = _update_diff([got["weights"][n] for n in kept],
                                       [ref["weights"][n] for n in kept],
                                       [init[n] for n in kept], kept)
        return {"loss": max(abs(a - b).item() for a, b in
                            zip(got["losses"], ref["losses"])),
                "update": upd, "update_kept": upd_kept,
                "worst_parameter": list(worst),
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
    return card32


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
    params = _params_of(net)
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
    want["mp_sgd"] = 1  # one launch a step for the 87 fp16 parameters
    trainable = [p for p in params.values() if p.requires_grad]
    grad_max, rates, masters, missing, opt_host = [], [], [], [], []

    def update():
        # the largest |gradient| of the step, read after it: a non-finite
        # value fails the run (a few launches inside the optimizer window)
        g16 = [p.grad for p in trainable if p.dtype == torch.float16]
        g32 = [p.grad for p in trainable if p.dtype == torch.float32]
        grad_max.append(torch.maximum(
            torch.stack(torch._foreach_norm(g16, float("inf"))).float()
            .max(), torch.stack(torch._foreach_norm(g32, float("inf")))
            .max()))
        t0 = time.perf_counter()
        trainer.step(RESNET_B * RESNET_LOSS_SCALE)
        opt_host.append((time.perf_counter() - t0) * 1e3)
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
        "b1_launches_per_step": totals["mp_sgd"] / RESNET_STEPS,
        "b1_tensors_per_step": RESNET_FP16_PARAMS,
        "trainer_step_host_ms_median": float(np.median(opt_host[1:])),
        "trainer_step_host_ms": opt_host,
        "b1_values_per_step": sum(sizes16),
        "b1_median_values_per_launch": int(np.median(sizes16)),
        "b1_bound_ms_per_step": 20 * sum(sizes16) / peaks["bytes"] * 1e3,
        "b1_bound_by": "bytes",
        "b1_share_of_optimizer": ours["mp_sgd"] / opt_ms,
        "b1_bound_share": 20 * sum(sizes16) / peaks["bytes"] * 1e3
        / ours["mp_sgd"],
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
    ref_params = _params_of(ref)
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
    return totals, summary


# -- the mx.nd surface (slice 11) -----------------------------------------------

# nd ops on the card against the same op on the CPU, on the same fp32
# inputs (TF32 off): an elementwise op agrees to a few fp32 ulps (rtol 1e-5,
# atol 1e-6: CUDA's and the CPU's libm differ in the last bits); an op
# that sums (GEMM, convolution, reductions, normalizations, softmax,
# pooling, resizes) may sum in another order on cuBLAS / cuDNN / ATen's
# CUDA kernels: rtol 1e-4, atol 1e-5
ND_TOL_EXACT, ND_TOL_SUMS = (1e-5, 1e-6), (1e-4, 1e-5)
ND_SUMS = {
    "dot", "batch_dot", "FullyConnected", "Convolution", "Deconvolution",
    "khatri_rao", "_fused_attention", "norm", "sum", "nansum", "mean",
    "prod", "nanprod", "moments", "_square_sum", "add_n", "cumsum",
    "softmax", "log_softmax", "softmin", "SoftmaxActivation",
    "SoftmaxOutput", "softmax_cross_entropy", "BatchNorm", "LayerNorm",
    "GroupNorm", "InstanceNorm", "L2Normalization", "LRN", "Pooling",
    "_contrib_AdaptiveAvgPooling2D", "_contrib_BilinearResize2D",
    "UpSampling", "_random_pdf_dirichlet", "multi_all_finite", "gamma",
    "gammaln", "_random_pdf_gamma", "_random_pdf_poisson",
    "_random_pdf_negative_binomial",
    "_random_pdf_generalized_negative_binomial", "erfinv", "RNN", "CTCLoss",
    "_contrib_DeformableConvolution", "_cvimresize", "_image_resize"}
# the random image ops draw as the samplers do: held by shape, dtype and
# finiteness
ND_SAMPLERS = ("_random_", "_sample_", "_shuffle", "_image_random_")
ND_ATTN = (8, HEADS, 512, 512, HEAD_DIM)
ND_ATTN_COUNTS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                  "fwd_tensor_core", "dq_tensor_core", "dkv_tensor_core",
                  "split_bf16x3")


def _nd_inputs(name, info, rs, tmp):
    """Inputs and params for op ``name`` as numpy arrays: the curated
    cases of ``tests/test_op_sweep.py::CASES`` for the ops that need them
    (copied here, as this script imports nothing of the tests), a JPEG for
    the decode ops (``_cvimread``'s file written under ``tmp``), else
    (2, 3, 4) tensors, one per required input."""
    def T(*s, lo=0.1, hi=0.9):
        return rs.uniform(lo, hi, s).astype(np.float32)

    def I(*s, hi=3):
        return rs.randint(0, hi, s).astype(np.float32)

    def softmax_rows(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    arr = np.array
    quads = [T(3, 4), T(3, 4), T(3, 4), T(3, 4), T(2, 2), T(2, 2),
             T(2, 2), T(2, 2)]
    cases = {
        "pick": lambda: ([T(4, 5), I(4, hi=5)], {}),
        "_graph_const": lambda: ([], {"data": [[1.0, 2.0], [3.0, 4.0]],
                                      "shape": (2, 2), "dtype": "float32"}),
        "_fused_attention": lambda: ([T(2, 2, 8, 4), T(2, 2, 8, 4),
                                      T(2, 2, 8, 4)], {"scale": 0.5}),
        "dot": lambda: ([T(3, 4), T(4, 5)], {}),
        "batch_dot": lambda: ([T(2, 3, 4), T(2, 4, 5)], {}),
        "reshape": lambda: ([T(2, 6)], {"shape": (3, 4)}),
        "slice": lambda: ([T(4, 5)], {"begin": (1, 0), "end": (3, 4)}),
        "tile": lambda: ([T(2, 3)], {"reps": (2, 2)}),
        "reverse": lambda: ([T(3, 4)], {"axis": 1}),
        "depth_to_space": lambda: ([T(1, 8, 2, 3)], {"block_size": 2}),
        "space_to_depth": lambda: ([T(1, 2, 4, 6)], {"block_size": 2}),
        "broadcast_to": lambda: ([T(1, 3)], {"shape": (4, 3)}),
        "broadcast_axis": lambda: ([T(1, 3)], {"axis": 0, "size": 4}),
        "Pad": lambda: ([T(1, 2, 4, 4)], {
            "mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)}),
        "batch_take": lambda: ([T(4, 5), I(4, hi=5)], {}),
        "scatter_nd": lambda: ([T(3), arr([[0, 2, 1]], np.float32)],
                               {"shape": (4,)}),
        "_scatter_set_nd": lambda: ([T(4), T(3), arr([[0, 2, 1]],
                                                     np.float32)],
                                    {"shape": (4,)}),
        "_ravel_multi_index": lambda: ([arr([[0, 1], [1, 2]], np.float32)],
                                       {"shape": (3, 4)}),
        "_unravel_index": lambda: ([arr([5, 7], np.float32)],
                                   {"shape": (3, 4)}),
        "FullyConnected": lambda: ([T(2, 5), T(4, 5), T(4)],
                                   {"num_hidden": 4}),
        "Deconvolution": lambda: ([T(1, 2, 4, 4), T(2, 3, 2, 2)], {
            "kernel": (2, 2), "num_filter": 3, "no_bias": True}),
        "Pooling": lambda: ([T(1, 2, 6, 6)], {
            "kernel": (2, 2), "pool_type": "max", "stride": (2, 2)}),
        "_contrib_AdaptiveAvgPooling2D": lambda: ([T(1, 2, 8, 8)],
                                                  {"output_size": 2}),
        "UpSampling": lambda: ([T(1, 2, 4, 4)], {"scale": 2,
                                                 "sample_type": "nearest"}),
        "_contrib_BilinearResize2D": lambda: ([T(1, 2, 4, 4)],
                                              {"height": 8, "width": 8}),
        "softmax_cross_entropy": lambda: ([T(4, 5), I(4, hi=5)], {}),
        "SoftmaxOutput": lambda: ([T(4, 5), I(4, hi=5)], {}),
        "SVMOutput": lambda: ([T(4, 5), I(4, hi=5)], {}),
        "BatchNorm": lambda: ([T(2, 3, 4, 4), T(3), T(3), T(3), T(3)], {}),
        "LayerNorm": lambda: ([T(2, 5), T(5), T(5)], {}),
        "GroupNorm": lambda: ([T(2, 4, 3, 3), T(4), T(4)],
                              {"num_groups": 2}),
        "InstanceNorm": lambda: ([T(2, 3, 5), T(3), T(3)], {}),
        "LRN": lambda: ([T(1, 4, 5, 5)], {"nsize": 3}),
        "Crop": lambda: ([T(1, 2, 8, 8)], {"h_w": (4, 4),
                                           "center_crop": True}),
        "arccosh": lambda: ([T(2, 3, lo=1.1, hi=3.0)], {}),
        "rmspropalex_update": lambda: ([T(3, 4), T(3, 4),
                                        T(3, 4, lo=1.0, hi=2.0),
                                        T(3, 4, lo=0.0, hi=0.5), T(3, 4)],
                                       {}),
        "multi_sgd_update": lambda: ([T(3, 4), T(3, 4), T(2, 2), T(2, 2)], {
            "lrs": (0.1, 0.1), "wds": (0, 0), "num_weights": 2}),
        "multi_sgd_mom_update": lambda: (
            [T(3, 4), T(3, 4), T(3, 4), T(2, 2), T(2, 2), T(2, 2)],
            {"lrs": (0.1, 0.1), "wds": (0, 0), "momentum": 0.9,
             "num_weights": 2}),
        "multi_mp_sgd_update": lambda: (
            [T(3, 4), T(3, 4), T(3, 4), T(2, 2), T(2, 2), T(2, 2)],
            {"lrs": (0.1, 0.1), "wds": (0, 0), "num_weights": 2}),
        "multi_mp_sgd_mom_update": lambda: (quads, {
            "lrs": (0.1, 0.1), "wds": (0, 0), "momentum": 0.9,
            "num_weights": 2}),
        "_contrib_boolean_mask": lambda: ([T(5, 3), arr([0, 1, 0, 1, 1],
                                                        np.float32)], {}),
        "_random_randint": lambda: ([], {"low": 0, "high": 5,
                                         "shape": (3, 4)}),
        "_sample_multinomial": lambda: ([softmax_rows(T(2, 5))],
                                        {"shape": (3,)}),
        "_sample_unique_zipfian": lambda: ([], {"range_max": 100,
                                                "shape": (1, 8)}),
        "_shuffle": lambda: ([T(6, 3)], {}),
        "_sample_uniform": lambda: ([T(3), T(3, lo=1.1, hi=2.0)],
                                    {"shape": (4,)}),
        "_sample_negative_binomial": lambda: ([I(3, hi=5) + 1, T(3)],
                                              {"shape": (4,)}),
        # an LSTM of 4 over 3 inputs: 144 parameters
        "RNN": lambda: ([T(5, 2, 3), T(144, lo=-0.1, hi=0.1),
                         np.zeros((1, 2, 4), np.float32),
                         np.zeros((1, 2, 4), np.float32)],
                        {"state_size": 4, "num_layers": 1, "mode": "lstm",
                         "state_outputs": True}),
        "CTCLoss": lambda: ([T(6, 2, 5), arr([[1, 2], [2, 3]], np.float32)],
                            {}),
        "_contrib_DeformableConvolution": lambda: (
            [T(1, 2, 6, 6), np.zeros((1, 18, 4, 4), np.float32),
             T(3, 2, 3, 3)], {"kernel": (3, 3), "num_filter": 3,
                              "no_bias": True}),
    }
    if name in ("_cvimdecode", "_cvimread"):
        import cv2
        jpeg = cv2.imencode(".jpg", (T(13, 17, 3) * 255).astype(np.uint8))[1]
        if name == "_cvimdecode":
            return [jpeg.reshape(-1)], {}
        path = os.path.join(tmp, "image.jpg")
        with open(path, "wb") as f:
            f.write(jpeg.tobytes())
        return [], {"filename": path}
    # the image ops on HWC images (the sweep's cases)
    image_params = {
        "_cvimresize": {"w": 8, "h": 6},
        "_image_adjust_lighting": {"alpha": (0.1,) * 3},
        "_image_random_flip_left_right": {},
        "_image_random_flip_top_bottom": {},
        "_image_random_brightness": {"min_factor": 0.5, "max_factor": 1.5},
        "_image_random_contrast": {"min_factor": 0.5, "max_factor": 1.5},
        "_image_random_saturation": {"min_factor": 0.5, "max_factor": 1.5},
        "_image_random_hue": {"min_factor": 0.8, "max_factor": 1.2},
        "_image_random_color_jitter": {"brightness": 0.2, "contrast": 0.2,
                                       "saturation": 0.2, "hue": 0.1},
        "_image_random_lighting": {"alpha_std": 0.05}}
    if name in image_params:
        return [T(6, 6, 3)], dict(image_params[name])
    if name in cases:
        return cases[name]()
    if name.startswith("_random_") and not name.startswith("_random_pdf") \
            and not name.endswith("_like"):
        return [], {"shape": (3, 4)}
    if name.startswith("_sample_"):
        n = sum(1 for a in info.arg_names if a not in info.defaults
                and a != "*")
        return [T(3) for _ in range(n)], {"shape": (4,)}
    n = 0
    for a in info.arg_names:
        if a == "*":
            n = max(n, 1)
            break
        if a in info.defaults:
            break
        n += 1
    return [T(2, 3, 4) for _ in range(n)], {}


def _nd_sweep():
    """Every registered dense op (one name per function; not the
    control-flow graph nodes) on the card and on the CPU, on the same
    inputs; returns the rows and the stub count."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops.control_flow import GRAPH_NODES
    from mxnet_tpu_torch.ops.registry import _OPS
    seen = {}
    for info in _OPS.values():
        # the control-flow nodes take sub-Symbols, not arrays
        # (tests/test_torch_control_flow.py drives them)
        if not info.stub and info.name not in GRAPH_NODES:
            seen.setdefault(id(info.fn), info)
    stubs = sorted(n for n, i in _OPS.items() if i.stub)
    rows, bad = [], []
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp()
    for info in sorted(seen.values(), key=lambda i: i.name):
        name = info.name
        args, params = _nd_inputs(name, info, np.random.RandomState(SEED),
                                  tmp)
        outs = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            mx.random.seed(SEED)
            with ctx:
                res = getattr(nd, name)(*[nd.array(a, dtype=a.dtype)
                                          for a in args], **params)
            outs[ctx.device_type] = res if isinstance(res, list) else [res]
        sampler = name.startswith(ND_SAMPLERS) \
            and not name.startswith("_random_pdf")
        rtol, atol = ND_TOL_SUMS if name in ND_SUMS else ND_TOL_EXACT
        worst, ok = 0.0, len(outs["cpu"]) == len(outs["gpu"])
        for c, g in zip(outs["cpu"], outs["gpu"]):
            ok &= g._data.is_cuda and c.shape == g.shape \
                and c.dtype == g.dtype
            if sampler or not ok:
                ok &= bool(torch.isfinite(g._data.float()).all())
                continue
            cn = c.asnumpy().astype(np.float64)
            gn = g.asnumpy().astype(np.float64)
            same_nan = np.array_equal(np.isnan(cn), np.isnan(gn))
            fin = np.isfinite(cn) & np.isfinite(gn)
            share = float(np.max(np.abs(gn - cn)[fin]
                                 / (atol + rtol * np.abs(cn[fin])),
                                 initial=0.0))
            worst = max(worst, share)
            ok &= same_nan and np.array_equal(cn[~fin], gn[~fin],
                                              equal_nan=True) and share <= 1
        rows.append({"op": name, "outputs": len(outs["gpu"]),
                     "sampler": sampler, "limit_share": worst,
                     "tol": None if sampler else [rtol, atol]})
        if not ok:
            bad.append(rows[-1])
    shutil.rmtree(tmp)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    if bad:
        raise SystemExit(f"chip_smoke: nd_ops: card and CPU disagree or an "
                         f"output left the card: {bad[:10]}")
    return rows, stubs


def _nd_b1(shapes):
    """``nd.mp_sgd_mom_update`` over each of ``shapes`` (with ``out=``) and
    ``nd.multi_mp_sgd_mom_update`` over all of them: B1's launches and
    bit-equality with the plain update, tensor by tensor."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.opt import kernels as opt_kernels
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lrs = [0.01 * (1 + i % 5) for i in range(len(shapes))]
    wds = [1e-4 * (i % 3) for i in range(len(shapes))]

    def quads():
        out = []
        for s in shapes:
            w32 = torch.randn(s, device="cuda", generator=gen)
            out.append([w32.half(), torch.randn(s, device="cuda",
                                                generator=gen).half(),
                        torch.randn(s, device="cuda", generator=gen) * 0.01,
                        w32])
        return out

    ref_in = quads()
    ref = [opt_kernels.mp_sgd_mom_update_ref(w, g, m, w32, lr, 0.9, wd)
           for (w, g, m, w32), lr, wd in zip(ref_in, lrs, wds)]
    result = {}
    for form in ("single", "multi"):
        arrs = [[nd.array(t) for t in q] for q in ref_in]
        torch.cuda.synchronize()
        opt_kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        with mx.gpu(0):
            if form == "single":
                for (w, g, m, w32), lr, wd in zip(arrs, lrs, wds):
                    nd.mp_sgd_mom_update(w, g, m, w32, lr=lr, momentum=0.9,
                                         wd=wd, out=w)
            else:
                nd.multi_mp_sgd_mom_update(
                    *[a for q in arrs for a in q], lrs=lrs, wds=wds,
                    momentum=0.9, num_weights=len(shapes),
                    out=[q[0] for q in arrs])
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        launches = opt_kernels.LAUNCHES.count
        equal = all(torch.equal(a._data, r) for q, rq in zip(arrs, ref)
                    for a, r in zip((q[0], q[2], q[3]), rq))
        result[form] = {"launches": launches, "bit_equal": equal,
                        "host_ms": host_ms}
        del arrs
    cap = opt_kernels.capacity()
    want = {"single": len(shapes), "multi": -(-len(shapes) // cap)}
    if any(result[f]["launches"] != want[f] or not result[f]["bit_equal"]
           for f in want):
        raise SystemExit(f"chip_smoke: nd_ops: nd's B1 routes {result}, "
                         f"expected {want} launches, bit-equal")
    return result


def _nd_attention():
    """``nd._fused_attention`` at the training rung, fp16 and fp32: the
    forward on B2's tensor-core route, the backward under ``record`` on
    B3/B4's, each against the plain version within FWD_TOL / BWD_TOL."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ops.flash_attention import (
        LAUNCHES, LAUNCHES_DKV, LAUNCHES_DKV_TC, LAUNCHES_DKV_TC32,
        LAUNCHES_DQ, LAUNCHES_DQ_TC, LAUNCHES_DQ_TC32, LAUNCHES_SPLIT,
        LAUNCHES_TC, LAUNCHES_TC32, flash_attention_ref_bwd,
        flash_attention_ref_fwd)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, Tq, Tk, D = ND_ATTN
    scale = 1 / D ** 0.5
    rows = []
    for dtype, tc in ((torch.float16, (LAUNCHES_TC, LAUNCHES_DQ_TC,
                                       LAUNCHES_DKV_TC)),
                      (torch.float32, (LAUNCHES_TC32, LAUNCHES_DQ_TC32,
                                       LAUNCHES_DKV_TC32))):
        ts = [torch.randn(B, H, T, D, device="cuda", generator=gen).to(dtype)
              for T in (Tq, Tk, Tk, Tq)]
        counters = (LAUNCHES, LAUNCHES_DQ, LAUNCHES_DKV) + tc \
            + (LAUNCHES_SPLIT,)
        for c in counters:
            c.reset()
        with mx.gpu(0):
            q, k, v, dout = (nd.array(t) for t in ts)
            fwd = nd._fused_attention(q, k, v, scale=scale)
            torch.cuda.synchronize()
            fwd_launches = [c.count for c in counters]
            for a in (q, k, v):
                a.attach_grad()
            with autograd.record():
                out = nd._fused_attention(q, k, v, scale=scale)
            out.backward(dout)
        torch.cuda.synchronize()
        all_launches = [c.count for c in counters]
        f32 = [t.float() for t in ts[:3]]
        ref_out, ref_lse = flash_attention_ref_fwd(*f32, False, scale)
        ref_grads = flash_attention_ref_bwd(*f32, ref_out, ref_lse,
                                            ts[3].float(), False, scale)
        name = str(dtype).replace("torch.", "")
        fwd_err = max((o._data.float() - ref_out).abs().max().item()
                      for o in (fwd, out))
        atol, rtol = BWD_TOL[name]
        share = max(((a.grad._data.float() - r).abs()
                     / (atol + rtol * r.abs())).max().item()
                    for a, r in zip((q, k, v), ref_grads))
        row = {"shape": list(ND_ATTN), "dtype": name,
               "forward_launches": dict(zip(ND_ATTN_COUNTS, fwd_launches)),
               "launches": dict(zip(ND_ATTN_COUNTS, all_launches)),
               "max_abs_err": fwd_err, "tol": FWD_TOL[name],
               "grad_limit_share": share,
               "on_card": all(a._data.is_cuda for a in (fwd, out, q.grad))}
        rows.append(row)
        # the fp32 route splits its operands once a forward and once a
        # backward
        splits = int(dtype == torch.float32)
        if not (fwd_launches == [1, 0, 0, 1, 0, 0, splits]
                and all_launches == [2, 1, 1, 2, 1, 1, 3 * splits]
                and fwd_err <= FWD_TOL[name] and share <= 1.0
                and row["on_card"]):
            raise SystemExit(f"chip_smoke: nd_ops: nd._fused_attention "
                             f"{row}")
        del ts, q, k, v, dout, fwd, out
    return rows


def _nd_host_cost():
    """Host microseconds of one nd call against the bare torch call on a
    small tensor on the card (reported, not gated)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    with mx.gpu(0):
        x = nd.ones((64,))
    t = x._data
    pairs = {"relu": (lambda: nd.relu(x), lambda: torch.relu(t)),
             "add_scalar": (lambda: x + 1.0, lambda: t + 1.0),
             "broadcast_mul": (lambda: nd.broadcast_mul(x, x),
                               lambda: torch.mul(t, t))}
    out = {}
    for key, fns in pairs.items():
        us = []
        for fn in fns:
            for _ in range(200):
                fn()
            best = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(2000):
                    fn()
                best.append((time.perf_counter() - t0) / 2000 * 1e6)
            us.append(min(best))
        torch.cuda.synchronize()
        out[key] = {"nd_us": us[0], "torch_us": us[1],
                    "boundary_us": us[0] - us[1]}
    return out


def phase_nd_ops():
    """The ``mx.nd`` surface on the card: every dense op against the CPU,
    the nd routes to B1 on BERT-base's 150 fp16 parameters, the nd route
    to B2/B3/B4, and the host cost of the nd boundary."""
    t0 = time.perf_counter()
    rows, stubs = _nd_sweep()
    worst = sorted(rows, key=lambda r: -r["limit_share"])[:5]
    log(f"[nd_ops] {len(rows)} ops checked on the card against the CPU "
        f"({sum(r['sampler'] for r in rows)} samplers by shape, dtype and "
        f"finiteness), every output on the card; {len(stubs)} stubs; "
        f"largest limit shares "
        f"{[(r['op'], round(r['limit_share'], 3)) for r in worst]} "
        f"({time.perf_counter() - t0:.1f} s)")
    b1 = _nd_b1(_fp16_shapes("bert"))
    log("[nd_ops] B1 through nd on BERT-base's 150 fp16 tensors "
        + json.dumps(b1))
    attn = _nd_attention()
    for row in attn:
        log("[nd_ops] nd._fused_attention " + json.dumps(row))
    cost = _nd_host_cost()
    log("[nd_ops] host cost of one call on a (64,) tensor, nd against the "
        "bare torch call (us, not gated) " + json.dumps(cost))
    return {"ops": len(rows), "stubs": len(stubs), "b1": b1,
            "attention": attn, "host_cost_us": cost}


def phase_index_fault():
    """Labels and indices -1, n and n + 2 through the loss, the Embedding
    layer, ``nd.pick`` and ``nd.Embedding`` on the card: no device-side
    assert, and the CPU path's values (-1 wraps, the rest NaN)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn as gnn
    rs = np.random.RandomState(SEED)
    n = 5
    pred = rs.randn(5, n).astype(np.float32)
    table = rs.randn(n, 3).astype(np.float32)
    idx = np.array([0, n - 1, -1, n, n + 2], np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        emb = gnn.Embedding(n, 3, device=dev)
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(table))
        ctx = mx.cpu() if dev == "cpu" else mx.gpu(0)
        p, t, i = (torch.from_numpy(a).to(dev) for a in (pred, table, idx))
        with ctx:
            vals = [gloss.SoftmaxCrossEntropyLoss()(p, i),
                    emb(i.long()).detach(),
                    nd.pick(nd.array(pred), nd.array(idx))._data,
                    nd.Embedding(nd.array(idx), nd.array(table),
                                 input_dim=n, output_dim=3)._data,
                    gloss.SoftmaxCrossEntropyLoss()(
                        nd.array(pred), nd.array(idx))._data]
        if dev == "cuda":
            torch.cuda.synchronize()   # a device-side assert surfaces here
        got[dev] = [v.cpu().numpy() for v in vals]
    same = all(np.array_equal(np.isnan(c), np.isnan(g))
               and np.allclose(c[~np.isnan(c)], g[~np.isnan(g)], rtol=1e-5,
                               atol=1e-6)
               for c, g in zip(got["cpu"], got["cuda"]))
    nan_rows = [bool(np.isnan(got["cuda"][0][j])) for j in range(len(idx))]
    row = {"indices": idx.tolist(), "loss_nan": nan_rows,
           "equal_to_cpu": same}
    log("[index_fault] " + json.dumps(row))
    if not same or nan_rows != [False, False, False, True, True]:
        raise SystemExit(f"chip_smoke: index_fault: {row}")
    return row


def phase_train_gluon_nd(card, resnet_summary):
    """``examples/image_classification/train_gluon.py``'s loop written
    with the port's public API at ResNet-50 v1's full width: NDArray
    batches on ``mx.gpu(0)``, a user-written output ``HybridBlock`` whose
    ``hybrid_forward`` calls ``F.FullyConnected``, fp16 with BatchNorm
    fp32, multi-precision SGD, ``record`` -> ``loss.backward()`` ->
    ``trainer.step`` -> ``metric.Accuracy().update`` every step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, initializer, metric, nd
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.opt import kernels as opt_kernels

    class Classifier(gluon.HybridBlock):
        """The output layer as a user writes it."""

        def __init__(self, units, in_units):
            super().__init__()
            self.weight = self.params.get("weight", shape=(units, in_units))
            self.bias = self.params.get("bias", shape=(units,),
                                        init="zeros")

        def hybrid_forward(self, F, x, weight, bias):
            return F.FullyConnected(x, weight, bias,
                                    num_hidden=weight.shape[0])

    t0 = time.perf_counter()
    ctx = mx.gpu(0)
    mx.random.seed(SEED)
    net = get_model("resnet50_v1", classes=RESNET_CLASSES, device="cuda")
    net.output = Classifier(RESNET_CLASSES, 2048)
    net.initialize(initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2))
    net.cast("float16")
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD, "multi_precision": True})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    rng = np.random.RandomState(SEED)
    x_np = rng.uniform(-1, 1, (RESNET_B, 3, RESNET_SIZE, RESNET_SIZE))
    y_np = rng.randint(0, RESNET_CLASSES, (RESNET_B,)).astype(np.float32)
    x = nd.array(x_np.astype(np.float32), ctx=ctx, dtype="float16")
    y = nd.array(y_np, ctx=ctx)
    log(f"[train_gluon_nd] resnet50_v1 with a user HybridBlock classifier "
        f"(F.FullyConnected), fp16 (BatchNorm fp32), batch {RESNET_B} as "
        f"NDArray on {ctx}; SGD lr {RESNET_LR} momentum {RESNET_MOMENTUM} "
        f"wd {RESNET_WD} multi_precision; built in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = _train_counters()
    want = dict.fromkeys(counters, 0)
    want["mp_sgd"] = 1
    walls, losses, outs, totals = [], [], [], dict.fromkeys(counters, 0)
    on_card = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RESNET_STEPS):
        for c in counters.values():
            c.reset()
        t_step = time.perf_counter()
        with autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        trainer.step(RESNET_B)
        acc.update(y, out)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t_step) * 1e3)
        counts = {n: c.count for n, c in counters.items()}
        for n in counts:
            totals[n] += counts[n]
        on_card &= all(isinstance(a, nd.NDArray) and a._data.is_cuda
                       for a in (out, loss))
        losses.append(loss.mean())
        outs.append(out._data)
        if counts != want:
            raise SystemExit(f"chip_smoke: train_gluon_nd: launches "
                             f"{counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    losses = [v.asscalar() for v in losses]
    recount = int(sum((o.argmax(1) == y._data.long()).sum().item()
                      for o in outs))
    wall_ms = float(np.median(walls[1:]))
    row = {"card": card, "batch": [RESNET_B, 3, RESNET_SIZE, RESNET_SIZE],
           "steps": len(walls), "losses": losses,
           "step_wall_ms_median": wall_ms, "step_wall_ms": walls,
           "images_per_s": RESNET_B / (wall_ms / 1e3),
           "train_resnet50_step_wall_ms_median":
               resnet_summary["step_wall_ms_median"],
           "train_resnet50_images_per_s": resnet_summary["images_per_s"],
           "nd_over_torch_ms": wall_ms
           - resnet_summary["step_wall_ms_median"],
           "metric": acc.get(), "metric_correct": acc.sum_metric,
           "torch_recount_correct": recount, "metric_count": acc.num_inst,
           "b1_launches_per_step": totals["mp_sgd"] / len(walls),
           "outputs_ndarray_on_card": on_card, "peak_memory_bytes": peak,
           "launches": totals}
    log("[train_gluon_nd] " + json.dumps(row))
    if not (on_card and np.all(np.isfinite(losses))
            and losses[-1] < losses[0] and recount == acc.sum_metric
            and acc.num_inst == RESNET_B * len(walls)):
        raise SystemExit(f"chip_smoke: train_gluon_nd: {row}")
    del net, trainer, x, y, outs, out, loss
    torch.cuda.empty_cache()
    return row


# -- the symbolic stack (Symbol, Executor, Module) ---------------------------

def _encoder_symbol(fused=True):
    """BERT-base's encoder in ``sym``, as bench.py's ``lm_block`` builds
    one: q/k/v by ``FullyConnected(flatten=False)``, reshaped and
    transposed to (B, H, T, D); attention as one ``_fused_attention`` node
    (``fused``) or in its dense spelling (batch_dot, softmax, batch_dot);
    the projection and a residual add, LayerNorm, a GELU FFN, a residual
    add and LayerNorm; token and position embeddings in, a
    ``SoftmaxOutput`` over the vocabulary out (one row per token)."""
    from mxnet_tpu_torch import sym
    B, T, C, H = ENC_B, ENC_T, ENC_UNITS, ENC_HEADS
    D = C // H
    x = sym.Embedding(sym.var("data"), input_dim=ENC_VOCAB, output_dim=C,
                      name="word_embed")
    x = sym.broadcast_add(x, sym.var("pos_embed_weight", shape=(1, T, C)),
                          name="pos_add")
    for i in range(ENC_LAYERS):
        p = f"l{i}_"
        proj = {}
        for nm in ("q", "k", "v"):
            t = sym.FullyConnected(x, num_hidden=C, flatten=False,
                                   no_bias=True, name=p + nm)
            t = sym.reshape(t, shape=(B, T, H, D))
            proj[nm] = sym.transpose(t, axes=(0, 2, 1, 3))
        if fused:
            att = sym._fused_attention(proj["q"], proj["k"], proj["v"],
                                       scale=1.0 / D ** 0.5, name=p + "att")
        else:
            scores = sym.batch_dot(proj["q"], proj["k"],
                                   transpose_b=True) * (1.0 / D ** 0.5)
            att = sym.batch_dot(sym.softmax(scores, axis=-1), proj["v"],
                                name=p + "att")
        att = sym.reshape(sym.transpose(att, axes=(0, 2, 1, 3)),
                          shape=(B, T, C))
        h = sym.LayerNorm(sym.broadcast_add(x, sym.FullyConnected(
            att, num_hidden=C, flatten=False, name=p + "o")), name=p + "ln1")
        f = sym.FullyConnected(h, num_hidden=ENC_FFN, flatten=False,
                               name=p + "ff1")
        f = sym.LeakyReLU(f, act_type="gelu", name=p + "gelu")
        f = sym.FullyConnected(f, num_hidden=C, flatten=False,
                               name=p + "ff2")
        x = sym.LayerNorm(sym.broadcast_add(h, f), name=p + "ln2")
    logits = sym.FullyConnected(x, num_hidden=ENC_VOCAB, flatten=False,
                                name="head")
    return sym.SoftmaxOutput(sym.reshape(logits, shape=(-1, ENC_VOCAB)),
                             sym.reshape(sym.var("softmax_label"),
                                         shape=(-1,)), name="softmax")


def _encoder_params(net):
    """N(0, 0.02) matrices and embeddings, zero biases, LayerNorm gamma 1
    and beta 0, from SEED with numpy, as NDArrays on the card."""
    import mxnet_tpu_torch as mx
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(ENC_B, ENC_T), softmax_label=(ENC_B, ENC_T))[0]))
    rng = np.random.default_rng(SEED)
    out = {}
    for name, shape in shapes.items():
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            v = np.ones(shape, np.float32)
        elif name.endswith(("bias", "beta")):
            v = np.zeros(shape, np.float32)
        else:
            v = rng.standard_normal(shape, dtype=np.float32) * 0.02
        out[name] = mx.nd.array(v, ctx=mx.gpu(0))
    return out


def _fit_steps(mod, it, steps, tag, counters=None, want=None, on_step=None):
    """``mod.fit`` over ``it`` (one epoch of ``steps`` batches) with a
    batch-end callback that times each step (the device waited for), reads
    its loss off the cross-entropy metric and its launches off
    ``counters`` (which must equal ``want``), then calls ``on_step(i)``.
    Returns the losses, the walls and the launches summed over the run."""
    losses, walls, last = [], [], [time.perf_counter(), 0.0, 0]
    totals = dict.fromkeys(counters or {}, 0)
    if counters:
        for c in counters.values():
            c.reset()

    def batch_end(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append((now - last[0]) * 1e3)
        m = param.eval_metric
        losses.append((m.sum_metric - last[1]) / (m.num_inst - last[2]))
        last[1:] = [m.sum_metric, m.num_inst]
        if counters:
            counts = {n: c.count for n, c in counters.items()}
            log(f"[{tag}] step {param.nbatch}: loss {losses[-1]:.6f}, wall "
                f"{walls[-1]:.2f} ms, launches {counts}")
            if counts != want:
                raise SystemExit(f"chip_smoke: {tag}: launches per step "
                                 f"{counts}, expected {want}")
            for n in counts:
                totals[n] += counts[n]
            for c in counters.values():
                c.reset()
        else:
            log(f"[{tag}] step {param.nbatch}: loss {losses[-1]:.6f}, wall "
                f"{walls[-1]:.2f} ms")
        if on_step:
            on_step(param.nbatch)
        torch.cuda.synchronize()
        last[0] = time.perf_counter()

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    # bound, initialised and with an optimizer: fit runs the loop (the
    # iterator makes each batch in the current context: the module's)
    with mod._context[0]:
        mod.fit(it, num_epoch=1, eval_metric="ce",
                batch_end_callback=batch_end)
    if len(losses) != steps or not np.all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: {tag}: loss not finite and falling "
                         f"over {steps} steps: {losses}")
    return losses, walls, totals


def _arrays_on_card(mod):
    ex = mod._exec_group.execs[0]
    arrays = list(ex.arg_dict.values()) + list(ex.grad_dict.values()) \
        + list(ex.aux_dict.values()) + ex.outputs
    args, auxs = mod.get_params()
    arrays += list(args.values()) + list(auxs.values())
    return all(a._data.is_cuda for a in arrays)


def phase_module_encoder(card, train32):
    """A 12-layer symbolic encoder at BERT-base's widths trained through
    ``Module.fit`` on the card (fp32, TF32 off): every ``_fused_attention``
    node's forward on B2 and backward on B3/B4, all on the fp32
    tensor-core route; then two steps of the same graph with attention's
    dense spelling from the same start, within [train32]'s limits; then
    one ``_fused_attention`` node bound in fp16 through ``simple_bind(
    type_dict=...)``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, sym
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_ref_bwd, flash_attention_ref_fwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, ENC_VOCAB, (ENC_B, ENC_T)).astype(np.float32)
    labels = rng.integers(0, ENC_VOCAB, (ENC_B, ENC_T)).astype(np.float32)
    steps = 1 + ENC_TIMED_STEPS
    opt = {"learning_rate": TRAIN_LR, "momentum": TRAIN_MOMENTUM,
           "rescale_grad": 1.0 / (ENC_B * ENC_T)}

    def build(fused):
        net = _encoder_symbol(fused)
        mod = mx.mod.Module(net, context=ctx)
        with ctx:
            # one batch repeated: the loss of the same tokens falls
            it = mx.io.NDArrayIter(np.tile(tokens, (steps, 1)),
                                   np.tile(labels, (steps, 1)),
                                   batch_size=ENC_B)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.set_params(_encoder_params(net), {})
        mod.init_optimizer(kvstore=None, optimizer="sgd",
                           optimizer_params=dict(opt))
        return net, mod, it

    net, mod, it = build(True)
    n_params = len(mod._param_names)
    n_values = sum(a.size for a in mod.get_params()[0].values())
    init = {n: a._data.clone() for n, a in mod.get_params()[0].items()}
    log(f"[module_encoder] {ENC_LAYERS} layers x {ENC_UNITS} units, "
        f"{ENC_HEADS} heads of {ENC_UNITS // ENC_HEADS}, FFN {ENC_FFN}, "
        f"vocab {ENC_VOCAB}; {len(net.list_arguments())} arguments "
        f"({n_params} parameters, {n_values} values), fp32 (TF32 off); "
        f"batch {ENC_B} x {ENC_T}; Module.fit, SGD lr {TRAIN_LR} momentum "
        f"{TRAIN_MOMENTUM}; built in {time.perf_counter() - t0:.2f} s")
    counters = _train_counters()
    want = dict.fromkeys(counters, 0)
    want.update({"flash_fwd": ENC_LAYERS, "flash_fwd_tc32": ENC_LAYERS,
                 "flash_bwd_dq": ENC_LAYERS, "flash_bwd_dkv": ENC_LAYERS,
                 "flash_bwd_dq_tc32": ENC_LAYERS,
                 "flash_bwd_dkv_tc32": ENC_LAYERS,
                 "split_bf16x3": 2 * ENC_LAYERS})
    after2 = {}

    def on_step(i):
        if i == REF_STEPS - 1:
            after2.update({n: a._data.clone()
                           for n, a in mod.get_params()[0].items()})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    losses, walls, launches = _fit_steps(mod, it, steps, "module_encoder",
                                         counters, want, on_step)
    peak = torch.cuda.max_memory_allocated()
    on_card = _arrays_on_card(mod)
    aux_untouched = not mod._exec_group.execs[0].aux_dict
    with ctx:
        batch = mx.io.DataBatch([nd.array(tokens)], [nd.array(labels)])

    def one_step():
        mod.forward_backward(batch)
        mod.update()

    # one more step, profiled (its launches are not the run's)
    kernel_ms, ours, top = profiled_step(one_step)
    wall_ms = float(np.median(walls[1:]))
    del mod, it, net
    torch.cuda.empty_cache()

    # the dense spelling, two steps from the same start
    ref_net, ref_mod, ref_it = build(False)
    ref_losses = _fit_steps(ref_mod, mx.io.ResizeIter(ref_it, REF_STEPS),
                            REF_STEPS, "module_encoder_dense")[0]
    ref_after = {n: a._data for n, a in ref_mod.get_params()[0].items()}
    names = sorted(init)
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
    upd_err, worst = _update_diff([after2[n] for n in names],
                                  [ref_after[n] for n in names],
                                  [init[n] for n in names], names)
    del ref_mod, ref_it, ref_net, ref_after, after2, init
    torch.cuda.empty_cache()
    log(f"[module_encoder] dense spelling of attention, the same start: "
        f"losses {ref_losses}; max loss diff {loss_err:.3e} (limit "
        f"{TRAIN32_LOSS_TOL}); update rel. L2 diff {upd_err:.3e} (limit "
        f"{TRAIN32_UPD_TOL}), worst parameter {worst[1]} {worst[0]:.3e} "
        f"(limit {TRAIN32_UPD_TOL_EACH})")

    # one _fused_attention node bound in fp16 (type_dict)
    shape = ND_ATTN[:3] + ND_ATTN[4:]
    node = sym._fused_attention(sym.var("q"), sym.var("k"), sym.var("v"),
                                scale=1.0 / ND_ATTN[4] ** 0.5, name="att")
    ex = node.simple_bind(ctx, type_dict=dict.fromkeys("qkv", "float16"),
                          q=shape, k=shape, v=shape)
    g = torch.Generator().manual_seed(SEED)
    q, k, v, dout = (torch.randn(shape, generator=g).cuda().half()
                     for _ in range(4))
    for c in counters.values():
        c.reset()
    out = ex.forward(is_train=True, q=nd.array(q, ctx=ctx),
                     k=nd.array(k, ctx=ctx), v=nd.array(v, ctx=ctx))[0]
    ex.backward(nd.array(dout, ctx=ctx))
    torch.cuda.synchronize()
    fp16_counts = {n: c.count for n, c in counters.items()}
    f32 = [t.float() for t in (q, k, v)]
    scale = 1.0 / ND_ATTN[4] ** 0.5
    ref, lse = flash_attention_ref_fwd(*f32, False, scale)
    fwd_err = (out._data.float() - ref).abs().max().item()
    atol, rtol = BWD_TOL["float16"]
    bwd_excess = max(((ex.grad_dict[n]._data.float() - r).abs()
                      - (atol + rtol * r.abs())).max().item()
                     for n, r in zip("qkv", flash_attention_ref_bwd(
                         *f32, ref, lse, dout.float(), False, scale)))
    fp16_want = {n: (1 if n in ("flash_fwd", "flash_fwd_tc", "flash_bwd_dq",
                                "flash_bwd_dq_tc", "flash_bwd_dkv",
                                "flash_bwd_dkv_tc") else 0)
                 for n in counters}
    del ex, out, q, k, v, dout, ref, lse, f32
    torch.cuda.empty_cache()

    summary = {
        "card": card, "batch": [ENC_B, ENC_T], "steps": steps,
        "dtype": "float32", "losses": losses, "dense_losses": ref_losses,
        "step_wall_ms_median": wall_ms, "step_wall_ms": walls,
        "tokens_per_s": ENC_B * ENC_T / (wall_ms / 1e3),
        "train32_step_wall_ms_median": train32["step_wall_ms_median"],
        "train32_tokens_per_s": train32["tokens_per_s"],
        "module_over_gluon_ms": wall_ms - train32["step_wall_ms_median"],
        "profiled_kernel_ms": kernel_ms,
        "device_busy_share": kernel_ms / wall_ms,
        "kernel_ms_in_step": ours, "top10_kernels_ms": top,
        "peak_memory_bytes": peak, "launches": launches,
        "loss_max_abs_diff_vs_dense": loss_err,
        "update_rel_l2_diff_vs_dense": upd_err,
        "worst_parameter_rel_diff": list(worst),
        "arrays_on_card": on_card, "aux_states": 0 if aux_untouched else -1,
        "fp16_node": {"shape": list(ND_ATTN), "launches": fp16_counts,
                      "fwd_max_abs_err": fwd_err,
                      "fwd_limit": FWD_TOL["float16"],
                      "bwd_max_excess_over_limit": bwd_excess,
                      "bwd_limit": list(BWD_TOL["float16"])}}
    log("[module_encoder] " + json.dumps(summary))
    if (loss_err > TRAIN32_LOSS_TOL or upd_err > TRAIN32_UPD_TOL
            or worst[0] > TRAIN32_UPD_TOL_EACH):
        raise SystemExit("chip_smoke: module_encoder disagrees with the "
                         "dense spelling")
    if not (on_card and aux_untouched):
        raise SystemExit("chip_smoke: module_encoder: an array off the card "
                         "or an aux state in a graph that has none")
    if fp16_counts != fp16_want or fwd_err > FWD_TOL["float16"] \
            or bwd_excess > 0:
        raise SystemExit(f"chip_smoke: module_encoder: the fp16 node: "
                         f"{summary['fp16_node']}")
    return {"launches": launches, "fp16": fp16_counts, "summary": summary}


def phase_module_resnet50(card, check32):
    """ResNet-50 v1 exported from the zoo and trained through ``Module.fit``
    at batch 256 in fp32 (TF32 off); one BatchNorm's moving statistics
    held to their closed form for one step (moved once); then two SGD
    steps at batch 4 through ``Module`` and through the Gluon ``Trainer``
    from the same weights and batch: in fp32 within ``MODULE_GLUON_RATIO``
    times [resnet_check]'s fp32 error (losses, statistics), in fp64
    within ``RESNET64_TOL`` (losses, update, worst parameter,
    statistics), a limit that two faults planted in the second update
    must fail."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd, sym
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    net = _seeded_resnet50("cuda")
    tmp = tempfile.mkdtemp(prefix="module_resnet50_")
    try:
        prefix = os.path.join(tmp, "resnet50_v1")
        net.export(prefix)
        head = sym.SoftmaxOutput(sym.load(prefix + "-symbol.json"),
                                 name="softmax")
        args, auxs = mx.model.load_params(prefix, 0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stem_conv, stem_bn = net.features[0], net.features[1]
    bn_mean = stem_bn.param_name("running_mean")
    bn_var = stem_bn.param_name("running_var")
    conv_w = stem_conv.param_name("weight")
    steps = 1 + MODULE_RESNET_TIMED_STEPS
    x, y = _resnet_batch(RESNET_B, torch.float32, "cpu")
    x, y = x.numpy(), y.numpy()

    def module(batch):
        mod = mx.mod.Module(head, context=ctx)
        mod.bind(data_shapes=[("data", (batch, 3, RESNET_SIZE,
                                        RESNET_SIZE))],
                 label_shapes=[("softmax_label", (batch,))])
        mod.set_params(args, auxs)
        return mod

    mod = module(RESNET_B)
    mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD, "rescale_grad": 1.0 / RESNET_B})
    log(f"[module_resnet50] resnet50_v1 exported ({len(args)} arguments, "
        f"{len(auxs)} aux states) -> sym.load + SoftmaxOutput -> Module on "
        f"{ctx}, fp32 (TF32 off), batch {RESNET_B}; SGD lr {RESNET_LR} "
        f"momentum {RESNET_MOMENTUM} wd {RESNET_WD} rescale 1/{RESNET_B}; "
        f"built in {time.perf_counter() - t0:.2f} s")

    # one step by hand: the stem BatchNorm moves once, by its closed form
    ex = mod._exec_group.execs[0]
    with ctx:
        batch = mx.io.DataBatch([nd.array(x)], [nd.array(y)])
    m0, v0 = ex.aux_dict[bn_mean]._data.clone(), ex.aux_dict[bn_var]._data \
        .clone()
    conv = torch.nn.functional.conv2d(batch.data[0]._data,
                                      ex.arg_dict[conv_w]._data, stride=2,
                                      padding=3)
    mu = conv.mean((0, 2, 3))
    var = conv.var((0, 2, 3), unbiased=False)
    del conv
    mod.forward_backward(batch)
    mod.update()
    m1, v1 = ex.aux_dict[bn_mean]._data, ex.aux_dict[bn_var]._data
    mom = RESNET_MOMENTUM
    once = [(m1 - (mom * m0 + (1 - mom) * mu)).abs().max().item(),
            (v1 - (mom * v0 + (1 - mom) * var)).abs().max().item()]
    twice = [(m1 - (mom * (mom * m0 + (1 - mom) * mu) + (1 - mom) * mu))
             .abs().max().item(),
             (v1 - (mom * (mom * v0 + (1 - mom) * var) + (1 - mom) * var))
             .abs().max().item()]
    once_ok = max(once) <= BN_ONCE_TOL < min(twice)
    log(f"[module_resnet50] stem BatchNorm after one step: max |moving - "
        f"closed form| once {once}, twice {twice} (limit {BN_ONCE_TOL})")

    with ctx:
        it = mx.io.NDArrayIter(np.tile(x, (steps, 1, 1, 1)),
                               np.tile(y, steps), batch_size=RESNET_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, _ = _fit_steps(mod, it, steps, "module_resnet50")
    peak = torch.cuda.max_memory_allocated()
    on_card = _arrays_on_card(mod)
    wall_ms = float(np.median(walls[1:]))
    del mod, ex, it, batch
    torch.cuda.empty_cache()

    # the same step through the Gluon Trainer on the torch-direct layers,
    # for the Module layer's cost (the iterator, the executor, the metric)
    gx, gy = (t.cuda() for t in _resnet_batch(RESNET_B, torch.float32,
                                              "cpu"))
    gl_net = _seeded_resnet50("cuda")
    gl_params = _params_of(gl_net)
    gl_big = Trainer(gl_params, "sgd", {"learning_rate": RESNET_LR,
                                        "momentum": RESNET_MOMENTUM,
                                        "wd": RESNET_WD})
    gl_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        tg = time.perf_counter()
        _train_step(gl_net, SoftmaxCrossEntropyLoss(), gx, gy,
                    lambda: gl_big.step(RESNET_B), scale=1.0)
        torch.cuda.synchronize()
        gl_walls.append((time.perf_counter() - tg) * 1e3)
    del gl_net, gl_params, gl_big, gx, gy
    torch.cuda.empty_cache()

    # Module against the Gluon Trainer: two steps at batch 4 from the same
    # weights, in fp32 and in fp64 (the JAX package's Module binds fp32
    # only, so the fp64 run casts the bound arrays, exactly, in place)
    xb, yb = _resnet_batch(RESNET_CHECK_B, torch.float32, "cuda")
    sgd = {"learning_rate": RESNET_CHECK_LR, "momentum": RESNET_MOMENTUM,
           "wd": RESNET_WD}
    state0 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    jax_params = net.named_jax_params()
    names = list(jax_params)   # the Module's; each new net counts its own
    trained = [n for n, p in jax_params.items() if p.requires_grad]
    stats = [n for n in jax_params if n not in trained]
    noise = {id(_params_of(net)[n]) for n in _noise_biases(net)}
    kept = [n for n in trained if id(jax_params[n]) not in noise]
    del net, jax_params
    rows = torch.arange(RESNET_CHECK_B)

    def against_gluon(dtype):
        small = module(RESNET_CHECK_B)
        ex = small._exec_group.execs[0]
        for arrays in (ex.arg_dict, ex.grad_dict, ex.aux_dict):
            for arr in arrays.values():
                arr._data = arr._data.to(dtype)
        small.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={
            **sgd, "rescale_grad": 1.0 / RESNET_CHECK_B})
        batch = mx.io.DataBatch([nd.array(xb, ctx=ctx)],
                                [nd.array(yb, ctx=ctx)])
        gnet = _seeded_resnet50("cuda")
        gnet.load_state_dict(state0)
        gnet.cast(dtype)
        gp = dict(zip(names, gnet.named_jax_params().values()))
        init = {n: p.detach().clone() for n, p in gp.items()}
        m_losses, m_stats, m_w = [], [], []
        for _ in range(RESNET_CHECK_STEPS):
            small.forward_backward(batch)
            prob = small.get_outputs()[0]._data
            m_losses.append(-torch.log(prob[rows, yb.long()]).mean().item())
            small.update()
            m_stats.append([ex.aux_dict[n]._data.clone() for n in stats])
            m_w.append({n: ex.arg_dict[n]._data.clone() for n in trained})
        trainer = Trainer(gnet.collect_params(), "sgd", dict(sgd))
        loss_fn = SoftmaxCrossEntropyLoss()
        g_losses, g_stats = [], []
        for _ in range(RESNET_CHECK_STEPS):
            with autograd.record():
                loss = loss_fn(gnet(xb.to(dtype)), yb)
            autograd.backward(loss)
            trainer.step(RESNET_CHECK_B)
            g_losses.append(loss.detach().mean().item())
            g_stats.append([gp[n].detach().clone() for n in stats])

        def update_diff(got, over=trained):
            return _update_diff([got[n] for n in over],
                                [gp[n].detach() for n in over],
                                [init[n] for n in over], over)

        diff = {"loss": max(abs(a - b) for a, b in zip(m_losses, g_losses)),
                "update": update_diff(m_w[-1])[0],
                "worst_parameter": list(update_diff(m_w[-1], kept)[1]),
                "stats": max(_rel_l2(a, b) for a, b in zip(m_stats,
                                                           g_stats))}
        # faults planted in the Module's second update, from its own
        # weights after each step (w1, w2; init w0): SGD's momentum state
        # after step 1 is w1 - w0, so w2 - momentum * (w1 - w0) is the
        # second step taken without it
        planted = {
            "second_update_skipped": update_diff(m_w[0])[0],
            "second_update_without_momentum": update_diff(
                {n: m_w[1][n] - RESNET_MOMENTUM * (m_w[0][n] - init[n])
                 for n in trained})[0]}
        moved = all(not torch.equal(a, init[n])
                    for a, n in zip(m_stats[0], stats))
        return {"module_losses": m_losses, "gluon_losses": g_losses,
                "diff": diff, "planted_faults_update": planted,
                "running_stats_moved": moved}

    vs32 = against_gluon(torch.float32)
    vs64 = against_gluon(torch.float64)
    torch.cuda.empty_cache()
    lim32 = {k: MODULE_GLUON_RATIO * check32[k] for k in ("loss", "stats")}
    d32, d64 = vs32["diff"], vs64["diff"]
    ok32 = all(d32[k] <= lim32[k] for k in lim32)
    ok64 = all(d64[k] <= RESNET64_TOL for k in ("loss", "update", "stats")) \
        and d64["worst_parameter"][0] <= RESNET64_TOL
    planted_fail = all(v > RESNET64_TOL for v in
                       vs64["planted_faults_update"].values())
    moved = vs32["running_stats_moved"] and vs64["running_stats_moved"]

    summary = {
        "card": card, "batch": [RESNET_B, 3, RESNET_SIZE, RESNET_SIZE],
        "steps": steps, "dtype": "float32", "losses": losses,
        "step_wall_ms_median": wall_ms, "step_wall_ms": walls,
        "images_per_s": RESNET_B / (wall_ms / 1e3),
        "gluon_fp32_step_wall_ms": gl_walls,
        "gluon_fp32_step_wall_ms_median": float(np.median(gl_walls[1:])),
        "peak_memory_bytes": peak, "arrays_on_card": on_card,
        "stem_bn_once_max_abs": once, "stem_bn_twice_max_abs": twice,
        "running_stats_moved": moved,
        "module_vs_gluon": {"batch": RESNET_CHECK_B, "lr": RESNET_CHECK_LR,
                            "float32": vs32, "float64": vs64,
                            "limits_float32": lim32,
                            "limit_float64": RESNET64_TOL,
                            "planted_faults_fail_float64": planted_fail,
                            "resnet_check_fp32_vs_fp64": check32}}
    log("[module_resnet50] " + json.dumps(summary))
    if not (on_card and once_ok and moved):
        raise SystemExit(f"chip_smoke: module_resnet50: arrays on the card "
                         f"{on_card}, BatchNorm moved once {once_ok}, every "
                         f"running statistic moved {moved}")
    if not (ok32 and ok64):
        raise SystemExit(f"chip_smoke: module_resnet50: Module and Gluon "
                         f"disagree: fp32 {d32} (limits {lim32}), fp64 "
                         f"{d64} (limit {RESNET64_TOL})")
    if not planted_fail:
        raise SystemExit(f"chip_smoke: module_resnet50: the fp64 limit "
                         f"{RESNET64_TOL} passes a planted fault: "
                         f"{vs64['planted_faults_update']}")
    return summary


def lenet_symbol(num_classes=10):
    """``examples/image_classification/train_mnist.py``'s LeNet in the
    port's ``sym``."""
    from mxnet_tpu_torch import sym
    data = sym.var("data")
    c1 = sym.Convolution(data, kernel=(5, 5), num_filter=20)
    a1 = sym.Activation(c1, act_type="tanh")
    p1 = sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(p1, kernel=(5, 5), num_filter=50)
    a2 = sym.Activation(c2, act_type="tanh")
    p2 = sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = sym.flatten(p2)
    h = sym.Activation(sym.FullyConnected(f, num_hidden=500),
                       act_type="tanh")
    h = sym.FullyConnected(h, num_hidden=num_classes)
    return sym.SoftmaxOutput(h, name="softmax")


def synthetic_mnist(n, seed=0):
    """``train_mnist.py``'s learnable synthetic digits: a bright 8 x 8
    blob whose quadrant and intensity band encode the class."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 1, 28, 28).astype("float32") * 0.2
    y = rs.randint(0, 10, n)
    for i, cls in enumerate(y):
        qy, qx = divmod(cls % 4, 2)
        r, c = 4 + qy * 12, 4 + qx * 12
        x[i, 0, r:r + 8, c:c + 8] += 0.4 + 0.15 * (cls // 4)
    return x, y.astype("float32")


def phase_module_lenet(card):
    """``train_mnist.py``'s loop (BASELINE config 1) on the port's public
    API on the card: LeNet, synthetic digits, ``Module.fit`` with
    ``Speedometer`` and ``do_checkpoint``; then ``Module.load`` of the last
    checkpoint scores the same accuracy, which beats chance by
    ``LENET_MARGIN``."""
    import logging
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    # train_mnist.py leaves the shuffle and the initial weights unseeded;
    # here both come from SEED (numpy's global state shuffles each epoch)
    np.random.seed(SEED)
    mx.random.seed(SEED)
    xs, ys = synthetic_mnist(LENET_EXAMPLES)
    vx, vy = synthetic_mnist(max(LENET_EXAMPLES // 5, LENET_BATCH), seed=99)
    tmp = tempfile.mkdtemp(prefix="module_lenet_")
    logger = logging.getLogger()
    level = logger.level
    logger.setLevel(logging.INFO)
    speeds = []

    class Grab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "samples/sec" in msg:
                speeds.append(float(msg.split("Speed: ")[1].split()[0]))

    grab = Grab()
    logger.addHandler(grab)
    try:
        with ctx:
            train = mx.io.NDArrayIter(data=nd.array(xs), label=nd.array(ys),
                                      batch_size=LENET_BATCH, shuffle=True,
                                      shuffle_seed=SEED + 1)
            val = mx.io.NDArrayIter(data=nd.array(vx), label=nd.array(vy),
                                    batch_size=LENET_BATCH)
            mod = mx.mod.Module(lenet_symbol(), data_names=("data",),
                                label_names=("softmax_label",), context=ctx)
            prefix = os.path.join(tmp, "lenet")
            mod.fit(train, eval_data=val, num_epoch=LENET_EPOCHS,
                    optimizer="sgd", optimizer_params={
                        "learning_rate": 0.05, "momentum": 0.9},
                    eval_metric="acc",
                    epoch_end_callback=mx.callback.do_checkpoint(prefix),
                    # every 10 batches: the example's 50 never comes in
                    # an epoch of 32
                    batch_end_callback=mx.callback.Speedometer(LENET_BATCH,
                                                               10))
            acc = mod.score(val, mx.metric.Accuracy())[0][1]
            loaded = mx.mod.Module.load(prefix, LENET_EPOCHS, context=ctx)
            loaded.bind(data_shapes=val.provide_data,
                        label_shapes=val.provide_label, for_training=False)
            acc_loaded = loaded.score(val, mx.metric.Accuracy())[0][1]
            files = sorted(os.listdir(tmp))
            on_card = _arrays_on_card(loaded)
    finally:
        logger.removeHandler(grab)
        logger.setLevel(level)
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"card": card, "examples": LENET_EXAMPLES, "batch": LENET_BATCH,
           "epochs": LENET_EPOCHS, "accuracy": acc,
           "accuracy_after_load": acc_loaded, "chance": 0.1,
           "margin": LENET_MARGIN, "checkpoint_files": files,
           "speedometer_samples_per_s": speeds, "loaded_on_card": on_card,
           "seconds": time.perf_counter() - t0}
    log("[module_lenet] " + json.dumps(row))
    if not (acc == acc_loaded and acc >= 0.1 + LENET_MARGIN and on_card
            and speeds and f"lenet-{LENET_EPOCHS:04d}.params" in files):
        raise SystemExit(f"chip_smoke: module_lenet: {row}")
    return row


# -- the fused training step: [fused_bert], [fused_resnet50], [fused_symbol] --

def _flat_state(state):
    """The tensors of an optimizer state (None, a tensor or a tuple)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _flat_state(s)]
    return [state]


def _fused_kernel_launches(rows):
    """Launches of each port kernel symbol (``KERNEL_NAMES``) in a
    profiled window's rows (``_profile_rows``), those launched at all."""
    syms = {s for group in KERNEL_NAMES.values() for s in group}
    counts = {s: sum(r[2] for r in rows if s in r[0]) for s in sorted(syms)}
    return {k: v for k, v in counts.items() if v}


class _BlockPath:
    """A Gluon model and its Trainer, stepped by the eager loop (``record``
    -> ``backward`` -> ``Trainer.step``) or by ``Trainer.fuse_step``."""

    def __init__(self, build, loss_fn, opt, opt_kw, x, y):
        from mxnet_tpu_torch.gluon import Trainer, collect_params
        self.model = build()
        self.params = collect_params(self.model)
        self.trainer = Trainer(self.params, opt, dict(opt_kw))
        self.loss_fn, self.x, self.y = loss_fn, x, y
        self.fused = None

    def eager_step(self):
        from mxnet_tpu_torch import autograd
        with autograd.record():
            loss = self.loss_fn(self.model(self.x), self.y)
        autograd.backward(loss)
        self.trainer.step(self.x.shape[0])
        return loss.detach()

    def fused_step(self):
        if self.fused is None:
            self.fused = self.trainer.fuse_step(self.model, self.loss_fn)
        return self.fused.step(self.x, self.y)

    def set_lr(self, lr):
        self.trainer.set_learning_rate(lr)

    @staticmethod
    def mean_loss(out):
        return float(out.float().mean())

    def lr(self):
        return self.trainer.learning_rate

    def tensors(self):
        """Weights, BatchNorm's running statistics and optimizer states."""
        sts = self.trainer._updaters[0].states
        return [p.detach() for p in self.params.values()] + [
            t for i in sorted(sts) for t in _flat_state(sts[i])]


class _SymbolPath:
    """The symbolic encoder stepped by ``Executor.forward`` / ``backward``
    and the list-form ``Updater`` (eager), or by a symbol-mode
    ``StepFunction`` over the same arrays (fused)."""

    def __init__(self, opt, opt_kw, x, y):
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import nd
        from mxnet_tpu_torch import optimizer as opt_mod
        ctx = mx.gpu(0)
        self.net = _encoder_symbol(True)
        self.args = _encoder_params(self.net)
        self.names = sorted(self.args)
        self.opt = opt_mod.create(opt, **opt_kw)
        self.opt.rescale_grad = 1.0 / (ENC_B * ENC_T)
        self.updater = opt_mod.get_updater(self.opt)
        self.x, self.y = x, y
        self.ex = self.net.bind(ctx, args=dict(
            self.args, data=nd.array(x, ctx=ctx),
            softmax_label=nd.array(y, ctx=ctx)),
            args_grad={n: nd.zeros(a.shape, ctx)
                       for n, a in self.args.items()},
            grad_req="write")
        self.opt_name, self.opt_kw = opt, opt_kw
        self.fused = None

    def eager_step(self):
        self.ex.forward(is_train=True)
        self.ex.backward()
        self.updater(list(range(len(self.names))),
                     [self.ex.grad_dict[n] for n in self.names],
                     [self.args[n] for n in self.names])
        return self.ex.outputs[0]._data

    def fused_step(self):
        from mxnet_tpu_torch.step import StepFunction
        if self.fused is None:
            self.fused = StepFunction(
                self.net, arg_dict=self.args, aux_dict={},
                input_names=("data", "softmax_label"),
                optimizer=self.opt_name, optimizer_params=self.opt_kw,
                name="encoder")
            self.opt = self.fused._optimizer
        return self.fused.step(self.x, self.y, batch_size=ENC_B * ENC_T)

    def set_lr(self, lr):
        self.opt.set_learning_rate(lr)

    def mean_loss(self, out):
        """The mean cross-entropy of the SoftmaxOutput's probabilities (the
        graph's first output) at the labels."""
        picked = out.gather(1, self.y.reshape(-1, 1).long())
        return float(-picked.double().log().mean())

    def lr(self):
        return self.opt.lr

    def tensors(self):
        sts = (self.fused._updater if self.fused else self.updater).states
        return [self.args[n]._data for n in self.names] + [
            t for i in sorted(sts) for t in _flat_state(sts[i])]


def _is_device_copy(name):
    """A profiler row of a device-to-device copy: ``copy_``'s element-wise
    kernel or a DtoD memcpy (a graph's memcpy node)."""
    return "direct_copy" in name or "Memcpy DtoD" in name


def _fused_against_eager(tag, make, want_launches, extra=None,
                         limits=False):
    """The eager loop twice and the fused step once, each from the same
    start (``make()`` builds a fresh path), for FUSED_STEPS steps, the
    rate halved after FUSED_LR_AT of them: the two eager runs bit-equal
    to each other (the eager step is reproducible on the card), and the
    fused run bit-equal to them (losses, weights, running statistics,
    optimizer states); one capture (one miss) for the whole run; the
    kernels a replayed step launches, counted by the profiler, equal to
    ``want_launches``. Then FUSED_TIMED more steps of each, timed, and a
    profiled one, whose device-to-device copies (the fused step's
    write-back among them) are summed. ``extra(path, i)`` runs after step
    ``i`` of every run and returns values to compare too. With
    ``limits`` (a block path whose eager step is not bit-reproducible:
    cuDNN's default algorithms), bit-equality is reported and the fused
    run is held to the first eager run within [train32]'s limits instead:
    the mean losses within TRAIN32_LOSS_TOL, the parameters' update within
    TRAIN32_UPD_TOL relative L2 and each parameter's within
    TRAIN32_UPD_TOL_EACH, or FUSED_NOISE_RATIO times the two eager runs'
    worst where that is larger (the biases a BatchNorm follows left out:
    their update is rounding noise). Returns the summary and the fused
    path (its model still alive)."""
    from mxnet_tpu_torch.telemetry import metrics
    counters = _train_counters()
    runs, timing, init = [], {}, None
    for which in ("eager", "eager", "fused"):
        gc.collect()
        torch.cuda.empty_cache()
        path = make()
        if limits and init is None:
            init = [p.detach().clone() for p in path.params.values()]
        step = path.fused_step if which == "fused" else path.eager_step
        misses = metrics.counter("fused_step_cache_misses_total").value()
        capture = metrics.histogram("fused_step_compile_seconds")
        cap0 = capture.value()["sum"]
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, means, extras, walls = [], [], [], []
        for i in range(FUSED_STEPS):
            t0 = time.perf_counter()
            losses.append(step().clone())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            means.append(path.mean_loss(losses[-1]))
            if i + 1 == FUSED_LR_AT:
                path.set_lr(path.lr() * 0.5)
            if extra is not None:
                extras.append(extra(path, i))
        snap = [t.clone() for t in path.tensors()]
        launches = {n: c.count for n, c in counters.items() if c.count}
        for _ in range(FUSED_TIMED):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = float(np.median(walls[1:]))
        rows = _profile_rows(step)
        kernel_ms = sum(r[1] for r in rows)
        per_step = _fused_kernel_launches(rows)
        copies = [r for r in rows if _is_device_copy(r[0])]
        timing[which] = {
            "first_step_wall_ms": walls[0], "step_wall_ms_median": wall_ms,
            "step_wall_ms": walls, "profiled_kernel_ms": kernel_ms,
            "device_busy_share": kernel_ms / wall_ms,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "kernel_launches_per_step": per_step,
            "device_copy_ms": sum(r[1] for r in copies),
            "device_copy_launches": sum(r[2] for r in copies),
            "top5_kernels_ms": [[r[0][:60], r[1], r[2]] for r in rows[:5]]}
        if which == "fused":
            timing[which].update({
                "capture_seconds": capture.value()["sum"] - cap0,
                "misses": metrics.counter(
                    "fused_step_cache_misses_total").value() - misses,
                "programs": path.fused.cache_info()["programs"],
                "wrapper_launches_at_capture": launches})
        runs.append((losses, snap, extras))
        timing[which]["losses"] = means
        log(f"[{tag}] {which}: losses {means}, step "
            f"{wall_ms:.2f} ms (first {walls[0]:.1f} ms), busy "
            f"{kernel_ms / wall_ms:.3f}, peak "
            f"{timing[which]['peak_memory_bytes'] / 2**30:.2f} GiB, "
            f"launches per step {per_step}")
        if which != "fused":
            del path, snap, step
    (la, sa, ea), (lb, sb, eb), (lf, sf, ef) = runs

    def same(x, y):
        return len(x) == len(y) and all(torch.equal(a, b)
                                        for a, b in zip(x, y))

    def same_extras(x, y):
        return all(same(a, b) for a, b in zip(x, y))

    reproducible = same(la, lb) and same(sa, sb) and same_extras(ea, eb)
    equal = same(la, lf) and same(sa, sf) and same_extras(ea, ef)
    finite = all(bool(torch.isfinite(v).all()) for v in la + lf)
    fused = timing["fused"]
    near = {}
    if limits:
        names = list(path.params)
        n = len(names)
        loss_err = max(abs(path.mean_loss(a) - path.mean_loss(b))
                       for a, b in zip(la, lf))
        upd_err, _ = _update_diff(sf[:n], sa[:n], init, names)
        noise = _noise_biases(path.model)
        keep = [i for i, name in enumerate(names) if name not in noise]
        _, worst = _update_diff([sf[i] for i in keep], [sa[i] for i in keep],
                                [init[i] for i in keep],
                                [names[i] for i in keep])
        # the same three figures between the two eager runs: the noise
        # of the algorithms themselves, reported
        run_err = (max(abs(path.mean_loss(a) - path.mean_loss(b))
                       for a, b in zip(la, lb)),
                   _update_diff(sb[:n], sa[:n], init, names)[0],
                   list(_update_diff([sb[i] for i in keep],
                                     [sa[i] for i in keep],
                                     [init[i] for i in keep],
                                     [names[i] for i in keep])[1]))
        near = {"loss_max_abs_diff": loss_err,
                "update_rel_l2_diff": upd_err,
                "worst_parameter_rel_diff": list(worst),
                "eager_run_to_run": run_err,
                "noise_biases_left_out": n - len(keep),
                "limits": [TRAIN32_LOSS_TOL, TRAIN32_UPD_TOL,
                           max(TRAIN32_UPD_TOL_EACH,
                               FUSED_NOISE_RATIO * run_err[2][0])]}

    summary = {
        "eager_losses": timing["eager"]["losses"],
        "fused_losses": fused["losses"],
        "steps_compared": FUSED_STEPS, "lr_halved_after": FUSED_LR_AT,
        "eager_bit_reproducible": reproducible,
        "fused_bit_equal_to_eager": equal, "losses_finite": finite,
        "tensors_compared": len(sa),
        "misses": fused["misses"], "programs": fused["programs"],
        "want_launches_per_step": want_launches,
        "eager": timing["eager"], "fused": fused,
        "fused_over_eager_step": fused["step_wall_ms_median"]
        / timing["eager"]["step_wall_ms_median"]}
    bad = []
    if limits:
        summary["fused_vs_eager_within_train32_limits"] = near
        if (not finite or near["loss_max_abs_diff"] > TRAIN32_LOSS_TOL
                or near["update_rel_l2_diff"] > TRAIN32_UPD_TOL
                or near["worst_parameter_rel_diff"][0]
                > near["limits"][2]):
            bad.append("fused outside [train32]'s limits of eager "
                       "(or not finite)")
    elif not (reproducible and equal and finite):
        bad.append("not bit-equal (or not finite)")
    if fused["misses"] != 1 or fused["programs"] != 1:
        bad.append(f"{fused['misses']} captures for one signature")
    if fused["kernel_launches_per_step"] != want_launches:
        bad.append(f"replayed launches {fused['kernel_launches_per_step']}")
    if bool(want_launches) != bool(fused["wrapper_launches_at_capture"]):
        bad.append(f"wrapper launches at the capture "
                   f"{fused['wrapper_launches_at_capture']}")
    if bad:
        log(f"[{tag}] " + json.dumps(summary))
        raise SystemExit(f"chip_smoke: {tag}: {'; '.join(bad)}")
    return summary, path


def _profile_rows(step):
    """[name, device ms, launches] of every CUDA kernel of one more
    ``step()``, from ``torch.profiler`` (kernels inside a replayed CUDA
    graph included), largest first."""
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
    return rows


def _write_back_bytes(path):
    """Bytes the fused step's write-back must move: each weight's and
    state's new value read once and written once into its own storage,
    over the path's tensors; and how many tensors that is."""
    dst = path.tensors()
    return 2 * sum(t.numel() * t.element_size() for t in dst), len(dst)


# per replayed step of BERT-base and of the encoder (12 layers each): B2,
# B3, B4 on the fp32 tensor-core route (D = 64) and a split per pass
FUSED_ATTN_WANT = {"flash_fwd_tc32_kernel": ENC_LAYERS,
                   "flash_bwd_tc32_dq_kernel": ENC_LAYERS,
                   "flash_bwd_tc32_dkv_kernel": ENC_LAYERS,
                   "split_bf16x3_kernel": 2 * ENC_LAYERS}


def phase_fused_bert(card, peaks, train32):
    """BERT-base fp32 (dropout 0.1) at 8 x 512 through ``Trainer(...,
    "adamw")`` and ``trainer.fuse_step(model, SoftmaxCrossEntropyLoss())``:
    the captured step bit-equal to the eager loop over FUSED_STEPS steps
    (the rate halved after FUSED_LR_AT, with no new capture), 12/12/12
    attention launches and 24 splits per replayed step on the fp32
    tensor-core route; after REF_STEPS steps within [train32]'s limits of
    a reference run with plain attention and the same update."""
    from mxnet_tpu_torch.gluon import collect_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    tokens, labels = _train_batch(30522)
    loss_fn = SoftmaxCrossEntropyLoss()
    adamw = dict(ADAMW, multi_precision=False)

    def make(attention=None):
        def build():
            model = _seeded_bert(torch.float32)
            if attention is not None:
                for layer in model.layers:
                    layer.attn.attention = attention
            return model
        return _BlockPath(build, loss_fn, "adamw", adamw, tokens, labels)

    after2 = []

    def keep_after2(path, i):
        if i == REF_STEPS - 1 and path.fused is not None:
            after2.extend(p.detach().clone() for p in path.params.values())
        return []

    summary, path = _fused_against_eager("fused_bert", make,
                                         FUSED_ATTN_WANT, keep_after2)
    write_bytes, write_tensors = _write_back_bytes(path)
    names = list(path.params)
    del path
    gc.collect()
    torch.cuda.empty_cache()
    ref = make(flash_attention_ref)
    init = [p.detach().clone() for p in ref.params.values()]
    ref_losses = [float(ref.eager_step().float().mean())
                  for _ in range(REF_STEPS)]
    loss_err = max(abs(a - b) for a, b in zip(summary["fused_losses"],
                                              ref_losses))
    upd_err, worst = _update_diff(after2, [p.detach() for p in
                                           ref.params.values()], init, names)
    del ref, init, after2
    gc.collect()
    torch.cuda.empty_cache()
    summary.update({
        "card": card, "batch": [TRAIN_B, TRAIN_T], "dtype": "float32",
        "optimizer": {"adamw": adamw},
        "reference_losses": ref_losses,
        "loss_max_abs_diff_vs_plain_attention": loss_err,
        "update_rel_l2_diff_vs_plain_attention": upd_err,
        "worst_parameter_rel_diff": list(worst),
        # the replayed step's device-to-device copies: the write-back
        # (write_back_tensors copies) and any other copy the step makes
        "write_back_in_graph_ms": summary["fused"]["device_copy_ms"],
        "write_back_in_graph_copies":
            summary["fused"]["device_copy_launches"],
        "write_back_tensors": write_tensors,
        "write_back_bytes": write_bytes,
        "write_back_bound_ms": write_bytes / peaks["bytes"] * 1e3,
        "train32_sgd_step_wall_ms_median": train32["step_wall_ms_median"],
        "seconds": time.perf_counter() - t0})
    log("[fused_bert] " + json.dumps(summary))
    if (loss_err > TRAIN32_LOSS_TOL or upd_err > TRAIN32_UPD_TOL
            or worst[0] > TRAIN32_UPD_TOL_EACH):
        raise SystemExit("chip_smoke: fused_bert disagrees with the "
                         "plain-attention reference run")
    return summary


def phase_fused_resnet50(card):
    """ResNet-50 v1 (the zoo's, Xavier from SEED), fp32 (TF32 off), batch
    256, SGD with momentum and weight decay, through ``fuse_step``, twice.
    First with cuDNN's default convolution algorithms, which users run:
    they are not bit-reproducible run to run here (a filter gradient may
    sum in any order; reported as ``eager_bit_reproducible``), so the
    fused step is held to the eager loop within [train32]'s limits over
    FUSED_STEPS steps, and timed. That run takes RESNET_CHECK_LR: at
    RESNET_LR the fresh model's first steps amplify the summation order's
    rounding until two eager runs differ by more than those limits (the
    two eager runs' distance is reported). Then with cuDNN's deterministic
    algorithms (``cudnn.deterministic``), under which the eager step is
    reproducible: the captured step bit-equal to the eager loop over
    FUSED_STEPS steps, the BatchNorm running statistics (updated inside
    the graph) bit-equal after REF_STEPS steps; timed too. No attention
    launch in either."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    x, y = _resnet_batch(RESNET_B, torch.float32, "cuda")
    sgd = {"learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
           "wd": RESNET_WD}
    loss_fn = SoftmaxCrossEntropyLoss()

    def make(lr=RESNET_LR):
        return _BlockPath(lambda: _seeded_resnet50("cuda"), loss_fn, "sgd",
                          dict(sgd, learning_rate=lr), x, y)

    def stats_after2(path, i):
        return [p.detach().clone() for n, p in path.params.items()
                if "running" in n] if i == REF_STEPS - 1 else []

    default, path = _fused_against_eager(
        "fused_resnet50_cudnn_default", lambda: make(RESNET_CHECK_LR), {},
        limits=True)
    default["learning_rate"] = RESNET_CHECK_LR
    del path
    torch.backends.cudnn.deterministic = True
    try:
        summary, path = _fused_against_eager("fused_resnet50", make, {},
                                             stats_after2)
    finally:
        torch.backends.cudnn.deterministic = False
    n_stats = sum(1 for n in path.params if "running" in n)
    del path
    gc.collect()
    torch.cuda.empty_cache()
    summary.update({
        "card": card, "batch": RESNET_B, "dtype": "float32",
        "optimizer": {"sgd": sgd}, "running_statistics": n_stats,
        "cudnn_deterministic": True,
        "eager_bit_reproducible_cudnn_default":
            default["eager_bit_reproducible"],
        "cudnn_default": default,
        "seconds": time.perf_counter() - t0})
    log("[fused_resnet50] " + json.dumps(summary))
    return summary


def phase_fused_symbol(card, enc):
    """``StepFunction(sym, optimizer="adamw", ...)`` in symbol mode over
    [module_encoder]'s BERT-base-wide encoder (its graph and weights):
    bit-equal over FUSED_STEPS steps to the eager ``Executor.forward`` /
    ``backward`` and the list-form ``Updater`` with the same optimizer
    (the rate halved after FUSED_LR_AT with no new capture), its
    ``_fused_attention`` nodes launching B2/B3/B4 12/12/12 and 24 splits
    per replayed step; its step time beside [module_encoder]'s."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    x, y = (torch.from_numpy(rng.integers(0, ENC_VOCAB, (ENC_B, ENC_T))
                             .astype(np.float32)).cuda() for _ in range(2))
    adamw = dict(ADAMW, multi_precision=False)
    summary, path = _fused_against_eager(
        "fused_symbol", lambda: _SymbolPath("adamw", adamw, x, y),
        FUSED_ATTN_WANT)
    del path
    gc.collect()
    torch.cuda.empty_cache()
    mod = enc["summary"]
    summary.update({
        "card": card, "batch": [ENC_B, ENC_T], "dtype": "float32",
        "optimizer": {"adamw": adamw},
        "module_encoder_sgd_step_wall_ms_median": mod["step_wall_ms_median"],
        "module_encoder_device_busy_share": mod["device_busy_share"],
        "seconds": time.perf_counter() - t0})
    log("[fused_symbol] " + json.dumps(summary))
    return summary


# -- the sparse slice: [sparse_linear], [sparse_embedding], [sparse_params] --

def _zipf_cdf(n, s):
    """The CDF of a Zipf law of exponent ``s`` over ranks 0..n-1."""
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -s)
    return cdf / cdf[-1]


def _zipf_draws(rs, cdf, size):
    return np.minimum(np.searchsorted(cdf, rs.random_sample(size)),
                      cdf.size - 1)


def avazu_data(steps, batch=AVAZU_BATCH, features=AVAZU_FEATURES,
               fields=AVAZU_FIELDS, seed=SEED):
    """Synthetic batches at LIBSVM Avazu's width: each row one active
    feature (value 1) in each of ``fields`` equal fields, as Avazu's rows
    hold one one-hot value per categorical field, drawn from a Zipf law
    (``AVAZU_ZIPF``) over the field's ids in a fixed shuffled order, so
    that ids repeat within a batch and many never come; labels are the
    sign of a random true weight's sum over the row. ``(column ids
    (batch * fields,) sorted within each row, labels (batch, 1))`` per
    step, and the initial weight (features, 1) ~ N(0, 0.01^2)."""
    rs = np.random.RandomState(seed)
    bounds = np.linspace(0, features, fields + 1).astype(np.int64)
    sizes = [int(n) for n in np.diff(bounds)]
    perms = [rs.permutation(n) for n in sizes]
    cdfs = [_zipf_cdf(n, AVAZU_ZIPF) for n in sizes]
    true_w = rs.randn(features).astype(np.float32)
    w_init = (rs.randn(features, 1) * 0.01).astype(np.float32)
    data = []
    for _ in range(steps):
        cols = np.stack([bounds[f] + perms[f][_zipf_draws(rs, cdfs[f], batch)]
                         for f in range(fields)], 1)
        y = (true_w[cols].sum(1, keepdims=True) > 0).astype(np.float32)
        data.append((cols.reshape(-1), y))
    return data, w_init


def _counted(fn, cuda):
    """``fn()`` under torch's sync debug mode ("warn") on CUDA: its result,
    the number of synchronizing CUDA calls it made (each warns), and the
    other warnings' messages."""
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in ws)
    return out, syncs, [str(w.message) for w in ws
                        if "synchroniz" not in str(w.message)]


def linear_grad_fp64(x, y, w, b):
    """The gradient of the mean logistic loss with respect to every
    feature's weight, in fp64 from the batch's payload: the check of
    ``w.grad``'s values."""
    a = x._aux
    cols, rows = a["indices"], x._row_ids()
    vals = a["values"].double()
    w64 = w._data.detach()[:, 0].double()
    logit = torch.zeros(x.shape[0], dtype=torch.float64,
                        device=vals.device).index_add_(
        0, rows, vals * w64[cols]) + b._data.detach().double()
    sign = 2 * y._data[:, 0].double() - 1
    dlogit = -sign * torch.sigmoid(-sign * logit) / x.shape[0]
    return torch.zeros(x.shape[1], dtype=torch.float64,
                       device=vals.device).index_add_(0, cols,
                                                      vals * dlogit[rows])


def sparse_linear_run(data, w_init, device, steps, check=None,
                      measure=False):
    """``examples/sparse/linear_classification.py``'s loop through the
    port's public API on ``device``: the csr batches built from their
    payload on the device, ``w.attach_grad(stype="row_sparse")``,
    ``nd.dot(csr, w) + b``, the example's logistic loss, AdaGrad through
    the ``Updater``. Each step's syncs are counted (forward and backward,
    then the update, each under the sync debug mode) and ``check(i, x, y,
    w, b)`` runs between them; or, with ``measure``, each step is timed
    whole (ending in a synchronize, after a garbage collection before
    the loop) and one more step is profiled after the loop."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd, optimizer
    from mxnet_tpu_torch.ndarray import sparse
    cuda = device == "cuda"
    ctx = mx.gpu(0) if cuda else mx.cpu()
    with ctx:
        batches = []
        for cols, y in data[:steps]:
            nnz = cols.size
            x = sparse.csr_matrix(
                (torch.ones(nnz), torch.from_numpy(cols),
                 torch.arange(0, nnz + 1, AVAZU_FIELDS)),
                shape=(y.shape[0], w_init.shape[0]), ctx=ctx)
            batches.append((x, nd.array(y)))
        w, b = nd.array(w_init), nd.zeros((1,))
        w.attach_grad(stype="row_sparse")
        b.attach_grad()
        upd = optimizer.get_updater(optimizer.create(
            "adagrad", learning_rate=SPARSE_LINEAR_LR,
            rescale_grad=1.0 / AVAZU_BATCH))

        def forward_backward(x, y):
            with autograd.record():
                loss = nd.mean(nd.log(1 + nd.exp(
                    -(2 * y - 1) * (nd.dot(x, w) + b))))
            loss.backward()
            return loss

        def update():
            upd(0, w.grad, w)
            upd(1, b.grad, b)

        def step(x, y):
            loss = forward_backward(x, y)
            update()
            return loss

        out = {"losses": [], "walls": [], "syncs": [], "warnings": []}
        if measure:
            gc.collect()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i, (x, y) in enumerate(batches):
                if measure:
                    if cuda:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    loss = step(x, y)
                    if cuda:
                        torch.cuda.synchronize()
                    out["walls"].append((time.perf_counter() - t0) * 1e3)
                else:
                    loss, n, msgs = _counted(
                        lambda: forward_backward(x, y), cuda)
                    if check:
                        check(i, x, y, w, b)
                    _, n2, msgs2 = _counted(update, cuda)
                    out["syncs"].append(n + n2)
                    out["warnings"] += msgs + msgs2
                out["losses"].append(loss)
                if i == 1:
                    out["w_after2"] = w._data.detach().clone()
        out["warnings"] += [str(m.message) for m in caught]
        out["losses"] = [float(v.asscalar()) for v in out["losses"]]
        out.update(w=w._data.detach().clone(), b=b._data.detach().clone(),
                   history=upd.states[0].clone(), batches=batches,
                   last_grad=w.grad, w_nd=w)
        if measure and cuda:
            out["profile"] = profiled_step(lambda: step(*batches[0]))
    return out


def phase_sparse_linear(card):
    """[sparse_linear]: ``linear_classification.py``'s loop at Avazu width
    (1,000,001 features, batches of 8192) on the card, 1 + 8 steps, run
    twice; then its first two steps on the CPU. Fails unless: no batch was
    densified and no storage-fallback warning came; every step's ``w.grad``
    is row_sparse on the sorted union of its batch's columns, with values
    within ``SPARSE_LINEAR_TOL`` of ``linear_grad_fp64``; the rows no batch
    touched keep their bits in the weight and AdaGrad's history; the CPU's
    first two losses and touched rows are within ``SPARSE_LINEAR_TOL``; the
    second card run is bit-equal to the first; the loss is finite and
    falls; the phase's peak memory is under ``SPARSE_LINEAR_PEAK``."""
    from mxnet_tpu_torch.ndarray import sparse
    t0 = time.perf_counter()
    data, w_init = avazu_data(SPARSE_LINEAR_STEPS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sparse._fallback_warned.clear()
    grad_err, grad_rows = [], []

    def check(i, x, y, w, b):
        g = w.grad
        rows = g._aux["indices"]
        grad_rows.append(g.stype == "row_sparse" and torch.equal(
            rows, torch.unique(x._aux["indices"])))
        ref = linear_grad_fp64(x, y, w, b)[rows]
        grad_err.append(float((g._aux["values"][:, 0].double() - ref)
                              .abs().max() / ref.abs().max()))
    first = sparse_linear_run(data, w_init, "cuda", SPARSE_LINEAR_STEPS,
                              check=check)
    second = sparse_linear_run(data, w_init, "cuda", SPARSE_LINEAR_STEPS,
                               measure=True)
    peak = torch.cuda.max_memory_allocated() - base
    cpu = sparse_linear_run(data, w_init, "cpu", 2)
    touched = torch.zeros(AVAZU_FEATURES, dtype=torch.bool)
    touched2 = touched.clone()
    for i, (cols, _) in enumerate(data):
        touched[torch.from_numpy(cols)] = True
        if i == 1:
            touched2 = touched.clone()
    w_card, hist = first["w"].cpu(), first["history"].cpu()
    untouched = ~touched
    unchanged = bool(torch.equal(w_card[untouched],
                                 torch.from_numpy(w_init)[untouched])
                     and not hist[untouched].any())
    w2 = first["w_after2"].cpu()[touched2]
    cpu_rows_err = float((w2 - cpu["w"][touched2]).abs().max()
                         / cpu["w"][touched2].abs().max())
    cpu_loss_err = max(abs(a - c) / abs(c) for a, c in
                       zip(first["losses"][:2], cpu["losses"]))
    bit_equal = (first["losses"] == second["losses"]
                 and torch.equal(first["w"], second["w"])
                 and torch.equal(first["b"], second["b"])
                 and torch.equal(first["history"], second["history"]))
    densified = any(x.densified() for run in (first, second)
                    for x, _ in run["batches"])
    fallbacks = [m for run in (first, second) for m in run["warnings"]
                 if "dense implementation" in m]
    losses = first["losses"]
    steady = second["walls"][1:]
    step_ms = float(np.median(steady))
    kernel_ms, _, top = second["profile"]
    x0 = first["batches"][0][0]
    row = {
        "card": card, "features": AVAZU_FEATURES, "batch": AVAZU_BATCH,
        "fields": AVAZU_FIELDS, "zipf_exponent": AVAZU_ZIPF,
        "steps": SPARSE_LINEAR_STEPS, "optimizer": "adagrad",
        "lr": SPARSE_LINEAR_LR,
        "nnz_per_batch": int(x0._aux["values"].numel()),
        "unique_columns_per_batch": [int(np.unique(c).size)
                                     for c, _ in data],
        "untouched_rows": int(untouched.sum()),
        "losses": losses, "grad_rows_are_batch_union": grad_rows,
        "grad_max_rel_err": max(grad_err), "tol": SPARSE_LINEAR_TOL,
        "untouched_rows_bit_unchanged": unchanged,
        "cpu_loss_rel_err": cpu_loss_err,
        "cpu_touched_rows_rel_err": cpu_rows_err,
        "second_run_bit_equal": bit_equal, "densified": densified,
        "fallback_warnings": fallbacks,
        "step_ms": steady, "step_ms_median": step_ms,
        "samples_per_s": AVAZU_BATCH / (step_ms / 1e3),
        "host_syncs_per_step": first["syncs"],
        "profiled_kernel_ms": kernel_ms,
        "device_busy_share": kernel_ms / step_ms, "top_kernels_ms": top,
        "peak_memory_bytes": peak, "peak_limit_bytes": SPARSE_LINEAR_PEAK,
        "seconds": time.perf_counter() - t0}
    log("[sparse_linear] " + json.dumps(row))
    if not (all(grad_rows) and max(grad_err) <= SPARSE_LINEAR_TOL
            and unchanged and cpu_loss_err <= SPARSE_LINEAR_TOL
            and cpu_rows_err <= SPARSE_LINEAR_TOL and bit_equal
            and not densified and not fallbacks
            and all(np.isfinite(losses)) and losses[-1] < losses[0]
            and peak < SPARSE_LINEAR_PEAK):
        raise SystemExit(f"chip_smoke: sparse_linear: {row}")
    # what [sparse_params] saves: the weight's rows the last gradient
    # names (row_sparse), that gradient and a slice of the first batch
    w_rs = sparse.cast_storage(first["w_nd"], "row_sparse").retain(
        first["last_grad"].indices)
    row["params_arrays"] = {"weight": w_rs, "grad": first["last_grad"],
                            "batch": x0.slice(0, 256)}
    return row


def sparse_embedding_run(name, kwargs, steps=EMB_STEPS, vocab=EMB_VOCAB,
                         device="cuda"):
    """A sparse-gradient embedding of ``vocab`` x ``EMB_DIM`` (fp32, random
    from the seed) trained toward a fixed random target table by the
    summed squared error of each step's ``EMB_BATCH`` x ``EMB_BPTT`` ids
    (Zipf, exponent ``EMB_ZIPF``, over the frequency-ordered vocabulary),
    through ``nd.Embedding(..., sparse_grad=True)``, ``w.attach_grad(
    stype="row_sparse")`` and the lazy update of optimizer ``name``.
    Before each update it checks the gradient against the per-id sums in
    fp64 and runs the dense optimizer on the touched rows' copies, after
    it compares; then the untouched rows, and the dense update of the
    whole table timed against the lazy one."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd, optimizer
    cuda = device == "cuda"
    rs = np.random.RandomState(SEED + 3)
    cdf = _zipf_cdf(vocab, EMB_ZIPF)
    ids_np = [_zipf_draws(rs, cdf, (EMB_BATCH, EMB_BPTT)).astype(np.int32)
              for _ in range(steps)]
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    w0 = torch.randn(vocab, EMB_DIM, device=device, generator=gen) * 0.1
    target = torch.randn(vocab, EMB_DIM, device=device, generator=gen)
    tokens = EMB_BATCH * EMB_BPTT
    kw = dict(kwargs, rescale_grad=1.0 / tokens, wd=0.0)
    out = {"losses": [], "grad_rows_are_unique_ids": [], "grad_rel_err": [],
           "rows_vs_dense_max_abs": [], "syncs": [], "lazy_update_ms": [],
           "warnings": [], "unique_ids": []}
    with (mx.gpu(0) if cuda else mx.cpu()):
        w, tgt = nd.array(w0), nd.from_dlpack(target)
        w.attach_grad(stype="row_sparse")
        upd = optimizer.get_updater(optimizer.create(name, **kw))
        dense_ref = optimizer.create(name, **kw)
        ids_list = [nd.array(i, dtype="int32") for i in ids_np]
        touched = torch.zeros(vocab, dtype=torch.bool, device=device)
        for ids in ids_list:
            def forward_backward():
                with autograd.record():
                    emb = nd.Embedding(ids, w, input_dim=vocab,
                                       output_dim=EMB_DIM, sparse_grad=True)
                    diff = emb - nd.Embedding(ids, tgt, input_dim=vocab,
                                              output_dim=EMB_DIM)
                    loss = nd.sum(nd.square(diff))
                loss.backward()
                return loss, diff
            (loss, diff), n, msgs = _counted(forward_backward, cuda)
            g = w.grad
            rows = g._aux["indices"]
            uniq, inv = torch.unique(ids._data.long(), return_inverse=True)
            touched[uniq] = True
            out["unique_ids"].append(int(uniq.numel()))
            out["grad_rows_are_unique_ids"].append(
                g.stype == "row_sparse" and torch.equal(rows, uniq))
            ref = torch.zeros(uniq.numel(), EMB_DIM, dtype=torch.float64,
                              device=device).index_add_(
                0, inv.reshape(-1),
                2 * diff._data.detach().double().reshape(-1, EMB_DIM))
            out["grad_rel_err"].append(float(
                (g._aux["values"].double() - ref).abs().max()
                / ref.abs().max()))
            # the dense optimizer on copies of the touched rows and of
            # their state, from the state before the step
            state = upd.states.get(0)
            parts = [] if state is None else \
                list(state) if isinstance(state, tuple) else [state]
            w_rows = w._data.detach()[rows].clone()
            st_rows = [p[rows].clone() for p in parts] or [
                torch.zeros_like(w_rows) for _ in range(
                    2 if name == "adam" else 1)]
            dense_ref.update(0, w_rows, g._aux["values"].clone(),
                             tuple(st_rows) if name == "adam"
                             else st_rows[0])
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, n2, msgs2 = _counted(lambda: upd(0, w.grad, w), cuda)
            if cuda:
                torch.cuda.synchronize()
            out["lazy_update_ms"].append((time.perf_counter() - t0) * 1e3)
            state = upd.states[0]
            parts = list(state) if isinstance(state, tuple) else [state]
            out["rows_vs_dense_max_abs"].append(max(
                float((a[rows] - b).abs().max())
                for a, b in zip([w._data.detach()] + parts,
                                [w_rows] + st_rows)))
            out["syncs"].append(n + n2)
            out["warnings"] += msgs + msgs2
            out["losses"].append(float(loss.asscalar()) / tokens)
        wt = w._data.detach()
        out["untouched_rows"] = int((~touched).sum())
        out["untouched_rows_bit_unchanged"] = not bool(
            ((wt != w0).any(1) & ~touched).any()) and not any(
            bool(((p != 0).any(1) & ~touched).any()) for p in parts)
        del w0, target, tgt
        # the dense update of the whole table from the densified gradient,
        # timed in this call beside the lazy one (it moves every row)
        if cuda:
            gd = w.grad._data
            dense = optimizer.create(name, **kw)
            st = tuple(parts) if name == "adam" else parts[0]
            out["dense_update_ms"] = cuda_ms(
                lambda: dense.update(0, wt, gd, st), iters=3, warm=1)
            del gd
    out["lazy_update_ms_median"] = float(np.median(out["lazy_update_ms"][1:]))
    return out


def phase_sparse_embedding(card):
    """[sparse_embedding]: the One Billion Word LM's vocabulary (793,471 x
    512 fp32, 1.62 GB; Adam's states 3.25 GB more) with a sparse-gradient
    ``nd.Embedding``, trained by lazy Adam and by lazy SGD with momentum
    0.9 for ``EMB_STEPS`` steps each. Fails unless every step's gradient
    rows are the sorted unique ids and its values the per-id sums within
    ``EMB_TOL``, the touched rows are within ``EMB_TOL`` of the dense
    optimizer's on them from the same state, the untouched rows of the
    weight and every state keep their bits, no storage-fallback warning
    came, and the loss falls. The lazy update's time beside the dense
    update of the same table is reported, not held."""
    from mxnet_tpu_torch.ndarray import sparse
    t0 = time.perf_counter()
    sparse._fallback_warned.clear()
    runs = {}
    for name, kwargs in (("adam", {"learning_rate": 0.05}),
                         ("sgd", {"learning_rate": 1.0, "momentum": 0.9})):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = sparse_embedding_run(name, kwargs)
        run["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
        runs[name] = run
        torch.cuda.empty_cache()
    row = {"card": card, "vocab": EMB_VOCAB, "dim": EMB_DIM,
           "ids_per_step": [EMB_BATCH, EMB_BPTT], "zipf_exponent": EMB_ZIPF,
           "steps": EMB_STEPS, "tol": EMB_TOL,
           **{name: {k: v for k, v in run.items()} for name, run in
              runs.items()},
           "seconds": time.perf_counter() - t0}
    log("[sparse_embedding] " + json.dumps(row))
    for name, run in runs.items():
        if not (all(run["grad_rows_are_unique_ids"])
                and max(run["grad_rel_err"]) <= EMB_TOL
                and max(run["rows_vs_dense_max_abs"]) <= EMB_TOL
                and run["untouched_rows_bit_unchanged"]
                and not any("dense implementation" in m
                            for m in run["warnings"])
                and all(np.isfinite(run["losses"]))
                and run["losses"][-1] < run["losses"][0]):
            raise SystemExit(f"chip_smoke: sparse_embedding: {name}: "
                             f"{row}")
    return row


def phase_sparse_params(card, linear):
    """[sparse_params]: ``nd.save`` on the card of [sparse_linear]'s
    row_sparse weight rows, its last row_sparse gradient and a 256-row csr
    slice of its first batch, and ``nd.load`` back onto the card. Fails
    unless every loaded payload (values, indices, indptr) is bit-equal to
    what was saved and the file's bytes equal those of a save of the same
    arrays moved to the CPU everywhere except each entry's device type
    (2, the GPU, against the CPU's 1: MXNet's format records the
    context)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ndarray import serialization
    arrays = linear.pop("params_arrays")
    tmp = tempfile.mkdtemp(prefix="sparse_params_")
    try:
        path = os.path.join(tmp, "sparse.params")
        nd.save(path, arrays)
        loaded = nd.load(path, ctx=mx.gpu(0))
        with open(path, "rb") as f:
            card_bytes = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cpu_bytes = serialization.save_bytes(
        [a.as_in_context(mx.cpu()) for a in arrays.values()], list(arrays))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    same = {k: (loaded[k].stype == a.stype and loaded[k].shape == a.shape
                and loaded[k].device.type == "cuda"
                and all(torch.equal(bits(loaded[k]._aux[n]), bits(v))
                        for n, v in a._aux.items() if not n.startswith("_")))
            for k, a in arrays.items()}
    cb, pb = (np.frombuffer(b, np.uint8) for b in (card_bytes, cpu_bytes))
    diff = np.nonzero(cb != pb)[0] if cb.size == pb.size else None
    bytes_ok = diff is not None and diff.size == len(arrays) and bool(
        (cb[diff] == 2).all() and (pb[diff] == 1).all())
    row = {"card": card, "entries": {k: [a.stype, list(a.shape),
                                         int(a._aux["values"].shape[0])]
                                     for k, a in arrays.items()},
           "file_bytes": len(card_bytes), "loaded_bit_equal": same,
           "bytes_equal_cpu_save_but_device_type": bytes_ok,
           "differing_bytes": None if diff is None else int(diff.size)}
    log("[sparse_params] " + json.dumps(row))
    if not (all(same.values()) and bytes_ok):
        raise SystemExit(f"chip_smoke: sparse_params: {row}")
    return row


# each port kernel's symbols in the profiler (substrings): every design of
# the forward and of the backward passes counts under one name
# ---------------------------------------------------------------------------
# autoregressive LM serving (serve2): [decode_serve], [decode_prefix],
# [decode_spec], [decode_quant], [decode_router]
# ---------------------------------------------------------------------------

# the LM stack of parallel/pipeline_lm.py at Cerebras-GPT-1.3B's widths
# (arXiv:2304.03208, Table 1: 24 x 2048, 16 heads of 128, FFN 8192, vocab
# 50257) with one expert (the gate is the constant 1: a dense FFN), fp32,
# random weights from SEED drawn on the card (numpy's draw of its 1.41e9
# values takes ~60 s on a host core) with init_pipeline_lm's scales but
# one: init_pipeline_lm scales wqkv (L, 3, D, H, K) by 1/sqrt(H), its
# second-to-last axis, where the projection's fan-in is D. At D = 2048, H
# = 16 that is 11.3x 1/sqrt(D): attention logits ~100, every softmax
# saturated, and the model chaotic in fp32 (a first chip run of this
# phase with that scale: dense_lm_logits in fp32 5.13 max abs from fp64
# on logits of at most 4.6, and 58-64 of 64 greedy tokens off the fp64
# oracle's argmax). A trained model is not so: wqkv takes 1/sqrt(D) here
DECODE_LM = dict(vocab=50257, d_model=2048, n_layers=24, n_heads=16,
                 d_head=128, d_ff=8192, n_experts=1)
DECODE_PAGE, DECODE_POOL_BYTES = 16, 8 << 30
DECODE_INFLIGHT, DECODE_BUCKETS = 8, (128, 256, 512)
DECODE_MAX_NEW, DECODE_STEPS = 64, 4
DECODE_REQUESTS, DECODE_CLIENTS, DECODE_PROMPTS = 32, 8, (64, 480)
# a pool of 40 pages (39 usable) for 8 requests of 256 + 64 tokens (16
# pages at admission, 20 at the end): growth must preempt
DECODE_SMALL_PAGES, DECODE_PREEMPT_N, DECODE_PREEMPT_PROMPT = 40, 8, 256
PREFIX_N, PREFIX_LEN, PREFIX_SUFFIX = 16, 256, (32, 128)
SPEC_DRAFT_LAYERS, SPEC_TOKENS, SPEC_N = 4, 4, 8
ROUTER_POOL_BYTES, ROUTER_N = 2 << 30, 16
DECODE_CHECK_STEPS = 8
# the paged logits (one prefill, DECODE_CHECK_STEPS decode steps) against
# dense_lm_logits: within the fusion class, or else, as ERR_OVER_CC holds
# the attention kernels, the paged path's max abs error against an fp64
# evaluation of the dense oracle within DECODE_ERR_RATIO times the fp32
# dense oracle's own: both are fp32 evaluations of one function whose
# products and sums are ordered differently (the paged decode takes one
# row through each GEMM and reads K/V back through a gather), and 24
# layers of such roundings, random in sign, leave neither side more than
# a small factor from the other; 2 as for the kernels. Two logits of one
# row then differ from the fp32 oracle's by at most (DECODE_ERR_RATIO + 1)
# x its error each, so an engine token may differ from the oracle's argmax
# only where the two logits are within twice that ("flips", counted)
DECODE_ERR_RATIO = 2.0


def _seeded_pipeline_lm():
    """``init_pipeline_lm``'s tree at DECODE_LM's widths, drawn on the
    card from SEED: each normal leaf N(0, 1) times its scale, the norms 1,
    the biases 0 (``pipeline_lm_spec``'s order and scales, wqkv's fan-in
    D: see DECODE_LM)."""
    from mxnet_tpu_torch.parallel.pipeline_lm import pipeline_lm_spec
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tree = {}
    for path, shape, init in pipeline_lm_spec(**DECODE_LM):
        if path == ("layers", "wqkv"):
            init = 1.0 / np.sqrt(DECODE_LM["d_model"])
        if init in ("ones", "zeros"):
            val = (torch.ones if init == "ones" else torch.zeros)(
                shape, dtype=torch.float32, device="cuda")
        else:
            val = torch.empty(shape, dtype=torch.float32, device="cuda")
            val.normal_(0.0, float(init), generator=gen)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


def _tree_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_tensors(v)
        else:
            yield v


def _decode_engine(params, name, pool_bytes=None, **kw):
    from mxnet_tpu_torch.serve2 import DecodeEngine, PagedLM
    kv = kw.get("kv_dtype", "f32")
    pool_bytes = DECODE_POOL_BYTES if pool_bytes is None else pool_bytes
    args = dict(page_size=DECODE_PAGE, max_inflight=DECODE_INFLIGHT,
                prefill_buckets=list(DECODE_BUCKETS),
                max_new_default=DECODE_MAX_NEW, decode_steps=DECODE_STEPS,
                name=name, device="cuda",
                num_pages=PagedLM.pages_for_bytes(
                    pool_bytes, page_size=DECODE_PAGE,
                    n_layers=DECODE_LM["n_layers"],
                    n_heads=DECODE_LM["n_heads"],
                    d_head=DECODE_LM["d_head"], kv_dtype=kv))
    args.update(kw)
    eng = DecodeEngine(params, **args)
    eng.warmup()
    return eng


def _serve_all(engine, prompts, clients, max_new=None):
    """Every prompt through ``engine.submit`` from ``clients`` closed-loop
    clients; returns (handles, the loadgen's summary)."""
    from mxnet_tpu_torch.serve import run_loadgen
    handles = {}

    def fire(i):
        h = handles[i] = engine.submit(prompts[i], max_new_tokens=max_new)
        h.wait()
        if h.error is not None:
            raise h.error
    load = run_loadgen(fire, list(range(len(prompts))), concurrency=clients)
    if load["completed"] != len(prompts) or load["errors"]:
        raise SystemExit(f"chip_smoke: decode requests failed: "
                         f"{load['errors'][:3]}")
    return [handles[i] for i in range(len(prompts))], load


def _latency_summary(handles, wall_s):
    """Time to first token and per output token (p50/p99, from each
    handle's host stamps) and output tokens/s over ``wall_s``."""
    from mxnet_tpu_torch.telemetry.metrics import percentile_of as pct
    ttft = sorted(h.t_first_token - h.t_submit for h in handles)
    tpot = sorted((h.t_done - h.t_first_token) / (len(h.result) - 1)
                  for h in handles if len(h.result) > 1)
    out_tokens = sum(len(h.result) for h in handles)
    return {"ttft_p50_ms": pct(ttft, 50) * 1e3,
            "ttft_p99_ms": pct(ttft, 99) * 1e3,
            "tpot_p50_ms": pct(tpot, 50) * 1e3,
            "tpot_p99_ms": pct(tpot, 99) * 1e3,
            "output_tokens": out_tokens,
            "output_tokens_per_s": out_tokens / wall_s, "wall_s": wall_s}


def _audit_clean(engine, tag):
    from mxnet_tpu_torch.passes.servelint import (lint_page_audit,
                                                  lint_serve_report)
    bad = [repr(f) for f in lint_page_audit(engine.page_audit())
           + lint_serve_report(engine.lint_report())
           if f.severity == "error"]
    if bad:
        raise SystemExit(f"chip_smoke: {tag}: servelint errors {bad[:3]}")


def _paged_logits(lm, prompt, steps, forced=None):
    """One prefill of ``prompt`` and ``steps`` decode steps through ``lm``
    (one row, pages 1..), feeding its own greedy tokens or ``forced``:
    (tokens fed after the prompt, logits (steps + 1, V) on the card)."""
    bt = np.zeros((1, lm.max_pages), np.int32)
    bt[0, :lm.max_pages] = np.arange(1, lm.max_pages + 1)
    rung = min(b for b in DECODE_BUCKETS if b >= len(prompt))
    padded = np.zeros((rung,), np.int32)
    padded[:len(prompt)] = prompt
    nxt, last = lm.prefill(padded, len(prompt), bt[0])
    rows, fed = [last], []
    for s in range(steps):
        tok = forced[s] if forced is not None else nxt
        fed.append(int(tok))
        out, logits = lm.decode(bt, np.array([len(prompt) + s], np.int32),
                                np.array([tok], np.int32),
                                np.ones((1,), np.int32))
        nxt = int(out[0, 0])
        rows.append(logits[0])
    return fed, torch.stack(rows)


def _logit_check(params, prompt):
    """[decode_serve]'s logit check: the f32 pool's paged logits against
    dense_lm_logits in fp32 and fp64. Returns the paged run (for
    [decode_quant]) and the per-logit limit the flips rule uses."""
    from mxnet_tpu_torch.opt.verify import tolerance_for
    from mxnet_tpu_torch.parallel.pipeline_lm import dense_lm_logits
    from mxnet_tpu_torch.serve2 import PagedLM
    lm = PagedLM(params, page_size=DECODE_PAGE, num_pages=40,
                 max_pages_per_seq=39, name="check-f32", device="cuda")
    fed, paged = _paged_logits(lm, prompt, DECODE_CHECK_STEPS)
    del lm
    tokens = torch.tensor([prompt + fed], device="cuda")
    rows = slice(len(prompt) - 1, len(prompt) + DECODE_CHECK_STEPS)
    dense32 = dense_lm_logits(params, tokens)[0, rows]
    params64 = {k: ({kk: vv.double() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.double())
                for k, v in params.items()}
    dense64 = dense_lm_logits(params64, tokens)[0, rows]
    del params64
    gc.collect()
    torch.cuda.empty_cache()
    rtol, atol = tolerance_for("fusion", "float32")
    in_fusion = bool(torch.allclose(paged, dense32, rtol=rtol, atol=atol))
    err = float((paged - dense32).abs().max())
    dense_err64 = float((dense32.double() - dense64).abs().max())
    paged_err64 = float((paged.double() - dense64).abs().max())
    ratio = paged_err64 / dense_err64
    limit = (DECODE_ERR_RATIO + 1) * dense_err64
    log(f"[decode_serve] paged logits (prefill + {DECODE_CHECK_STEPS} "
        f"decode steps, prompt {len(prompt)}) vs dense_lm_logits: max abs "
        f"{err:.3e}; within fusion (rtol {rtol}, atol {atol}): {in_fusion}; "
        f"vs fp64: paged {paged_err64:.3e}, dense fp32 {dense_err64:.3e}, "
        f"ratio {ratio:.3f} (limit {DECODE_ERR_RATIO}); max |logit| "
        f"{float(dense64.abs().max()):.3f}; greedy tokens agree: "
        f"{bool((paged.argmax(-1) == dense32.argmax(-1)).all())}")
    if not (in_fusion or ratio <= DECODE_ERR_RATIO):
        raise SystemExit("chip_smoke: paged logits disagree with the dense "
                         "oracle")
    return {"fed": fed, "logits": paged, "max_abs_err": err,
            "in_fusion": in_fusion, "paged_fp64_err": paged_err64,
            "dense_fp64_err": dense_err64, "err_ratio": ratio,
            "logit_limit": limit}


def _teacher_forced(params, prompt, tokens, limit):
    """The engine's greedy ``tokens`` after ``prompt`` against
    dense_lm_logits over prompt + tokens: the number of positions whose
    token differs from the oracle's argmax (each allowed only where the
    two logits are within 2 * ``limit``) and the largest such gap."""
    from mxnet_tpu_torch.parallel.pipeline_lm import dense_lm_logits
    seq = torch.tensor([list(prompt) + list(tokens)[:-1]], device="cuda")
    lg = dense_lm_logits(params, seq)[0, len(prompt) - 1:]
    tok = torch.tensor(list(tokens), device="cuda")
    top = lg.max(-1).values
    mine = lg.gather(1, tok[:, None])[:, 0]
    gaps = (top - mine)[tok != lg.argmax(-1)]
    flips = int(gaps.numel())
    worst = float(gaps.max()) if flips else 0.0
    if worst > 2 * limit:
        raise SystemExit(f"chip_smoke: an engine token's logit is "
                         f"{worst:.3e} under the oracle's top-1 (limit "
                         f"{2 * limit:.3e})")
    return flips, worst


def _same_or_near_tie(params, prompts, got, want, limit, tag):
    """Trajectories ``got`` equal to ``want``, or diverging first where
    the dense oracle, teacher-forced over the common prefix, has the two
    tokens within 2 * ``limit`` (a near-tie, counted)."""
    from mxnet_tpu_torch.parallel.pipeline_lm import dense_lm_logits
    ties = 0
    for p, a, b in zip(prompts, got, want):
        a, b = list(a), list(b)
        if a == b:
            continue
        j = next(i for i in range(min(len(a), len(b))) if a[i] != b[i])
        lg = dense_lm_logits(params, torch.tensor(
            [list(p) + a[:j]], device="cuda"))[0, -1]
        gap = float((lg[a[j]] - lg[b[j]]).abs())
        if gap > 2 * limit:
            raise SystemExit(f"chip_smoke: {tag}: trajectories differ at "
                             f"token {j} by a logit gap of {gap:.3e} "
                             f"(limit {2 * limit:.3e})")
        ties += 1
    return ties


def _decode_rung_ms(lm, rungs, context=300):
    """Host ms of one ``decode`` call (DECODE_STEPS tokens a row) at each
    batch rung, rows of ``context`` cached tokens on distinct free pages,
    median of 3 after one warm call, and its device ms (CUDA events)."""
    per_row = -(-(context + DECODE_STEPS) // lm.page_size)
    out = {}
    for b in rungs:
        bt = np.zeros((b, lm.max_pages), np.int32)
        bt[:, :per_row] = 1 + np.arange(b * per_row).reshape(b, per_row)
        args = (bt, np.full((b,), context, np.int32),
                np.arange(b, dtype=np.int32) + 7,
                np.full((b,), DECODE_STEPS, np.int32))
        lm.decode(*args)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            lm.decode(*args)
            walls.append((time.perf_counter() - t0) * 1e3)
        dev = cuda_ms(lambda: lm.decode_device(*args), iters=3, warm=0)
        out[b] = {"call_ms": sorted(walls)[1], "device_ms": dev,
                  "per_step_ms": sorted(walls)[1] / DECODE_STEPS}
    return out


def _profiled_window(fn):
    """Wall ms of ``fn()`` (synchronised) and the device time of its
    kernels from ``torch.profiler``: (wall_ms, kernel_ms, top ten)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append([e.key[:80], us / 1e3, e.count])
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows[:10]


def phase_decode_serve(card, peaks, params):
    """[decode_serve]: one DecodeEngine at the 1.3B widths under 8
    closed-loop clients, its gates and its time split; then a 40-page
    engine that must preempt. Returns what the later decode phases
    compare with."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    engine = _decode_engine(params, "gpt13b")
    lm = engine.lm
    where = {str(t.device) for t in list(_tree_tensors(lm.params))
             + list(lm.pools.values())} | {str(lm.device)}
    if where != {"cuda:0"}:
        raise SystemExit(f"chip_smoke: decode tensors on {where}")
    ptrs = {k: v.data_ptr() for k, v in lm.pools.items()}
    log(f"[decode_serve] DecodeEngine: {lm.num_pages} pages of "
        f"{DECODE_PAGE} slots ({lm.pool_bytes} B of f32 pools), rungs "
        f"decode {engine.decode_rungs} prefill {engine.prefill_rungs}, "
        f"max_seq_len {engine.max_seq_len}, decode_steps {DECODE_STEPS}, "
        f"attention {lm.attention}; "
        f"{sum(t.numel() for t in _tree_tensors(params))} parameters")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(DECODE_PROMPTS[0], DECODE_PROMPTS[1] + 1,
                        DECODE_REQUESTS)
    prompts = [rng.integers(0, DECODE_LM["vocab"], n).tolist() for n in lens]
    handles, load = _serve_all(engine, prompts, DECODE_CLIENTS)
    lat = _latency_summary(handles, load["wall_s"])
    results = [h.result.tolist() for h in handles]
    if any(len(r) != DECODE_MAX_NEW for r in results):
        raise SystemExit("chip_smoke: a request stopped short")
    # host syncs per tick, counted by the sync debug mode over 8 more
    # requests (64-token prompts, 32 tokens each)
    ticks0 = engine.stats()["ticks"]
    (_, _), syncs, _ = _counted(lambda: _serve_all(
        engine, [p[:64] for p in prompts[:8]], 8, max_new=32), True)
    ticks = engine.stats()["ticks"] - ticks0
    rungs = _decode_rung_ms(lm, engine.decode_rungs)
    wall, kernel_ms, top = _profiled_window(lambda: _serve_all(
        engine, [p[:128] for p in prompts[8:16]], 8, max_new=32))
    st = engine.stats()
    if st["recompiles_after_warmup"] != 0:
        raise SystemExit(f"chip_smoke: {st['recompiles_after_warmup']} "
                         "signatures after warmup")
    if ptrs != {k: v.data_ptr() for k, v in lm.pools.items()}:
        raise SystemExit("chip_smoke: a pool was reallocated")
    check = _logit_check(params, prompts[0][:200])
    flips = [_teacher_forced(params, prompts[i], results[i],
                             check["logit_limit"]) for i in range(4)]
    log(f"[decode_serve] teacher-forced greedy over requests 0-3: "
        f"{[f for f, _ in flips]} positions whose token is not the "
        f"oracle's argmax (largest gap {max(g for _, g in flips):.3e}, "
        f"limit {2 * check['logit_limit']:.3e})")
    layer_bytes = sum(t.numel() * t.element_size()
                      for t in _tree_tensors(params["layers"]))
    head_bytes = params["head"].numel() * params["head"].element_size()
    bound_ms = (layer_bytes + head_bytes) / peaks["bytes"] * 1e3
    summary = {
        "card": card, "model": DECODE_LM, "pool_pages": lm.num_pages,
        "pool_bytes": lm.pool_bytes, "requests": DECODE_REQUESTS,
        "clients": DECODE_CLIENTS, **lat,
        "decode_call_ms_by_rung": rungs,
        "host_syncs": syncs, "ticks": ticks,
        "host_syncs_per_tick": syncs / max(ticks, 1),
        "profiled_window_ms": wall, "profiled_kernel_ms": kernel_ms,
        "busy_share": kernel_ms / wall, "top_kernels": top,
        "weight_read_bytes_per_step": layer_bytes + head_bytes,
        "weight_read_bound_ms": bound_ms,
        "step_ms_at_top_rung": rungs[DECODE_INFLIGHT]["per_step_ms"],
        "teacher_forced_flips": [f for f, _ in flips],
        **{k: check[k] for k in ("max_abs_err", "in_fusion",
                                 "paged_fp64_err", "dense_fp64_err",
                                 "err_ratio", "logit_limit")},
        "stats": {k: st[k] for k in ("ticks", "tokens_generated",
                                     "preemptions", "finished")}}

    # the same engine serves [decode_prefix]'s requests with the cache off
    prefix = _prefix_requests()
    off = [h.result.tolist() for h in _serve_all(engine, prefix, 8)[0]]
    engine.drain()
    if engine.stats()["pages"]["pages_used"] != 0:
        raise SystemExit("chip_smoke: pages in use after drain")
    _audit_clean(engine, "decode_serve")
    engine.close()
    del engine, lm

    # a 40-page pool: growth must preempt
    small = _decode_engine(params, "gpt13b-small",
                           num_pages=DECODE_SMALL_PAGES)
    rng = np.random.default_rng(SEED + 1)
    pre = [rng.integers(0, DECODE_LM["vocab"],
                        DECODE_PREEMPT_PROMPT).tolist()
           for _ in range(DECODE_PREEMPT_N)]
    _, load2 = _serve_all(small, pre, DECODE_PREEMPT_N)
    small.drain()
    pst = small.stats()
    _audit_clean(small, "decode_serve small pool")
    small.close()
    if pst["preemptions"] < 1 or pst["pages"]["pages_used"] != 0:
        raise SystemExit(f"chip_smoke: the 40-page pool: {pst['preemptions']}"
                         f" preemptions, {pst['pages']['pages_used']} pages "
                         "in use after drain")
    summary.update({"small_pool_preemptions": pst["preemptions"],
                    "small_pool_wall_s": load2["wall_s"],
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                    "phase_s": time.perf_counter() - t_phase})
    log("[decode_serve] " + json.dumps(summary))
    return {"prompts": prompts, "results": results, "check": check,
            "prefix_off": off, "tokens_per_s": lat["output_tokens_per_s"],
            "pool_pages": summary["pool_pages"]}


def _prefix_requests():
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, DECODE_LM["vocab"], PREFIX_LEN).tolist()
    reqs = [shared + rng.integers(0, DECODE_LM["vocab"], int(n)).tolist()
            for n in rng.integers(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1,
                                  PREFIX_N - 1)]
    # the shared prefix alone (whole pages): its admission copies on write
    return reqs + [shared]


def phase_decode_prefix(card, params, serve):
    """[decode_prefix]: 16 requests sharing a 256-token prefix through
    ``prefix_cache=True``, against the same requests with the cache off."""
    t0 = time.perf_counter()
    engine = _decode_engine(params, "gpt13b-prefix", prefix_cache=True)
    reqs = _prefix_requests()
    # the first request alone fills the cache; the rest share it
    first = engine.predict(reqs[0]).tolist()
    handles, load = _serve_all(engine, reqs[1:], 8)
    got = [first] + [h.result.tolist() for h in handles]
    ties = _same_or_near_tie(params, reqs, got, serve["prefix_off"],
                             serve["check"]["logit_limit"], "decode_prefix")
    st = engine.stats()
    pc = st["prefix_cache"]
    _audit_clean(engine, "decode_prefix")
    engine.close()
    summary = {"card": card, "requests": PREFIX_N, "prefix": PREFIX_LEN,
               "hits": pc["hits"], "cow_copies": pc["cow_copies"],
               "prefill_tokens_avoided": st["prefill_tokens_avoided"],
               "prompt_tokens": sum(len(r) for r in reqs),
               "near_ties": ties, "wall_s": load["wall_s"],
               "recompiles_after_warmup": st["recompiles_after_warmup"],
               "phase_s": time.perf_counter() - t0}
    log("[decode_prefix] " + json.dumps(summary))
    if (st["prefill_tokens_avoided"] <= 0 or pc["cow_copies"] < 1
            or st["recompiles_after_warmup"]):
        raise SystemExit("chip_smoke: the prefix cache saved nothing, made "
                         "no copy-on-write copy, or new signatures came")


def phase_decode_spec(card, params, serve):
    """[decode_spec]: a 4-layer truncation of the model as the draft, 4
    draft tokens a tick; trajectories against [decode_serve]'s."""
    from mxnet_tpu_torch.parallel.pipeline_lm import truncate_pipeline_lm
    t0 = time.perf_counter()
    engine = _decode_engine(
        params, "gpt13b-spec", spec_tokens=SPEC_TOKENS,
        draft_params=truncate_pipeline_lm(params, SPEC_DRAFT_LAYERS))
    prompts = serve["prompts"][:SPEC_N]
    handles, load = _serve_all(engine, prompts, SPEC_N)
    got = [h.result.tolist() for h in handles]
    ties = _same_or_near_tie(params, prompts, got,
                             serve["results"][:SPEC_N],
                             serve["check"]["logit_limit"], "decode_spec")
    st = engine.stats()
    _audit_clean(engine, "decode_spec")
    engine.close()
    lat = _latency_summary(handles, load["wall_s"])
    summary = {"card": card, "draft_layers": SPEC_DRAFT_LAYERS,
               "spec_tokens": SPEC_TOKENS, "requests": SPEC_N,
               "acceptance_rate": st["spec"]["acceptance_rate"],
               "proposed": st["spec"]["proposed"],
               "accepted": st["spec"]["accepted"], "ticks": st["ticks"],
               "near_ties": ties, **lat,
               "decode_serve_tokens_per_s": serve["tokens_per_s"],
               "recompiles_after_warmup": st["recompiles_after_warmup"],
               "phase_s": time.perf_counter() - t0}
    log("[decode_spec] " + json.dumps(summary))
    if st["recompiles_after_warmup"]:
        raise SystemExit("chip_smoke: speculative engine made new "
                         "signatures after warmup")


def phase_decode_quant(card, params, serve):
    """[decode_quant]: bf16 and int8 pools at the f32 pool's bytes: the
    same prefill and decode steps (the f32 run's tokens fed) within
    quant_bf16 / quant_int8 of the f32 pool's logits; the int8 pool's
    capacity and type."""
    from mxnet_tpu_torch.opt.verify import tolerance_for
    from mxnet_tpu_torch.serve2 import PagedLM
    check = serve["check"]
    prompt = serve["prompts"][0][:200]
    out = {"card": card, "f32_pages": serve["pool_pages"]}
    for kv, cls in (("bf16", "quant_bf16"), ("int8", "quant_int8")):
        pages = PagedLM.pages_for_bytes(
            DECODE_POOL_BYTES, page_size=DECODE_PAGE,
            n_layers=DECODE_LM["n_layers"], n_heads=DECODE_LM["n_heads"],
            d_head=DECODE_LM["d_head"], kv_dtype=kv)
        lm = PagedLM(params, page_size=DECODE_PAGE, num_pages=pages,
                     max_pages_per_seq=39, kv_dtype=kv, name=f"check-{kv}",
                     device="cuda")
        _, logits = _paged_logits(lm, prompt, DECODE_CHECK_STEPS,
                                  forced=check["fed"])
        rtol, atol = tolerance_for(cls, "float32")
        ok = bool(torch.allclose(logits, check["logits"], rtol=rtol,
                                 atol=atol))
        out[kv] = {"pages": pages, "pool_bytes": lm.pool_bytes,
                   "pool_dtype": str(lm.pools["k"].dtype),
                   "max_abs_err_vs_f32_pool":
                       float((logits - check["logits"]).abs().max()),
                   "class": cls, "within_class": ok,
                   "pages_over_f32": pages / serve["pool_pages"]}
        del lm, logits
        torch.cuda.empty_cache()
        log(f"[decode_quant] {kv}: " + json.dumps(out[kv]))
        if not ok:
            raise SystemExit(f"chip_smoke: {kv} pool logits outside {cls}")
    log("[decode_quant] " + json.dumps(out))
    if (out["int8"]["pages_over_f32"] < 3.5
            or out["int8"]["pool_dtype"] != "torch.int8"):
        raise SystemExit("chip_smoke: the int8 pool is not what it should "
                         "be")


def phase_decode_router(card, params):
    """[decode_router]: a Router over 2 DecodeEngine replicas sharing one
    parameter tree: a rolling reload under closed-loop load dropping
    nothing; a replica whose scheduler dies mid-load, its breaker open
    and its requests served by the other; one HTTP round trip."""
    import urllib.request
    from mxnet_tpu_torch.serve import (ModelRegistry, ServingEndpoint,
                                       run_loadgen)
    from mxnet_tpu_torch.serve2 import Router
    t0 = time.perf_counter()
    router = Router(name="gpt13b-router")
    router.add_group("gpt", lambda v, r: _decode_engine(
        params, f"gpt13b-r{r}-v{v}", pool_bytes=ROUTER_POOL_BYTES,
        max_new_default=32), n_replicas=2)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, DECODE_LM["vocab"], int(n)).tolist()
               for n in rng.integers(64, 257, ROUTER_N)]
    box = {}

    def reload_mid():
        time.sleep(0.5)
        box["report"] = router.rolling_reload("gpt")

    thread = threading.Thread(target=reload_mid, daemon=True)
    thread.start()
    load = run_loadgen(lambda p: router.predict("gpt", p, timeout_ms=6e5),
                       prompts, concurrency=8)
    thread.join(600)
    rep = box.get("report", {})
    brief = {k: rep.get(k) for k in ("new_version", "drained", "dropped",
                                     "duration_s")}
    log(f"[decode_router] rolling reload under load: {load['completed']}/"
        f"{ROUTER_N} served, errors {load['errors'][:2]}, reload {brief}")
    if (thread.is_alive() or load["completed"] != ROUTER_N or load["errors"]
            or rep.get("dropped") != 0 or rep.get("new_version") != 2):
        raise SystemExit("chip_smoke: the rolling reload dropped requests")
    # replica 0's scheduler dies mid-load
    victim = router._group("gpt").replicas[0].engine

    def die():
        raise RuntimeError("replica lost")

    def kill_mid():
        time.sleep(0.3)
        victim.tick = die
        with victim._cv:
            victim._cv.notify_all()
    killer = threading.Thread(target=kill_mid, daemon=True)
    killer.start()
    load2 = run_loadgen(lambda p: router.predict("gpt", p, timeout_ms=6e5),
                        prompts, concurrency=8)
    killer.join(60)
    state = router._group("gpt").replicas[0].breaker.state
    log(f"[decode_router] replica 0 lost mid-load: {load2['completed']}/"
        f"{ROUTER_N} served, errors {load2['errors'][:2]}; its breaker "
        f"{state}; {victim.stats()['finished']} finished there")
    if load2["completed"] != ROUTER_N or load2["errors"] or state != "open":
        raise SystemExit("chip_smoke: requests did not fail over, or the "
                         "breaker stayed closed")
    # the HTTP front door
    front = ModelRegistry()
    front.register("gpt", router.frontend("gpt"))
    ep = ServingEndpoint(front, host="127.0.0.1", port=0).start()
    try:
        req = urllib.request.Request(
            ep.address + "/v1/models/gpt:predict", method="POST",
            data=json.dumps({"inputs": prompts[0]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            body = json.loads(r.read())
        direct = router.predict("gpt", prompts[0]).tolist()
    finally:
        ep.stop()
    if body["outputs"] != direct:
        raise SystemExit("chip_smoke: the HTTP endpoint's tokens differ "
                         "from a direct predict")
    audit = router.audit("gpt")
    router.close()
    summary = {"card": card, "replicas": 2, "requests": ROUTER_N,
               "reload": rep, "reload_load_wall_s": load["wall_s"],
               "failover_load_wall_s": load2["wall_s"],
               "breaker_after_loss": state, "http_tokens_equal": True,
               "audit_findings": len(audit["findings"]),
               "phase_s": time.perf_counter() - t0}
    log("[decode_router] " + json.dumps(summary, default=str))


def _zoo_loader(size, batch):
    """A DataLoader over ``3 * batch`` synthetic images (uint8, HWC, from
    SEED with numpy; label k brightens the k-th of ZOO_LABELS horizontal
    bands) and int32 labels, through ToTensor and Normalize, in
    ZOO_WORKERS worker processes."""
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.data.vision import transforms
    rng = np.random.RandomState(SEED)
    n = 3 * batch
    y = rng.randint(0, ZOO_LABELS, n).astype(np.int32)
    x = rng.randint(0, 128, (n, size, size, 3)).astype(np.uint8)
    band = size // ZOO_LABELS
    for i, k in enumerate(y):
        x[i, k * band:(k + 1) * band] += 100
    tf = transforms.Compose([transforms.ToTensor(),
                             transforms.Normalize(ZOO_MEAN, ZOO_STD)])
    return DataLoader(ArrayDataset(x, y).transform_first(tf),
                      batch_size=batch, last_batch="discard",
                      num_workers=ZOO_WORKERS, pin_memory=True)


def _zoo_names(net):
    """``{collect_params() key without the model's own prefix: shape}``
    (the prefix counts the models built before it)."""
    return {n[len(net.prefix):]: p.shape
            for n, p in net.collect_params().items()}


def _zoo_reference(name, size):
    """The names and shapes the same build resolves on the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    with mx.cpu():
        ref = get_model(name)
        ref.initialize()
        with autograd.pause():
            ref(torch.zeros(1, 3, size, size))
    return _zoo_names(ref)


def phase_zoo(card, tag, name, size, batch):
    """``name`` built and trained through the public API as a user script
    does (see ZOO_PHASES), with the checks of its deferred resolution,
    placement, dtypes, naming, B1 count, gradients, loss and running
    statistics, each fatal."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from torch.nn.parameter import UninitializedParameter
    t0 = time.perf_counter()
    loader = _zoo_loader(size, batch)
    batches = []
    with mx.gpu(0):
        while len(batches) < ZOO_STEPS + 1:
            batches.extend(loader)
    load_s = time.perf_counter() - t0
    want_shapes = _zoo_reference(name, size)
    mx.random.seed(SEED)
    torch.cuda.synchronize()
    t_build = time.perf_counter()
    net = get_model(name)
    net.initialize(mx.init.Xavier(magnitude=2), ctx=mx.gpu(0))
    net.cast("float16")
    params = net.collect_params()
    trainer = gluon.Trainer(params, "sgd", {
        "learning_rate": ZOO_LR, "momentum": 0.9, "wd": 1e-4,
        "multi_precision": True})
    deferred = sum(isinstance(p, UninitializedParameter)
                   for p in net.parameters())
    tensors = _params_of(net)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    feed = iter(batches * 2)
    first_forward_s, grad_max, missing = [], [], []

    def update():
        grads = [p.grad for p in tensors.values() if p.grad is not None]
        grad_max.append(torch.stack(torch._foreach_norm(
            grads, float("inf"))).float().max())
        trainer.step(batch * RESNET_LOSS_SCALE)
    checked = _checked(update, tensors, missing)

    def step(events=None):
        xb, yb = next(feed)
        if events:
            events[0].record()
        with autograd.record():
            out = net(xb.astype("float16"))
            if not first_forward_s:
                torch.cuda.synchronize()
                first_forward_s.append(time.perf_counter() - t_build)
            loss = loss_fn(out, yb)
            scaled = loss * RESNET_LOSS_SCALE
        if events:
            events[1].record()
        scaled.backward()
        if events:
            events[2].record()
        checked()
        if events:
            events[3].record()
        return loss._data.detach().float().mean()

    want = dict.fromkeys(_train_counters(), 0)
    want["mp_sgd"] = 1
    losses, walls, parts, totals, peak = _run_steps(
        tag, ZOO_STEPS, step, missing, want)
    shapes = _zoo_names(net)
    faults = []
    if any(isinstance(p, UninitializedParameter) for p in net.parameters()):
        faults.append("a parameter is still uninitialized")
    if any(p.device != torch.device("cuda", 0) for p in net.parameters()):
        faults.append("a parameter is not on cuda:0")
    if list(shapes) != list(want_shapes) or shapes != want_shapes:
        faults.append("names or shapes differ from the CPU build's")
    for m in net.modules():
        ps = [p for p in m.parameters(recurse=False)]
        if isinstance(m, (gnn.Conv2D, gnn.Dense)) and any(
                p.dtype != torch.float16 for p in ps):
            faults.append(f"{m.prefix}: a weight is not fp16")
        if isinstance(m, gnn.BatchNorm) and any(
                p.dtype != torch.float32 for p in ps):
            faults.append(f"{m.prefix}: a BatchNorm parameter is not fp32")
    bns = [m for m in net.modules() if isinstance(m, gnn.BatchNorm)]
    if not all(bool((m.running_mean != 0).any())
               and bool((m.running_var != 1).any()) for m in bns):
        faults.append("a running statistic did not move")
    max_grad = [g.item() for g in grad_max]
    if not all(np.isfinite(max_grad)):
        faults.append(f"a gradient held inf or NaN: {max_grad}")
    if not losses[-1] < losses[1]:
        faults.append(f"the loss did not fall over the 8 steps: {losses}")
    if totals["mp_sgd"] != ZOO_STEPS:
        faults.append(f"{totals['mp_sgd']} B1 launches in {ZOO_STEPS} steps")
    if faults:
        raise SystemExit(f"chip_smoke: {tag}: " + "; ".join(faults[:6]))
    steady = range(1, len(walls))
    wall_ms = float(np.median([walls[i] for i in steady]))
    kernel_ms, ours, top = profiled_step(step)
    if ours["mp_sgd"] <= 0:
        raise SystemExit(f"chip_smoke: {tag}: the profiler found no device "
                         "time for mp_sgd")
    fp16 = [p for p in net.parameters()
            if p.requires_grad and p.dtype == torch.float16]
    summary = {
        "card": card, "model": name, "batch": [batch, 3, size, size],
        "steps": ZOO_STEPS, "dtype": "float16, BatchNorm float32",
        "parameters": len(params),
        "deferred_before_first_forward": deferred,
        "values": sum(p.numel() for p in net.parameters()),
        "losses": losses, "max_abs_grad_by_step": max_grad,
        "step_wall_ms_median": wall_ms, "step_wall_ms": walls,
        "images_per_s": batch / (wall_ms / 1e3),
        "forward_ms": float(np.median([parts[i][0] for i in steady])),
        "backward_ms": float(np.median([parts[i][1] for i in steady])),
        "optimizer_ms": float(np.median([parts[i][2] for i in steady])),
        "profiled_kernel_ms": kernel_ms,
        "device_busy_share": kernel_ms / wall_ms, "top_kernels_ms": top,
        "b1_ms_per_step": ours["mp_sgd"],
        "b1_launches_per_step": totals["mp_sgd"] / ZOO_STEPS,
        "b1_tensors_per_step": len(fp16),
        "b1_values_per_step": sum(p.numel() for p in fp16),
        "construction_to_first_forward_s": first_forward_s[0],
        "data_loading_s": load_s, "peak_memory_bytes": peak,
        "launches": totals}
    log(f"[{tag}] " + json.dumps(summary))
    return net, batches, summary


def phase_zoo_export(net, batches):
    """[zoo_mobilenet_v2]: ``export`` and ``SymbolBlock.imports`` on the
    card give the block's predict-mode fp16 logits within ZOO_EXPORT_TOL
    of the largest."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    x = batches[0][0]._data[:16].half()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mobilenetv2")
        net.export(path)
        blk = gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                        path + "-0000.params",
                                        ctx=mx.gpu(0))
    with torch.no_grad(), autograd.predict_mode():
        want = net(x).float()
        got = blk(x).float()
    err = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[zoo_mobilenet_v2] export -> SymbolBlock.imports on the card: "
        f"{len(blk.collect_params())} parameters, logits max abs error "
        f"{err:.3e} of the largest (limit {ZOO_EXPORT_TOL})")
    if not (torch.isfinite(got).all() and err <= ZOO_EXPORT_TOL):
        raise SystemExit("chip_smoke: zoo_mobilenet_v2: the exported graph "
                         "disagrees with the block")
    return err


def phase_zoo_check(card, name, size):
    """[zoo_mobilenet_v2]: one SGD step at batch ZOO_CHECK_B from the same
    weights and batch on the card and the CPU, in fp32 and fp64 (TF32
    off): the card's fp64 run within RESNET64_TOL of the CPU's, and its
    fp32 errors against the CPU's fp64 run (loss, update, running
    statistics, logits) at most RESNET32_ERR_RATIO times the CPU's fp32
    errors, as [resnet_check] holds ResNet-50."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    x0 = rng.uniform(-1, 1, (ZOO_CHECK_B, 3, size, size))
    y0 = rng.randint(0, 1000, ZOO_CHECK_B).astype(np.float32)
    mx.random.seed(SEED)
    with mx.cpu():
        src = get_model(name)
        src.initialize(mx.init.Xavier(magnitude=2))
        with autograd.pause():
            src(torch.zeros(1, 3, size, size))
    state = {k: v.detach().clone() for k, v in src.state_dict().items()}

    def run(device, dtype):
        ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
        net = get_model(name)
        net.initialize(ctx=ctx)
        with autograd.pause():
            net(torch.zeros(1, 3, size, size, device=device))
        net.load_state_dict(state)
        net.cast(dtype)
        tensors = _params_of(net)
        trainer = gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": ZOO_CHECK_LR, "momentum": 0.9, "wd": 1e-4})
        x = torch.from_numpy(x0).to(device, getattr(torch, dtype))
        y = torch.from_numpy(y0).to(device)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        autograd.backward(loss)
        trainer.step(1)
        with torch.no_grad(), autograd.predict_mode():
            logits = net(x)
        return {"loss": loss.detach().double().cpu(),
                "logits": logits.double().cpu(),
                "weights": {n: p.detach().double().cpu().clone()
                            for n, p in tensors.items()}}

    runs = {(d, t): run(d, t) for d in ("cuda", "cpu")
            for t in ("float32", "float64")}
    names = list(runs[("cpu", "float64")]["weights"])
    stats = [n for n in names if n.endswith(("running_mean", "running_var"))]
    trained = [n for n in names if n not in stats]
    init = {n: state[port_name_of(n)].double() for n in names}

    def errors(got, ref):
        upd, _ = _update_diff([got["weights"][n] for n in trained],
                              [ref["weights"][n] for n in trained],
                              [init[n] for n in trained], trained)
        return {"loss": abs(got["loss"] - ref["loss"]).item(),
                "update": upd,
                "stats": _rel_l2([got["weights"][n] for n in stats],
                                 [ref["weights"][n] for n in stats]),
                "logits": _rel_l2([got["logits"]], [ref["logits"]])}

    ref = runs[("cpu", "float64")]
    e64 = errors(runs[("cuda", "float64")], ref)
    card32 = errors(runs[("cuda", "float32")], ref)
    cpu32 = errors(runs[("cpu", "float32")], ref)
    keys = ("loss", "update", "stats", "logits")
    ratios = {k: card32[k] / max(cpu32[k], 1e-300) for k in keys}
    summary = {"card": card, "batch": [ZOO_CHECK_B, 3, size, size],
               "fp64_cuda_vs_cpu": e64, "fp32_cuda_vs_fp64": card32,
               "fp32_cpu_vs_fp64": cpu32,
               "fp32_error_ratio_cuda_over_cpu": ratios}
    log("[zoo_mobilenet_v2] one step at batch 4, card vs CPU: "
        + json.dumps(summary))
    ok = all(e64[k] <= RESNET64_TOL for k in keys) \
        and max(ratios.values()) <= RESNET32_ERR_RATIO \
        and all(torch.isfinite(r["logits"]).all() for r in runs.values())
    if not ok:
        raise SystemExit("chip_smoke: zoo_mobilenet_v2: the step on the card "
                         "disagrees with the CPU")
    return summary


def port_name_of(name):
    from mxnet_tpu_torch.convert import port_name
    return port_name(name)


def phase_zoo_all(card):
    """Both zoo phases; returns their summaries by tag."""
    out = {}
    for tag, name, size, batch in ZOO_PHASES:
        net, batches, summary = phase_zoo(card, tag, name, size, batch)
        if tag == "zoo_mobilenet_v2":
            summary["export_logits_error"] = phase_zoo_export(net, batches)
            del net, batches
            torch.cuda.empty_cache()
            summary["check"] = phase_zoo_check(card, name, size)
        else:
            del net, batches
        torch.cuda.empty_cache()
        out[tag] = summary
    return out


def _profiled_ops(step):
    """One more ``step()`` under ``torch.profiler``: (wall ms, {host op
    name: calls}, [[kernel, device ms, launches], ...] largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops, kernels = {}, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels.append([e.key[:80], us / 1e3, e.count])
        else:
            ops[e.key] = ops.get(e.key, 0) + e.count
    kernels.sort(key=lambda r: -r[1])
    return wall, ops, kernels


# ops a recurrence computed step by step would issue (torch's native
# loop, a cell per time step)
_PER_STEP_OPS = ("aten::lstm_cell", "aten::_thnn_fused_lstm_cell",
                 "aten::gru_cell", "aten::_thnn_fused_gru_cell",
                 "aten::rnn_tanh_cell", "aten::rnn_relu_cell")
_MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")


def _rnn_profile_checks(tag, ops, kernels, rnn_calls, steps_per_call):
    """cuDNN's RNN ran ``rnn_calls`` times forward and backward, no
    per-step cell op ran, fewer products than one per time step were
    issued, and the device ran cuDNN's RNN kernels."""
    faults = []
    fwd = ops.get("aten::_cudnn_rnn", 0)
    bwd = ops.get("aten::_cudnn_rnn_backward", 0)
    if fwd != rnn_calls or bwd != rnn_calls:
        faults.append(f"aten::_cudnn_rnn {fwd} / backward {bwd} calls, "
                      f"expected {rnn_calls}")
    cells = {k: v for k, v in ops.items() if k in _PER_STEP_OPS}
    if cells:
        faults.append(f"per-step cell ops ran: {cells}")
    mm = sum(v for k, v in ops.items() if k in _MATMUL_OPS)
    if mm >= steps_per_call:
        faults.append(f"{mm} matrix products, as many as the "
                      f"{steps_per_call} time steps")
    if not any("rnn" in r[0].lower() or "lstm" in r[0].lower()
               for r in kernels):
        faults.append("no cuDNN RNN kernel in the device trace")
    if faults:
        raise SystemExit(f"chip_smoke: {tag}: " + "; ".join(faults))
    return {"cudnn_rnn_forward_calls": fwd,
            "cudnn_rnn_backward_calls": bwd, "matrix_product_ops": mm,
            "per_step_cell_ops": 0}


def _word_lm(vocab, width, layers, dropout):
    """``examples/rnn/word_lm.py``'s model as upstream MXNet's
    ``word_lm/model.py`` builds it: embedding -> dropout -> LSTM (dropout
    between layers) -> dropout -> a decoder tied to the embedding through
    ``params=``."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(vocab, width)
                self.rnn = rnn.LSTM(width, num_layers=layers,
                                    dropout=dropout, input_size=width)
                self.decoder = nn.Dense(vocab, flatten=False,
                                        in_units=width,
                                        params=self.encoder.params)

        def begin_state(self, batch_size):
            return self.rnn.begin_state(batch_size=batch_size)

        def forward(self, x, state):
            emb = self.drop(self.encoder(x))
            out, state = self.rnn(emb, state)
            return self.decoder(self.drop(out)), state

    return RNNModel()


def _lm_tokens(steps, batch, bptt, vocab, seed=SEED):
    """``batch`` Zipf-drawn (exponent 1) token streams of ``steps * bptt +
    1`` tokens, time-major: (T, batch) int32."""
    rs = np.random.RandomState(seed)
    cdf = _zipf_cdf(vocab, 1.0)
    return _zipf_draws(rs, cdf, (steps * bptt + 1, batch)).astype(np.int32)


def _lm_step(net, trainer, params, loss_fn, x, y, state, cfg, events=None):
    """One truncated-BPTT step of ``word_lm.py``: the loss, the clip's norm
    and the new (detached next time) states."""
    from mxnet_tpu_torch import autograd, gluon
    state = [s.detach() for s in state]
    if events:
        events[0].record()
    with autograd.record():
        out, state = net(x, state)
        loss = loss_fn(out.reshape((-1, cfg["vocab"])), y.reshape((-1,)))
    if events:
        events[1].record()
    loss.backward()
    if events:
        events[2].record()
    grads = [p.grad() for p in params.values()]
    norm = gluon.utils.clip_global_norm(
        grads, cfg["clip"] * cfg["bptt"] * x.shape[1])
    trainer.step(x.shape[0] * x.shape[1])
    if events:
        events[3].record()
    return loss, norm, state


def _lm_check_run(init, tokens, device, dtype, cfg):
    """RNN_LM_CHECK_STEPS steps at batch RNN_LM_CHECK_B, dropout 0, from
    the weights ``init``: (losses, final states, final weights) as fp64
    CPU tensors."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
    with ctx:
        net = _word_lm(cfg["vocab"], cfg["width"], cfg["layers"], 0.0)
        net.initialize(ctx=ctx)
        net.cast(dtype)
        b, T = tokens.shape[1], cfg["bptt"]
        state = [s.astype(dtype) for s in net.begin_state(b)]
        net.load_state_dict({k: torch.from_numpy(v).to(getattr(torch, dtype))
                             for k, v in init.items()})
        params = net.collect_params()
        trainer = gluon.Trainer(params, "sgd", {"learning_rate": cfg["lr"]})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for i in range(RNN_LM_CHECK_STEPS):
            x = nd.array(tokens[i * T:(i + 1) * T], ctx=ctx)
            y = nd.array(tokens[i * T + 1:(i + 1) * T + 1], ctx=ctx)
            loss, _, state = _lm_step(net, trainer, params, loss_fn, x, y,
                                      state, cfg)
            losses.append(loss._data.detach().double().mean().cpu())
    weights = {k: v.detach().double().cpu()
               for k, v in net.state_dict().items()}
    return (torch.stack(losses), [s._data.detach().double().cpu()
                                  for s in state], weights)


def _errs(got, ref):
    """Max abs differences of (losses, states, weights) triples."""
    def m(a, b):
        return max(float((x - z).abs().max()) for x, z in zip(a, b))
    return {"loss": float((got[0] - ref[0]).abs().max()),
            "states": m(got[1], ref[1]),
            "weights": m(list(got[2].values()), list(ref[2].values()))}


def _weight_copy_ms(net, x):
    """The LSTM layer's forward on per-layer weights (cuDNN copies them
    into its own buffer on every call) against ``torch.nn.LSTM`` with the
    same values flattened once (a yardstick, used nowhere in the port), in
    predict mode at the phase's shape; and the bytes copied."""
    lstm = net.rnn
    ref = torch.nn.LSTM(lstm._hidden_size, lstm._hidden_size,
                        num_layers=lstm._num_layers).cuda()
    with torch.no_grad():
        for i in range(lstm._num_layers):
            for name, ours in (("weight_ih", "i2h_weight"),
                               ("weight_hh", "h2h_weight"),
                               ("bias_ih", "i2h_bias"),
                               ("bias_hh", "h2h_bias")):
                getattr(ref, f"{name}_l{i}").copy_(
                    getattr(lstm, f"l{i}_{ours}"))
    ref.eval()
    ref.flatten_parameters()
    n = lstm._num_layers
    h0 = torch.zeros(n, x.shape[1], lstm._hidden_size, device="cuda")
    emb = net.encoder(x._data)
    with torch.no_grad():
        ours_ms = cuda_ms(lambda: lstm(emb, [h0, h0]))
        flat_ms = cuda_ms(lambda: ref(emb, (h0, h0)))
        diff = (lstm(emb, [h0, h0])[0] - ref(emb, (h0, h0))[0]).abs().max()
    nbytes = sum(p.numel() * p.element_size() for p in ref.parameters())
    return {"per_layer_weights_forward_ms": ours_ms,
            "flattened_weights_forward_ms": flat_ms,
            "weight_copy_ms_estimate": ours_ms - flat_ms,
            "weight_bytes": nbytes,
            "max_abs_diff_to_flattened": float(diff)}


def phase_rnn_lm(card):
    """[rnn_lm]: see RNN_LM; each check fatal."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    cfg = RNN_LM
    V, W, T, B = cfg["vocab"], cfg["width"], cfg["bptt"], cfg["batch"]
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    mx.random.seed(SEED)
    tokens = _lm_tokens(RNN_LM_STEPS + 1, B, T, V)
    gpu = mx.gpu(0)
    net = _word_lm(V, W, cfg["layers"], cfg["dropout"])
    net.initialize(mx.init.Uniform(cfg["init"]), ctx=gpu)
    params = net.collect_params()
    tied = net.encoder.weight
    if net.decoder.weight is not tied or \
            sum(p.tensor is tied for p in params.values()) != 1:
        raise SystemExit("chip_smoke: rnn_lm: the decoder's weight is not "
                         "the embedding's, once")
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": cfg["lr"]})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with gpu:
        state = net.begin_state(B)
        batches = [(nd.array(tokens[i * T:(i + 1) * T], ctx=gpu),
                    nd.array(tokens[i * T + 1:(i + 1) * T + 1], ctx=gpu))
                   for i in range(RNN_LM_STEPS + 1)]
    feed = iter(batches)
    norms, tied_faults, held = [], [], {}

    def step(events=None):
        nonlocal state
        x, y = next(feed)
        before = tied.detach().clone()
        loss, norm, state = _lm_step(net, trainer, params, loss_fn, x, y,
                                     state, cfg, events)
        norms.append(norm)
        # the update SGD makes from the clipped gradient, applied once: the
        # new weight within 1% of the largest step of before - lr * g / BT
        # (fp32 rounding of the weight is ~1e-9 here; a second update
        # would be off by a whole step)
        g = held.pop("grad", None)
        if g is not None:
            d = cfg["lr"] * g.double() / (B * T)
            err = (tied.detach().double() - (before.double() - d)).abs()
            if not float(err.max()) <= 0.01 * float(d.abs().max()):
                tied_faults.append(len(norms))
        return loss._data.detach().float().mean()

    # the tied weight's clipped gradient, read just before the update
    step_fn = trainer.step

    def traced_step(batch_size, **kw):
        held["grad"] = tied.grad.detach().clone()
        return step_fn(batch_size, **kw)
    trainer.step = traced_step
    want = dict.fromkeys(_train_counters(), 0)
    losses, walls, parts, totals, peak = _run_steps(
        "rnn_lm", RNN_LM_STEPS + 1, step, [], want)
    trainer.step = step_fn
    faults = []
    if abs(losses[0] - math.log(V)) > 0.05 * math.log(V):
        faults.append(f"first loss {losses[0]} not within 5% of ln({V})")
    if tied_faults:
        faults.append(f"the tied weight's update at steps {tied_faults} is "
                      "not one SGD update of its clipped gradient")
    if [tuple(s.shape) for s in state] != [(cfg["layers"], B, W)] * 2:
        faults.append(f"states {[s.shape for s in state]}")
    if not all(s._data.device == torch.device("cuda", 0) for s in state):
        faults.append("a state is not on cuda:0")
    if faults:
        raise SystemExit("chip_smoke: rnn_lm: " + "; ".join(faults))
    x, y = batches[-1]
    feed = iter([(x, y)])
    wall, ops, kernels = _profiled_ops(step)
    # dropout between the layers: one cuDNN call per layer
    profile = _rnn_profile_checks("rnn_lm", ops, kernels, cfg["layers"], T)
    kernel_ms = sum(r[1] for r in kernels)
    dtod = sum(r[1] for r in kernels if "DtoD" in r[0])
    copy = _weight_copy_ms(net, x)
    steady = range(1, len(walls))
    wall_ms = float(np.median([walls[i] for i in steady]))
    del net, trainer, params, batches, state, tied
    gc.collect()
    torch.cuda.empty_cache()
    check = phase_rnn_lm_check(cfg, tokens)
    summary = {
        "card": card, "config": cfg, "steps": RNN_LM_STEPS + 1,
        "losses": losses, "ln_vocab": math.log(V),
        "clip_norms": [float(n) for n in norms],
        "step_wall_ms_median": wall_ms, "step_wall_ms": walls,
        "tokens_per_s": B * T / (wall_ms / 1e3),
        "forward_ms": float(np.median([parts[i][0] for i in steady])),
        "backward_ms": float(np.median([parts[i][1] for i in steady])),
        "clip_and_optimizer_ms": float(np.median([parts[i][2]
                                                  for i in steady])),
        "profiled_step_wall_ms": wall, "profiled_kernel_ms": kernel_ms,
        "device_busy_share": kernel_ms / wall,
        "dtod_memcpy_ms_in_profiled_step": dtod,
        "top_kernels_ms": kernels[:10], "profile": profile,
        "weight_copy": copy, "peak_memory_bytes": peak,
        "launches": totals, "card_vs_cpu": check,
        "phase_s": time.perf_counter() - t0}
    log("[rnn_lm] " + json.dumps(summary))
    return summary


def phase_rnn_lm_check(cfg, tokens):
    """The card against the CPU at batch RNN_LM_CHECK_B over
    RNN_LM_CHECK_STEPS steps, dropout 0 (the two devices' generators draw
    different masks), from one set of numpy-drawn weights: in fp64 the
    losses, states and weights within RNN_LM_FP64_TOL; in fp32 the card's
    error against the CPU's fp64 at most RNN_ERR_RATIO times the CPU's own
    fp32 error (ties at 0 pass)."""
    rs = np.random.RandomState(SEED + 1)
    V, W, L = cfg["vocab"], cfg["width"], cfg["layers"]
    shapes = {"encoder.weight": (V, W), "decoder.weight": (V, W),
              "decoder.bias": (V,)}
    for i in range(L):
        shapes.update({f"rnn.l{i}_i2h_weight": (4 * W, W),
                       f"rnn.l{i}_h2h_weight": (4 * W, W),
                       f"rnn.l{i}_i2h_bias": (4 * W,),
                       f"rnn.l{i}_h2h_bias": (4 * W,)})
    init = {k: rs.uniform(-cfg["init"], cfg["init"], s).astype(np.float64)
            for k, s in shapes.items()}
    init["decoder.weight"] = init["encoder.weight"]
    toks = tokens[:, :RNN_LM_CHECK_B]
    runs = {(d, t): _lm_check_run(init, toks, d, t, cfg)
            for d in ("cpu", "cuda") for t in ("float64", "float32")}
    ref = runs[("cpu", "float64")]
    e64 = _errs(runs[("cuda", "float64")], ref)
    cpu32 = _errs(runs[("cpu", "float32")], ref)
    card32 = _errs(runs[("cuda", "float32")], ref)
    faults = [f"fp64 {k} {v} > {RNN_LM_FP64_TOL}" for k, v in e64.items()
              if v > RNN_LM_FP64_TOL]
    faults += [f"fp32 {k}: card {card32[k]} > {RNN_ERR_RATIO} x CPU "
               f"{cpu32[k]}" for k in card32
               if card32[k] > RNN_ERR_RATIO * cpu32[k]]
    out = {"batch": RNN_LM_CHECK_B, "steps": RNN_LM_CHECK_STEPS,
           "fp64_max_abs_err": e64, "fp64_tol": RNN_LM_FP64_TOL,
           "fp32_card_err_vs_cpu64": card32,
           "fp32_cpu_err_vs_cpu64": cpu32, "ratio_limit": RNN_ERR_RATIO,
           "losses_cpu64": ref[0].tolist()}
    if faults:
        raise SystemExit("chip_smoke: rnn_lm check: " + "; ".join(faults)
                         + f" ({json.dumps(out)})")
    return out


def _ctc_batch(templates, rs, batch, lengths=None, label_counts=None):
    """``batch`` utterances: label sequences of CTC["labels"] phones from
    1..phones-1 (no phone twice in a row), each phone over an equal run of
    frames (at least two, so every utterance aligns), frames its phone's
    template plus noise, zero-padded to the longest. ``lengths`` and
    ``label_counts`` fix the frame and phone counts, else they are drawn;
    returns (x (N, T,
    features) on the card, labels (N, L) padded with 0, frame lengths,
    label lengths)."""
    lo, hi = CTC["frames"]
    llo, lhi = CTC["labels"]
    phones = CTC["phones"]
    if lengths is None:
        lengths = rs.randint(lo, hi + 1, batch)
    if label_counts is None:
        label_counts = rs.randint(llo, lhi + 1, batch)
    labs = [min(int(m), n // 2) for n, m in zip(lengths, label_counts)]
    T, L = int(max(lengths)), int(max(labs))
    idx = np.zeros((batch, T), np.int64)  # 0: the padding template
    labels = np.zeros((batch, L), np.float32)
    for b, (n, m) in enumerate(zip(lengths, labs)):
        seq = [rs.randint(1, phones)]
        while len(seq) < m:
            p = rs.randint(1, phones)
            if p != seq[-1]:
                seq.append(p)
        labels[b, :m] = seq
        idx[b, :n] = np.asarray(seq)[np.arange(n) * m // n]
    g = torch.Generator(device="cuda").manual_seed(int(rs.randint(2 ** 31)))
    x = templates[torch.from_numpy(idx).cuda()]
    x = x + 0.5 * torch.randn(x.shape, generator=g, device="cuda")
    x = x * torch.from_numpy(idx > 0).cuda()[..., None]
    return x, labels, np.asarray(lengths, np.float32), \
        np.asarray(labs, np.float32)


def _ctc_net(ctx):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn

    class AcousticModel(gluon.HybridBlock):
        """``examples/speech_recognition/lstm_ctc.py``'s model at Graves
        et al. 2013's CTC-5L-250H widths."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.lstm = rnn.LSTM(CTC["hidden"],
                                     num_layers=CTC["layers"],
                                     bidirectional=True, layout="NTC")
                self.out = nn.Dense(CTC["phones"], flatten=False)

        def hybrid_forward(self, F, x):
            return self.out(self.lstm(x))

    net = AcousticModel()
    net.initialize(ctx=ctx)
    return net


def _ctc_loss_grad(net, x, labels, plen, llen, ctx):
    """The CTC losses of ``net`` on ``x`` (an NDArray) and their gradient
    with respect to the logits (fp64 CPU tensors)."""
    from mxnet_tpu_torch import autograd, gluon, nd
    ctc = gluon.loss.CTCLoss(layout="NTC")
    with autograd.record():
        logits = net(x)
        logits._data.retain_grad()
        loss = ctc(logits, nd.array(labels, ctx=ctx),
                   nd.array(plen, ctx=ctx), nd.array(llen, ctx=ctx))
    loss.backward()
    return loss._data.detach().double().cpu(), \
        logits._data.grad.detach().double().cpu()


def phase_rnn_ctc(card):
    """[rnn_ctc]: see CTC; each check fatal."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    gpu = mx.gpu(0)
    rs = np.random.RandomState(SEED)
    templates = torch.from_numpy(
        rs.randn(CTC["phones"], CTC["features"]).astype(np.float32)).cuda()
    templates[0] = 0
    net = _ctc_net(gpu)
    params = net.collect_params()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": CTC["lr"],
                                            "momentum": CTC["momentum"]})
    ctc = gluon.loss.CTCLoss(layout="NTC")
    batches = [_ctc_batch(templates, rs, CTC["batch"])
               for _ in range(CTC_STEPS)]
    feed = iter(batches)
    pad_grad = []

    def step(events=None):
        x, labels, plen, llen = next(feed)
        with gpu:
            xs, ys = nd.array(x, ctx=gpu), nd.array(labels, ctx=gpu)
            pl, ll = nd.array(plen, ctx=gpu), nd.array(llen, ctx=gpu)
        if events:
            events[0].record()
        with autograd.record():
            logits = net(xs)
            logits._data.retain_grad()
            loss = ctc(logits, ys, pl, ll)
        if events:
            events[1].record()
        loss.backward()
        if events:
            events[2].record()
        g = logits._data.grad
        frame = torch.arange(g.shape[1], device=g.device)
        padded = frame[None, :] >= pl._data[:, None]
        pad_grad.append(g[padded].abs().max() if padded.any()
                        else g.new_zeros(()))
        trainer.step(xs.shape[0])
        if events:
            events[3].record()
        return loss._data.detach().float().mean()

    want = dict.fromkeys(_train_counters(), 0)
    losses, walls, parts, totals, peak = _run_steps(
        "rnn_ctc", CTC_STEPS, step, [], want)
    pad = [float(v) for v in pad_grad]
    if any(v != 0.0 for v in pad):
        raise SystemExit(f"chip_smoke: rnn_ctc: padded frames' logit "
                         f"gradients {pad}, not 0")
    feed = iter(batches[-1:])
    wall, ops, kernels = _profiled_ops(step)
    T = int(batches[-1][0].shape[1])
    # no dropout: one cuDNN call runs the five bidirectional layers
    profile = _rnn_profile_checks("rnn_ctc", ops, kernels, 1, T)
    ctc_kernels = [r for r in kernels if "ctc" in r[0].lower()]
    if not ctc_kernels:
        raise SystemExit("chip_smoke: rnn_ctc: no CTC kernel in the trace")
    kernel_ms = sum(r[1] for r in kernels)
    steady = range(1, len(walls))
    wall_ms = float(np.median([walls[i] for i in steady]))
    check = phase_rnn_ctc_check(net, templates, rs)
    summary = {
        "card": card, "config": CTC, "steps": CTC_STEPS,
        "frames": [int(b[0].shape[1]) for b in batches],
        "losses": losses, "step_wall_ms_median": wall_ms,
        "step_wall_ms": walls,
        "utterances_per_s": CTC["batch"] / (wall_ms / 1e3),
        "forward_ms": float(np.median([parts[i][0] for i in steady])),
        "backward_ms": float(np.median([parts[i][1] for i in steady])),
        "optimizer_ms": float(np.median([parts[i][2] for i in steady])),
        "padded_frame_logit_grad_max": pad,
        "profiled_step_wall_ms": wall, "profiled_kernel_ms": kernel_ms,
        "device_busy_share": kernel_ms / wall, "profile": profile,
        "ctc_kernels_ms": ctc_kernels, "top_kernels_ms": kernels[:10],
        "peak_memory_bytes": peak, "launches": totals,
        "card_vs_cpu_fp64": check, "phase_s": time.perf_counter() - t0}
    log("[rnn_ctc] " + json.dumps(summary))
    del net, trainer, params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def phase_rnn_ctc_check(net, templates, rs):
    """The trained model's weights in fp64 on the card and the CPU, on
    CTC_CHECK_B utterances across the timed range (the longest frame and
    phone counts, the shortest, and the rest drawn): the losses and their
    gradients with respect to the logits, each within CTC_FP64_TOL of the
    largest magnitude."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import _wrap
    (lo, hi), (llo, lhi) = CTC["frames"], CTC["labels"]
    extra = CTC_CHECK_B - 2
    x, labels, plen, llen = _ctc_batch(
        templates, rs, CTC_CHECK_B,
        lengths=np.r_[hi, lo, rs.randint(lo, hi + 1, extra)],
        label_counts=np.r_[lhi, llo, rs.randint(llo, lhi + 1, extra)])
    state = {k: v.detach().double().cpu() for k, v in net.state_dict().items()}
    out = {}
    for dev, ctx in (("cuda", mx.gpu(0)), ("cpu", mx.cpu())):
        with ctx:
            m = _ctc_net(ctx)
            with mx.autograd.pause():
                m(x[:, :2].to(dev))
            m.cast("float64")
            m.load_state_dict({k: v.to(dev) for k, v in state.items()})
            out[dev] = _ctc_loss_grad(m, _wrap(x.double().to(dev)), labels,
                                      plen, llen, ctx)
    errs = {}
    for i, name in enumerate(("loss", "logit_grad")):
        a, b = out["cuda"][i], out["cpu"][i]
        errs[name] = float((a - b).abs().max() / b.abs().max())
    res = {"batch": CTC_CHECK_B, "frames": plen.tolist(),
           "label_lengths": llen.tolist(),
           "scaled_max_abs_err": errs, "tol": CTC_FP64_TOL,
           "losses_cpu": out["cpu"][0].tolist()}
    if any(v > CTC_FP64_TOL for v in errs.values()):
        raise SystemExit(f"chip_smoke: rnn_ctc check: {json.dumps(res)}")
    return res


def _bucket_sentences():
    """BUCKETING["sentences"] sentences of 5-60 Zipf-drawn word ids (as
    words, for ``encode_sentences``)."""
    rs = np.random.RandomState(SEED)
    cdf = _zipf_cdf(BUCKETING["vocab"] - 1, 1.0)
    return [[f"w{i}" for i in _zipf_draws(rs, cdf, rs.randint(5, 61))]
            for _ in range(BUCKETING["sentences"])]


def _bucket_sym_gen(cell, cfg):
    from mxnet_tpu_torch import sym

    def sym_gen(seq_len):
        data, label = sym.var("data"), sym.var("softmax_label")
        emb = sym.Embedding(data, input_dim=cfg["vocab"],
                            output_dim=cfg["embed"], name="embed")
        cell.reset()
        out, _ = cell.unroll(seq_len, inputs=emb, merge_outputs=True)
        pred = sym.FullyConnected(
            sym.Reshape(out, shape=(-1, cfg["hidden"])),
            num_hidden=cfg["vocab"], name="pred")
        return (sym.SoftmaxOutput(pred, sym.Reshape(label, shape=(-1,)),
                                  name="softmax", use_ignore=True,
                                  ignore_label=0),
                ("data",), ("softmax_label",))
    return sym_gen


def phase_rnn_bucketing(card):
    """[rnn_bucketing]: see BUCKETING; each check fatal."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    cfg = BUCKETING
    mx.random.seed(SEED)
    enc, vocab = mx.rnn.encode_sentences(_bucket_sentences(),
                                         invalid_label=0, start_label=1)
    it = mx.rnn.BucketSentenceIter(enc, cfg["batch"],
                                   buckets=list(cfg["buckets"]),
                                   invalid_label=0, seed=SEED)
    cell = mx.rnn.SequentialRNNCell()
    for i in range(cfg["layers"]):
        cell.add(mx.rnn.LSTMCell(cfg["hidden"], prefix=f"lstm_l{i}_"))
    mod = mx.mod.BucketingModule(_bucket_sym_gen(cell, cfg),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0))
    ppl, walls = [], []
    last = [time.perf_counter()]

    def on_batch(param):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append((now - last[0]) * 1e3)
        last[0] = now
        ppl.append(param.eval_metric.get()[1])
        param.eval_metric.reset()

    metric = mx.metric.Perplexity(ignore_label=0)
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": cfg["lr"], "wd": cfg["wd"]},
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            batch_end_callback=on_batch, epoch_end_callback=None)
    faults = []
    keys = sorted(mod._buckets)
    if keys != sorted(cfg["buckets"]):
        faults.append(f"buckets bound {keys}")
    execs = [m._exec_group.execs[0] for m in mod._buckets.values()]
    if len({id(e) for e in execs}) != len(keys):
        faults.append("fewer executors than buckets")
    names = mod._buckets[it.default_bucket_key]._param_names
    for n in names:
        if len({e.arg_dict[n]._data.data_ptr() for e in execs}) != 1 or \
                len({id(e.grad_dict[n]) for e in execs}) != 1:
            faults.append(f"{n} is not one storage across the buckets")
    if not all(np.isfinite(ppl)) or not \
            np.mean(ppl[-3:]) < np.mean(ppl[:3]):
        faults.append(f"perplexity not finite and falling: {ppl}")
    if faults:
        raise SystemExit("chip_smoke: rnn_bucketing: " + "; ".join(faults))
    fused = phase_rnn_fused_check(cfg)
    summary = {"card": card, "config": cfg, "vocab_words": len(vocab),
               "buckets_bound": keys, "batches": len(ppl),
               "perplexity_by_batch": ppl,
               "step_wall_ms_median": float(np.median(walls[1:])),
               "step_wall_ms": walls, "parameters": names,
               "fused": fused, "phase_s": time.perf_counter() - t0}
    log("[rnn_bucketing] " + json.dumps(summary))
    return summary


def phase_rnn_fused_check(cfg):
    """A FusedRNNCell (one ``RNN`` node, cuDNN) against its ``unfuse()``
    stack on the card, the same weights, at the largest bucket: outputs
    within FUSED_TOL; then ``save_rnn_checkpoint`` and
    ``load_rnn_checkpoint`` bit-equal."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import sym
    gpu = mx.gpu(0)
    T, N = max(cfg["buckets"]), cfg["batch"]
    fused = mx.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"],
                                mode="lstm", prefix="lstm_")

    def graph(cell):
        data = sym.var("data")
        emb = sym.Embedding(data, input_dim=cfg["vocab"],
                            output_dim=cfg["embed"], name="embed")
        out, _ = cell.unroll(T, inputs=emb, merge_outputs=True)
        return out

    fs = graph(fused)
    rs = np.random.RandomState(SEED)
    with gpu:
        ex = fs.simple_bind(gpu, data=(N, T), grad_req="null")
        args = {}
        for k, v in ex.arg_dict.items():
            a = rs.randint(1, cfg["vocab"], v.shape) if k == "data" \
                else rs.uniform(-0.07, 0.07, v.shape)
            args[k] = mx.nd.array(a.astype(np.float32), ctx=gpu)
            v._data = args[k]._data.clone()
        out_f = ex.forward()[0]._data
        us = graph(fused.unfuse())
        unpacked = fused.unpack_weights(args)
        ex2 = us.bind(gpu, unpacked)
        out_u = ex2.forward()[0]._data
        tmp = tempfile.mkdtemp()
        try:
            prefix = os.path.join(tmp, "fused")
            mx.rnn.save_rnn_checkpoint(fused, prefix, 1, fs, args, {})
            _, loaded, _ = mx.rnn.load_rnn_checkpoint(fused, prefix, 1)
        finally:
            shutil.rmtree(tmp)
    err = float((out_f - out_u).abs().max())
    same = sorted(loaded) == sorted(args) and all(
        torch.equal(loaded[k]._data.cpu(), args[k]._data.cpu())
        for k in args)
    res = {"shape": [N, T], "fused_vs_unfused_max_abs": err,
           "tol": FUSED_TOL, "checkpoint_round_trip_bit_equal": same,
           "unfused_arguments": sorted(unpacked)}
    if err > FUSED_TOL or not same:
        raise SystemExit(f"chip_smoke: rnn_bucketing fused check: "
                         f"{json.dumps(res)}")
    return res


def _contrib_cases():
    """name -> (build(gluon), input shape, forward(block, x) or None for
    the call, whether it sums, whether it runs in training mode (not where
    a mask would be drawn: the two devices' generators differ))."""
    def step_twice(cell, x):
        states = cell.begin_state(batch_size=x.shape[0])
        out, states = cell(x, states)
        out2, states = cell(x, states)
        return [out, out2] + list(states)

    def unroll(cell, x):
        out, states = cell.unroll(3, x, merge_outputs=True)
        return [out] + list(states)

    def conc(g, cls):
        c = cls(axis=1)
        c.add(g.nn.Dense(4, flatten=False), g.contrib.nn.Identity(),
              g.nn.Dense(3, flatten=False))
        return c

    cases = {
        "HybridConcurrent": (lambda g: conc(g, g.contrib.nn.HybridConcurrent),
                             (8, 5), None, True, True),
        "Concurrent": (lambda g: conc(g, g.contrib.nn.Concurrent), (8, 5),
                       None, True, True),
        "Identity": (lambda g: g.contrib.nn.Identity(), (4, 7), None, False,
                     True),
        "SyncBatchNorm": (lambda g: g.contrib.nn.SyncBatchNorm(),
                          (8, 3, 9, 9), None, True, True),
        "PixelShuffle1D": (lambda g: g.contrib.nn.PixelShuffle1D(3),
                           (2, 6, 8), None, False, True),
        "PixelShuffle2D": (lambda g: g.contrib.nn.PixelShuffle2D((2, 3)),
                           (2, 12, 4, 5), None, False, True),
        "PixelShuffle3D": (lambda g: g.contrib.nn.PixelShuffle3D(2),
                           (1, 16, 2, 3, 4), None, False, True),
        "VariationalDropoutCell": (lambda g: g.contrib.rnn.
                                   VariationalDropoutCell(g.rnn.LSTMCell(
                                       16), drop_inputs=0.3), (4, 3, 8),
                                   unroll, True, False),
        "LSTMPCell": (lambda g: g.contrib.rnn.LSTMPCell(16, 6), (4, 3, 5),
                      unroll, True, True),
        "DeformableConvolution": (lambda g: g.contrib.cnn.
                                  DeformableConvolution(
                                      6, kernel_size=3, padding=1,
                                      offset_weight_initializer="uniform"),
                                  (2, 4, 9, 9), None, True, True),
    }
    for dims, shape in ((1, (2, 4, 10)), (2, (2, 4, 8, 8)),
                        (3, (1, 4, 4, 4, 4))):
        for kind in ("RNN", "LSTM", "GRU"):
            name = f"Conv{dims}D{kind}Cell"
            cases[name] = ((lambda n, s: lambda g: getattr(g.contrib.rnn, n)(
                s[1:], 5, 3, 3, i2h_pad=1))(name, shape), shape, step_twice,
                True, True)
    return cases


def phase_gluon_contrib(card):
    """[gluon_contrib]: each contrib layer on the card against the CPU on
    the same fp32 inputs and weights (in training mode but where a mask
    would be drawn), rtol 1e-5 / atol 1e-6, or CONTRIB_SUMS where the
    layer sums; SparseEmbedding's row-sparse gradient and its lazy
    update; DeformableConvolution with zero offsets against Conv2D;
    Estimator.fit with CheckpointHandler and EarlyStoppingHandler."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    t0 = time.perf_counter()
    gpu, cpu = mx.gpu(0), mx.cpu()
    rows, faults = [], []
    for name, (build, shape, fwd, sums, train) in _contrib_cases().items():
        fwd = fwd or (lambda b, x: b(x))
        x = np.random.RandomState(SEED).rand(*shape).astype(np.float32)
        outs = {}
        state = None
        for ctx in (cpu, gpu):
            with ctx:
                torch.manual_seed(SEED)
                b = build(gluon)
                b.initialize(mx.init.Uniform(0.3), ctx=ctx)
                with autograd.pause():
                    fwd(b, nd.array(x, ctx=ctx))
                if state is None:
                    state = {k: v.detach().cpu()
                             for k, v in b.state_dict().items()}
                else:
                    b.load_state_dict(state)
                with autograd.record(train_mode=train):
                    out = fwd(b, nd.array(x, ctx=ctx))
                outs[ctx.device_type] = [o.asnumpy() for o in (
                    out if isinstance(out, list) else [out])]
        rtol, atol = CONTRIB_SUMS if sums else (1e-5, 1e-6)
        pairs = list(zip(outs["gpu"], outs["cpu"]))
        err = max(float(np.max(np.abs(a - c))) for a, c in pairs)
        # |card - cpu| <= atol + rtol * |cpu| elementwise
        excess = max(float(np.max(np.abs(a - c) - rtol * np.abs(c)))
                     for a, c in pairs)
        rows.append({"layer": name, "max_abs_err": err, "rtol": rtol,
                     "atol": atol, "passes": excess <= atol})
        if excess > atol:
            faults.append(f"{name}: card against CPU off by {err}, past "
                          f"rtol {rtol} / atol {atol}")
    # SparseEmbedding: the same rows' gradient, the lazy update's rows
    tok = np.array([[1, 2], [3, 1]], np.int32)
    grads, table = {}, None
    for ctx in (cpu, gpu):
        with ctx:
            emb = gluon.contrib.nn.SparseEmbedding(10, 4)
            emb.initialize(mx.init.Uniform(0.3), ctx=ctx)
            if table is None:
                table = emb.weight.data().asnumpy()
            emb.weight.set_data(table)
            with autograd.record():
                loss = (emb(nd.array(tok, ctx=ctx, dtype="int32")) ** 2).sum()
            loss.backward()
            g = emb.weight.grad()
            before = emb.weight.data().asnumpy()
            gluon.Trainer(emb.collect_params(), "sgd",
                          {"learning_rate": 0.1, "wd": 0.1}).step(1)
            moved = np.abs(emb.weight.data().asnumpy() - before).sum(1) > 0
            grads[ctx.device_type] = (g.stype, g.asnumpy(), moved.tolist())
    if grads["gpu"][0] != "row_sparse" or grads["gpu"][2] != \
            [False, True, True, True] + [False] * 6 or not np.allclose(
                grads["gpu"][1], grads["cpu"][1], rtol=1e-5, atol=1e-6):
        faults.append(f"SparseEmbedding: {grads['gpu'][0]}, rows moved "
                      f"{grads['gpu'][2]}")
    # zero offsets: the plain convolution
    with gpu:
        layer = gluon.contrib.cnn.DeformableConvolution(5, kernel_size=3,
                                                        padding=1)
        layer.initialize(ctx=gpu)
        xd = nd.array(np.random.RandomState(1).rand(2, 4, 7, 7)
                      .astype(np.float32), ctx=gpu)
        dout = layer(xd)
        ref = nd.Convolution(xd, layer.weight, layer.bias, kernel=(3, 3),
                             pad=(1, 1), num_filter=5)
        zero_err = float((dout - ref).abs().max().asscalar())
    if zero_err > CONTRIB_SUMS[1] + CONTRIB_SUMS[0] * float(
            ref.abs().max().asscalar()):
        faults.append(f"DeformableConvolution with zero offsets off "
                      f"Conv2D by {zero_err}")
    est = _contrib_estimator(gpu)
    if est["stopped_epoch"] != 2 or est["checkpoints"] != [
            "model-best.params", "model-epoch1.params",
            "model-epoch2.params"] or not est["parameters_on_card"]:
        faults.append(f"Estimator: {est}")
    summary = {"card": card, "card_vs_cpu": rows,
               "sparse_embedding_rows_moved": grads["gpu"][2],
               "deformable_zero_offsets_vs_conv2d": zero_err,
               "estimator": est, "phase_s": time.perf_counter() - t0}
    log("[gluon_contrib] " + json.dumps(summary))
    if faults:
        raise SystemExit("chip_smoke: gluon_contrib: " + "; ".join(faults))
    return summary


def _contrib_estimator(gpu):
    """Estimator.fit of a HybridConcurrent net for at most 3 epochs, a
    CheckpointHandler each epoch and an EarlyStoppingHandler on a metric
    that cannot improve in its mode after the first epoch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon.contrib import estimator as est_mod
    rs = np.random.RandomState(SEED)
    x = rs.rand(64, 8).astype(np.float32)
    y = (x.sum(1) > 4).astype(np.float32)
    tmp = tempfile.mkdtemp()
    try:
        with gpu:
            net = gluon.nn.HybridSequential()
            branches = gluon.contrib.nn.HybridConcurrent(axis=1)
            branches.add(gluon.nn.Dense(8, activation="relu"),
                         gluon.contrib.nn.Identity())
            net.add(branches, gluon.nn.Dense(2))
            net.initialize(ctx=gpu)
            loader = gluon.data.DataLoader(gluon.data.ArrayDataset(
                nd.array(x, ctx=gpu), nd.array(y, ctx=gpu)), batch_size=16)
            est = est_mod.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                    train_metrics=[mx.metric.Accuracy()])
            ckpt = est_mod.CheckpointHandler(tmp, monitor=est.loss_metric)
            stop = est_mod.EarlyStoppingHandler(monitor=est.loss_metric,
                                                mode="max", patience=1)
            est.fit(loader, epochs=3, event_handlers=[ckpt, stop])
        on_card = all(p.device == torch.device("cuda", 0)
                      for p in net.parameters())
        return {"stopped_epoch": stop.stopped_epoch,
                "checkpoints": sorted(os.listdir(tmp)),
                "loss": est.loss_metric.get()[1],
                "parameters_on_card": on_card}
    finally:
        shutil.rmtree(tmp)


def phase_rnn_all(card):
    """The four phases of the recurrent slice, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"rnn_lm": phase_rnn_lm(card), "rnn_ctc": phase_rnn_ctc(card),
           "rnn_bucketing": phase_rnn_bucketing(card),
           "gluon_contrib": phase_gluon_contrib(card)}
    log(f"[rnn] the four recurrent-slice phases took "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# -- the image input pipeline and image serving (slice 18) ----------------------

def _image_jpeg(i):
    """Record ``i``'s JPEG (see IMAGE_RECORDS) and its class."""
    import cv2
    rng = np.random.default_rng([SEED, i])
    h, w = (int(v) for v in rng.integers(IMAGE_SIDES[0], IMAGE_SIDES[1] + 1,
                                         size=2))
    coarse = rng.integers(0, 256, (h // IMAGE_CELL + 2, w // IMAGE_CELL + 2,
                                   3), dtype=np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR) \
        .astype(np.int16)
    img += rng.integers(-IMAGE_NOISE, IMAGE_NOISE + 1, img.shape,
                        dtype=np.int16)
    cls = i % IMAGE_CLASSES
    band = h // IMAGE_CLASSES
    img[cls * band:(cls + 1) * band] += 40
    ok, buf = cv2.imencode(".jpg", np.clip(img, 0, 255).astype(np.uint8),
                           [cv2.IMWRITE_JPEG_QUALITY, IMAGE_QUALITY])
    if not ok:
        raise SystemExit("chip_smoke: image_rec: OpenCV could not encode")
    return buf.tobytes(), cls


def _image_file(directory, cores):
    """The .rec/.idx pair of IMAGE_RECORDS images, written with the port's
    recordio (encoded on ``cores`` threads); its path and mean JPEG KB."""
    import concurrent.futures
    from mxnet_tpu_torch import recordio
    path = os.path.join(directory, "images.rec")
    w = recordio.MXIndexedRecordIO(os.path.join(directory, "images.idx"),
                                   path, "w")
    sizes = []
    with concurrent.futures.ThreadPoolExecutor(cores) as pool:
        for i, (jpeg, cls) in enumerate(pool.map(_image_jpeg,
                                                 range(IMAGE_RECORDS))):
            sizes.append(len(jpeg))
            w.write_idx(i, recordio.pack(
                recordio.IRHeader(0, [float(cls), float(i)], i, 0), jpeg))
    w.close()
    return path, float(np.mean(sizes)) / 1e3


def _np_resize(src, dw, dh):
    """The pipeline's bilinear resize (half-pixel centres, edges clamped,
    +0.5 then truncation to uint8) written in numpy, in float32."""
    sh, sw = src.shape[:2]

    def axis(n_out, n_in):
        f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(n_in / n_out) - np.float32(0.5)
        i0 = np.clip(f.astype(np.int32), 0, n_in - 1)
        i1 = np.minimum(n_in - 1, i0 + 1)
        return i0, i1, np.clip(f - i0, 0, 1).astype(np.float32)
    y0, y1, wy = axis(dh, sh)
    x0, x1, wx = axis(dw, sw)
    s = src.astype(np.float32)
    wy, wx = wy[:, None, None], wx[None, :, None]
    v = (s[y0][:, x0] * (1 - wy) * (1 - wx) + s[y0][:, x1] * (1 - wy) * wx
         + s[y1][:, x0] * wy * (1 - wx) + s[y1][:, x1] * wy * wx)
    return (v + np.float32(0.5)).astype(np.uint8)


def _plain_pass(jpeg):
    """One image as the deterministic pass makes it, in numpy: the
    pipeline's codec, the shorter side to IMAGE_RESIZE, the centre 224,
    (v - mean) / std, CHW."""
    from mxnet_tpu_torch import native
    img = native.decode(jpeg)
    h, w = img.shape[:2]
    if w < h:
        nw, nh = IMAGE_RESIZE, h * IMAGE_RESIZE // w
    else:
        nw, nh = w * IMAGE_RESIZE // h, IMAGE_RESIZE
    img = _np_resize(img, nw, nh)
    y0, x0 = (nh - RESNET_SIZE) // 2, (nw - RESNET_SIZE) // 2
    crop = img[y0:y0 + RESNET_SIZE, x0:x0 + RESNET_SIZE].astype(np.float32)
    out = (crop - np.asarray(IMAGE_MEAN, np.float32)) \
        / np.asarray(IMAGE_STD, np.float32)
    return out.transpose(2, 0, 1)


def _codec_check(path, n=IMAGE_CODEC_N):
    """The native codec against OpenCV's on records 0..n-1 of ``path``
    (see IMAGE_CODEC_N): the largest and mean absolute differences, in
    counts, as stored (4:2:0), re-encoded 4:4:4 and in one channel, and
    what a swap of R and B would give. Fatal past the limits."""
    import cv2
    from mxnet_tpu_torch import native, recordio
    rec = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "r")
    jpegs = [recordio.unpack(rec.read_idx(i))[1] for i in range(n)]
    rec.close()

    def cv(buf, flag=cv2.IMREAD_COLOR):
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
        return (img[:, :, ::-1] if img.ndim == 3 else img[:, :, None]) \
            .astype(np.int16)

    def gap(pairs):
        d = [np.abs(a - b) for a, b in pairs]
        return {"max_counts": int(max(int(x.max()) for x in d)),
                "mean_counts": float(sum(float(x.sum()) for x in d)
                                     / sum(x.size for x in d))}
    rgb = [(native.decode(j).astype(np.int16), cv(j)) for j in jpegs]
    if any(a.shape != b.shape for a, b in rgb):
        raise SystemExit("chip_smoke: image_rec: the codec's image shapes "
                         "differ from OpenCV's")
    re444 = [cv2.imencode(".jpg", np.ascontiguousarray(b[:, :, ::-1])
                          .astype(np.uint8),
                          [cv2.IMWRITE_JPEG_QUALITY, IMAGE_QUALITY,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])[1]
             .tobytes() for _, b in rgb]
    out = {"codec": native.codec(), "images": n, "rgb_420": gap(rgb),
           "rgb_444": gap([(native.decode(j).astype(np.int16), cv(j))
                           for j in re444]),
           "luma": gap([(native.decode(j, 1).astype(np.int16),
                         cv(j, cv2.IMREAD_GRAYSCALE)) for j in jpegs]),
           "rgb_420_with_r_and_b_swapped": gap([(a[:, :, ::-1], b)
                                                for a, b in rgb])}
    faults = []
    if out["rgb_420"]["max_counts"] > IMAGE_CODEC_MAX \
            or out["rgb_420"]["mean_counts"] > IMAGE_CODEC_MEAN:
        faults.append("RGB")
    if out["rgb_444"]["max_counts"] > IMAGE_CODEC_444_MAX:
        faults.append("RGB 4:4:4")
    if out["luma"]["max_counts"] > IMAGE_CODEC_LUMA_MAX:
        faults.append("luma")
    if out["rgb_420_with_r_and_b_swapped"]["mean_counts"] \
            <= IMAGE_CODEC_MEAN:
        faults.append("a swap of R and B would pass the mean limit")
    log(f"[image_rec] codec check: {json.dumps(out)} (limits: max "
        f"{IMAGE_CODEC_MAX}, mean {IMAGE_CODEC_MEAN}, 4:4:4 max "
        f"{IMAGE_CODEC_444_MAX}, luma max {IMAGE_CODEC_LUMA_MAX})")
    if faults:
        raise SystemExit(f"chip_smoke: image_rec: {out['codec']} disagrees "
                         f"with OpenCV: {', '.join(faults)}")
    return out


def _image_iter_args(path, cores, **kw):
    args = dict(path_imgrec=path, data_shape=(3, RESNET_SIZE, RESNET_SIZE),
                batch_size=RESNET_B, label_width=2, resize=IMAGE_RESIZE,
                rand_crop=True, rand_mirror=True, shuffle=True,
                mean_r=IMAGE_MEAN[0], mean_g=IMAGE_MEAN[1],
                mean_b=IMAGE_MEAN[2], std_r=IMAGE_STD[0],
                std_g=IMAGE_STD[1], std_b=IMAGE_STD[2],
                preprocess_threads=cores, seed=SEED)
    args.update(kw)
    return args


def _index_check(tag, indices):
    """Every record index once: each label read back is the one written."""
    got = sorted(int(v) for v in torch.cat(indices).tolist())
    if got != list(range(IMAGE_RECORDS)):
        raise SystemExit(f"chip_smoke: {tag}: the labels read back are not "
                         f"the {IMAGE_RECORDS} written ({len(got)} read)")


def _pipeline_epochs(args):
    """ImageRecordIter(**args) alone on the card: one epoch (its batches
    kept), a reset, and the next epoch. The iterator, the kept batches,
    and the times: the first epoch, the reset, the reset to the next
    epoch's first batch, and that epoch's rate."""
    import mxnet_tpu_torch as mx
    with mx.gpu(0):
        it = mx.io.ImageRecordIter(**args)
    if it.backend != "native":
        raise SystemExit(f"chip_smoke: image_rec: the {it.backend} pipeline "
                         f"ran ({it.reason}), not the native one")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept = [(b.data[0]._data, b.label[0]._data, b.pad) for b in it]
    torch.cuda.synchronize()
    times = {"pipeline_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    it.reset()
    times["reset_ms"] = (time.perf_counter() - t0) * 1e3
    first = it.next()
    torch.cuda.synchronize()
    times["reset_to_first_batch_ms"] = (time.perf_counter() - t0) * 1e3
    n = first.data[0].shape[0] - first.pad \
        + sum(b.data[0].shape[0] - b.pad for b in it)
    torch.cuda.synchronize()
    times["second_epoch_images_per_s"] = n / (time.perf_counter() - t0)
    return it, kept, times


def phase_image_rec(card, path, cores):
    """[image_rec]: see IMAGE_RECORDS; each check fatal. Returns the
    trained net, its trainer, the launch totals and the summary."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, native
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    gpu = mx.gpu(0)
    args = _image_iter_args(path, cores)
    # the pipeline alone, one epoch to the card, each batch kept for the
    # comparison with the CPU run below, then the epoch's end
    it, kept, epochs = _pipeline_epochs(args)
    pipeline_s = epochs["pipeline_s"]
    _index_check("image_rec", [lab[:, 1] for _, lab, _ in kept])
    with mx.cpu():
        cpu_it = mx.io.ImageRecordIter(**args)
    same = [torch.equal(x.cpu(), c.data[0]._data)
            and torch.equal(y.cpu(), c.label[0]._data) and pad == c.pad
            for (x, y, pad), c in zip(kept, cpu_it)]
    if len(same) != IMAGE_RECORDS // RESNET_B or not all(same):
        raise SystemExit(f"chip_smoke: image_rec: the batches on cuda:0 "
                         f"differ from ctx=cpu's: {same}")
    failures = it.decode_failures + cpu_it.decode_failures
    del kept, cpu_it, it
    # the deterministic pass against numpy on the same decoded pixels
    with gpu:
        det = mx.io.ImageRecordIter(**_image_iter_args(
            path, cores, batch_size=IMAGE_DET_N, rand_crop=False,
            rand_mirror=False, shuffle=False))
    first = det.next()
    failures += det.decode_failures
    det_x = first.data[0]._data.cpu().numpy()
    rec = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "r")
    plain = np.stack([_plain_pass(mx.recordio.unpack(rec.read_idx(i))[1])
                      for i in range(IMAGE_DET_N)])
    rec.close()
    det_counts = float((np.abs(det_x - plain)
                        * np.asarray(IMAGE_STD)[None, :, None, None]).max())
    log(f"[image_rec] {IMAGE_RECORDS} records, native pipeline "
        f"({native.codec()}), {cores} threads: one epoch to cuda:0 in "
        f"{pipeline_s:.3f} s ({IMAGE_RECORDS / pipeline_s:.1f} images/s); "
        f"cuda:0 batches bit-equal to ctx=cpu's; deterministic pass vs "
        f"numpy {det_counts:.4f} counts (limit {IMAGE_DET_COUNTS})")
    if det_counts > IMAGE_DET_COUNTS + 1e-3:
        raise SystemExit("chip_smoke: image_rec: the deterministic pass "
                         "disagrees with numpy")
    log(f"[image_rec] the epoch's end: reset {epochs['reset_ms']:.2f} ms, "
        f"the next epoch's first batch "
        f"{epochs['reset_to_first_batch_ms']:.2f} ms after it, that epoch "
        f"{epochs['second_epoch_images_per_s']:.1f} images/s")
    codec_gap = _codec_check(path)

    # training fed by the iterator
    t_build = time.perf_counter()
    net = _seeded_resnet50("cuda", "float16")
    params = _params_of(net)
    init_state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    stat_names = [n for n in params if n.endswith(("running_mean",
                                                   "running_var"))]
    trainer = gluon.Trainer(params, "sgd", {
        "learning_rate": IMAGE_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD, "multi_precision": True})
    loss_fn = SoftmaxCrossEntropyLoss()
    trainable = [p for p in params.values() if p.requires_grad]
    with gpu:
        feed = mx.io.ImageRecordIter(**args)
    build_s = time.perf_counter() - t_build
    waits, grad_max, missing, last = [], [], [], {}

    def update():
        grad_max.append(torch.stack(torch._foreach_norm(
            [p.grad for p in trainable], float("inf"))).float().max())
        trainer.step(RESNET_B * RESNET_LOSS_SCALE)
    checked = _checked(update, params, missing)

    def step(events=None):
        t0 = time.perf_counter()
        batch = feed.next()
        waits.append((time.perf_counter() - t0) * 1e3)
        last["x"] = batch.data[0]._data.half()
        last["y"] = batch.label[0]._data[:, 0].contiguous()
        return _train_step(net, loss_fn, last["x"], last["y"], checked,
                           events, RESNET_LOSS_SCALE)

    want = dict.fromkeys(_train_counters(), 0)
    want["mp_sgd"] = 1
    def after(i):
        if i == 0:  # drop what was decoded during the warm-up step
            feed.reset()
    losses, walls, parts, totals, peak = _run_steps(
        "image_rec", IMAGE_STEPS, step, missing, want, after)
    kernel_ms, ours, top = profiled_step(step)
    failures += feed.decode_failures
    max_grad = [g.item() for g in grad_max]
    faults = []
    if failures:
        faults.append(f"{failures} records did not decode")
    if not all(np.isfinite(max_grad)):
        faults.append(f"a gradient held inf or NaN: {max_grad}")
    if not all(params[n].dtype == torch.float32
               and not torch.equal(params[n].detach(), init_state[n])
               for n in stat_names):
        faults.append("a running statistic did not move or is not fp32")
    if ours["mp_sgd"] <= 0:
        faults.append("the profiler found no device time for mp_sgd")
    if faults:
        raise SystemExit("chip_smoke: image_rec: " + "; ".join(faults))
    steady = range(1, len(walls))
    wall_ms = float(np.median([walls[i] for i in steady]))

    # the same net's step on the batch it last read, held on the card
    def resident(events=None):
        return _train_step(net, loss_fn, last["x"], last["y"], checked,
                           events, RESNET_LOSS_SCALE)
    res_walls = []
    for _ in range(IMAGE_RESIDENT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident().item()
        res_walls.append((time.perf_counter() - t0) * 1e3)
    res_kernel_ms, _, _ = profiled_step(resident)
    res_ms = float(np.median(res_walls[1:]))
    feed.close()
    summary = {
        "card": card, "records": IMAGE_RECORDS, "codec": native.codec(),
        "preprocess_threads": cores, "batch": [RESNET_B, 3, RESNET_SIZE,
                                               RESNET_SIZE],
        "pipeline_alone_images_per_s": IMAGE_RECORDS / pipeline_s,
        "pipeline_alone_s": pipeline_s,
        "reset_ms": epochs["reset_ms"],
        "reset_to_first_batch_ms": epochs["reset_to_first_batch_ms"],
        "second_epoch_images_per_s": epochs["second_epoch_images_per_s"],
        "codec_vs_opencv": codec_gap, "losses": losses,
        "max_abs_grad_by_step": max_grad,
        "fed_step_wall_ms_median": wall_ms, "fed_step_wall_ms": walls,
        "fed_images_per_s": RESNET_B / (wall_ms / 1e3),
        "fed_window_images_per_s": RESNET_B * (len(walls) - 1)
        / (sum(walls[1:]) / 1e3),
        "host_wait_for_batch_ms_median": float(np.median(waits[1:])),
        "host_wait_for_batch_ms": waits,
        "fed_profiled_kernel_ms": kernel_ms,
        # a step's kernels over the fed window's mean step (the median fed
        # step drew a batch decoded ahead)
        "fed_window_device_busy_share": kernel_ms * (len(walls) - 1)
        / sum(walls[1:]),
        "resident_step_wall_ms_median": res_ms,
        "resident_step_wall_ms": res_walls,
        "resident_images_per_s": RESNET_B / (res_ms / 1e3),
        "resident_device_busy_share": res_kernel_ms / res_ms,
        "fed_over_resident": wall_ms / res_ms,
        "top_kernels_ms": top, "b1_ms_per_step": ours["mp_sgd"],
        "b1_launches_per_step": totals["mp_sgd"] / IMAGE_STEPS,
        "peak_memory_bytes": peak, "decode_failures": failures,
        "deterministic_pass_max_counts": det_counts,
        "net_build_s": build_s, "launches": totals}
    log("[image_rec] " + json.dumps(summary))
    return net, trainer, det_x, summary


def phase_image_dataset(card, path, cores, net, trainer):
    """[image_dataset]: the Gluon way in, fatal checks as [image_rec]'s."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import image
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import (ImageRecordDataset,
                                                   transforms)
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.opt import kernels as opt_kernels
    tf = transforms.Compose([
        transforms.RandomResizedCrop(RESNET_SIZE),
        transforms.RandomFlipLeftRight(), transforms.ToTensor(),
        transforms.Normalize([m / 255 for m in IMAGE_MEAN],
                             [s / 255 for s in IMAGE_STD])])
    ds = ImageRecordDataset(path).transform_first(tf)
    loader = DataLoader(ds, batch_size=RESNET_B, shuffle=True,
                        num_workers=cores, thread_pool=True)
    np.random.seed(SEED)
    with mx.gpu(0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = [y._data[:, 1] for _, y in loader]
        torch.cuda.synchronize()
        loader_s = time.perf_counter() - t0
        _index_check("image_dataset", labels)
        loss_fn = SoftmaxCrossEntropyLoss()
        batches = iter(loader)
        losses, walls, b1 = [], [], []
        for _ in range(IMAGE_DATASET_STEPS):
            opt_kernels.LAUNCHES.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, y = next(batches)
            loss = _train_step(
                net, loss_fn, x._data.half(), y._data[:, 0].contiguous(),
                lambda: trainer.step(RESNET_B * RESNET_LOSS_SCALE),
                scale=RESNET_LOSS_SCALE)
            losses.append(loss.item())
            walls.append((time.perf_counter() - t0) * 1e3)
            b1.append(opt_kernels.LAUNCHES.count)
        del batches
    if not all(np.isfinite(losses)) or b1 != [1] * IMAGE_DATASET_STEPS:
        raise SystemExit(f"chip_smoke: image_dataset: losses {losses}, B1 "
                         f"launches {b1}")
    summary = {"card": card, "decoder": image.decoder(),
               "threads": cores, "loader_alone_s": loader_s,
               "loader_alone_images_per_s": IMAGE_RECORDS / loader_s,
               "losses": losses, "step_wall_ms": walls,
               "images_per_s_per_step": [RESNET_B / (w / 1e3)
                                         for w in walls],
               "b1_launches": b1}
    log("[image_dataset] " + json.dumps(summary))
    return summary


def phase_image_serve(card, net, images):
    """[image_serve]: see IMAGE_SERVE_RUNGS; each check fatal."""
    from mxnet_tpu_torch.serve import InputSpec, ServingEngine
    from mxnet_tpu_torch.serve.buckets import parse_bucket_spec
    pool = images.astype(np.float16)
    rs = np.random.RandomState(SEED)
    sizes = rs.randint(1, 9, IMAGE_SERVE_REQUESTS)
    reqs = [np.take(pool, np.arange(j, j + n) % len(pool), axis=0)
            for j, n in enumerate(sizes)]
    engine = ServingEngine(net, input_specs=[InputSpec(
        (3, RESNET_SIZE, RESNET_SIZE), "float16")],
        ladder=parse_bucket_spec(IMAGE_SERVE_RUNGS))
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        out, lat = [None] * len(reqs), [None] * len(reqs)

        def client(k):
            for j in range(k, len(reqs), IMAGE_SERVE_CLIENTS):
                t = time.perf_counter()
                out[j] = engine.predict(reqs[j])
                lat[j] = (time.perf_counter() - t) * 1e3
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(IMAGE_SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall_s = time.perf_counter() - t0

        def direct(x):
            with torch.no_grad():
                return net(torch.from_numpy(x).cuda()).float().cpu().numpy()
        errs = [float(np.abs(o.astype(np.float32) - d).max()
                      / np.abs(d).max())
                for o, d in zip(out, (direct(x) for x in reqs))]
        bias = net.output.bias
        saved = bias.detach().clone()
        before = engine.predict(reqs[0]).astype(np.float32)
        with torch.no_grad():
            bias += IMAGE_BIAS_STEP
        try:
            after = engine.predict(reqs[0]).astype(np.float32)
            want_after = direct(reqs[0])
        finally:
            with torch.no_grad():
                bias.copy_(saved)
        shift = float(np.mean(after - before))
        update_err = float(np.abs(after - want_after).max()
                           / np.abs(want_after).max())
        stats = engine.stats()
    finally:
        engine.close()
    lat_sorted = sorted(lat)
    summary = {
        "card": card, "rungs": IMAGE_SERVE_RUNGS, "dtype": "float16",
        "requests": len(reqs), "images": int(sizes.sum()),
        "clients": IMAGE_SERVE_CLIENTS, "warmup_s": warmup_s,
        "requests_per_s": len(reqs) / wall_s,
        "images_per_s": float(sizes.sum()) / wall_s,
        "latency_p50_ms": float(np.percentile(lat_sorted, 50)),
        "latency_p99_ms": float(np.percentile(lat_sorted, 99)),
        "max_error_of_largest_logit": max(errs),
        "bias_step_mean_shift": shift, "after_update_error": update_err,
        "recompiles_after_warmup": stats["recompiles_after_warmup"]}
    log("[image_serve] " + json.dumps(summary))
    faults = []
    if stats["recompiles_after_warmup"]:
        faults.append(f"{stats['recompiles_after_warmup']} signatures after "
                      "warmup")
    if max(errs) > ZOO_EXPORT_TOL:
        faults.append(f"a response {max(errs):.3e} of the largest logit "
                      f"from the direct forward (limit {ZOO_EXPORT_TOL})")
    if update_err > ZOO_EXPORT_TOL or \
            abs(shift - IMAGE_BIAS_STEP) > ZOO_EXPORT_TOL * np.abs(
                want_after).max():
        faults.append(f"the bias step did not show: mean shift {shift}, "
                      f"error {update_err:.3e}")
    if faults:
        raise SystemExit("chip_smoke: image_serve: " + "; ".join(faults))
    return summary


def phase_image_all(card):
    """The three phases of the image slice over one .rec file, with
    torch's CPU threads at one (the decode threads have the cores)."""
    import mxnet_tpu_torch as mx
    gc.collect()
    torch.cuda.empty_cache()
    cores = len(os.sched_getaffinity(0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d:
            path, kb = _image_file(d, cores)
            write_s = time.perf_counter() - t0
            log(f"[image_rec] wrote {IMAGE_RECORDS} JPEG records in "
                f"{write_s:.2f} s: mean {kb:.2f} KB (limit {IMAGE_KB}); "
                f"{cores} usable cores; decoder of mx.image: "
                f"{mx.image.decoder()}")
            if not IMAGE_KB[0] <= kb <= IMAGE_KB[1]:
                raise SystemExit(f"chip_smoke: image_rec: mean JPEG {kb} KB")
            net, trainer, det_x, rec = phase_image_rec(card, path, cores)
            rec.update(mean_jpeg_kb=kb, write_s=write_s)
            dataset = phase_image_dataset(card, path, cores, net, trainer)
        serve = phase_image_serve(card, net, det_x)
    finally:
        torch.set_num_threads(threads)
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[image] the three image-slice phases took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"image_rec": rec, "image_dataset": dataset,
            "image_serve": serve}


def phase_decode(card, peaks):
    """The autoregressive serving slice: every decode phase on one
    parameter tree, the engines of each closed before the next."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = _seeded_pipeline_lm()
    torch.cuda.synchronize()
    log(f"[decode_serve] parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; "
        "torch.backends.cuda.matmul.allow_tf32 = False")
    serve = phase_decode_serve(card, peaks, params)
    phase_decode_prefix(card, params, serve)
    phase_decode_spec(card, params, serve)
    phase_decode_quant(card, params, serve)
    phase_decode_router(card, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[decode] the five decode phases took "
        f"{time.perf_counter() - t0:.1f} s")


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
    the port's kernels summed over its launches, and the ten kernels
    that take most of it as [name, ms, calls]."""
    rows = _profile_rows(step)
    ours = {name: sum(r[1] for r in rows if any(s in r[0] for s in syms))
            for name, syms in KERNEL_NAMES.items()}
    return (sum(r[1] for r in rows), ours,
            [[r[0][:80], r[1], r[2]] for r in rows[:10]])


def top_rung_breakdown(engine, ladder, top_seq):
    """Where one full dispatch at the top rung goes: the host wall time of
    ``predict`` (staging, copies, forward, unpadding) against the device
    time of the model's forward and the host time of bringing its logits
    back as the engine does (``_to_host``: the request's rows sliced on
    the card, copied into pinned memory asynchronously, one sync), beside
    the whole padded block's pageable ``.cpu()`` (the engine's copy until
    its device-side unpadding). Runs after the served load, so its
    launches are not counted."""
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

        def host_ms(fn):
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t0) * 1e3)
            return sorted(ms)[1]
        d2h_ms = host_ms(lambda: engine._to_host([logits]))
        pageable_ms = host_ms(lambda: logits.cpu().numpy())
    return {"rung": [b, top_seq], "predict_wall_ms": sorted(walls)[1],
            "forward_device_ms": forward_ms, "logits_to_host_ms": d2h_ms,
            "whole_block_pageable_ms": pageable_ms,
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
    multi_rows = phase_sgd_multi_check(peaks)
    serve_launches = phase_slice(card)
    train = phase_train(card)
    adamw_run = phase_train_adamw(card)
    phase_checkpoint(card, adamw_run)
    adamw = phase_adamw_profile(adamw_run)
    train32, train32_summary = phase_train_fp32(card)
    gpt = phase_train_gpt32(card)
    check32 = phase_resnet_check(card)
    resnet, resnet_summary = phase_train_resnet50(card, peaks)
    nd_run = phase_nd_ops()
    phase_index_fault()
    gluon_nd = phase_train_gluon_nd(card, resnet_summary)
    enc = phase_module_encoder(card, train32_summary)
    phase_module_resnet50(card, check32)
    phase_module_lenet(card)
    fbert = phase_fused_bert(card, peaks, train32_summary)
    phase_fused_resnet50(card)
    fsym = phase_fused_symbol(card, enc)
    linear = phase_sparse_linear(card)
    phase_sparse_embedding(card)
    phase_sparse_params(card, linear)
    zoo = phase_zoo_all(card)
    phase_rnn_all(card)
    images = phase_image_all(card)
    phase_decode(card, peaks)
    enc32, enc16 = enc["launches"], enc["fp16"]
    image_rec = images["image_rec"]
    nd_attn = {r["dtype"]: r["launches"] for r in nd_run["attention"]}
    nd_b1 = nd_run["b1"]

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
                "train_gpt_fp32": gpt[name],
                "module_encoder_fp32": enc32[name],
                "symbol_fused_attention_fp16": enc16[name],
                **fused_capture(name)}

    def fused_capture(name):
        """The wrapper's launches on the fused paths: the warm-up and the
        capture (a replay is no Python call)."""
        return {f"{tag}_capture": run["fused"]["wrapper_launches_at_capture"]
                .get(name, 0) for tag, run in (("fused_bert_fp32", fbert),
                                               ("fused_symbol_fp32", fsym))}

    def fused_total(name):
        return sum(fused_capture(name).values())

    def per_replay(symbol):
        """Launches per replayed fused step, counted by the profiler."""
        return {"fused_bert_fp32": fbert["fused"]["kernel_launches_per_step"]
                .get(symbol, 0),
                "fused_symbol_fp32": fsym["fused"]
                ["kernel_launches_per_step"].get(symbol, 0)}
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
        + train32["flash_fwd"] + gpt["flash_fwd"]
        + sum(r["flash_fwd"] for r in nd_attn.values())
        + enc32["flash_fwd"] + enc16["flash_fwd"] + fused_total("flash_fwd"),
        "launches_by_path": {"serve": serve_launches,
                             **launches("flash_fwd"),
                             "nd_fused_attention": {
                                 d: r["flash_fwd"]
                                 for d, r in nd_attn.items()}},
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
            "launches": serve_launches + train32["flash_fwd"]
            + enc32["flash_fwd"] + fused_total("flash_fwd"),
            "launches_tc32": serve_launches + train32["flash_fwd_tc32"]
            + enc32["flash_fwd_tc32"] + fused_total("flash_fwd_tc32"),
            "launches_per_replayed_step": per_replay(
                "flash_fwd_tc32_kernel"),
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
            + train32[f"flash_bwd_{which}"] + gpt[f"flash_bwd_{which}"]
            + sum(r[f"flash_bwd_{which}"] for r in nd_attn.values())
            + enc32[f"flash_bwd_{which}"] + enc16[f"flash_bwd_{which}"]
            + fused_total(f"flash_bwd_{which}"),
            "launches_by_path": {
                **launches(f"flash_bwd_{which}"),
                "nd_fused_attention_under_record": {
                    d: r[f"flash_bwd_{which}"]
                    for d, r in nd_attn.items()}},
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
                "launches": train32[f"flash_bwd_{which}_tc32"]
                + enc32[f"flash_bwd_{which}_tc32"]
                + fused_total(f"flash_bwd_{which}_tc32"),
                "launches_per_replayed_step": per_replay(
                    f"flash_bwd_tc32_{which}_kernel"),
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
        + gpt["split_bf16x3"]
        + sum(r["split_bf16x3"] for r in nd_attn.values())
        + enc32["split_bf16x3"] + fused_total("split_bf16x3"),
        "launches_per_replayed_step": per_replay("split_bf16x3_kernel"),
        "launches_by_path": {"serve": serve_launches,
                             "train_fp32": train32["split_bf16x3"],
                             "train_gpt_fp32": gpt["split_bf16x3"],
                             "module_encoder_fp32": enc32["split_bf16x3"],
                             **fused_capture("split_bf16x3"),
                             "nd_fused_attention": {
                                 d: r["split_bf16x3"]
                                 for d, r in nd_attn.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in split_rows),
        "ms": split["ms"], "plain_ms": split["plain_ms"],
        "bound_ms": split["bound_ms"], "bound_by": split["bound_by"],
        "library_ms": None,
        "library_none_because": "no single PyTorch call splits a tensor "
                                "into bf16 planes",
        "shape": [split["elements"]], "dtype": "float32 -> 3 x bfloat16",
        **common})
    # B1 on the main paths is one launch over every fp16 parameter of a
    # step: "ms" and its bound are the BERT-base list's (150 tensors), the
    # ResNet-50 list's (87) beside them; the list of one at single sizes
    # keeps the earlier rows' shapes
    bert_multi, resnet_multi = multi_rows["bert"], multi_rows["resnet50"]
    multi_keys = ("tensors", "values", "median_values", "ms",
                  "single_launches_ms", "host_ms", "single_launches_host_ms",
                  "plain_ms", "bound_ms", "bound_by", "bound_share",
                  "single_launches_bound_share", "fused_sgd_fp32_context_ms")
    kernels.append({
        "name": "mp_sgd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/mp_sgd.cu",
        "replaces": "mxnet_tpu/opt/kernels.py:95",
        "launches": train["mp_sgd"] + resnet["mp_sgd"]
        + adamw["launches"]["mp_sgd"] + gluon_nd["launches"]["mp_sgd"]
        + nd_b1["single"]["launches"] + nd_b1["multi"]["launches"]
        + sum(z["launches"]["mp_sgd"] for z in zoo.values())
        + image_rec["launches"]["mp_sgd"]
        + sum(images["image_dataset"]["b1_launches"]),
        "launches_by_path": {"train_fp16": train["mp_sgd"],
                             "train_resnet50_fp16": resnet["mp_sgd"],
                             "train_bert_adamw_fp16":
                                 adamw["launches"]["mp_sgd"],
                             "train_gluon_nd_fp16":
                                 gluon_nd["launches"]["mp_sgd"],
                             "nd_mp_sgd_mom_update_bert_150":
                                 nd_b1["single"]["launches"],
                             "nd_multi_mp_sgd_mom_update_bert_150":
                                 nd_b1["multi"]["launches"],
                             **{f"{t}_fp16": z["launches"]["mp_sgd"]
                                for t, z in zoo.items()},
                             "image_rec_fp16": image_rec["launches"]["mp_sgd"],
                             "image_dataset_fp16":
                                 sum(images["image_dataset"]["b1_launches"])},
        "launches_per_step": {
            "train_fp16": train["mp_sgd"] / TRAIN_STEPS,
            "train_resnet50_fp16": resnet["mp_sgd"] / RESNET_STEPS,
            "train_bert_adamw_fp16": adamw["launches"]["mp_sgd"]
            / adamw["steps"],
            "train_gluon_nd_fp16": gluon_nd["b1_launches_per_step"],
            **{f"{t}_fp16": z["b1_launches_per_step"]
               for t, z in zoo.items()},
            "image_rec_fp16": image_rec["b1_launches_per_step"]},
        "max_abs_err": max([r["max_abs_err"] for r in sgd_rows]
                           + [r[f"clip_{c}"]["max_abs_err"]
                              for r in multi_rows.values()
                              for c in (-1.0, 1.0)]),
        "ms": bert_multi["ms"], "plain_ms": bert_multi["plain_ms"],
        "bound_ms": bert_multi["bound_ms"],
        "bound_by": bert_multi["bound_by"],
        "shape": [bert_multi["values"]], "tensors": bert_multi["tensors"],
        "multi": {"bert_base_fp16": {k: bert_multi[k] for k in multi_keys},
                  "resnet50_fp16": {k: resnet_multi[k]
                                    for k in multi_keys},
                  "fused_sgd_note": bert_multi["fused_sgd_note"],
                  "capacity": bert_multi["capacity"]},
        "single_tensor": {k: sgd[k] for k in (
            "n", "ms", "plain_ms", "bound_ms", "bound_by")},
        "largest_resnet50_tensor": {k: sgd_resnet[k] for k in (
            "n", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "library_none_because": "no single PyTorch call computes the "
                                "update and the cast together",
        "dtype": "float16/float32", **common})
    log(f"[time] chip_smoke ran for {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
