"""The fused attention op: the nd route to the flash-attention kernels.

Counterpart of ``mxnet_tpu/ops/fused.py``'s ``_fused_attention`` (the op
the JAX package's graph optimizer fuses attention into, which lowers to
its Pallas flash kernel on a TPU). Here it calls
:func:`~mxnet_tpu_torch.ops.flash_attention.flash_attention` for the
shapes the kernels take (:func:`flash_attention_available`, head dims up
to 128): on CUDA tensors the forward kernel (B2) and, under
``autograd.record()``, the dQ and dK/dV kernels (B3, B4) in the backward;
on CPU tensors their plain versions. Other shapes take the dense
composition the JAX package falls back to, ``softmax(q . k^T * scale) .
v`` with masked logits at -1e30. The rest of ``fused.py`` (the fused
groups and the NHWC ops of the graph optimizer) waits with the symbolic
stack (ROADMAP Queue A item 5).
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_available
from .registry import register_op

__all__ = ["fused_attention"]


@register_op("_fused_attention", input_names=("q", "k", "v"))
def fused_attention(q, k, v, scale=1.0, causal=False):
    """Scaled-dot-product attention over (B, H, T, D) ``q``/``k``/``v``:
    ``softmax(q . k^T * scale) . v``, causal masking top-left aligned."""
    if flash_attention_available(q.shape[-2], k.shape[-2], q.shape[-1]):
        return flash_attention(q, k, v, causal=bool(causal),
                               scale=float(scale))
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = scores.shape[-2:]
        mask = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=q.device).tril(t_k - t_q)
        scores = scores.masked_fill(~mask, -1e30)
    return torch.matmul(torch.softmax(scores, -1), v)
