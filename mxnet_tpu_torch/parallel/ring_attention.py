"""Dense local attention: the oracle the flash kernel is held against.

Counterpart of ``local_attention`` in
``mxnet_tpu/parallel/ring_attention.py``. Ring and Ulysses context
parallelism wait for the port's distribution slice.
"""
from __future__ import annotations

import math

import torch

__all__ = ["local_attention"]


def local_attention(q, k, v, scale=None, causal=False, q_offset=0,
                    kv_offset=0):
    """Plain attention on local blocks. q: (B,H,Tq,D), k/v: (B,H,Tk,D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[2], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
