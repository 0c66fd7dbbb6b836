"""Paged-KV attention: decode-time attention over a block-table cache.

Counterpart of ``mxnet_tpu/parallel/paged_attention.py``, as torch ops
(it is no Pallas kernel there). Each sequence's K/V history lives in
fixed-size pages of one pool ``(S, H, K)``, ``S = num_pages * page_size``
slots; a block table row names the page of each logical page. Page 0 is
the null page: dead rows and padding point at it.

- :func:`paged_attention` streams the block table one page at a time with
  the running (max, denominator, accumulator) of an online softmax: the
  logits buffer is ``(B, H, page_size)``. As torch ops this is ~12
  launches per page, so the decode engine does not pick it on CUDA.
- :func:`paged_attention_flat` gathers each sequence's whole window
  ``(B, N * page_size, H, K)`` once and takes one masked softmax.

Both mask positions at or past a row's length with ``-inf`` and guard
every ``exp`` with ``isfinite`` exactly as the JAX package does, so a row
of length 0 gives zeros; no op reads a value back to the host. Quantized
pools dequantize inside the gather: bf16 pools widen, int8 pools take
per-slot f32 scales ``kscale``/``vscale`` of shape ``(S,)``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["paged_attention", "paged_attention_flat", "flat_window"]


def _deq(pool_rows, scale_rows):
    """Widen gathered pool rows (..., H, K) to f32, times per-row
    dequant scales (...,) when there are any."""
    rows = pool_rows.to(torch.float32)
    if scale_rows is None:
        return rows
    return rows * scale_rows.to(torch.float32)[..., None, None]


def _finite_or(x, fill: float):
    return torch.where(torch.isfinite(x), x, fill)


def paged_attention(q, kpool, vpool, block_tables, lengths, *,
                    page_size: int, scale: Optional[float] = None,
                    kscale=None, vscale=None):
    """Single-token attention over paged K/V, streamed page by page.

    q (B, H, K): one query per sequence; kpool, vpool (S, H, K);
    block_tables (B, N) int; lengths (B,) int, valid cached positions per
    row (0 = inactive row, output zeros); kscale, vscale (S,) f32 for
    int8 pools. Returns (B, H, K) in q's dtype."""
    B, H, K = q.shape
    dev = q.device
    scale_v = float(scale if scale is not None else 1.0 / (K ** 0.5))
    offs = torch.arange(page_size, dtype=torch.int64, device=dev)
    qf = q.to(torch.float32)
    bt = block_tables.to(torch.int64)
    lengths = lengths.to(torch.int64)
    o = torch.zeros((B, H, K), dtype=torch.float32, device=dev)
    l = torch.zeros((B, H), dtype=torch.float32, device=dev)
    m = torch.full((B, H), float("-inf"), dtype=torch.float32, device=dev)
    for j in range(bt.shape[1]):
        idx = bt[:, j, None] * page_size + offs[None, :]       # (B, page)
        k_c = _deq(kpool[idx], None if kscale is None else kscale[idx])
        v_c = _deq(vpool[idx], None if vscale is None else vscale[idx])
        logits = torch.einsum("bhk,bphk->bhp", qf, k_c) * scale_v
        mask = (j * page_size + offs)[None, :] < lengths[:, None]
        logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
        new_m = torch.maximum(m, logits.amax(dim=-1))
        safe_m = _finite_or(new_m, 0.0)
        p = torch.exp(logits - safe_m[..., None])
        p = torch.where(torch.isfinite(logits), p, 0.0)
        m_fin = torch.isfinite(m)
        corr = torch.exp(torch.where(m_fin, m - safe_m, float("-inf")))
        corr = torch.where(m_fin, corr, 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhp,bphk->bhk", p, v_c)
        m = new_m
    out = torch.where(l[..., None] > 0,
                      o / torch.clamp_min(l, 1e-30)[..., None], 0.0)
    return out.to(q.dtype)


def flat_window(block_tables, lengths, page_size: int):
    """The flat form's gather indices (B, N * page_size) into the pool and
    the mask of each row's cached positions, the same for every layer of
    one decode step (so a caller computes them once a step)."""
    B = block_tables.shape[0]
    page = int(page_size)
    dev = block_tables.device
    offs = torch.arange(page, dtype=torch.int64, device=dev)
    idx = (block_tables.to(torch.int64)[:, :, None] * page
           + offs[None, None, :]).reshape(B, -1)
    pos = torch.arange(idx.shape[1], dtype=torch.int64, device=dev)
    return idx, pos[None, :] < lengths.to(torch.int64)[:, None]


def paged_attention_flat(q, kpool, vpool, block_tables, lengths, *,
                         page_size: int, scale: Optional[float] = None,
                         kscale=None, vscale=None):
    """Same contract as :func:`paged_attention`: one gather of each
    row's window and one masked softmax (a few launches whatever the
    window; the window buffer is the cost)."""
    return _flat_attend(q, kpool, vpool,
                        flat_window(block_tables, lengths, page_size),
                        scale, kscale, vscale)


def _flat_attend(q, kpool, vpool, window, scale, kscale, vscale):
    """:func:`paged_attention_flat` over :func:`flat_window`'s result."""
    K = q.shape[-1]
    scale_v = float(scale if scale is not None else 1.0 / (K ** 0.5))
    idx, mask = window
    k_all = _deq(kpool[idx], None if kscale is None else kscale[idx])
    v_all = _deq(vpool[idx], None if vscale is None else vscale[idx])
    logits = torch.einsum("bhk,bshk->bhs", q.to(torch.float32),
                          k_all) * scale_v
    logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    safe_m = _finite_or(m, 0.0)
    p = torch.where(torch.isfinite(logits), torch.exp(logits - safe_m), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhs,bshk->bhk", p, v_all)
    out = torch.where(l[..., None] > 0,
                      o / torch.clamp_min(l, 1e-30)[..., None], 0.0)
    return out.to(q.dtype)
