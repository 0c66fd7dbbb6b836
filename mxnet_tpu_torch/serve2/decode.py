"""Prefill / decode / verify over the in-repo LM stack and a paged KV pool.

Counterpart of ``mxnet_tpu/serve2/decode.py``. The model is
:func:`~mxnet_tpu_torch.parallel.pipeline_lm.init_pipeline_lm`'s pre-LN
decoder stack (causal MHA + top-1 MoE FFN), with the same parameters and
math as the dense oracle ``dense_lm_logits``, in incremental form:

- :meth:`PagedLM.prefill` — a causal forward over one prompt padded to a
  rung; each layer's K/V is written into the pool through the block
  table; the next token from the last real position. Only that row goes
  through the final norm and the head (the JAX package computes the
  head for every position and keeps one row: the same row, a GEMV
  instead of a slice of a GEMM);
- :meth:`PagedLM.prefill_ext` — the prefix-cache hit: only the uncached
  suffix is computed, the cached prefix read back through the pool;
- :meth:`PagedLM.decode` — one batch rung of in-flight rows, ``decode_steps``
  greedy tokens per call: embed the last token, write its K/V at its
  length, paged attention, FFN, head, argmax;
- :meth:`PagedLM.verify` — the speculative target step: W candidates per
  row in one causal forward, exact greedy acceptance, the K/V of
  rejected candidates sent to the null page;
- :meth:`PagedLM.copy_page` — copy-on-write of one page (and its scales).

What differs from the JAX package, on purpose:

- **The pools are written in place.** XLA donates the pools to each
  program and the caller threads the new ones forward; here each layer's
  ``(S, H, K)`` slice takes ``index_copy_``, so the pools keep their
  storage (``data_ptr``) for the life of the engine.
- **The ``decode_steps`` loop runs on the host** and makes no host sync:
  the tokens, ``remaining`` and each row's final-step logits stay on the
  device, and a call copies its tokens to the host once at its end. The
  inputs of a call go to the device in one copy.
- **``attention="auto"`` takes ``flat`` on CUDA too.** JAX takes the
  streaming ``scan`` off the CPU; as torch ops the scan is ~12 launches
  per page per layer (~9,000 a token at 24 layers x 32 pages), so the
  one-gather form wins on the card as on the CPU. ``scan`` stays
  selectable (and tested).
- ``export_pages``/``import_pages`` (the fleet's page streaming) wait for
  ROADMAP Queue A item 8.

Pools may be ``f32``, ``bf16`` or ``int8`` with per-slot f32 scales
(quantize on append); reads dequantize inside the gather. A program here
is one padded input signature: each new (kind, size) is recorded, and one
first seen after :meth:`warmup` counts in ``recompiles_after_warmup``.

Parity contract (test-enforced): greedy decode through this cache matches
one-sequence-at-a-time ``dense_lm_logits`` decode token for token, with
logits within the ``fusion`` class for f32 pools and the ``quant_bf16`` /
``quant_int8`` classes for quantized ones.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import resolve_device
from ..telemetry import metrics as _metrics
from ..telemetry import recompile as _recompile
from ..parallel.paged_attention import (_deq, _flat_attend, flat_window,
                                        paged_attention)
from ..parallel.pipeline_lm import _one_hot, _rmsnorm

__all__ = ["PagedLM", "decode_rungs_for", "KV_DTYPES"]

KV_DTYPES = ("f32", "bf16", "int8")
_KV_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}
_KV_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}


def decode_rungs_for(max_inflight: int) -> Tuple[int, ...]:
    """The decode bucket ladder: powers of two up to ``max_inflight``
    (inclusive, appended when not itself a power of two)."""
    m = int(max_inflight)
    if m < 1:
        raise MXNetError("max_inflight must be >= 1")
    rungs = []
    r = 1
    while r < m:
        rungs.append(r)
        r *= 2
    rungs.append(m)
    return tuple(rungs)


def _moe_ffn(lp, hn):
    """Top-1-gated MoE FFN on a (..., D) activation: the dense
    ``_layer`` math with the T axis generalized away. Each product is a
    ``matmul`` over the weights' own layouts (an einsum over ``w1``'s
    (E, D, F) would copy it into (D, E, F) first)."""
    lead = hn.shape[:-1]
    x = hn.reshape(-1, hn.shape[-1])                        # (N, D)
    wts = torch.softmax(x @ lp["gate"], dim=-1)              # (N, E)
    top1 = _one_hot(torch.argmax(wts, -1), wts.shape[-1], wts.dtype) * wts
    top1 = top1 / (torch.sum(top1, -1, keepdim=True) + 1e-9)
    y = torch.matmul(x, lp["w1"]) + lp["b1"][:, None, :]     # (E, N, F)
    y = F.gelu(y, approximate="tanh")
    y = torch.matmul(y, lp["w2"]) + lp["b2"][:, None, :]     # (E, N, D)
    return torch.einsum("ne,end->nd", top1, y).reshape(*lead, -1)


def _qkv(lp, hn):
    """q, k, v (each (..., H, K)) of a (..., D) activation: one batched
    product over ``wqkv``'s (3, D, H, K) layout."""
    three, D, H, K = lp["wqkv"].shape
    out = torch.matmul(hn.reshape(-1, D), lp["wqkv"].reshape(three, D,
                                                             H * K))
    return out.reshape((three,) + hn.shape[:-1] + (H, K))


def _proj(ctx, lp):
    """(..., H, K) attention output through ``wo`` (H, K, D)."""
    H, K, D = lp["wo"].shape
    return (ctx.reshape(-1, H * K) @ lp["wo"].reshape(H * K, D)).reshape(
        ctx.shape[:-2] + (D,))


def _quantize(rows):
    """int8 codes and per-row scales of (..., H, K) rows: absmax / 127
    in f32, round half to even, clip to +-127 (as the JAX package)."""
    amax = torch.amax(torch.abs(rows), dim=(-2, -1))
    s = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(rows / s[..., None, None]), -127, 127)
    return q.to(torch.int8), s


def _deq_rows(kv_dtype: str, pool, scales, idx):
    """Gather + dequantize pool rows at ``idx``: (..., H, K) f32, by the
    paged-attention gather's rule."""
    return _deq(pool[idx], scales[idx] if kv_dtype == "int8" else None)


class PagedLM:
    """One LM + one page pool + the serving programs.

    Parameters
    ----------
    params : the :func:`init_pipeline_lm` tree (tensors or arrays; moved
        to ``device`` as float32, shared where they already are).
    page_size, num_pages : pool geometry (page 0 is the null page).
    max_pages_per_seq : block-table width; caps a sequence at
        ``max_pages_per_seq * page_size`` cached positions.
    decode_steps : tokens per :meth:`decode` call.
    attention : "auto" (= "flat"), "flat" or "scan".
    kv_dtype : "f32", "bf16" or "int8" pools.
    device : default ``"cuda"``; a host without a GPU raises unless the
        caller passes ``"cpu"``.
    """

    def __init__(self, params: Dict, *, page_size: int, num_pages: int,
                 max_pages_per_seq: int, decode_steps: int = 1,
                 attention: str = "auto", kv_dtype: str = "f32",
                 name: str = "lm", device="cuda"):
        self.name = name
        if attention not in ("auto", "scan", "flat"):
            raise MXNetError("attention must be auto/scan/flat")
        if kv_dtype not in KV_DTYPES:
            raise MXNetError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.device = resolve_device(device)
        self.kv_dtype = kv_dtype
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages = int(max_pages_per_seq)
        self.decode_steps = int(decode_steps)
        if self.decode_steps < 1:
            raise MXNetError("decode_steps must be >= 1")

        def dev(x):
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=self.device)
        self.params = {"embed": dev(params["embed"]),
                       "layers": {k: dev(v)
                                  for k, v in params["layers"].items()},
                       "ln_f": dev(params["ln_f"]),
                       "head": dev(params["head"])}
        wqkv = self.params["layers"]["wqkv"]
        self.n_layers, _, self.d_model, self.n_heads, self.d_head = \
            wqkv.shape
        self.vocab = self.params["head"].shape[1]
        self._layers = [{k: v[i] for k, v in self.params["layers"].items()}
                        for i in range(self.n_layers)]
        self.backend = self.device.type
        self.attention = "flat" if attention == "auto" else attention
        slots = self.num_pages * self.page_size
        shape = (self.n_layers, slots, self.n_heads, self.d_head)
        pdt = _KV_TORCH[kv_dtype]
        self.pools = {"k": torch.zeros(shape, dtype=pdt, device=self.device),
                      "v": torch.zeros(shape, dtype=pdt, device=self.device)}
        if kv_dtype == "int8":
            for key in ("ks", "vs"):
                self.pools[key] = torch.zeros(
                    (self.n_layers, slots), dtype=torch.float32,
                    device=self.device)
        self.pool_bytes = self.pool_bytes_for(
            page_size=self.page_size, num_pages=self.num_pages,
            n_layers=self.n_layers, n_heads=self.n_heads,
            d_head=self.d_head, kv_dtype=kv_dtype)
        self._scale = 1.0 / (self.d_head ** 0.5)
        self._lock = threading.Lock()
        self._seen: set = set()
        self._warmed = False
        self._warmed_rungs: dict = {"decode": (), "prefill": (),
                                    "prefill_ext": (), "verify": (),
                                    "pagewire": ()}
        self._after_warmup = 0
        self._m_after = _metrics.counter(
            "mxserve2_recompile_after_warmup_total",
            "serve2 decode/prefill signatures first seen after warmup "
            "declared the set closed — should stay 0")

    # ------------------------------------------------------------------
    # pool geometry
    # ------------------------------------------------------------------
    @staticmethod
    def pool_bytes_for(*, page_size: int, num_pages: int, n_layers: int,
                       n_heads: int, d_head: int,
                       kv_dtype: str = "f32") -> int:
        """Device bytes of the K+V pools (scales included)."""
        slots = int(num_pages) * int(page_size)
        b = 2 * int(n_layers) * slots * int(n_heads) * int(d_head) \
            * _KV_ITEMSIZE[kv_dtype]
        if kv_dtype == "int8":
            b += 2 * int(n_layers) * slots * 4
        return b

    @staticmethod
    def pages_for_bytes(budget_bytes: int, *, page_size: int,
                        n_layers: int, n_heads: int, d_head: int,
                        kv_dtype: str = "f32") -> int:
        """Largest ``num_pages`` whose pool fits ``budget_bytes``."""
        per_page = PagedLM.pool_bytes_for(
            page_size=page_size, num_pages=1, n_layers=n_layers,
            n_heads=n_heads, d_head=d_head, kv_dtype=kv_dtype)
        return max(0, int(budget_bytes) // per_page)

    # ------------------------------------------------------------------
    # device bodies
    # ------------------------------------------------------------------
    def to_device(self, *arrays):
        """Integer host arrays (or device tensors) to int64 device
        tensors: the host ones packed into one buffer, one copy (from
        pinned memory, asynchronous, on CUDA)."""
        host = [i for i, a in enumerate(arrays)
                if not isinstance(a, torch.Tensor)]
        flat = [np.asarray(arrays[i], dtype=np.int64).reshape(-1)
                for i in host]
        buf = torch.from_numpy(np.concatenate(flat)) if flat else None
        if buf is not None and self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        out, off = list(arrays), 0
        for i, f in zip(host, flat):
            out[i] = buf[off:off + f.size].view(np.shape(arrays[i]))
            off += f.size
        return [o.to(device=self.device, dtype=torch.int64) for o in out]

    def _write(self, layer: int, slot, k, v):
        """Quantize-on-append of (..., H, K) rows at ``slot`` (...,)."""
        slot = slot.reshape(-1)
        H, K = k.shape[-2:]
        for key, rows in (("k", k), ("v", v)):
            rows = rows.reshape(-1, H, K)
            if self.kv_dtype == "int8":
                q, s = _quantize(rows)
                self.pools[key][layer].index_copy_(0, slot, q)
                self.pools[key + "s"][layer].index_copy_(0, slot, s)
            else:
                self.pools[key][layer].index_copy_(
                    0, slot, rows.to(self.pools[key].dtype))

    def _layer_pools(self, layer: int):
        int8 = self.kv_dtype == "int8"
        return (self.pools["k"][layer], self.pools["v"][layer],
                self.pools["ks"][layer] if int8 else None,
                self.pools["vs"][layer] if int8 else None)

    def _head(self, h):
        return _rmsnorm(h, self.params["ln_f"]) @ self.params["head"]

    def _decode_body(self, bt, lengths, tokens, remaining):
        """``decode_steps`` greedy tokens for every row, on the device.
        bt (B, N); lengths/tokens/remaining (B,): row i is active for
        steps ``s < remaining[i]`` (0 = dead row). Returns (out (B, K),
        last_logits (B, V)); row i's logits are from its own final
        active step ``remaining[i] - 1``."""
        page = self.page_size
        n_cols = bt.shape[1]
        p = self.params

        def one_token(toks, s):
            act = s < remaining
            pos = lengths + s
            # inactive steps write into the null page's scratch slots,
            # never through a clipped read of the block table
            page_id = torch.gather(
                bt, 1, torch.clamp(pos // page, 0, n_cols - 1)[:, None])[:, 0]
            slot = torch.where(act, page_id * page + pos % page, pos % page)
            att_len = torch.where(act, pos + 1, torch.zeros_like(pos))
            # the flat form's window is the same for every layer
            window = flat_window(bt, att_len, page) \
                if self.attention == "flat" else None
            h = p["embed"][toks]                              # (B, D)
            for i, lp in enumerate(self._layers):
                qkv = _qkv(lp, _rmsnorm(h, lp["ln1"]))
                self._write(i, slot, qkv[1], qkv[2])
                kp, vp, ks, vs = self._layer_pools(i)
                if window is not None:
                    ctx = _flat_attend(qkv[0], kp, vp, window, self._scale,
                                       ks, vs)
                else:
                    ctx = paged_attention(qkv[0], kp, vp, bt, att_len,
                                          page_size=page, scale=self._scale,
                                          kscale=ks, vscale=vs)
                h = h + _proj(ctx, lp)
                h = h + _moe_ffn(lp, _rmsnorm(h, lp["ln2"]))
            logits = self._head(h)
            return torch.argmax(logits, dim=-1), logits

        if self.decode_steps == 1:
            nxt, logits = one_token(tokens, 0)
            return nxt[:, None], logits
        B = tokens.shape[0]
        out = torch.zeros((B, self.decode_steps), dtype=torch.int64,
                          device=self.device)
        last = torch.zeros((B, self.vocab), dtype=torch.float32,
                           device=self.device)
        toks = tokens
        for s in range(self.decode_steps):
            toks, logits = one_token(toks, s)
            out[:, s] = toks
            last = torch.where((s == remaining - 1)[:, None], logits, last)
        return out, last

    def _causal_prefill(self, tokens, slot, mask_fn, hist_idx=None):
        """The layer loop shared by prefill and prefill_ext: attention
        over the (dequantized) history at ``hist_idx`` (if any) and the
        rows themselves, under ``mask_fn``'s (T, S_hist + T) mask, with
        the rows' K/V written at ``slot`` after the history is read."""
        p = self.params
        mask = mask_fn()
        h = p["embed"][tokens]                                # (T, D)
        for i, lp in enumerate(self._layers):
            q, k, v = _qkv(lp, _rmsnorm(h, lp["ln1"]))
            if hist_idx is None:
                lg = torch.einsum("thk,shk->hts", q, k) * self._scale
                vals = v
            else:
                kp, vp, ks, vs = self._layer_pools(i)
                k_hist = _deq_rows(self.kv_dtype, kp, ks, hist_idx)
                v_hist = _deq_rows(self.kv_dtype, vp, vs, hist_idx)
                lg = torch.cat(
                    [torch.einsum("thk,shk->hts", q, k_hist),
                     torch.einsum("thk,uhk->htu", q, k)], dim=-1) \
                    * self._scale
                vals = torch.cat([v_hist, v], dim=0)
            self._write(i, slot, k, v)
            att = torch.softmax(torch.where(mask[None], lg, -1e30), dim=-1)
            ctx = torch.einsum("hts,shk->thk", att, vals)
            h = h + _proj(ctx, lp)
            h = h + _moe_ffn(lp, _rmsnorm(h, lp["ln2"]))
        return h

    def _verify_body(self, bt, lengths, cands, remaining):
        """cands (B, W) = [last accepted token, draft_1..draft_{W-1}]:
        one causal forward over all W positions, greedy acceptance on the
        device. Returns (out (B, W), accepted (B,), last_logits (B, V)):
        row i emits ``out[i, :accepted[i]]``; accepted candidates' K/V
        land at ``lengths[i] + j``, the rest on the null page."""
        page = self.page_size
        B, W = cands.shape
        n_cols = bt.shape[1]
        p = self.params
        dev = self.device
        act = remaining > 0
        offs = torch.arange(page, dtype=torch.int64, device=dev)
        widx = (bt[:, :, None] * page + offs[None, None, :]).reshape(B, -1)
        wpos = torch.arange(widx.shape[1], dtype=torch.int64, device=dev)
        w = torch.arange(W, dtype=torch.int64, device=dev)
        m_hist = (wpos[None, :] < lengths[:, None])[:, None, :].expand(
            B, W, widx.shape[1])
        m_suf = torch.ones((W, W), dtype=torch.bool,
                           device=dev).tril()[None].expand(B, W, W)
        mask = torch.cat([m_hist, m_suf], dim=-1) & act[:, None, None]
        h = p["embed"][cands]                                 # (B, W, D)
        k_new, v_new = [], []
        for i, lp in enumerate(self._layers):
            q, k, v = _qkv(lp, _rmsnorm(h, lp["ln1"]))   # (B, W, H, K)
            kp, vp, ks, vs = self._layer_pools(i)
            k_hist = _deq_rows(self.kv_dtype, kp, ks, widx)
            v_hist = _deq_rows(self.kv_dtype, vp, vs, widx)
            lg = torch.cat([torch.einsum("bwhk,bshk->bhws", q, k_hist),
                            torch.einsum("bwhk,buhk->bhwu", q, k)],
                           dim=-1) * self._scale
            att = torch.softmax(torch.where(mask[:, None], lg, -1e30),
                                dim=-1)
            ctx = torch.einsum("bhws,bshk->bwhk", att,
                               torch.cat([v_hist, v], dim=1))
            h = h + _proj(ctx, lp)
            h = h + _moe_ffn(lp, _rmsnorm(h, lp["ln2"]))
            # acceptance is known only after the head: the writes wait
            k_new.append(k)
            v_new.append(v)
        logits = self._head(h)                                # (B, W, V)
        g = torch.argmax(logits, dim=-1)                      # (B, W)
        match = (cands[:, 1:] == g[:, :-1]).to(torch.int64)
        m = torch.cumprod(match, dim=1).sum(dim=1)            # (B,)
        a = torch.minimum(m + 1, remaining)
        shifted = torch.cat([cands[:, 1:], torch.zeros_like(cands[:, :1])],
                            dim=1)
        out = torch.where(w[None, :] == m[:, None], g, shifted)
        last = torch.gather(
            logits, 1, torch.clamp(a - 1, 0, W - 1)[:, None, None].expand(
                B, 1, logits.shape[-1]))[:, 0]
        pos = lengths[:, None] + w[None, :]                   # (B, W)
        keep = (w[None, :] < a[:, None]) & act[:, None]
        page_id = torch.gather(bt, 1, torch.clamp(pos // page, 0,
                                                  n_cols - 1))
        slot = torch.where(keep, page_id * page + pos % page, pos % page)
        for i in range(self.n_layers):
            self._write(i, slot, k_new[i], v_new[i])
        return out, a, last

    # ------------------------------------------------------------------
    # program record
    # ------------------------------------------------------------------
    def _record(self, kind: str, size: int):
        key = (kind, int(size))
        if key in self._seen:
            return
        self._seen.add(key)
        sig = {"inputs": [{"shape": [int(size)], "dtype": "int32"}],
               "training": False, "program": kind}
        _recompile.record_recompile(f"PagedLM:{self.name}", sig,
                                    kind="serving2")
        if self._warmed:
            self._m_after.inc()
            self._after_warmup += 1

    # ------------------------------------------------------------------
    # public API (one caller at a time: the engine's scheduler thread)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_device(self, bt, lengths, tokens, remaining):
        """:meth:`decode` without the copy to the host: (tokens (B,
        decode_steps) int64, last_logits (B, V)), both on the device."""
        with self._lock:
            self._record("decode", np.shape(bt)[0])
            return self._decode_body(*self.to_device(bt, lengths, tokens,
                                                  remaining))

    def decode(self, bt, lengths, tokens, remaining):
        """One decode call (``decode_steps`` tokens per row); returns
        (tokens (B, decode_steps) int32 numpy, last_logits (B, V) on the
        device). Row i's valid prefix is ``remaining[i]`` tokens. ``bt``
        is (B, max_pages), B a warmed rung."""
        out, logits = self.decode_device(bt, lengths, tokens, remaining)
        return out.cpu().numpy().astype(np.int32), logits

    @torch.no_grad()
    def prefill(self, tokens_padded, length: int, bt_row):
        """Prefill one prompt padded to a rung; returns (next_token,
        last_logits (V,) on the device)."""
        length = int(length)
        with self._lock:
            self._record("prefill", len(tokens_padded))
            tokens, bt_row = self.to_device(tokens_padded, bt_row)
            page, T = self.page_size, tokens.shape[0]
            pos = torch.arange(T, dtype=torch.int64, device=self.device)
            row = bt_row[torch.clamp(pos // page, max=bt_row.shape[0] - 1)]
            slot = torch.where(pos < length, row * page + pos % page,
                               pos % page)
            h = self._causal_prefill(
                tokens, slot,
                lambda: torch.ones((T, T), dtype=torch.bool,
                                   device=self.device).tril())
            last = self._head(h[length - 1])
        return int(torch.argmax(last)), last

    @torch.no_grad()
    def prefill_ext(self, tokens_padded, start: int, length: int, bt_row):
        """Suffix prefill after a prefix-cache hit: ``tokens_padded``
        holds the uncached suffix padded to a rung, ``start`` cached
        positions already sit in the pool through ``bt_row``. Returns
        (next_token, last_logits (V,) on the device)."""
        start, length = int(start), int(length)
        with self._lock:
            self._record("prefill_ext", len(tokens_padded))
            tokens, bt_row = self.to_device(tokens_padded, bt_row)
            page, T = self.page_size, tokens.shape[0]
            dev = self.device
            t = torch.arange(T, dtype=torch.int64, device=dev)
            posq = start + t
            valid = t < length
            row = bt_row[torch.clamp(posq // page, 0, bt_row.shape[0] - 1)]
            slot = torch.where(valid, row * page + posq % page, posq % page)
            offs = torch.arange(page, dtype=torch.int64, device=dev)
            widx = (bt_row[:, None] * page + offs[None, :]).reshape(-1)
            wpos = torch.arange(widx.shape[0], dtype=torch.int64,
                                device=dev)

            def mask():
                # cached positions [0, start) through the pool; the
                # suffix attends to itself in registers
                m_hist = valid[:, None] & (wpos[None, :] < start)
                m_suf = valid[:, None] & valid[None, :] \
                    & (t[None, :] <= t[:, None])
                return torch.cat([m_hist, m_suf], dim=1)
            h = self._causal_prefill(tokens, slot, mask, hist_idx=widx)
            last = self._head(h[length - 1])
        return int(torch.argmax(last)), last

    @torch.no_grad()
    def verify(self, bt, lengths, cands, remaining):
        """Speculative verify of (B, W) candidates (numpy or a device
        tensor); see :meth:`_verify_body`. Returns (out (B, W) int32,
        accepted (B,) int32, last_logits (B, V) on the device), the two
        int arrays in one copy to the host."""
        with self._lock:
            self._record("verify", np.shape(bt)[0])
            out, a, logits = self._verify_body(
                *self.to_device(bt, lengths, cands, remaining))
        host = torch.cat([out, a[:, None]], dim=1).cpu().numpy()
        host = host.astype(np.int32)
        return host[:, :-1], host[:, -1], logits

    @torch.no_grad()
    def copy_page(self, src: int, dst: int):
        """Copy-on-write: duplicate page ``src`` into ``dst`` in every
        pool (K, V, scales)."""
        page = self.page_size
        s0, d0 = int(src) * page, int(dst) * page
        with self._lock:
            self._record("copy_page", 0)
            for pool in self.pools.values():
                pool[:, d0:d0 + page].copy_(pool[:, s0:s0 + page])

    def export_pages(self, pages):
        raise MXNetError("export_pages (pagewire) waits for the fleet "
                         "slice (ROADMAP Queue A item 8)")

    def import_pages(self, pages, planes):
        raise MXNetError("import_pages (pagewire) waits for the fleet "
                         "slice (ROADMAP Queue A item 8)")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, decode_rungs, prefill_rungs, *,
               verify_width: int = 0, prefill_ext: bool = False,
               copy_page: bool = False,
               pagewire_chunk: int = 0) -> List[dict]:
        """Run every rung once; afterwards a new signature counts as a
        recompile after warmup. ``verify_width`` W > 0 also runs the
        verify per decode rung, ``prefill_ext`` the suffix prefill per
        prefill rung, ``copy_page`` the page copy. Each row of the report
        is one program's first run, in ms of host time."""
        if pagewire_chunk:
            raise MXNetError("pagewire_chunk > 0 (fleet page streaming) "
                             "waits for ROADMAP Queue A item 8")
        report = []
        N = self.max_pages

        def timed(program, size, fn):
            t0 = time.perf_counter()
            fn()
            self._sync()
            report.append({"program": program, "size": size,
                           "first_run_ms": (time.perf_counter() - t0)
                           * 1e3})
        zeros = np.zeros
        for b in sorted(set(int(r) for r in decode_rungs)):
            timed("decode", b, lambda: self.decode(
                zeros((b, N), "int32"), zeros((b,), "int32"),
                zeros((b,), "int32"), zeros((b,), "int32")))
            if verify_width > 0:
                timed("verify", b, lambda: self.verify(
                    zeros((b, N), "int32"), zeros((b,), "int32"),
                    zeros((b, verify_width), "int32"),
                    zeros((b,), "int32")))
        for t in sorted(set(int(r) for r in prefill_rungs)):
            timed("prefill", t, lambda: self.prefill(
                zeros((t,), "int32"), 1, zeros((N,), "int32")))
            if prefill_ext:
                timed("prefill_ext", t, lambda: self.prefill_ext(
                    zeros((t,), "int32"), 0, 1, zeros((N,), "int32")))
        if copy_page:
            timed("copy_page", 0, lambda: self.copy_page(0, 0))
        self._warmed = True
        dr = tuple(sorted(set(int(r) for r in decode_rungs)))
        pr = tuple(sorted(set(int(r) for r in prefill_rungs)))
        self._warmed_rungs = {
            "decode": dr, "prefill": pr,
            "verify": dr if verify_width > 0 else (),
            "prefill_ext": pr if prefill_ext else (), "pagewire": ()}
        return report

    @property
    def warmed(self) -> bool:
        return self._warmed

    def lint_report(self) -> dict:
        """What :mod:`mxnet_tpu_torch.passes.servelint` checks: the
        signatures seen against the declared rungs, and the pools'
        update mode (in place: the counterpart of donation)."""
        with self._lock:
            seen = sorted(self._seen)
            after = self._after_warmup
        return {
            "name": self.name,
            "warmed": self._warmed,
            "decode_rungs": self._warmed_rungs["decode"],
            "prefill_rungs": self._warmed_rungs["prefill"],
            "verify_rungs": self._warmed_rungs["verify"],
            "prefill_ext_rungs": self._warmed_rungs["prefill_ext"],
            "pagewire_rungs": self._warmed_rungs["pagewire"],
            "compiled": seen,
            "decode_steps": self.decode_steps,
            "attention": self.attention,
            "kv_dtype": self.kv_dtype,
            "donate_mode": "in_place",
            "donate_pages": True,
            "backend": self.backend,
            "recompiles_after_warmup": after,
            "pool_bytes": self.pool_bytes,
        }
