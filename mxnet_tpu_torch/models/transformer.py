"""Transformer / BERT model family as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/models/transformer.py``. Attribute names are
the JAX package's (``embed``, ``pos_embed``, ``layers.N.attn.qkv``,
``proj``, ``ln1``, ``ln2``, ``ffn1``, ``ffn2``, ``ln_f``, ``head``), so
parameter names line up with its ``_collect_params_with_prefix()`` and
``convert.params_from_mxnet_tpu`` maps one onto the other.

Attention picks its function per shape, as the reference's
``MultiHeadAttention`` does, before any launch: where
:func:`~mxnet_tpu_torch.ops.flash_attention.flash_attention_available`
holds for the layer's head dim (up to 128), it goes through
:func:`~mxnet_tpu_torch.ops.flash_attention`: on CUDA every layer launches
the hand-written flash kernels (the forward, and in a backward the dQ and
dK/dV kernels; on the tensor cores in fp16/bf16, and in fp32 for a head
dim up to 64 in the forward and up to 128 in the backward), on the CPU it
takes their plain versions. Elsewhere it is dense
:func:`~mxnet_tpu_torch.parallel.local_attention`.
``dtype=torch.float16`` builds the model for mixed-precision training.
The models are Gluon ``HybridBlock``s, as there: ``collect_params``,
``save_parameters`` and ``load_parameters`` address their parameters in
the JAX package's naming.
The JAX package's measured choice between flash and dense attention on
shapes both take (``operator_tune``), context parallelism and the
mixture-of-experts FFN come with later slices.
"""
from __future__ import annotations

import torch

from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import (GELU, Dense, Dropout, Embedding, HybridSequential,
                        LayerNorm)
from ..ops.flash_attention import flash_attention, flash_attention_available
from ..parallel.ring_attention import local_attention

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerLM",
           "BERTModel"]


class MultiHeadAttention(HybridBlock):
    """Self-attention over ``(B, T, C)``.

    ``attention`` is the function applied to the ``(B, H, T, D)`` q/k/v,
    :func:`flash_attention` by default, which stands for the reference's
    choice: the kernels where :func:`flash_attention_available` holds,
    dense :func:`local_attention` elsewhere (mxnet_tpu/models/
    transformer.py:88-104). A caller that needs another function (the
    dense oracle of a reference run, ``flash_attention_ref``) assigns it,
    and it is applied at every shape."""

    def __init__(self, units: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = True, causal: bool = False, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        dev = resolve_device(device)
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self.causal = causal
        self.attention = flash_attention
        self.qkv = Dense(3 * units, use_bias=use_bias, flatten=False, in_units=units,
                         device=dev, dtype=dtype)
        self.proj = Dense(units, use_bias=use_bias, flatten=False, in_units=units,
                          device=dev, dtype=dtype)
        self.drop = Dropout(dropout, device=dev)

    def forward(self, x):
        B, T, C = x.shape
        # (B, T, 3, H, D) -> (3, B, H, T, D): one copy makes q, k and v
        # each contiguous, as the kernel requires
        qkv = self.qkv(x).reshape(B, T, 3, self._num_heads, self._head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        attention = self.attention
        if attention is flash_attention and not flash_attention_available(
                T, T, self._head_dim):
            attention = local_attention
        out = attention(q, k, v, causal=self.causal)   # (B, H, T, D)
        out = out.transpose(1, 2).reshape(B, T, C)
        return self.drop(self.proj(out))


class TransformerEncoderLayer(HybridBlock):
    def __init__(self, units: int, num_heads: int, hidden_size: int,
                 dropout: float = 0.0, pre_norm: bool = True,
                 num_experts: int = 0, num_experts_per_tok: int = 2,
                 causal: bool = False, device="cuda", dtype=torch.float32):
        super().__init__()
        if num_experts > 0:
            raise NotImplementedError(
                "the mixture-of-experts FFN is not ported yet; use "
                "num_experts=0")
        dev = resolve_device(device)
        self._pre_norm = pre_norm
        self.attn = MultiHeadAttention(units, num_heads, dropout,
                                       causal=causal, device=dev, dtype=dtype)
        self.ln1 = LayerNorm(in_channels=units, device=dev, dtype=dtype)
        self.ln2 = LayerNorm(in_channels=units, device=dev, dtype=dtype)
        self.ffn1 = Dense(hidden_size, flatten=False, in_units=units, device=dev,
                          dtype=dtype)
        self.act = GELU()
        self.ffn2 = Dense(units, flatten=False, in_units=hidden_size, device=dev,
                          dtype=dtype)
        self.drop = Dropout(dropout, device=dev)

    def _ffn(self, h):
        return self.ffn2(self.act(self.ffn1(h)))

    def forward(self, x):
        if self._pre_norm:
            x = x + self.attn(self.ln1(x))
            return x + self.drop(self._ffn(self.ln2(x)))
        x = self.ln1(x + self.attn(x))
        return self.ln2(x + self.drop(self._ffn(x)))


class TransformerLM(HybridBlock):
    """Encoder / decoder-only LM over token ids ``(B, T)`` -> logits
    ``(B, T, vocab)``: BERT-style (``causal=False``) or GPT-style
    (``causal=True``)."""

    def __init__(self, vocab_size: int, units: int = 256, num_layers: int = 4,
                 num_heads: int = 8, hidden_size: int = 1024,
                 max_len: int = 512, dropout: float = 0.0,
                 causal: bool = False, num_experts: int = 0,
                 num_experts_per_tok: int = 2, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self._max_len = max_len
        self.embed = Embedding(vocab_size, units, device=dev, dtype=dtype)
        self.pos_embed = Embedding(max_len, units, device=dev, dtype=dtype)
        self.layers = HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderLayer(
                units, num_heads, hidden_size, dropout,
                num_experts=num_experts,
                num_experts_per_tok=num_experts_per_tok, causal=causal,
                device=dev, dtype=dtype))
        self.ln_f = LayerNorm(in_channels=units, device=dev, dtype=dtype)
        self.head = Dense(vocab_size, flatten=False, in_units=units, device=dev,
                          dtype=dtype)

    def forward(self, tokens):
        T = tokens.shape[1]
        if T > self._max_len:
            raise ValueError(f"sequence length {T} > max_len "
                             f"{self._max_len}")
        pos = torch.arange(T, device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(pos).unsqueeze(0)
        x = self.layers(x)
        return self.head(self.ln_f(x))


class BERTModel(TransformerLM):
    """BERT-base-style encoder (config 3 in BASELINE.json): vocab 30522,
    768 units, 12 layers, 12 heads, FFN 3072, max_len 512."""

    def __init__(self, vocab_size: int = 30522, units: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 hidden_size: int = 3072, max_len: int = 512,
                 dropout: float = 0.1, device="cuda", dtype=torch.float32):
        super().__init__(vocab_size, units, num_layers, num_heads,
                         hidden_size, max_len, dropout, causal=False,
                         device=device, dtype=dtype)
