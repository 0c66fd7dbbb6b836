"""The pre-LN decoder stack with top-1 MoE FFNs, dense reference only.

Counterpart of the dense half of ``mxnet_tpu/parallel/pipeline_lm.py``:
the parameter tree (:func:`init_pipeline_lm`, per-layer leaves stacked on
a leading layer axis), :func:`truncate_pipeline_lm` (the self-drafting
model of speculative decoding), one layer (:func:`_layer`) and the dense
forward (:func:`dense_lm_logits`, :func:`dense_lm_loss`), which is the
oracle the paged serving path (``serve2/``) is held to. The mesh, stage
and pipeline functions wait for the distribution slice (ROADMAP Queue A
item 6), and so does ``attention="ring"``.

The tree is ``{"embed": (V, D), "layers": {"ln1", "ln2": (L, D), "wqkv":
(L, 3, D, H, K), "wo": (L, H, K, D), "gate": (L, D, E), "w1": (L, E, D,
F), "b1": (L, E, F), "w2": (L, E, F, D), "b2": (L, E, D)}, "ln_f": (D,),
"head": (D, V)}`` of float32 tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["init_pipeline_lm", "pipeline_lm_spec", "truncate_pipeline_lm",
           "dense_lm_logits", "dense_lm_loss"]


def pipeline_lm_spec(*, vocab: int, d_model: int, n_layers: int,
                     n_heads: int, d_head: int, d_ff: int,
                     n_experts: int) -> List[Tuple[tuple, tuple, object]]:
    """``[(path, shape, init)]`` of the tree in the order the JAX package
    builds it: ``init`` is ``"ones"``, ``"zeros"`` or the scale of a
    normal draw (the draws consume the generator in this order)."""
    L, D, H, K, Fd, E = n_layers, d_model, n_heads, d_head, d_ff, n_experts

    def w(*shape, scale=None):
        return (shape, 1.0 / np.sqrt(shape[-2]) if scale is None else scale)

    spec = [(("embed",),) + w(vocab, D, scale=0.02),
            (("layers", "ln1"), (L, D), "ones"),
            (("layers", "ln2"), (L, D), "ones"),
            (("layers", "wqkv"),) + w(L, 3, D, H, K),
            (("layers", "wo"),) + w(L, H, K, D, scale=1.0 / np.sqrt(H * K)),
            (("layers", "gate"),) + w(L, D, E),
            (("layers", "w1"),) + w(L, E, D, Fd),
            (("layers", "b1"), (L, E, Fd), "zeros"),
            (("layers", "w2"),) + w(L, E, Fd, D, scale=1.0 / np.sqrt(Fd)),
            (("layers", "b2"), (L, E, D), "zeros"),
            (("ln_f",), (D,), "ones"),
            (("head",),) + w(D, vocab)]
    return spec


def _put(tree: Dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init_pipeline_lm(seed: int, *, vocab: int, d_model: int, n_layers: int,
                     n_heads: int, d_head: int, d_ff: int, n_experts: int,
                     device="cuda") -> Dict:
    """The JAX package's tree, bit for bit: the same
    ``numpy.random.RandomState(seed)`` draws in the same order, each
    ``randn(...).astype(float32) * scale`` rounded to float32 as
    ``jnp.asarray`` rounds it. The draws run on the host (numpy), one
    value at a time: ~40 ns a value."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    tree: Dict = {}
    for path, shape, init in pipeline_lm_spec(
            vocab=vocab, d_model=d_model, n_layers=n_layers,
            n_heads=n_heads, d_head=d_head, d_ff=d_ff,
            n_experts=n_experts):
        if init == "ones":
            val = torch.ones(shape, dtype=torch.float32, device=dev)
        elif init == "zeros":
            val = torch.zeros(shape, dtype=torch.float32, device=dev)
        else:
            arr = np.asarray(rs.randn(*shape).astype("float32") * init,
                             dtype=np.float32)
            val = torch.from_numpy(arr).to(dev)
        _put(tree, path, val)
    return tree


def truncate_pipeline_lm(params: Dict, n_layers: int) -> Dict:
    """The first ``n_layers`` of a stack with the embedding, head and
    final norm shared: the self-drafting model of speculative decoding.
    The layer leaves are views (no copy)."""
    L = params["layers"]["wqkv"].shape[0]
    n = int(n_layers)
    if not 1 <= n <= L:
        raise ValueError(f"truncate_pipeline_lm: n_layers must be in "
                         f"[1, {L}], got {n}")
    out = dict(params)
    out["layers"] = {k: v[:n] for k, v in params["layers"].items()}
    return out


def _rmsnorm(h, scale):
    return h * scale * torch.rsqrt(
        torch.mean(torch.square(h), dim=-1, keepdim=True) + 1e-6)


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: by comparison (``F.one_hot`` checks its input's
    range with a read back to the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _layer_params(layers: Dict, i: int) -> Dict:
    return {k: v[i] for k, v in layers.items()}


def _layer(lp, h, shard=None, attention="gspmd"):
    """One pre-LN block on (B, T, D): causal MHA + top-1-gated MoE FFN.
    ``shard`` is the JAX package's sharding hook, the identity in the
    dense reference; only ``attention="gspmd"`` exists here."""
    if attention == "ring":
        raise MXNetError("attention='ring' (ring attention inside the "
                         "pipeline) waits for the distribution slice "
                         "(ROADMAP Queue A item 6)")
    if attention != "gspmd":
        raise ValueError(f"attention must be 'gspmd' or 'ring', "
                         f"got {attention!r}")
    T = h.shape[1]
    K = lp["wo"].shape[1]
    hn = _rmsnorm(h, lp["ln1"])
    qkv = torch.einsum("btd,cdhk->cbthk", hn, lp["wqkv"])
    q, k, v = qkv[0], qkv[1], qkv[2]
    logits = torch.einsum("bthk,bshk->bhts", q, k) / math.sqrt(K)
    causal = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    att = torch.softmax(torch.where(causal, logits, -1e30), dim=-1)
    ctx = torch.einsum("bhts,bshk->bthk", att, v)
    h = h + torch.einsum("bthk,hkd->btd", ctx, lp["wo"])
    hn = _rmsnorm(h, lp["ln2"])
    E = lp["gate"].shape[-1]
    wts = torch.softmax(torch.einsum("btd,de->bte", hn, lp["gate"]), dim=-1)
    top1 = _one_hot(torch.argmax(wts, -1), E, wts.dtype) * wts
    top1 = top1 / (torch.sum(top1, -1, keepdim=True) + 1e-9)
    y = torch.einsum("btd,edf->betf", hn, lp["w1"]) + lp["b1"][:, None, :]
    y = F.gelu(y, approximate="tanh")
    y = torch.einsum("betf,efd->betd", y, lp["w2"]) + lp["b2"][:, None, :]
    return h + torch.einsum("bte,betd->btd", top1, y)


def _stack(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    h = params["embed"][tokens]
    for i in range(params["layers"]["wqkv"].shape[0]):
        h = _layer(_layer_params(params["layers"], i), h)
    return _rmsnorm(h, params["ln_f"])


@torch.no_grad()
def dense_lm_logits(params: Dict, tokens) -> torch.Tensor:
    """Next-token logits (B, T, V) of the dense stack: the serving
    oracle. ``tokens`` (B, T) integer ids on the parameters' device."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    return torch.einsum("btd,dv->btv", _stack(params, tokens.long()),
                        params["head"])


def dense_lm_loss(params: Dict, tokens, labels) -> torch.Tensor:
    """Mean next-token NLL of the dense stack (differentiable)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    labels = torch.as_tensor(labels, device=dev).long()
    logits = torch.einsum("btd,dv->btv", _stack(params, tokens),
                          params["head"])
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None]).mean()
