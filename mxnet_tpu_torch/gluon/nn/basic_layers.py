"""Basic layers as ``torch.nn.Module``s: the subset BERT needs.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``. Shapes are given
up front (no deferred initialization) and every layer takes ``device=``
(default ``"cuda"``, raising without a GPU) and ``dtype=``. Parameter
layouts match the JAX package, so weights carry over one to one
(``convert.py``): a ``Dense`` weight is ``(units, in_units)``, the layout
of ``torch.nn.Linear``; ``LayerNorm``'s ``gamma``/``beta`` are ``weight``/
``bias`` here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ... import autograd
from ...base import MXNetError
from ...context import resolve_device

__all__ = ["HybridSequential", "Dense", "Dropout", "LayerNorm", "Embedding",
           "GELU", "gelu"]

# the JAX package's default initializer: Uniform(0.07) for weights
_INIT_SCALE = 0.07


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``LeakyReLU(act_type="gelu")`` computes it."""
    return F.gelu(x, approximate="none")


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class HybridSequential(nn.Sequential):
    """Children run in order; named ``0, 1, ...`` as in the JAX package."""

    def add(self, *blocks: nn.Module) -> None:
        for block in blocks:
            self.append(block)


class Dense(nn.Module):
    """``FullyConnected`` with ``flatten=False``: ``x . W^T + b`` over the
    last axis."""

    def __init__(self, units: int, in_units: int, use_bias: bool = True,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(units, in_units, device=dev,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(units, device=dev, dtype=dtype)) \
            if use_bias else None
        nn.init.uniform_(self.weight, -_INIT_SCALE, _INIT_SCALE)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"{self.weight.shape[1]} -> {self.weight.shape[0]}"


class Dropout(nn.Module):
    """Dropout with rate ``rate``, active exactly when
    ``autograd.is_training()`` (inside ``autograd.record()``), as the JAX
    package's ``F.Dropout`` is; elsewhere, serving included, the identity.

    Kept elements are scaled by ``1 / (1 - rate)``. Masks come from the
    layer's own ``torch.Generator`` on its device, seeded from torch's
    global generator (so ``torch.manual_seed`` fixes them);
    :meth:`manual_seed` restarts it, so that two runs draw the same
    masks."""

    def __init__(self, rate: float = 0.0, device="cuda"):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = rate
        self._gen = torch.Generator(device=resolve_device(device))
        self.manual_seed(int(torch.randint(0, 2 ** 62, ()).item()))

    def manual_seed(self, seed: int) -> None:
        self._gen.manual_seed(seed)

    def forward(self, x):
        if self.rate == 0.0 or not autograd.is_training():
            return x
        if x.device != self._gen.device:
            raise MXNetError(f"Dropout: input on {x.device}, the layer's "
                             f"generator on {self._gen.device}")
        keep = torch.rand(x.shape, generator=self._gen, device=x.device) \
            >= self.rate
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.rate))

    def extra_repr(self):
        return f"rate={self.rate}"


class LayerNorm(nn.Module):
    """Layer normalization over the last axis, eps 1e-5."""

    def __init__(self, in_channels: int, epsilon: float = 1e-5,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.eps = epsilon
        self.weight = nn.Parameter(torch.ones(in_channels, device=dev,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(in_channels, device=dev,
                                             dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias,
                            self.eps)


class Embedding(nn.Module):
    """Row lookup into an ``(input_dim, output_dim)`` table."""

    def __init__(self, input_dim: int, output_dim: int, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim,
                                               device=dev, dtype=dtype))
        nn.init.uniform_(self.weight, -_INIT_SCALE, _INIT_SCALE)

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.weight.shape[0]} -> {self.weight.shape[1]}"
