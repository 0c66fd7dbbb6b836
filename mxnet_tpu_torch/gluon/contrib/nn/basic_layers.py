"""Contributed layers: ``Concurrent``, ``HybridConcurrent``,
``Identity``, ``SparseEmbedding``, ``SyncBatchNorm`` and
``PixelShuffle1D/2D/3D``.

Counterpart of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``.
``SparseEmbedding`` gives its weight a row-sparse gradient: torch's
sparse embedding backward leaves a COO gradient on the weight, which
``Parameter.grad()`` shows as a ``RowSparseNDArray`` and the Trainer
hands to the optimizer's lazy row-wise update (the JAX package's
gradient there is dense, with the same values). ``SyncBatchNorm`` is
``BatchNorm`` on one device, as in the JAX package; across devices it
waits for the distribution slice (ROADMAP Queue A item 6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...block import Block, HybridBlock
from ...nn import BatchNorm, Embedding, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class Concurrent(Sequential):
    """Every child on the same input, the outputs concatenated on
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self], dim=self.axis)

    def _trace(self, F, x):
        return F.concat(*[block(x) for block in self], dim=self.axis)


class HybridConcurrent(HybridSequential):
    """:class:`Concurrent` that may be hybridized."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self], dim=self.axis)

    def _trace(self, F, x):
        return F.concat(*[block(x) for block in self], dim=self.axis)


class Identity(HybridBlock):
    """The input, unchanged."""

    def forward(self, x):
        return x

    def _trace(self, F, x):
        return F.identity(x)


class SparseEmbedding(Block):
    """An embedding whose weight takes a row-sparse gradient (see the
    module's docstring); an index in ``[-n, -1]`` wraps and any other
    index outside ``[0, n)`` gives a NaN row, as ``Embedding``'s does."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        self._embedding = Embedding(input_dim, output_dim, dtype=dtype,
                                    weight_initializer=weight_initializer,
                                    sparse_grad=True, device=device)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}

    @property
    def weight(self):
        return self._embedding.param("weight")

    def forward(self, x):
        w = self._embedding.weight
        n = w.shape[0]
        idx = x.long()
        idx = torch.where(idx < 0, idx + n, idx)
        bad = (idx < 0) | (idx >= n)
        out = F.embedding(idx.clamp(0, n - 1), w, sparse=True)
        return out.masked_fill(bad.unsqueeze(-1), math.nan)

    def extra_repr(self):
        return "{input_dim} -> {output_dim}".format(**self._kwargs)


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm; ``BatchNorm`` on one device (see the
    module's docstring). ``num_devices`` is kept."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(in_channels=in_channels, momentum=momentum,
                         epsilon=epsilon, **kwargs)
        self._num_devices = num_devices


def _pixel_shuffle(x, factors):
    """(N, C * prod(f), *S) -> (N, C, *(S * f)): depth to space."""
    n = len(factors)
    N, C = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    c_out = C // math.prod(factors)
    x = x.reshape((N, c_out) + tuple(factors) + spatial)
    perm = [0, 1]
    for i in range(n):
        perm += [2 + n + i, 2 + i]
    x = x.permute(perm)
    return x.reshape((N, c_out) + tuple(s * f for s, f in
                                        zip(spatial, factors)))


class _PixelShuffle(HybridBlock):
    _ndim = 1

    def __init__(self, factor, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(factor, int):
            factor = (factor,) * self._ndim
        self._factor = tuple(int(f) for f in factor)

    def forward(self, x):
        return _pixel_shuffle(x, self._factor)

    def extra_repr(self):
        return str(self._factor if self._ndim > 1 else self._factor[0])


class PixelShuffle1D(_PixelShuffle):
    """(N, C * f, W) -> (N, C, W * f)."""

    _ndim = 1


class PixelShuffle2D(_PixelShuffle):
    """(N, C * f1 * f2, H, W) -> (N, C, H * f1, W * f2)."""

    _ndim = 2


class PixelShuffle3D(_PixelShuffle):
    """(N, C * f1 * f2 * f3, D, H, W) -> (N, C, D * f1, H * f2,
    W * f3)."""

    _ndim = 3
