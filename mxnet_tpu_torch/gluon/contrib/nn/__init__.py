"""Contributed layers (``mxnet_tpu/gluon/contrib/nn/``)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           PixelShuffle1D, PixelShuffle2D, PixelShuffle3D,
                           SparseEmbedding, SyncBatchNorm)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]
