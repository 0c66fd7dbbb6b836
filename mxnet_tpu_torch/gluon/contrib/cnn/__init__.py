"""Contributed convolution layers (``mxnet_tpu/gluon/contrib/cnn/``)."""
from .conv_layers import DeformableConvolution

__all__ = ["DeformableConvolution"]
