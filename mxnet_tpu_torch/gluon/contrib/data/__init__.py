"""Contributed samplers (``mxnet_tpu/gluon/contrib/data/``)."""
from .sampler import IntervalSampler

__all__ = ["IntervalSampler"]
