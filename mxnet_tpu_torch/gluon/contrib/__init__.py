"""Gluon's contributed components: ``nn``, ``rnn``, ``cnn``, ``data``
and ``estimator``.

Counterpart of ``mxnet_tpu/gluon/contrib/``."""
from . import cnn, data, estimator, nn, rnn

__all__ = ["nn", "rnn", "cnn", "data", "estimator"]
