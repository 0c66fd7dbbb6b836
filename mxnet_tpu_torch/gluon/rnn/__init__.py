"""Gluon's recurrent layers (``RNN``, ``LSTM``, ``GRU``) and cells.

Counterpart of ``mxnet_tpu/gluon/rnn/``."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_cell import __all__ as _cells
from .rnn_layer import *  # noqa: F401,F403
from .rnn_layer import __all__ as _layers

__all__ = _cells + _layers
