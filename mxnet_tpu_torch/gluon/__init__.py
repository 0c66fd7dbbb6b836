"""Gluon of the port: blocks (and ``SymbolBlock``, a graph as a block),
parameters with deferred initialization, layers, recurrent layers and
cells (``gluon.rnn``), losses, ``gluon.data``, utilities, the model zoo,
the contributed components (``gluon.contrib``) and the Trainer."""
from . import data, loss, model_zoo, nn, rnn, utils  # noqa: F401
from . import contrib  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict, collect_params)
from .trainer import Trainer  # noqa: F401

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "nn", "loss",
           "data", "utils", "model_zoo", "collect_params", "Trainer", "rnn",
           "contrib"]
