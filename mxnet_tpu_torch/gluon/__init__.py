"""Gluon of the port: blocks (and ``SymbolBlock``, a graph as a block),
parameters with deferred initialization, layers, losses, ``gluon.data``,
utilities, the model zoo and the Trainer."""
from . import data, loss, model_zoo, nn, utils  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict, collect_params)
from .trainer import Trainer  # noqa: F401

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "nn", "loss",
           "data", "utils", "model_zoo", "collect_params", "Trainer"]
