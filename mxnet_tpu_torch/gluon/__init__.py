"""Gluon of the port: blocks (and ``SymbolBlock``, a graph as a block),
layers, losses, parameters, the model zoo and the Trainer."""
from . import loss, model_zoo, nn  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import collect_params  # noqa: F401
from .trainer import Trainer  # noqa: F401

__all__ = ["Block", "HybridBlock", "SymbolBlock", "nn", "loss", "model_zoo",
           "collect_params", "Trainer"]
