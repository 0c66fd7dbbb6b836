"""Gluon of the port: blocks, layers, losses, parameters, the model zoo
and the Trainer."""
from . import loss, model_zoo, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import collect_params  # noqa: F401
from .trainer import Trainer  # noqa: F401

__all__ = ["Block", "HybridBlock", "nn", "loss", "model_zoo",
           "collect_params", "Trainer"]
