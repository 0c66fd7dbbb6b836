"""Gluon of the port: layers, losses, parameters and the Trainer."""
from . import loss, nn  # noqa: F401
from .parameter import collect_params  # noqa: F401
from .trainer import Trainer  # noqa: F401

__all__ = ["nn", "loss", "collect_params", "Trainer"]
