"""Gluon-named layers of the port, as ``torch.nn.Module``s."""
from . import nn  # noqa: F401

__all__ = ["nn"]
