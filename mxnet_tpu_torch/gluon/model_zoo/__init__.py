"""Predefined models of the port: the vision zoo."""
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401

__all__ = ["vision", "get_model"]
