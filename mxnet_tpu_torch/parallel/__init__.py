"""Attention oracles of the port (context parallelism comes later)."""
from .ring_attention import local_attention  # noqa: F401

__all__ = ["local_attention"]
