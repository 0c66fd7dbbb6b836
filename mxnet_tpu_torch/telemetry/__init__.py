"""Telemetry of the port: the metrics registry and the program record."""
from . import metrics, recompile  # noqa: F401

__all__ = ["metrics", "recompile"]
