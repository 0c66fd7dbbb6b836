"""Framework error type of the port (counterpart of mxnet_tpu.base)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Framework error type."""
