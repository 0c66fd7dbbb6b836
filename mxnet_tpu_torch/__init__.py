"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu.

The JAX package ``mxnet_tpu`` is the reference this package is held
against; the two share module names so that each counterpart can be
found, but this package imports neither JAX nor ``mxnet_tpu``. Entry
points default to ``device="cuda"`` and raise without a GPU unless the
caller passes ``device="cpu"``. The hand-written kernels (the
flash-attention forward and backward, mixed-precision SGD) live in
``csrc/`` and are built at first use.
"""
from .base import MXNetError  # noqa: F401
from .context import resolve_device  # noqa: F401

__version__ = "0.1.0"
__all__ = ["MXNetError", "resolve_device"]
