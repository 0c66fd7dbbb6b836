"""Devices of the port: ``Context`` over ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``: ``Context``, ``cpu()``,
``gpu(i)``, ``current_context()``, ``with ctx:`` and ``num_gpus()``. A
``Context`` names a ``torch.device`` (``gpu(i)`` is ``cuda:i``). Entry
points take ``device=`` (or ``ctx=``) and default to CUDA: asking for a
GPU on a host without one raises instead of running on the CPU, so
``mx.gpu()`` raises there, and so does ``current_context()`` outside a
``with mx.cpu():`` scope. The CPU is used only when the caller names it.
"""
from __future__ import annotations

import threading
from typing import Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "resolve_device", "as_device"]


def resolve_device(device: Union[str, torch.device, "Context", None] = "cuda"
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; raises :class:`MXNetError`
    for a CUDA device when CUDA is not available."""
    if isinstance(device, Context):
        return device.torch_device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


class Context:
    """A device: ``Context("cpu")`` or ``Context("gpu", i)``; used as
    ``with ctx:`` it is the default of the creation functions inside."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if isinstance(device_type, torch.device):
            device_id = device_type.index or 0
            device_type = "gpu" if device_type.type == "cuda" else "cpu"
        if device_type not in self.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r} "
                             "(cpu or gpu)")
        self.device_type = device_type
        self.device_id = int(device_id)
        self.torch_device = resolve_device(
            f"cuda:{self.device_id}" if device_type == "gpu" else "cpu")

    @property
    def device_typeid(self) -> int:
        return self.devstr2type[self.device_type]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        stack = getattr(Context._default_ctx, "stack", None)
        if stack is None:
            stack = Context._default_ctx.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default_ctx.stack.pop()

    def empty_cache(self):
        """Return the caching allocator's free blocks to the device."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.torch_device):
                torch.cuda.empty_cache()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """The CUDA device ``device_id``; raises without CUDA."""
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` context, else ``gpu(0)`` (which raises
    on a host without CUDA)."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    return gpu(0)


def as_device(ctx=None) -> torch.device:
    """``ctx`` (a Context, a device or its name, or None for
    :func:`current_context`) as a :class:`torch.device`."""
    if ctx is None:
        return current_context().torch_device
    return resolve_device(ctx)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
