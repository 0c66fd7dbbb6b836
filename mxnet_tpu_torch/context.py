"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Asking for a GPU
on a host without one raises instead of running on the CPU; the CPU is
used only when the caller names it.
"""
from __future__ import annotations

from typing import Union

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; raises :class:`MXNetError`
    for a CUDA device when CUDA is not available."""
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
