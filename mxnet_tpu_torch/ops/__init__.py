"""Operators of the port: the wrappers of the hand-written kernels
(flash attention, the optimizer's update) and the layer ops on cuDNN and
ATen (``nn``)."""
from . import nn, optimizer_ops  # noqa: F401
from .flash_attention import (flash_attention, flash_attention_bwd,  # noqa: F401
                              flash_attention_fwd, flash_attention_ref,
                              flash_attention_ref_bwd,
                              flash_attention_ref_fwd)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_ref", "flash_attention_ref_fwd",
           "flash_attention_ref_bwd", "nn", "optimizer_ops"]
