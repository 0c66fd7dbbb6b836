"""Operators of the port that run a hand-written kernel."""
from . import optimizer_ops  # noqa: F401
from .flash_attention import (flash_attention, flash_attention_bwd,  # noqa: F401
                              flash_attention_fwd, flash_attention_ref,
                              flash_attention_ref_bwd,
                              flash_attention_ref_fwd)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_ref", "flash_attention_ref_fwd",
           "flash_attention_ref_bwd", "optimizer_ops"]
