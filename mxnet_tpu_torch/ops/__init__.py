"""Operators of the port: the wrappers of the hand-written kernels
(flash attention, the optimizer's update), the op registry and the op
corpus it generates ``mx.nd`` and ``mx.sym`` from (``tensor``, ``nn``,
``random_ops``, ``optimizer_ops``, ``extra_ops``, ``fused``,
``control_flow``, ``rnn``, ``ctc``, ``image_ops``, ``aliases``), and the registered
stubs of the ops still to port (``deferred``)."""
from . import registry  # noqa: F401
from . import tensor  # noqa: F401
from . import nn, optimizer_ops  # noqa: F401
from . import control_flow, extra_ops, fused, random_ops  # noqa: F401
from . import ctc, image_ops, rnn  # noqa: F401
from . import aliases, deferred  # noqa: F401
from .flash_attention import (flash_attention, flash_attention_bwd,  # noqa: F401
                              flash_attention_fwd, flash_attention_ref,
                              flash_attention_ref_bwd,
                              flash_attention_ref_fwd)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_ref", "flash_attention_ref_fwd",
           "flash_attention_ref_bwd", "nn", "optimizer_ops", "registry",
           "tensor", "random_ops", "extra_ops", "fused", "control_flow",
           "aliases", "deferred", "rnn", "ctc", "image_ops"]
