"""AMP: dynamic loss scaling for fp16 training.

Counterpart of ``mxnet_tpu/amp/__init__.py``'s ``init_trainer``,
``scale_loss``, ``unscale`` and ``LossScaler``::

    amp.init_trainer(trainer)
    with autograd.record():
        loss = loss_fn(model(x), y)
    with amp.scale_loss(loss, trainer) as scaled:
        autograd.backward(scaled)
    scaler = trainer._amp_loss_scaler
    overflow = scaler.has_overflow(params.values())
    scaler.update_scale(overflow)
    if not overflow:
        trainer.step(batch_size)

The scale starts at 2**16, halves on an overflow (never below 1) and
doubles after ``scale_window`` (2000) clean steps. ``scale_loss`` sets the
trainer's ``_scale`` to ``original / loss_scale``, so ``step`` divides the
scale back out of the gradients. ``has_overflow`` gives the reference's
answer (any non-finite gradient) from one device reduction over every
gradient and one host sync, where the reference syncs once per parameter.

``init`` (the cast policy) and ``convert_model`` / ``convert_hybrid_block``
act through the ``mx.nd`` op-dispatch layer, which comes with the
``mx.nd`` slice (ROADMAP Queue A item 3); they raise until then.
"""
from __future__ import annotations

import torch

from ..ops.optimizer_ops import multi_all_finite

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "convert_hybrid_block", "LossScaler"]

_WAITS = ("comes with the mx.nd slice: the cast policy acts through the "
          "mx.nd op-dispatch layer (ROADMAP Queue A item 3)")


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    raise NotImplementedError(f"amp.init {_WAITS}")


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None, **kwargs):
    raise NotImplementedError(f"amp.convert_model {_WAITS}")


def convert_hybrid_block(block, target_dtype="bfloat16", **kwargs):
    raise NotImplementedError(f"amp.convert_hybrid_block {_WAITS}")


def init_trainer(trainer):
    """Attach a :class:`LossScaler` to ``trainer``."""
    trainer._amp_loss_scaler = LossScaler()
    trainer._amp_original_scale = getattr(trainer, "_scale", 1.0)


class scale_loss:
    """``with scale_loss(loss, trainer) as scaled:`` the loss (or each
    loss of a list) times the trainer's loss scale; the trainer's
    ``_scale`` becomes ``original / loss_scale``."""

    def __init__(self, loss, trainer):
        self._loss = loss
        self._trainer = trainer

    def __enter__(self):
        scaler = getattr(self._trainer, "_amp_loss_scaler", None)
        if scaler is None:
            return self._loss
        self._trainer._scale = self._trainer._amp_original_scale \
            / scaler.loss_scale
        if isinstance(self._loss, (list, tuple)):
            return [l * scaler.loss_scale for l in self._loss]
        return self._loss * scaler.loss_scale

    def __exit__(self, *exc):
        return False


def unscale(trainer):
    """Divide every gradient of ``trainer``'s parameters by the loss
    scale, in place."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    grads = [p.grad for p in trainer._params
             if p.requires_grad and p.grad is not None]
    if grads:
        with torch.no_grad():
            torch._foreach_div_(grads, scaler.loss_scale)


class LossScaler:
    """Dynamic loss scaling: double the scale every ``scale_window``
    overflow-free steps, halve it on an overflow (never below 1)."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params) -> bool:
        """Whether any gradient of ``params`` holds an inf or a NaN: one
        reduction over all of them (``multi_all_finite``), one sync."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return False
        return multi_all_finite(*grads).item() == 0.0

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped == self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
