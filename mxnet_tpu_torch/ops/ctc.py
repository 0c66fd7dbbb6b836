"""The CTC loss.

Counterpart of ``mxnet_tpu/ops/ctc.py``, where the loss is a log-space
alpha recursion over ``lax.scan`` that XLA lowers with no Pallas kernel.
Here it is ``torch.nn.functional.ctc_loss`` on the activations' log
softmax: torch's CTC kernels on a CUDA tensor, its CPU loop on a CPU one.

The conventions are the JAX package's, not upstream MXNet's:

- the blank is index 0 (``blank_label="first"``) or ``C - 1``
  (``"last"``);
- without ``use_label_lengths`` a row's label length is its count of
  labels ``> 0``, whatever the blank (so a row padded with 0 or -1 ends
  at its first non-positive label), and without ``use_data_lengths``
  every row takes all ``T`` frames;
- a row no alignment fits (fewer frames than labels plus repeats) has the
  loss ``1e30``, the JAX package's value (its ``NEG_INF = -1e30``), where
  torch gives ``inf``; its gradient is 0 (the JAX package's is an
  artefact of that sentinel: ROADMAP, faults of the JAX package);
- frames past a row's data length get a gradient of exactly 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = ["IMPOSSIBLE_LOSS"]

# the loss of a row no alignment fits: -(the JAX package's NEG_INF)
IMPOSSIBLE_LOSS = 1e30


@register_op("CTCLoss", aliases=["ctc_loss", "_contrib_CTCLoss",
                                 "_contrib_ctc_loss"])
def ctc_loss(data, label, *lengths, use_data_lengths=False,
             use_label_lengths=False, blank_label="first"):
    """data: (T, B, C) activations before the softmax; label: (B, L)
    labels. Returns the (B,) negative log likelihoods."""
    T, B, C = data.shape
    li = 0
    data_lengths = label_lengths = None
    if use_data_lengths and len(lengths) > li:
        data_lengths = lengths[li].to(torch.int64)
        li += 1
    if use_label_lengths and len(lengths) > li:
        label_lengths = lengths[li].to(torch.int64)
    labels = label.to(torch.int64)
    if label_lengths is None:
        label_lengths = (labels > 0).sum(1)
    if data_lengths is None:
        data_lengths = torch.full((B,), T, dtype=torch.int64,
                                  device=data.device)
    blank = C - 1 if blank_label == "last" else 0
    logp = torch.log_softmax(data, dim=-1)
    loss = F.ctc_loss(logp, labels.clamp_min(0), data_lengths, label_lengths,
                      blank=blank, reduction="none", zero_infinity=True)
    # a path needs a frame per label and one more between equal neighbours
    L = labels.shape[1]
    within = torch.arange(1, L, device=labels.device) < label_lengths[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & within).sum(1)
    impossible = data_lengths < label_lengths + repeats
    return torch.where(impossible, loss.new_tensor(IMPOSSIBLE_LOSS), loss)
