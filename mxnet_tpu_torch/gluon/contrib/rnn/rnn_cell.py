"""``VariationalDropoutCell`` and ``LSTMPCell``.

Counterpart of ``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``.
"""
from __future__ import annotations

import torch

from .... import autograd
from ....ops import nn as nn_ops
from ...nn.basic_layers import MaskSource
from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell, MaskSource):
    """Variational (locked) dropout (Gal and Ghahramani 2016): in training
    one mask per sequence, drawn at its first step and kept until
    :meth:`reset` (``unroll`` resets), on the inputs, the first state
    and the outputs."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = self._state_mask = self._output_mask = None
        self._init_masks()

    def reset(self):
        super().reset()
        self._input_mask = self._state_mask = self._output_mask = None

    def _alias(self):
        return "vardrop"

    def _mask(self, name, p, like):
        mask = getattr(self, name)
        if mask is None:
            keep = self._keep(p, like.shape, like.device)
            mask = keep.to(like.dtype) * (1.0 / (1.0 - p))
            setattr(self, name, mask)
        return mask

    def _step(self, inputs, states):
        training = autograd.is_training()
        if training and self.drop_inputs:
            inputs = inputs * self._mask("_input_mask", self.drop_inputs,
                                         inputs)
        if training and self.drop_states:
            states = [states[0] * self._mask("_state_mask",
                                             self.drop_states, states[0])] \
                + list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        if training and self.drop_outputs:
            output = output * self._mask("_output_mask", self.drop_outputs,
                                         output)
        return output, next_states

    def extra_repr(self):
        return f"in={self.drop_inputs}, state={self.drop_states}, " \
               f"out={self.drop_outputs}"


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projected recurrent state (Sak et al. 2014): the
    states are ``[r, c]``, ``r`` of ``projection_size`` and ``c`` of
    ``hidden_size``; gates from ``x`` and ``r``, ``c' = f c + i g``,
    ``h = o tanh(c')``, ``r' = W_r h`` (``h2r_weight``, no bias)."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, device=None, dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        n = 4 * hidden_size
        for attr, shape, init in (
                ("i2h_weight", (n, input_size), i2h_weight_initializer),
                ("h2h_weight", (n, projection_size), h2h_weight_initializer),
                ("h2r_weight", (projection_size, hidden_size),
                 h2r_weight_initializer),
                ("i2h_bias", (n,), i2h_bias_initializer),
                ("h2h_bias", (n,), h2h_bias_initializer)):
            setattr(self, attr, self._new_param(attr, shape, dtype, init,
                                                device))

    def _infer_param_shapes(self, x, *args):
        self.param("i2h_weight").shape = (4 * self._hidden_size,
                                          x.shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _step(self, inputs, states):
        r, c = states
        gates = nn_ops.fully_connected(inputs, self.i2h_weight,
                                       self.i2h_bias) + \
            nn_ops.fully_connected(r, self.h2h_weight, self.h2h_bias)
        i, f, g, o = gates.chunk(4, dim=1)
        next_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hidden = torch.sigmoid(o) * torch.tanh(next_c)
        next_r = nn_ops.fully_connected(hidden, self.h2r_weight, None,
                                        no_bias=True)
        return next_r, [next_r, next_c]
