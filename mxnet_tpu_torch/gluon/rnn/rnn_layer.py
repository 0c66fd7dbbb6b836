"""Gluon's fused recurrent layers: ``RNN``, ``LSTM``, ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``. The parameters are
the JAX package's, per layer, direction and gate: ``l0_i2h_weight``,
``l0_h2h_weight``, ``l0_i2h_bias``, ``l0_h2h_bias``, then ``r0_...`` for
the reverse direction, each an attribute of the layer (so ``convert.py``
and ``.params`` files carry them by name). The input size may be left at
0: the first forward resolves it. The forward hands the per-gate tensors
straight to :func:`~mxnet_tpu_torch.ops.rnn.rnn_forward` (torch's RNN
entry, cuDNN on the card); the JAX package's concatenation into one flat
vector is not made.

``layout`` is ``"TNC"`` (time first) or ``"NTC"``. Called without
states, the layer starts from zeros and returns only the outputs; with
states (a tensor, an NDArray or a list), it returns ``(outputs,
[h, c])`` for an LSTM and ``(outputs, [h])`` otherwise, each state
``(num_layers * ndir, N, hidden_size)``. ``dropout`` acts between
layers in training (``autograd.is_training()``), with the layer's own
generator (:meth:`manual_seed`).
"""
from __future__ import annotations

import torch

from ... import autograd
from ...ops.rnn import GATES, rnn_forward
from ..block import HybridBlock
from ..nn.basic_layers import MaskSource

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock, MaskSource):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None,
                 prefix=None, params=None, device=None,
                 dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._projection_size = projection_size  # kept, never read
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = GATES[mode]
        self._init_masks(device)
        self._names = []
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in "lr"[:self._dir]:
                for name, shape, init in (
                        ("i2h_weight", (ng * nh, ni), i2h_weight_initializer),
                        ("h2h_weight", (ng * nh, nh), h2h_weight_initializer),
                        ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                        ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                    attr = f"{j}{i}_{name}"
                    setattr(self, attr, self._new_param(attr, shape, dtype,
                                                         init, device))
                    self._names.append(attr)
            ni = nh * self._dir

    def _infer_param_shapes(self, x, *args):
        ng, nh = self._gates, self._hidden_size
        for j in "lr"[:self._dir]:
            self.param(f"{j}0_i2h_weight").shape = (ng * nh, x.shape[-1])

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"}
                for _ in range(2 if self._mode == "lstm" else 1)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``kwargs`` such as ``ctx`` go to
        ``nd.zeros``), or ``func(name=..., shape=..., **kwargs)`` of each
        state's info."""
        from ...ndarray.ndarray import zeros as nd_zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if func is None:
                states.append(nd_zeros(info["shape"], **kwargs))
            else:
                info.update(kwargs)
                states.append(func(name=f"{self.prefix}h0_{i}",
                                   **{k: v for k, v in info.items()
                                      if k != "__layout__"}))
        return states

    def forward(self, inputs, states=None):
        skip_states = states is None
        if skip_states:
            n = inputs.shape[self._layout.find("N")]
            states = [inputs.new_zeros(info["shape"])
                      for info in self.state_info(n)]
        elif isinstance(states, torch.Tensor):
            states = [states]
        x = inputs if self._layout == "TNC" else inputs.transpose(0, 1)
        training = autograd.is_training()
        gen = self._generator(x.device) \
            if self._dropout > 0 and training else None
        out, h, c = rnn_forward(
            x, [getattr(self, n) for n in self._names], states[0],
            states[1] if self._mode == "lstm" else None, self._mode,
            self._num_layers, self._dir == 2, self._dropout, training, gen)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, ([h, c] if self._mode == "lstm" else [h])

    def extra_repr(self):
        return f"{self._input_size or None} -> {self._hidden_size}, " \
               f"{self._layout}, num_layers={self._num_layers}" + \
               (", bidirectional" if self._dir == 2 else "")


class RNN(_RNNLayer):
    """Elman RNN with ``activation`` ``"relu"`` or ``"tanh"``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """LSTM (gates i, f, g, o). ``projection_size`` is kept and not
    used, as in the JAX package."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", projection_size,
                         **kwargs)


class GRU(_RNNLayer):
    """GRU (gates r, z, n; ``r`` scales ``h W_hn^T + b_hn``)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
