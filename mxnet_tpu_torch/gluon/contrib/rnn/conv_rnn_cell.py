"""Convolutional recurrent cells: ``Conv1D/2D/3D`` ``RNN``, ``LSTM`` and
``GRU`` cells (Shi et al. 2015).

Counterpart of ``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``: the
dense ``i2h``/``h2h`` projections of the plain cells become
convolutions, ``h2h`` padded so that the state keeps its spatial shape
(its kernel must be odd); ``input_shape`` is ``(C, *spatial)`` and a
state ``(N, hidden_channels, *spatial')``.
"""
from __future__ import annotations

import torch

from ....ops import nn as nn_ops
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _BaseConvRNNCell(HybridRecurrentCell):
    _n_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 conv_layout="NCHW", activation="tanh", prefix=None,
                 params=None, device=None, dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        dims = len(conv_layout) - 2
        self._dims = dims
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        nn_ops.check_act_type(activation)
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        for k in self._h2h_kernel:
            assert k % 2 == 1, \
                "h2h kernel must be odd to preserve the state shape " \
                f"(got {self._h2h_kernel})"
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._h2h_dilate))
        spatial = [s + 2 * p - d * (k - 1) for s, k, p, d in zip(
            self._input_shape[1:], self._i2h_kernel, self._i2h_pad,
            self._i2h_dilate)]
        self._state_shape = (hidden_channels,) + tuple(spatial)
        n = self._n_gates * hidden_channels
        for attr, shape, init in (
                ("i2h_weight", (n, self._input_shape[0]) + self._i2h_kernel,
                 None),
                ("h2h_weight", (n, hidden_channels) + self._h2h_kernel,
                 None),
                ("i2h_bias", (n,), "zeros"), ("h2h_bias", (n,), "zeros")):
            setattr(self, attr, self._new_param(attr, shape, dtype, init,
                                                device))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NC" + "DHW"[-self._dims:]}]

    def _gates(self, inputs, h):
        i2h = nn_ops.convolution(inputs, self.i2h_weight, self.i2h_bias,
                                 pad=self._i2h_pad, dilate=self._i2h_dilate)
        h2h = nn_ops.convolution(h, self.h2h_weight, self.h2h_bias,
                                 pad=self._h2h_pad, dilate=self._h2h_dilate)
        return i2h, h2h

    def _act(self, x):
        return nn_ops.activation(x, self._activation)


class _ConvRNNCell(_BaseConvRNNCell):
    _n_gates = 1

    def _alias(self):
        return "conv_rnn"

    def _step(self, inputs, states):
        i2h, h2h = self._gates(inputs, states[0])
        out = self._act(i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _n_gates = 4

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def _alias(self):
        return "conv_lstm"

    def _step(self, inputs, states):
        i2h, h2h = self._gates(inputs, states[0])
        i, f, g, o = (i2h + h2h).chunk(4, dim=1)
        next_c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * \
            self._act(g)
        next_h = torch.sigmoid(o) * self._act(next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _n_gates = 3

    def _alias(self):
        return "conv_gru"

    def _step(self, inputs, states):
        i2h, h2h = self._gates(inputs, states[0])
        ir, iz, in_ = i2h.chunk(3, dim=1)
        hr, hz, hn = h2h.chunk(3, dim=1)
        reset = torch.sigmoid(ir + hr)
        update = torch.sigmoid(iz + hz)
        cand = self._act(in_ + reset * hn)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]


def _make(cell_base, dims, name):
    layout = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[dims]

    class _Cell(cell_base):
        __doc__ = f"{name}: layout {layout}."

        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     activation="tanh", prefix=None, params=None,
                     conv_layout=layout, device=None, dtype=torch.float32):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad=i2h_pad,
                             i2h_dilate=i2h_dilate, h2h_dilate=h2h_dilate,
                             conv_layout=conv_layout, activation=activation,
                             prefix=prefix, params=params, device=device,
                             dtype=dtype)

    _Cell.__name__ = _Cell.__qualname__ = name
    return _Cell


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
