"""Gluon's recurrent cells: one step of a recurrence, and ``unroll`` over
a sequence.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: ``RecurrentCell``
(``state_info``, ``begin_state``, ``unroll`` with ``merge_outputs`` and
``valid_length``), ``RNNCell``, ``LSTMCell`` (gates i, f, g, o),
``GRUCell`` (r, z, n), ``SequentialRNNCell``,
``HybridSequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``,
``ResidualCell`` and ``BidirectionalCell``. A cell's parameters are the
JAX package's (``i2h_weight``, ``h2h_weight``, ``i2h_bias``,
``h2h_bias``; the input size may be left at 0), and its step computes on
tensors: ``cell(x, states)`` returns ``(output, new_states)``, NDArrays
for NDArrays. ``unroll`` runs the steps in a Python loop, as the JAX
package's does; the fused path is the layers of ``rnn_layer``.

With ``valid_length``, ``unroll`` zeroes each row's outputs past its
length and leaves its states running, as the JAX package does. The
random cells (``DropoutCell``, ``ZoneoutCell``, and ``contrib.rnn``'s
``VariationalDropoutCell``) draw their masks in training only, from the
cell's own generator (:class:`~mxnet_tpu_torch.gluon.nn.MaskSource`,
``manual_seed``); a kept value of a dropout mask is scaled by ``1 / (1 -
rate)``, as ``Dropout``'s is; a zoneout mask keeps the previous value.
"""
from __future__ import annotations

from typing import List

import torch

from ... import autograd
from ...base import MXNetError
from ...ndarray.ndarray import NDArray
from ...ops import nn as nn_ops
from ...ops.registry import call_op
from ..block import Block, HybridBlock, _unwrap_tree, _wrap_tree
from ..nn.basic_layers import MaskSource

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _has_nd(*trees) -> bool:
    for t in trees:
        if isinstance(t, NDArray):
            return True
        if isinstance(t, (list, tuple)) and _has_nd(*t):
            return True
    return False


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _time_steps(inputs, length, axis):
    if isinstance(inputs, (list, tuple)):
        if len(inputs) != length:
            raise MXNetError(f"unroll: {len(inputs)} inputs for length "
                             f"{length}")
        return list(inputs)
    return [inputs.select(axis, i) for i in range(length)]


class RecurrentCell(Block):
    """The base of the cells (see the module's docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Restart the step counters (and a cell's per-sequence state)
        before a new sequence."""
        self._init_counter = -1
        self._counter = -1
        for cell in self.children():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``kwargs`` such as ``ctx`` go to
        ``nd.zeros``), or ``func(name=..., shape=..., **kwargs)``."""
        assert not self._modified, \
            "After applying modifier cells, call the modifier's begin_state"
        from ...ndarray.ndarray import zeros as nd_zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            shape = tuple(info["shape"])
            if func is None:
                states.append(nd_zeros(shape, **kwargs))
            else:
                states.append(func(
                    name=f"{self._prefix}begin_state_{self._init_counter}",
                    shape=shape, **kwargs))
        return states

    def _zero_states(self, like, batch_size) -> List[torch.Tensor]:
        return [like.new_zeros(tuple(info["shape"]))
                for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs`` (a tensor or NDArray with
        the time axis of ``layout``, or a list of steps). Returns
        ``(outputs, states)``: a list of steps, or with ``merge_outputs``
        one array stacked on the time axis."""
        nd_in = _has_nd(inputs, begin_state, valid_length)
        out = call_op(self._unroll, autograd.is_recording() or not nd_in,
                      length, _unwrap_tree(inputs),
                      _unwrap_tree(begin_state), layout, merge_outputs,
                      _unwrap_tree(valid_length))
        return _wrap_tree(out) if nd_in else out

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        axis = layout.find("T")
        seq = _time_steps(inputs, length, axis)
        batch_size = seq[0].shape[0]
        states = list(begin_state) if begin_state is not None \
            else self._zero_states(seq[0], batch_size)
        outputs = []
        for x in seq:
            output, states = self(x, states)
            outputs.append(output)
        if valid_length is not None:
            outputs = _mask_outputs(outputs, valid_length)
        if merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return self._step(inputs, list(states))

    def _step(self, inputs, states):
        raise NotImplementedError

    def _alias(self):
        return "recurrentcell"


def _mask_outputs(outputs, valid_length):
    """Each step's rows at or past their valid length set to 0."""
    out = []
    for i, o in enumerate(outputs):
        keep = (valid_length > i).reshape((-1,) + (1,) * (o.dim() - 1))
        out.append(torch.where(keep, o, torch.zeros((), dtype=o.dtype,
                                                    device=o.device)))
    return out


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell that may be hybridized (the flags are kept; it runs
    eagerly)."""


class _DenseCell(HybridRecurrentCell):
    """A cell with the dense ``i2h``/``h2h`` projections of ``gates``
    blocks of ``hidden_size``."""

    _n_gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params,
                 device=None, dtype=torch.float32):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        n = self._n_gates * hidden_size
        self.i2h_weight = self._new_param("i2h_weight", (n, input_size),
                                          dtype, i2h_weight_initializer,
                                          device)
        self.h2h_weight = self._new_param("h2h_weight", (n, hidden_size),
                                          dtype, h2h_weight_initializer,
                                          device)
        self.i2h_bias = self._new_param("i2h_bias", (n,), dtype,
                                        i2h_bias_initializer, device)
        self.h2h_bias = self._new_param("h2h_bias", (n,), dtype,
                                        h2h_bias_initializer, device)

    def _infer_param_shapes(self, x, *args):
        self.param("i2h_weight").shape = (self._n_gates * self._hidden_size,
                                          x.shape[-1])

    def _projections(self, x, h):
        return (nn_ops.fully_connected(x, self.i2h_weight, self.i2h_bias),
                nn_ops.fully_connected(h, self.h2h_weight, self.h2h_bias))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def extra_repr(self):
        return f"{self.param('i2h_weight').shape[1] or None} -> " \
               f"{self._hidden_size}"


class RNNCell(_DenseCell):
    """``h' = act(W_i x + b_i + W_h h + b_h)``."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None, **kwargs):
        nn_ops.check_act_type(activation)
        self._activation = activation
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         **kwargs)

    def _alias(self):
        return "rnn"

    def _step(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        output = nn_ops.activation(i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_DenseCell):
    """LSTM step, gates i, f, g, o; states ``[h, c]``. ``activation``
    and ``recurrent_activation`` are accepted and not used, as in the JAX
    package (tanh and sigmoid)."""

    _n_gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid", **kwargs):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         **kwargs)

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def _alias(self):
        return "lstm"

    def _step(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        i, f, g, o = (i2h + h2h).chunk(4, dim=1)
        next_c = torch.sigmoid(f) * states[1] + \
            torch.sigmoid(i) * torch.tanh(g)
        next_h = torch.sigmoid(o) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_DenseCell):
    """GRU step, gates r, z, n: ``n = tanh(x_n + r * (W_hn h + b_hn))``,
    ``h' = (1 - z) n + z h``."""

    _n_gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, **kwargs):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         **kwargs)

    def _alias(self):
        return "gru"

    def _step(self, inputs, states):
        h = states[0]
        i2h, h2h = self._projections(inputs, h)
        ir, iz, in_ = i2h.chunk(3, dim=1)
        hr, hz, hn = h2h.chunk(3, dim=1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        next_h = (1.0 - z) * n + z * h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its own slice
    of the states."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(list(self.children()), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(list(self.children()),
                                  batch_size=batch_size, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self.children():
            n = len(cell.state_info())
            inputs, state = cell(inputs, list(states[p:p + n]))
            p += n
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self.children())[i]


class HybridSequentialRNNCell(SequentialRNNCell, HybridBlock):
    """:class:`SequentialRNNCell` that may be hybridized (the flags are
    kept; it runs eagerly)."""


class DropoutCell(HybridRecurrentCell, MaskSource):
    """Dropout on the inputs at each step (in training), ``axes`` sharing
    one mask; it has no state."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)
        self._init_masks()

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def _step(self, inputs, states):
        if self._rate > 0 and autograd.is_training():
            shape = [1 if i in self._axes else s
                     for i, s in enumerate(inputs.shape)]
            keep = self._keep(self._rate, shape, inputs.device)
            inputs = inputs * keep.to(inputs.dtype) * (1.0 / (1.0 -
                                                             self._rate))
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell around ``base_cell``: its parameters and states are the base
    cell's."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            f"Cell {base_cell.name} is already modified. One cell cannot " \
            "be modified twice"
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell, MaskSource):
    """Zoneout (Krueger et al. 2016): in training each output (state)
    value keeps its previous one with probability ``zoneout_outputs``
    (``zoneout_states``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None
        self._init_masks()

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def _step(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if not autograd.is_training():
            return next_output, next_states
        p_out, p_st = self.zoneout_outputs, self.zoneout_states
        prev = self._prev_output if self._prev_output is not None \
            else torch.zeros_like(next_output)
        output = torch.where(self._keep(p_out, next_output.shape,
                                        next_output.device),
                             next_output, prev) if p_out else next_output
        new_states = [torch.where(self._keep(p_st, new.shape, new.device),
                                  new, old)
                      for new, old in zip(next_states, states)] \
            if p_st else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def _alias(self):
        return "residual"

    def _step(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed, the
    outputs concatenated on the channel axis; it can only be unrolled."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def forward(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(list(self.children()), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(list(self.children()),
                                  batch_size=batch_size, **kwargs)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        axis = layout.find("T")
        seq = _time_steps(inputs, length, axis)
        batch_size = seq[0].shape[0]
        l_cell, r_cell = self.children()
        states = list(begin_state) if begin_state is not None \
            else self._zero_states(seq[0], batch_size)
        n_l = len(l_cell.state_info(batch_size))
        l_out, l_states = l_cell._unroll(length, seq, states[:n_l], layout,
                                         False, valid_length)
        r_out, r_states = r_cell._unroll(length, seq[::-1], states[n_l:],
                                         layout, False, valid_length)
        outputs = [torch.cat([lo, ro], dim=1)
                   for lo, ro in zip(l_out, r_out[::-1])]
        if merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, l_states + r_states
