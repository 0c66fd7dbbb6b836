"""The symbolic recurrent cells of ``mx.rnn``: the pre-Gluon cell API
that builds Symbol graphs for ``Module`` and ``BucketingModule``.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py``. Cells make their weight
variables through an :class:`RNNParams` container (so stacked and
bucketed graphs share them), and ``unroll`` composes a Symbol over the
steps, which the executor runs op by op.

:class:`FusedRNNCell` differs from the JAX package's, which stacks
unfused cells under the same names: here it is upstream MXNet's cell,
one ``RNN`` node (the fused op, cuDNN's RNN on the card) over one flat
``<prefix>parameters`` variable in the op's layout. :meth:`FusedRNNCell.
unfuse` gives the stack of unfused cells whose weights are
``<prefix>l0_i2h_weight``, ``<prefix>r0_h2h_bias``, ... (the JAX
package's names for its fused cell's weights);
:meth:`~FusedRNNCell.unpack_weights` splits the flat vector into them and
:meth:`~FusedRNNCell.pack_weights` joins them again, so that
``save_rnn_checkpoint`` writes the unfused names and
``load_rnn_checkpoint`` reads them back into the flat vector.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import symbol
from ..ops.rnn import rnn_input_size, rnn_param_slices

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


class RNNParams:
    """Shared container of weight Variables (ref: rnn_cell.py
    RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """ref: rnn_cell.py BaseRNNCell."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [s["shape"] for s in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """ref: rnn_cell.py begin_state — state placeholder symbols.

        The reference emits zeros with a 0 batch dim and lets bind-time
        shape inference fill it; here unroll() derives batch-correct
        zeros from the input symbol instead (_states_like), and this
        method keeps the API for callers supplying explicit shapes."""
        assert not self._modified, \
            "After applying modifier cells, call the modifier's begin_state"
        states = []
        for info in self.state_info:
            self._init_counter += 1
            state = func(name=f"{self._prefix}begin_state_"
                              f"{self._init_counter}",
                         **{k: v for k, v in (info or {}).items()
                            if k != "__layout__"}, **kwargs)
            states.append(state)
        return states

    def _states_like(self, ref):
        """Batch-matched zero states derived from a (B, C) input symbol
        (plays the role of the reference's 0-dim shape inference)."""
        states = []
        for info in self.state_info:
            n_hidden = info["shape"][-1]
            z = symbol.slice_axis(ref * 0.0, axis=1, begin=0, end=1)
            states.append(symbol.tile(z, reps=(1, n_hidden)))
        return states

    def _resolve_states(self, begin_state, first_input):
        """Default states, with reference-compat fixup: begin_state()
        zeros carry a literal 0 batch dim (the reference's infer-at-
        bind sentinel, meaningless here) — substitute input-derived
        zeros so the documented begin_state()+unroll pattern works."""
        if begin_state is None:
            return self._states_like(first_input)
        fixed = []
        for st, like in zip(begin_state, self._states_like(first_input)):
            node, _ = st._outputs[0]
            shape = (node.params or {}).get("shape", ())
            if node.op == "_sym_zeros" and shape and 0 in tuple(shape):
                fixed.append(like)
            else:
                fixed.append(st)
        return fixed

    def _normalize_inputs(self, length, inputs, input_prefix, axis):
        if inputs is None:
            return [symbol.Variable(f"{input_prefix}t{i}_data")
                    for i in range(length)]
        if isinstance(inputs, symbol.Symbol):
            if len(inputs.list_outputs()) != 1:
                raise MXNetError("unroll needs a single-output Symbol")
            sliced = symbol.SliceChannel(inputs, axis=axis,
                                         num_outputs=length,
                                         squeeze_axis=1)
            return [sliced[i] for i in range(length)]
        return list(inputs)

    @staticmethod
    def _merge(outputs, axis):
        outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
        return symbol.Concat(*outputs, dim=axis)

    def unpack_weights(self, args):
        """Split fused weight blobs into per-gate arrays (ref:
        rnn_cell.py unpack_weights). The base layout is already
        per-gate, so this copies through."""
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """ref: rnn_cell.py unroll — symbolic time unrolling."""
        self.reset()
        axis = layout.find("T")
        inputs = self._normalize_inputs(length, inputs, input_prefix,
                                        axis)
        states = self._resolve_states(begin_state, inputs[0])
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = self._merge(outputs, axis)
        return outputs, states

    def __call__(self, inputs, states):
        raise NotImplementedError


class RNNCell(BaseRNNCell):
    """Plain tanh/relu cell (ref: rnn_cell.py RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}h2h")
        output = symbol.Activation(i2h + h2h,
                                   act_type=self._activation,
                                   name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """ref: rnn_cell.py LSTMCell (gate order i, f, c, o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=4 * self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=4 * self._num_hidden,
                                    name=f"{name}h2h")
        gates = i2h + h2h
        sliced = symbol.SliceChannel(gates, num_outputs=4,
                                     name=f"{name}slice")
        in_gate = symbol.Activation(sliced[0], act_type="sigmoid")
        forget_gate = symbol.Activation(sliced[1], act_type="sigmoid")
        in_transform = symbol.Activation(sliced[2], act_type="tanh")
        out_gate = symbol.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """ref: rnn_cell.py GRUCell (reset/update/new gate order r, z, n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        prev = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=3 * self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(prev, self._hW, self._hB,
                                    num_hidden=3 * self._num_hidden,
                                    name=f"{name}h2h")
        i2h_s = symbol.SliceChannel(i2h, num_outputs=3)
        h2h_s = symbol.SliceChannel(h2h, num_outputs=3)
        reset = symbol.Activation(i2h_s[0] + h2h_s[0],
                                  act_type="sigmoid")
        update = symbol.Activation(i2h_s[1] + h2h_s[1],
                                   act_type="sigmoid")
        new = symbol.Activation(i2h_s[2] + reset * h2h_s[2],
                                act_type="tanh")
        next_h = (1.0 - update) * new + update * prev
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """The fused multi-layer cell: one ``RNN`` node over the whole
    sequence (see the module's docstring). ``mode`` is ``"lstm"``,
    ``"gru"``, ``"rnn_tanh"`` or ``"rnn_relu"``; ``dropout`` acts between
    layers in training."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        b = len(self._directions) * self._num_layers
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    def _slices(self, input_size):
        """``(name, offset, shape)`` of each weight and bias in the flat
        vector (``ops.rnn.rnn_param_slices``)."""
        return [(f"{self._prefix}{d}{layer}_{kind}", off, shape)
                for layer, d, kind, off, shape in rnn_param_slices(
                    self._mode, self._num_layers, input_size,
                    self._num_hidden, self._bidirectional)]

    def unpack_weights(self, args):
        """``args`` with ``<prefix>parameters`` replaced by the unfused
        stack's arrays (views of it)."""
        args = dict(args)
        name = f"{self._prefix}parameters"
        if name not in args:
            return args
        flat = args.pop(name)
        size = rnn_input_size(flat.size, self._mode, self._num_layers,
                              self._num_hidden, self._bidirectional)
        for key, off, shape in self._slices(size):
            n = shape[0] * (shape[1] if len(shape) > 1 else 1)
            args[key] = flat[off:off + n].reshape(shape)
        return args

    def pack_weights(self, args):
        """``args`` with the unfused stack's arrays joined into
        ``<prefix>parameters``."""
        from ..ndarray.ndarray import concat
        args = dict(args)
        first = f"{self._prefix}l0_i2h_weight"
        if first not in args:
            return args
        keys = [k for k, _, _ in self._slices(args[first].shape[1])]
        args[f"{self._prefix}parameters"] = concat(
            *[args.pop(k).reshape((-1,)) for k in keys], dim=0)
        return args

    def begin_state(self, func=symbol.zeros, **kwargs):
        return super().begin_state(func=func, **kwargs)

    def _states_like(self, ref):
        """Zero states (num_layers * ndir, N, H) from a (T, N, C) input
        symbol."""
        b = len(self._directions) * self._num_layers
        z = symbol.slice_axis(symbol.slice_axis(ref * 0.0, axis=2, begin=0,
                                                end=1), axis=0, begin=0,
                              end=1)
        return [symbol.tile(z, reps=(b, 1, self._num_hidden))
                for _ in self.state_info]

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if inputs is None or not isinstance(inputs, symbol.Symbol):
            steps = self._normalize_inputs(length, inputs, input_prefix,
                                           axis)
            inputs = symbol.stack(*steps, axis=0)
        elif axis == 1:
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        states = self._resolve_states(begin_state, inputs)
        state_kw = {"state": states[0]}
        if self._mode == "lstm":
            state_kw["state_cell"] = states[1]
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **state_kw)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        if not merge_outputs:
            sliced = symbol.SliceChannel(outputs, axis=axis,
                                         num_outputs=length, squeeze_axis=1)
            outputs = [sliced[i] for i in range(length)]
        return outputs, states

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def _cell(self, prefix):
        cls = {"rnn_tanh": RNNCell, "rnn_relu": RNNCell,
               "lstm": LSTMCell, "gru": GRUCell}[self._mode]
        kw = {"activation": "relu"} if self._mode == "rnn_relu" else {}
        return cls(self._num_hidden, prefix=prefix, **kw)

    def unfuse(self):
        """The same network as unfused cells: a SequentialRNNCell of one
        cell (or BidirectionalCell) per layer, named as
        :meth:`unpack_weights` names the weights, with DropoutCells
        between layers where ``dropout`` is set."""
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    self._cell(f"{self._prefix}l{i}_"),
                    self._cell(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(self._cell(f"{self._prefix}l{i}_"))
            if self._dropout and i < self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}d{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """ref: rnn_cell.py SequentialRNNCell."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, func=symbol.zeros, **kwargs):
        return sum((c.begin_state(func=func, **kwargs)
                    for c in self._cells), [])

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """Each cell unrolled over the whole sequence in turn, as upstream
        MXNet's does, so that a ``BidirectionalCell`` or a
        ``FusedRNNCell`` may be one of them (the JAX package steps every
        cell at each time step, which those refuse)."""
        self.reset()
        inputs = self._normalize_inputs(length, inputs, input_prefix,
                                        layout.find("T"))
        next_states = []
        p = 0
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            state = None if begin_state is None else begin_state[p:p + n]
            p += n
            last = i == len(self._cells) - 1
            inputs, state = cell.unroll(
                length, inputs=inputs, begin_state=state, layout=layout,
                merge_outputs=merge_outputs if last else None)
            next_states.extend(state)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """ref: rnn_cell.py DropoutCell."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = symbol.Dropout(inputs, p=self._dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """ref: rnn_cell.py ModifierCell."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """ref: rnn_cell.py ZoneoutCell — randomly preserve previous
    states."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        if self.zoneout_outputs > 0.0:
            keep = mask(self.zoneout_outputs, next_output)
            next_output = symbol.where(keep, next_output, prev_output)
        if self.zoneout_states > 0.0:
            next_states = [symbol.where(mask(self.zoneout_states, ns),
                                        ns, s)
                           for ns, s in zip(next_states, states)]
        self.prev_output = next_output
        return next_output, next_states


class ResidualCell(ModifierCell):
    """ref: rnn_cell.py ResidualCell — output = cell(x) + x."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(BaseRNNCell):
    """ref: rnn_cell.py BidirectionalCell — must be unrolled (stepping
    a bidirectional cell one timestep is undefined)."""

    def __init__(self, l_cell, r_cell, params=None,
                 output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._cells = [l_cell, r_cell]
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, func=symbol.zeros, **kwargs):
        return sum((c.begin_state(func=func, **kwargs)
                    for c in self._cells), [])

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped; use unroll")

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        inputs = self._normalize_inputs(length, inputs, input_prefix,
                                        axis)
        l_cell, r_cell = self._cells
        begin_state = self._resolve_states(begin_state, inputs[0])
        n_l = len(l_cell.state_info)
        l_out, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_out, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(lo, ro, dim=1,
                                 name=f"{self._output_prefix}t{i}")
                   for i, (lo, ro) in enumerate(
                       zip(l_out, reversed(r_out)))]
        if merge_outputs:
            outputs = self._merge(outputs, axis)
        return outputs, l_states + r_states
