"""The fused multi-layer RNN op (vanilla, LSTM, GRU) and
``_rnn_param_concat``.

Counterpart of ``mxnet_tpu/ops/rnn.py``, where each layer is a
``lax.scan`` that XLA lowers with no Pallas kernel. Here the recurrence
is torch's own RNN entry (``torch.lstm``, ``torch.gru``,
``torch.rnn_tanh``, ``torch.rnn_relu``), which runs cuDNN's RNN
(``aten::_cudnn_rnn``) on a CUDA tensor and torch's native loop on a CPU
one. There is no other route: where cuDNN refuses a call, torch's error
is raised.

Layouts agree with the JAX package's: the flat parameter vector holds
every layer's and direction's ``W_i2h`` and ``W_h2h`` first, then every
``b_i2h`` and ``b_h2h`` (MXNet's ``GetParamSize`` order), and the gate
orders are cuDNN's (LSTM i, f, g, o; GRU r, z, n, with ``r`` applied to
``h W_hh^T + b_hh``). :func:`unpack_rnn_params` slices views of the flat
vector into the per-layer ``[w_ih, w_hh, b_ih, b_hh]`` list torch takes;
the Gluon layers pass their per-gate parameters to :func:`rnn_forward`
directly. cuDNN copies weights that do not lie in one buffer in its own
order on every call (neither layout does).

Dropout ``p`` acts between layers only, in training only, as in the JAX
package. It draws from the op's explicit generator, so with ``p > 0`` in
training the layers run one call each and the port applies the mask
between them; torch's internal RNN dropout, which draws from the global
generator, is never used. The JAX package accepts ``projection_size``,
``lstm_state_clip_*`` and ``use_sequence_length`` and ignores them; so
does the port (ROADMAP, faults of the JAX package).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from .registry import parse_bool_param, register_op

__all__ = ["rnn_param_slices", "rnn_param_size", "rnn_input_size",
           "unpack_rnn_params", "rnn_forward", "GATES"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

_ENTRY = {"lstm": torch.lstm, "gru": torch.gru, "rnn_tanh": torch.rnn_tanh,
          "rnn_relu": torch.rnn_relu}


def rnn_param_slices(mode, num_layers, input_size, H, bidirectional):
    """The flat vector's layout, the one place it is written down:
    ``(layer, direction, kind, offset, shape)`` for each array, in order.
    ``direction`` is ``"l"`` or ``"r"``; ``kind`` is ``"i2h_weight"``,
    ``"h2h_weight"``, ``"i2h_bias"`` or ``"h2h_bias"``. Every weight
    comes first, then every bias, each in layer and direction order."""
    g = GATES[mode]
    dirs = ("l", "r") if bidirectional else ("l",)
    out, off = [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * len(dirs)
        for d in dirs:
            for kind, cols in (("i2h_weight", in_sz), ("h2h_weight", H)):
                out.append((layer, d, kind, off, (g * H, cols)))
                off += g * H * cols
    for layer in range(num_layers):
        for d in dirs:
            for kind in ("i2h_bias", "h2h_bias"):
                out.append((layer, d, kind, off, (g * H,)))
                off += g * H
    return out


def rnn_param_size(mode, num_layers, input_size, H, bidirectional) -> int:
    """Length of the flat parameter vector."""
    *_, (_, _, _, off, shape) = rnn_param_slices(
        mode, num_layers, input_size, H, bidirectional)
    return off + shape[0]


def rnn_input_size(total, mode, num_layers, H, bidirectional) -> int:
    """The input size that a flat vector of ``total`` values implies (the
    size grows by ``ndir * gates * H`` with each input feature)."""
    base = rnn_param_size(mode, num_layers, 0, H, bidirectional)
    per = (2 if bidirectional else 1) * GATES[mode] * H
    if total < base or (total - base) % per:
        raise ValueError(f"RNN: {total} parameters fit no input size of "
                         f"{num_layers} {mode} layers of {H}")
    return (total - base) // per


def unpack_rnn_params(params: torch.Tensor, mode, num_layers, input_size, H,
                      bidirectional) -> List[torch.Tensor]:
    """Views of the flat vector as torch's weight list: ``[w_ih, w_hh,
    b_ih, b_hh]`` for each layer, the forward direction before the
    reverse one."""
    slices = rnn_param_slices(mode, num_layers, input_size, H, bidirectional)
    total = rnn_param_size(mode, num_layers, input_size, H, bidirectional)
    if total != params.numel():
        raise ValueError(f"RNN: {params.numel()} parameters given, the "
                         f"{mode} layers take {total}")
    order = ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")
    views = {(layer, d, kind): params[off:off + math.prod(shape)].view(shape)
             for layer, d, kind, off, shape in slices}
    return [views[(layer, d, kind)]
            for layer, d, first, _, _ in slices if first == "i2h_weight"
            for kind in order]


def _call(mode, x, h0, c0, weights, num_layers, bidirectional, train):
    """One call of torch's RNN entry: ``(outputs, h_n, c_n or None)``."""
    fn = _ENTRY[mode]
    if mode == "lstm":
        return fn(x, (h0, c0), weights, True, num_layers, 0.0, train,
                  bidirectional, False)
    out, h_n = fn(x, h0, weights, True, num_layers, 0.0, train,
                  bidirectional, False)
    return out, h_n, None


def rnn_forward(data: torch.Tensor, weights: Sequence[torch.Tensor],
                h0: torch.Tensor, c0: Optional[torch.Tensor], mode: str,
                num_layers: int, bidirectional: bool, p: float = 0.0,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
    """``data`` (T, B, I) through ``num_layers`` layers of ``mode`` with
    torch's weight list ``weights`` and initial states ``h0`` (and ``c0``
    for an LSTM), each (num_layers * ndir, B, H). Returns ``(outputs
    (T, B, ndir * H), h_n, c_n)``, ``c_n`` None but for an LSTM. With
    ``p > 0`` in training, dropout with ``generator`` between layers."""
    train = torch.is_grad_enabled()
    weights = list(weights)
    if not (p > 0 and training and num_layers > 1):
        return _call(mode, data, h0, c0, weights, num_layers, bidirectional,
                     train)
    ndir = 2 if bidirectional else 1
    x = data
    hs, cs = [], []
    for layer in range(num_layers):
        sl = slice(layer * ndir, (layer + 1) * ndir)
        x, h_n, c_n = _call(mode, x, h0[sl], None if c0 is None else c0[sl],
                            weights[4 * ndir * layer:4 * ndir * (layer + 1)],
                            1, bidirectional, train)
        hs.append(h_n)
        cs.append(c_n)
        if layer < num_layers - 1:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) >= p
            x = x * keep.to(x.dtype) * (1.0 / (1.0 - p))
    return (x, torch.cat(hs), None if c0 is None else torch.cat(cs))


def _rnn_inputs(params):
    """``state_cell`` only for an LSTM, which alone has a cell state."""
    names = ("data", "parameters", "state", "state_cell")
    return names if params.get("mode", "lstm") == "lstm" else names[:3]


def _rnn_visible(params):
    """One output, or with ``state_outputs`` also h_out (and c_out for an
    LSTM): ``rnn-inl.h`` NumVisibleOutputs."""
    if not parse_bool_param(params.get("state_outputs", False)):
        return 1
    return 3 if params.get("mode", "lstm") == "lstm" else 2


@register_op("RNN", n_out=3, needs_rng=True, needs_train=True,
             aliases=["_npx_rnn"],
             input_names=_rnn_inputs,
             visible_outputs=_rnn_visible)
def rnn(data, parameters, state, *rest, state_size=0, num_layers=1,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False, _training=False, _generator=None):
    """data (T, B, I); parameters the flat vector; state (num_layers *
    ndir, B, H), and for an LSTM ``state_cell`` after it. Returns
    ``(output, h_out, c_out)`` (``c_out`` zeros but for an LSTM)."""
    num_layers = int(num_layers)
    bidirectional = parse_bool_param(bidirectional)
    H = int(state_size)
    c0 = rest[0] if mode == "lstm" else None
    weights = unpack_rnn_params(parameters, mode, num_layers, data.shape[2],
                                H, bidirectional)
    out, h_n, c_n = rnn_forward(data, weights, state, c0, mode, num_layers,
                                bidirectional, float(p), _training,
                                _generator)
    return out, h_n, c_n if c_n is not None else torch.zeros_like(h_n)


register_op("_rnn_param_concat", aliases=["_npi_rnn_param_concat"],
            doc="Flatten-and-concatenate RNN parameter tensors into the "
                "packed parameter vector (ref: rnn.cc "
                "_rnn_param_concat).")(
    lambda *args, dim=0: torch.cat([a.reshape(-1) for a in args]))
