"""The port's Gluon recurrent cells against the JAX package's, on the
CPU: each cell's ``unroll`` (``RNNCell``, ``LSTMCell``, ``GRUCell``, the
sequential, hybrid sequential, residual, zoneout, dropout and
bidirectional cells), and three of them with ``valid_length``, built
without their input sizes in the port: outputs and states within 1e-5
(max abs), the gradients of the input and of every parameter within
1e-4 relative L2, the JAX side one compiled program
(``test_torch_rnn.jax_forward_backward``).
"""
import numpy as np
import pytest

from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd

from test_torch_rnn import (B, H, I, T, _carry, _squares, assert_matches,
                            jax_forward_backward, port_forward_backward)


CELLS = {
    "rnn": lambda g, i: g.rnn.RNNCell(H, activation="relu", input_size=i),
    "lstm": lambda g, i: g.rnn.LSTMCell(H, input_size=i),
    "gru": lambda g, i: g.rnn.GRUCell(H, input_size=i),
    "sequential": lambda g, i: _stack(g, g.rnn.SequentialRNNCell, i),
    "hybrid_sequential": lambda g, i: _stack(
        g, g.rnn.HybridSequentialRNNCell, i),
    "residual": lambda g, i: g.rnn.ResidualCell(g.rnn.GRUCell(
        I, input_size=i)),
    "zoneout": lambda g, i: g.rnn.ZoneoutCell(g.rnn.LSTMCell(
        H, input_size=i)),
    "dropout": lambda g, i: _stack(g, g.rnn.SequentialRNNCell, i,
                                   drop=True),
    "bidirectional": lambda g, i: g.rnn.BidirectionalCell(
        g.rnn.LSTMCell(H, input_size=i), g.rnn.GRUCell(H, input_size=i)),
}


def _stack(g, cls, i, drop=False):
    cell = cls()
    cell.add(g.rnn.LSTMCell(H, input_size=i))
    if drop:
        cell.add(g.rnn.DropoutCell(0.5))
    cell.add(g.rnn.GRUCell(H, input_size=i and H))
    return cell


def _unroll_fn(cell, x, *valid):
    out, st = cell.unroll(T, x, layout="NTC", merge_outputs=True,
                          valid_length=valid[0] if valid else None)
    return [_squares(out, st), out] + list(st)


@pytest.mark.parametrize("name,valid", [(n, False) for n in sorted(CELLS)]
                         + [("lstm", True), ("sequential", True),
                            ("bidirectional", True)])
def test_cell_unroll_matches_jax(name, valid):
    """In predict mode (the dropout cell passes its input through, the
    zoneout cell has rates 0)."""
    rs = np.random.RandomState(2)
    x = rs.randn(B, T, I).astype("float32")
    inputs = [x] + ([np.array([5, 2, 3], "float32")] if valid else [])
    jc, tc = CELLS[name](jgluon, I), CELLS[name](gluon, 0)
    jc.initialize()
    with mx.cpu():
        tc.initialize(ctx=mx.cpu())
        with autograd.pause():
            tc.unroll(T, nd.array(x), layout="NTC")
        _carry(jc, tc)
        port = port_forward_backward(tc, _unroll_fn, inputs, training=False)
        # a list of steps in, a list of steps out
        with autograd.pause():
            steps = [nd.array(x[:, t]) for t in range(T)]
            outs, _ = tc.unroll(T, steps, layout="NTC", merge_outputs=False)
    assert len(outs) == T and outs[0].shape == port[0][0][:, 0].shape
    assert_matches(port, jax_forward_backward(jc, _unroll_fn, inputs,
                                              training=False), [0])
    if valid and name != "bidirectional":
        # (the JAX package masks the reverse cell's outputs by their
        # position in the reversed sequence; the port does the same)
        assert not port[0][0][1, 2:].any()
