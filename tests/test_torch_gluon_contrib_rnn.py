"""The port's ``gluon.contrib.rnn`` against the JAX package's, on the
CPU: the recurrent cases of ``tests/test_gluon_contrib.py``
(``VariationalDropoutCell``, ``LSTMPCell``, the Conv1D/2D/3D RNN, LSTM
and GRU cells), each also held against the JAX package on the same
numpy-seeded inputs and weights (fp32, rtol 1e-4 / atol 1e-5: the cells
sum). The JAX package's random cells draw other masks than the port's,
so the variational dropout cell is held to it with its masks off
(predict mode) and by its own properties in training.
"""
import numpy as np
import pytest

from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

from mxnet_tpu_torch import autograd, gluon, nd

from test_torch_gluon_contrib import CPU, SUMS, _both, _carry, _close, _rand


def test_variational_dropout_mask_fixed_across_steps():
    x = np.ones((20, 3, 8), "float32")

    def cell_of(g):
        return g.contrib.rnn.VariationalDropoutCell(
            g.rnn.RNNCell(8, input_size=8), drop_outputs=0.5)
    with CPU:
        cell = cell_of(gluon)
        cell.base_cell.initialize(ctx=CPU)
        states = cell.begin_state(batch_size=3)
        with autograd.record():
            out1, states = cell(nd.array(x[0]), states)
            out2, states = cell(nd.array(x[1]), states)
    z1 = out1.asnumpy() == 0.0
    z2 = out2.asnumpy() == 0.0
    assert z1.any(), "dropout produced no zeros at p=0.5"
    assert (z1 == z2).all()
    cell.reset()
    assert cell._output_mask is None
    # without masks (predict mode) it is the JAX package's cell
    jcell = cell_of(jgluon)
    jcell.base_cell.initialize()
    _carry(jcell, cell)
    jo, _ = jcell(jnd.array(x[0]), jcell.begin_state(batch_size=3))
    with CPU:
        to, _ = cell(nd.array(x[0]), cell.begin_state(batch_size=3))
    _close(to, jo, SUMS)


def test_lstmp_cell_projection_shapes():
    def build(g):
        return g.contrib.rnn.LSTMPCell(hidden_size=16, projection_size=6,
                                       input_size=5)
    x = _rand(4, 3, 5)
    jb, tb, jouts, touts = _both(build, x, forward=lambda b, a: b.unroll(
        3, a, merge_outputs=True)[0])
    assert [p[len(tb.prefix):] for p in tb.collect_params()] == \
        [p[len(jb.prefix):] for p in jb.collect_params()]
    with CPU:
        states = tb.begin_state(batch_size=4)
        assert states[0].shape == (4, 6) and states[1].shape == (4, 16)
        out, new_states = tb(nd.zeros((4, 5)), states)
    assert out.shape == (4, 6)
    assert new_states[0].shape == (4, 6) and new_states[1].shape == (4, 16)
    assert touts.shape == (4, 3, 6)
    _close(touts, jouts, SUMS)


def _step_twice(cell, x):
    states = cell.begin_state(batch_size=x.shape[0])
    out, states = cell(x, states)
    out2, states = cell(x, states)
    return [out, out2] + list(states)


@pytest.mark.parametrize("cls,states_n", [("Conv2DRNNCell", 1),
                                          ("Conv2DLSTMCell", 2),
                                          ("Conv2DGRUCell", 1)])
def test_conv_rnn_cells(cls, states_n):
    def build(g):
        return getattr(g.contrib.rnn, cls)(
            input_shape=(4, 8, 8), hidden_channels=6, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1)
    _, tb, jouts, touts = _both(build, _rand(2, 4, 8, 8),
                                forward=_step_twice)
    assert len(touts) == 2 + states_n
    assert all(o.shape == (2, 6, 8, 8) for o in touts)
    _close(touts, jouts, SUMS)


@pytest.mark.parametrize("cls,args,x,out", [
    ("Conv1DLSTMCell", ((2, 10), 4, 3, 3), (2, 2, 10), (2, 4, 10)),
    ("Conv3DGRUCell", ((2, 4, 4, 4), 3, 3, 3), (1, 2, 4, 4, 4),
     (1, 3, 4, 4, 4))])
def test_conv1d_3d_cells_shapes(cls, args, x, out):
    _, _, jouts, touts = _both(
        lambda g: getattr(g.contrib.rnn, cls)(*args, i2h_pad=1),
        _rand(*x), forward=_step_twice)
    assert touts[0].shape == out
    _close(touts, jouts, SUMS)
