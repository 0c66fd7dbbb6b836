"""Checkpoints of symbolic recurrent cells, and ``rnn_unroll``.

Counterpart of ``mxnet_tpu/rnn/rnn.py``, in upstream MXNet's order:
``save_rnn_checkpoint`` unpacks each cell's weights (a
:class:`~mxnet_tpu_torch.rnn.rnn_cell.FusedRNNCell`'s flat vector into
its unfused stack's arrays) before ``model.save_checkpoint``, and
``load_rnn_checkpoint`` packs them again after ``model.load_checkpoint``.
The JAX package's cells pack and unpack nothing, so its order does not
show there.
"""
from __future__ import annotations

import logging

from .. import model as model_mod

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]

_log = logging.getLogger("mxnet_tpu_torch.rnn")


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """``cell.unroll`` (the deprecated name)."""
    return cell.unroll(length, inputs=inputs, begin_state=begin_state,
                       input_prefix=input_prefix, layout=layout)


def _cells_pack(cells, args):
    for cell in (cells if isinstance(cells, (list, tuple)) else [cells]):
        args = cell.pack_weights(args)
    return args


def _cells_unpack(cells, args):
    for cell in (cells if isinstance(cells, (list, tuple)) else [cells]):
        args = cell.unpack_weights(args)
    return args


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """Unpack the cells' weights, then ``model.save_checkpoint``."""
    model_mod.save_checkpoint(prefix, epoch, symbol,
                              _cells_unpack(cells, arg_params), aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """``model.load_checkpoint``, then pack the cells' weights:
    ``(symbol, arg_params, aux_params)``."""
    sym, arg, aux = model_mod.load_checkpoint(prefix, epoch)
    return sym, _cells_pack(cells, arg), aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback that saves every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
