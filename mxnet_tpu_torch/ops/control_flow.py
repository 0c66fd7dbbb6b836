"""The graph nodes of symbolic control flow: ``_foreach``, ``_while_loop``
and ``_cond``.

Counterpart of the registered half of ``mxnet_tpu/ops/control_flow.py``.
A node's parameters carry its sub-Symbols (built by
:mod:`mxnet_tpu_torch.symbol.control_flow`); the op runs them with
:func:`~mxnet_tpu_torch.symbol.symbol.eval_graph` in a Python loop, so
that autograd records each step and the trip count of a while loop is the
data's. The results are the JAX package's: ``_foreach`` stacks the loop
outputs over axis 0 and then gives the final states; ``_while_loop``
gives its outputs in ``max_iterations`` rows, zero past the last step it
ran, then the final loop variables; ``_cond`` runs the branch its
predicate picks.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ["GRAPH_NODES"]

# the ops that take sub-Symbols as parameters: graph nodes, which an nd
# call (arrays in) cannot make
GRAPH_NODES = ("_foreach", "_while_loop", "_cond")


def _eval_sub(sub, value_map, training):
    from ..symbol.symbol import eval_graph
    return eval_graph(sub, value_map, training)[0]


@register_op("_foreach", n_out=-1, needs_train=True)
def _foreach_node(*arrays, __subgraph__=None, in_names=(), n_data=1,
                  n_states=1, num_outputs=None, _training=False, **_ig):
    """``__subgraph__`` (loop outputs, then new states) over axis 0 of the
    first ``n_data`` inputs; the inputs after the states are loop
    invariants."""
    in_names = list(in_names)
    data = arrays[:n_data]
    states = list(arrays[n_data:n_data + n_states])
    vm = dict(zip(in_names[n_data + n_states:], arrays[n_data + n_states:]))
    stacked = None
    for t in range(data[0].shape[0]):
        vm.update(zip(in_names[:n_data], (d[t] for d in data)))
        vm.update(zip(in_names[n_data:n_data + n_states], states))
        outs = _eval_sub(__subgraph__, vm, _training)
        n_loop = len(outs) - n_states
        states = outs[n_loop:]
        if stacked is None:
            stacked = [[] for _ in range(n_loop)]
        for acc, o in zip(stacked, outs[:n_loop]):
            acc.append(o)
    return tuple(torch.stack(acc) for acc in stacked or []) + tuple(states)


@register_op("_while_loop", n_out=-1, needs_train=True)
def _while_loop_node(*arrays, __cond__=None, __func__=None, in_names=(),
                     n_vars=1, max_iterations=1, num_outputs=None,
                     _training=False, **_ig):
    """``__func__`` (outputs, then new loop variables) while ``__cond__``
    holds, at most ``max_iterations`` times."""
    in_names = list(in_names)
    vs = list(arrays[:n_vars])
    vm = dict(zip(in_names[n_vars:], arrays[n_vars:]))
    rows = []
    for _ in range(int(max_iterations)):
        vm.update(zip(in_names[:n_vars], vs))
        if not bool(_eval_sub(__cond__, vm, _training)[0].reshape(())):
            break
        outs = _eval_sub(__func__, vm, _training)
        n_out = len(outs) - n_vars
        rows.append(outs[:n_out])
        vs = outs[n_out:]
    if not rows:
        # no step ran: the outputs' shapes from one evaluation, all rows 0
        vm.update(zip(in_names[:n_vars], vs))
        probe = _eval_sub(__func__, vm, _training)
        firsts = [torch.zeros_like(o) for o in probe[:len(probe) - n_vars]]
    else:
        firsts = rows[0]
    bufs = []
    for i, first in enumerate(firsts):
        got = [r[i] for r in rows]
        pad = [torch.zeros_like(first)] * (int(max_iterations) - len(got))
        bufs.append(torch.stack(got + pad))
    return tuple(bufs) + tuple(vs)


@register_op("_cond", n_out=-1, needs_train=True)
def _cond_node(*arrays, __pred__=None, __then__=None, __else__=None,
               in_names=(), num_outputs=None, _training=False, **_ig):
    """``__then__`` where ``__pred__`` is true, else ``__else__``."""
    vm = dict(zip(list(in_names), arrays))
    pred = _eval_sub(__pred__, vm, _training)[0]
    branch = __then__ if bool(pred.reshape(())) else __else__
    return tuple(_eval_sub(branch, vm, _training))
