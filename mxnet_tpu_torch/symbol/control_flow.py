"""Symbolic control flow: ``sym.contrib.foreach``, ``while_loop`` and
``cond``.

Counterpart of ``mxnet_tpu/symbol/control_flow.py``. Each builder traces
its body callables on fresh variables into sub-Symbols and makes one
``_foreach`` / ``_while_loop`` / ``_cond`` node that carries them
(:mod:`mxnet_tpu_torch.ops.control_flow` runs it). A variable the body
closes over becomes an extra, loop-invariant input of the node; a
computed entry it closes over is computed again inside the subgraph.
"""
from __future__ import annotations

import threading
from typing import Callable

from ..base import MXNetError
from .symbol import Symbol, Variable, Group, _Node, _auto_name

__all__ = ["foreach", "while_loop", "cond"]

_counter = threading.local()


def _fresh(prefix):
    n = getattr(_counter, "n", 0)
    _counter.n = n + 1
    return f"__{prefix}{n}__"


def _as_list(x):
    return (list(x), False) if isinstance(x, (list, tuple)) else ([x], True)


def _entries(syms):
    return [s._entry() for s in syms]


def _free_var_entries(subs, bound_names):
    """Variable nodes used by the subgraphs but not bound by the loop."""
    seen, out = set(), []
    for sub in subs:
        for node in sub._topo_nodes():
            if node.is_variable and node.name not in bound_names \
                    and id(node) not in seen:
                seen.add(id(node))
                out.append((node, 0))
    return out


def foreach(body: Callable, data, init_states, name=None):
    """Scan ``body(data_slice, states) -> (outputs, new_states)`` over
    axis 0, as one graph node."""
    data_list, single_data = _as_list(data)
    state_list, single_state = _as_list(init_states)

    slice_vars = [Variable(_fresh("foreach_data")) for _ in data_list]
    state_vars = [Variable(_fresh("foreach_state")) for _ in state_list]
    outs, new_states = body(slice_vars[0] if single_data else slice_vars,
                            state_vars[0] if single_state else state_vars)
    out_list, single_out = _as_list(outs)
    ns_list, _ = _as_list(new_states)
    if len(ns_list) != len(state_list):
        raise MXNetError("foreach body must return as many states as "
                         f"init_states ({len(ns_list)} vs {len(state_list)})")
    sub = Group(out_list + ns_list)

    bound = {v.name for v in slice_vars + state_vars}
    free = _free_var_entries([sub], bound)
    in_names = ([v.name for v in slice_vars]
                + [v.name for v in state_vars]
                + [n.name for n, _ in free])
    n_total = len(out_list) + len(ns_list)
    from ..attribute import AttrScope
    node = _Node("_foreach", name or _auto_name("_foreach"),
                 _entries(data_list) + _entries(state_list) + free,
                 {"__subgraph__": sub, "in_names": tuple(in_names),
                  "n_data": len(data_list), "n_states": len(state_list),
                  "num_outputs": n_total},
                 AttrScope.current().get(None))
    entries = [(node, i) for i in range(n_total)]
    out_syms = [Symbol([e]) for e in entries[:len(out_list)]]
    st_syms = [Symbol([e]) for e in entries[len(out_list):]]
    return (out_syms[0] if single_out else out_syms,
            st_syms[0] if single_state else st_syms)


def while_loop(cond: Callable, func: Callable, loop_vars,
               max_iterations: int, name=None):
    """A while loop of at most ``max_iterations`` steps; its outputs come
    in ``max_iterations`` rows, zero past the last step run."""
    var_list, single_var = _as_list(loop_vars)
    lvars = [Variable(_fresh("while_var")) for _ in var_list]
    arg = lvars if not single_var else lvars
    c_sym = cond(*arg)
    outs, new_vars = func(*arg)
    out_list, single_out = _as_list(outs)
    nv_list, _ = _as_list(new_vars)
    if len(nv_list) != len(var_list):
        raise MXNetError("while_loop func must return as many loop_vars "
                         f"as given ({len(nv_list)} vs {len(var_list)})")
    func_sub = Group(out_list + nv_list)
    cond_sub = Group([c_sym])

    bound = {v.name for v in lvars}
    free = _free_var_entries([func_sub, cond_sub], bound)
    in_names = [v.name for v in lvars] + [n.name for n, _ in free]
    n_total = len(out_list) + len(nv_list)
    from ..attribute import AttrScope
    node = _Node("_while_loop", name or _auto_name("_while_loop"),
                 _entries(var_list) + free,
                 {"__cond__": cond_sub, "__func__": func_sub,
                  "in_names": tuple(in_names), "n_vars": len(var_list),
                  "max_iterations": int(max_iterations),
                  "num_outputs": n_total},
                 AttrScope.current().get(None))
    entries = [(node, i) for i in range(n_total)]
    out_syms = [Symbol([e]) for e in entries[:len(out_list)]]
    var_syms = [Symbol([e]) for e in entries[len(out_list):]]
    return (out_syms[0] if single_out else out_syms, var_syms)


def cond(pred: Callable, then_func: Callable, else_func: Callable,
         inputs=None, name=None):
    """Both branches traced, the one ``pred`` picks run. ``pred`` and the
    branches are callables over ``inputs`` (Symbols)."""
    in_list, _ = _as_list(inputs if inputs is not None else [])
    ivars = [Variable(_fresh("cond_in")) for _ in in_list]
    p_sym = pred(*ivars) if callable(pred) else pred
    t_out = then_func(*ivars)
    e_out = else_func(*ivars)
    t_list, single_out = _as_list(t_out)
    e_list, _ = _as_list(e_out)
    if len(t_list) != len(e_list):
        raise MXNetError("cond branches must return the same number of "
                         "outputs")
    pred_sub = Group([p_sym] if isinstance(p_sym, Symbol) else [p_sym])
    then_sub = Group(t_list)
    else_sub = Group(e_list)

    bound = {v.name for v in ivars}
    free = _free_var_entries([pred_sub, then_sub, else_sub], bound)
    in_names = [v.name for v in ivars] + [n.name for n, _ in free]
    from ..attribute import AttrScope
    node = _Node("_cond", name or _auto_name("_cond"),
                 _entries(in_list) + free,
                 {"__pred__": pred_sub, "__then__": then_sub,
                  "__else__": else_sub, "in_names": tuple(in_names),
                  "num_outputs": len(t_list)},
                 AttrScope.current().get(None))
    out_syms = [Symbol([(node, i)]) for i in range(len(t_list))]
    return out_syms[0] if single_out else out_syms
