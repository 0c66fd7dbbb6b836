"""Symbol: MXNet's symbolic graph.

Counterpart of ``mxnet_tpu/symbol/symbol.py``. A Symbol is a list of
output entries over a DAG of :class:`_Node`s; a node names a registered op
of :mod:`mxnet_tpu_torch.ops.registry` with its parameters, or is a
variable. What each part maps to here:

- composition, arithmetic, ``list_*``, ``get_internals``/``get_children``
  and the attribute calls are the JAX package's, line for line;
- ``tojson``/``load_json``/``save``/``load`` write and read the same JSON
  (each parameter ``repr``'d, read back as a Python literal), so that a
  graph file crosses between the packages both ways;
- shape inference (:func:`_infer_all_shapes`) runs each op on
  ``device="meta"`` tensors: no values, no FLOPs, the role
  ``jax.eval_shape`` has in the JAX package. The ops that cannot run
  there (an index input, a kernel wrapper, a loop whose trip count the
  data decides) have a rule of their own in :data:`SHAPE_RULES`.
  Contradictory shapes raise under ``strict``. The auto-created
  parameters' shapes come from :func:`_solve_param_shapes`, and dtypes
  from :func:`_infer_all_types`, both the JAX package's rules;
- :func:`eval_graph` runs the graph op by op on torch tensors; the
  :class:`~mxnet_tpu_torch.executor.Executor` records it with autograd
  and differentiates the run it recorded.
"""
from __future__ import annotations

import ast
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ops.registry import OpInfo, add_call_params, get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "SHAPE_RULES"]


def _auto_name(op_name: str) -> str:
    """An op's name from the active NameManager (``fullyconnected0``)."""
    from ..name import NameManager
    base = op_name.lower().lstrip("_")
    return NameManager.current().get(None, base)


def aux_updates_for(info: OpInfo, params) -> Dict[int, int]:
    """``{output index: input index}`` of the aux states ``info`` updates
    under ``params`` (a dict, or a callable of the params giving one)."""
    au = info.aux_updates
    if callable(au):
        au = au(params or {})
    return au or {}


class _Node:
    """A graph node: an op with its parameters and input entries, or a
    variable (``op`` None)."""

    __slots__ = ("op", "name", "inputs", "params", "attrs", "_n_out")

    def __init__(self, op: Optional[str], name: str,
                 inputs: List[Tuple["_Node", int]], params: dict,
                 attrs: Optional[dict] = None):
        self.op = op
        self.name = name
        self.inputs = inputs
        self.params = params
        self.attrs = attrs or {}
        if op is None:
            self._n_out = 1
        else:
            n_out = get_op(op).n_out
            if n_out == -1:
                n_out = int(params.get("num_outputs", 1))
            self._n_out = n_out

    @property
    def is_variable(self):
        return self.op is None

    @property
    def info(self) -> Optional[OpInfo]:
        return get_op(self.op) if self.op else None


class Symbol:
    """A set of output entries over the node DAG."""

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = list(outputs)

    # -- introspection ------------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _topo_nodes(self) -> List[_Node]:
        seen = set()
        order: List[_Node] = []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._outputs:
            visit(node)
        return order

    def list_arguments(self) -> List[str]:
        """Variable names in topological order, aux states left out."""
        aux = set(self.list_auxiliary_states())
        return [n.name for n in self._topo_nodes()
                if n.is_variable and n.name not in aux]

    def list_auxiliary_states(self) -> List[str]:
        """The variables an op takes at an aux position (BatchNorm's moving
        statistics)."""
        aux: List[str] = []
        for n in self._topo_nodes():
            if n.op is None:
                continue
            positions = set(aux_updates_for(n.info, n.params).values())
            for pos, (inp, _) in enumerate(n.inputs):
                if pos in positions and inp.is_variable \
                        and inp.name not in aux:
                    aux.append(inp.name)
        return aux

    def list_outputs(self) -> List[str]:
        return [f"{node.name}_output" if idx == 0
                else f"{node.name}_output{idx}"
                for node, idx in self._outputs]

    def list_inputs(self):
        return [n.name for n in self._topo_nodes() if n.is_variable]

    def get_internals(self) -> "Symbol":
        return Symbol([(n, i) for n in self._topo_nodes()
                       for i in range(n._n_out)])

    def get_children(self) -> Optional["Symbol"]:
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def __getitem__(self, index):
        if isinstance(index, str):
            for i, name in enumerate(self.list_outputs()):
                if name == index or name.rsplit("_", 1)[0] == index:
                    return Symbol([self._outputs[i]])
            raise MXNetError(f"no output named {index}")
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    @property
    def num_outputs(self):
        return len(self._outputs)

    def __repr__(self):
        return f"<Symbol {self.name or 'group'}>"

    # -- attributes -------------------------------------------------------
    def attr(self, key):
        return self._outputs[0][0].attrs.get(key)

    def attr_dict(self):
        return {n.name: dict(n.attrs) for n in self._topo_nodes() if n.attrs}

    def _set_attr(self, **kwargs):
        self._outputs[0][0].attrs.update(kwargs)

    # -- composition and arithmetic ---------------------------------------
    def _entry(self) -> Tuple[_Node, int]:
        if len(self._outputs) != 1:
            raise MXNetError("operation on grouped symbol is not supported")
        return self._outputs[0]

    def __call__(self, *args, **kwargs):
        raise MXNetError("symbol composition via __call__ is not supported; "
                         "pass inputs at construction")

    def _binary(self, other, op_name, scalar_op=None, reverse=False):
        if isinstance(other, Symbol):
            ins = [other._entry(), self._entry()] if reverse \
                else [self._entry(), other._entry()]
            return _make_node(op_name, ins, {})
        return _make_node(scalar_op, [self._entry()],
                          {"scalar": float(other)})

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        if isinstance(o, Symbol):
            return o.__sub__(self)
        return _make_node("_rminus_scalar", [self._entry()],
                          {"scalar": float(o)})

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        if isinstance(o, Symbol):
            return o.__truediv__(self)
        return _make_node("_rdiv_scalar", [self._entry()],
                          {"scalar": float(o)})

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _make_node("_mul_scalar", [self._entry()], {"scalar": -1.0})

    def __eq__(self, o):
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def reshape(self, shape, **kw):
        return _make_node("reshape", [self._entry()], {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return _make_node("transpose", [self._entry()],
                          {"axes": tuple(axes) if axes else None})

    def sum(self, axis=None, keepdims=False):
        return _make_node("sum", [self._entry()],
                          {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _make_node("mean", [self._entry()],
                          {"axis": axis, "keepdims": keepdims})

    def flatten(self):
        return _make_node("Flatten", [self._entry()], {})

    def astype(self, dtype):
        return _make_node("cast", [self._entry()], {"dtype": str(dtype)})

    def slice_axis(self, axis, begin, end):
        return _make_node("slice_axis", [self._entry()],
                          {"axis": axis, "begin": begin, "end": end})

    # -- shape and type inference -----------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)``; contradictory input
        shapes raise, undetermined entries are None."""
        return self._infer_shape_impl(False, *args, _strict=True, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, _strict=False, **kwargs):
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known: Dict[str, tuple] = {}
        for name, shape in zip(arg_names, args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        shapes = _infer_all_shapes(self, known, strict=_strict)
        return ([shapes.get(n) for n in arg_names],
                [shapes.get(("__out__", i))
                 for i in range(len(self._outputs))],
                [shapes.get(n) for n in aux_names])

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as numpy dtypes: an
        unknown parameter variable takes its node's carrier dtype, an op
        with a ``dtype`` parameter sets its own output's."""
        arg_names = self.list_arguments()
        known: Dict[str, object] = {}
        for name, t in zip(arg_names, args):
            if t is not None:
                known[name] = onp.dtype(t)
        known.update({k: onp.dtype(v) for k, v in kwargs.items()})
        types = _infer_all_types(self, known)
        f32 = onp.dtype(onp.float32)
        out_types = [types.get(node.name, f32) if node.is_variable
                     else types.get((id(node), oi), f32)
                     for node, oi in self._outputs]
        return ([types.get(n, f32) for n in arg_names], out_types,
                [types.get(n, f32) for n in self.list_auxiliary_states()])

    # -- binding ------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """An :class:`~mxnet_tpu_torch.executor.Executor` with zero arrays
        of the inferred shapes: each argument in ``type_dict``'s dtype
        (else float32), aux states and gradients in float32, as the JAX
        package allocates them."""
        from ..executor import Executor
        from ..ndarray.ndarray import zeros as nd_zeros
        ctx = ctx or current_context()
        arg_names = self.list_arguments()
        shapes = _infer_all_shapes(
            self, {k: tuple(v) for k, v in kwargs.items()})
        type_dict = type_dict or {}
        args = {}
        for n in arg_names:
            if shapes.get(n) is None:
                raise MXNetError(f"cannot infer shape for argument {n}; "
                                 f"pass it to simple_bind")
            args[n] = nd_zeros(shapes[n], ctx,
                               dtype=onp.dtype(type_dict.get(n, "float32"))
                               .name)
        auxs = {n: nd_zeros(shapes[n], ctx)
                for n in self.list_auxiliary_states()}
        grad_reqs = _grad_reqs(grad_req, arg_names)
        grads = {n: nd_zeros(shapes[n], ctx) for n in arg_names
                 if grad_reqs[n] != "null"}
        return Executor(self, ctx, args, grads, grad_reqs, auxs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over the given arrays (lists in argument order, or
        dicts); a ``grad_req`` string applies to the arguments that have
        a gradient array."""
        from ..executor import Executor
        from ..ndarray.ndarray import zeros as nd_zeros
        ctx = ctx or current_context()
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        args_grad = args_grad or {}
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        aux_states = aux_states or {}
        if isinstance(grad_req, str):
            grad_reqs = {n: (grad_req if n in args_grad or grad_req == "null"
                             else "null") for n in arg_names}
            if grad_req != "null" and not args_grad:
                grad_reqs = {n: "null" for n in arg_names}
        else:
            grad_reqs = _grad_reqs(grad_req, arg_names)
        if aux_names and not aux_states:
            shapes = _infer_all_shapes(
                self, {n: a.shape for n, a in args.items()})
            aux_states = {n: nd_zeros(shapes[n], ctx) for n in aux_names}
        return Executor(self, ctx, dict(args), dict(args_grad), grad_reqs,
                        dict(aux_states))

    def eval(self, ctx=None, **kwargs):
        """The outputs for the given arrays (an inference forward)."""
        ex = self.bind(ctx or current_context(), kwargs, grad_req="null")
        return ex.forward()

    # -- serialization --------------------------------------------------------
    def tojson(self) -> str:
        nodes = self._topo_nodes()
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": n.op or "null",
            "name": n.name,
            "attrs": {k: repr(v) for k, v in n.params.items()}
            if n.params else {},
            "inputs": [[idx[id(i)], oi, 0] for i, oi in n.inputs],
        } for n in nodes]
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[idx[id(n)], oi, 0] for n, oi in self._outputs],
            "attrs": {"mxnet_version": ["int", 10600]},
        }, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())


def _grad_reqs(grad_req, arg_names) -> Dict[str, str]:
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, dict):
        return {n: grad_req.get(n, "null") for n in arg_names}
    return dict(zip(arg_names, grad_req))


def _parse_attr_value(v: str):
    """A parameter as written by ``repr``: the literal it spells, else the
    string itself (as the JAX package reads it)."""
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError, TypeError, MemoryError,
            RecursionError):
        return v


def load_json(json_str: str) -> Symbol:
    data = json.loads(json_str)
    nodes: List[_Node] = []
    for jn in data["nodes"]:
        params = {k: _parse_attr_value(v)
                  for k, v in (jn.get("attrs") or {}).items()}
        inputs = [(nodes[i], oi) for i, oi, *_ in jn["inputs"]]
        op = None if jn["op"] == "null" else jn["op"]
        nodes.append(_Node(op, jn["name"], inputs, params))
    return Symbol([(nodes[i], oi) for i, oi, *_ in data["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


# -- construction -------------------------------------------------------------

def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """A variable: an argument (or aux state) of the graph, by name."""
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update(kwargs)
    from ..attribute import AttrScope
    attrs = AttrScope.current().get(attrs)
    return Symbol([(_Node(None, name, [], {}, attrs), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries = []
    for s in symbols:
        entries.extend(s._outputs)
    return Symbol(entries)


def zeros(shape, dtype="float32", **kw):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return _make_node("_sym_zeros", [], {"shape": shape, "dtype": dtype})


def ones(shape, dtype="float32", **kw):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return _make_node("_sym_ones", [], {"shape": shape, "dtype": dtype})


def _make_node(op_name: str, inputs: List[Tuple[_Node, int]], params: dict,
               name: Optional[str] = None, attrs: Optional[dict] = None
               ) -> Symbol:
    """A node of ``op_name``; the op's declared inputs that are not given
    become variables named ``<node>_<input>`` (``fc1_weight``)."""
    info = get_op(op_name)
    name = name or _auto_name(op_name)
    from ..attribute import AttrScope
    attrs = AttrScope.current().get(attrs)
    expected = info.inputs_for(params)
    if expected:
        if params.get("no_bias") and "bias" in expected:
            expected.remove("bias")
        while len(inputs) < len(expected):
            vname = f"{name}_{expected[len(inputs)]}"
            inputs = list(inputs) + [(_Node(None, vname, [], {}), 0)]
    node = _Node(op_name, name, list(inputs), params, attrs)
    vis = info.visible_outputs
    if callable(vis):
        vis = vis(params)
    return Symbol([(node, i) for i in range(node._n_out if vis is None
                                            else vis)])


def make_symbol_function(op_name: str) -> Callable:
    """``sym.<op_name>``: Symbols in (positionally, in lists, or by input
    name), one Symbol out; other arguments are the op's parameters."""
    info = get_op(op_name)

    def sym_fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        inputs: List[Tuple[_Node, int]] = []
        params = {}
        param_names = info.param_names
        pi = 0
        for a in args:
            if isinstance(a, Symbol):
                inputs.append(a._entry())
            elif isinstance(a, (list, tuple)) and a \
                    and isinstance(a[0], Symbol):
                inputs.extend(x._entry() for x in a)
            else:
                while pi < len(param_names) and param_names[pi] in kwargs:
                    pi += 1
                if pi < len(param_names):
                    params[param_names[pi]] = a
                    pi += 1
        kw_syms = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        params.update({k: v for k, v in kwargs.items()
                       if not isinstance(v, Symbol)})
        if kw_syms:
            names = info.inputs_for(params)
            inputs.extend(kw_syms[k]._entry() for k in names or kw_syms
                          if k in kw_syms)
            if names:
                inputs.extend(v._entry() for k, v in kw_syms.items()
                              if k not in names)
        return _make_node(op_name, inputs, params, name=name,
                          attrs=dict(attr) if attr else None)

    sym_fn.__name__ = op_name
    sym_fn.__doc__ = info.fn.__doc__
    return sym_fn


# -- evaluation ---------------------------------------------------------------

def _call_params(node: _Node, training: bool, device) -> dict:
    """The keyword arguments of a node's op call: its parameters, the
    training flag and the device's generator where the op takes them."""
    params = dict(node.params)
    params.pop("num_args", None)
    return add_call_params(node.info, params, training, device)


def eval_graph(symbol: Symbol, value_map: Dict[str, torch.Tensor],
               training: bool, device=None):
    """Run the graph op by op on the tensors of ``value_map`` (by variable
    name); returns ``(outputs, {aux name: new value})``. Autograd records
    the run where the caller enables it. An op without tensor inputs
    creates its result on ``device`` (default: the first value's)."""
    if device is None:
        device = next(iter(value_map.values())).device if value_map \
            else current_context().torch_device
    device = torch.device(device)
    values: Dict[Tuple[int, int], torch.Tensor] = {}
    aux_updates: Dict[str, torch.Tensor] = {}
    with Context(device):
        for node in symbol._topo_nodes():
            if node.is_variable:
                if node.name not in value_map:
                    raise MXNetError(f"unbound variable {node.name}")
                values[(id(node), 0)] = value_map[node.name]
                continue
            info = node.info
            ins = [values[(id(i), oi)] for i, oi in node.inputs]
            out = info.fn(*ins, **_call_params(node, training, device))
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            for i, o in enumerate(outs):
                values[(id(node), i)] = o
            for out_idx, in_idx in aux_updates_for(info,
                                                   node.params).items():
                src, _ = node.inputs[in_idx]
                if src.is_variable:
                    aux_updates[src.name] = outs[out_idx]
    return [values[(id(n), oi)] for n, oi in symbol._outputs], aux_updates


def _infer_all_types(symbol: Symbol, known: Dict[str, object]
                     ) -> Dict[object, object]:
    """Dtype propagation, the JAX package's rule: a node's output takes its
    ``dtype`` parameter where it has one, else the result type of its
    known inputs; an input variable of unknown type takes that carrier
    type."""
    types: Dict[object, object] = dict(known)
    for node in symbol._topo_nodes():
        if node.is_variable:
            continue
        in_types = [types.get(inode.name) if inode.is_variable
                    else types.get((id(inode), oi))
                    for inode, oi in node.inputs]
        ks = [t for t in in_types if t is not None]
        carrier = onp.result_type(*ks) if ks else onp.dtype(onp.float32)
        for (inode, _), t in zip(node.inputs, in_types):
            if t is None and inode.is_variable:
                types[inode.name] = carrier
        dt = node.params.get("dtype")
        out_t = onp.dtype(dt) if dt is not None else carrier
        for i in range(node._n_out if node._n_out and node._n_out > 0
                       else 1):
            types[(id(node), i)] = out_t
    return types


# -- shape rules of the ops that cannot run on meta tensors -------------------

def _attention_shapes(node, in_shapes):
    q, k, v = in_shapes
    if len(q) != 4 or len(k) != 4 or len(v) != 4 or q[:2] != k[:2] \
            or k[:3] != v[:3] or q[3] != k[3]:
        raise MXNetError(f"_fused_attention: q {q}, k {k}, v {v} are not "
                         f"(B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, Dv)")
    return [tuple(q[:3]) + (v[3],)]


def _take_rows_shapes(node, in_shapes):
    data, weight = in_shapes
    if len(weight) != 2:
        raise MXNetError(f"Embedding: weight {weight} is not 2-D")
    out_dim = node.params.get("output_dim")
    if out_dim and int(out_dim) != weight[1]:
        raise MXNetError(f"Embedding: output_dim {out_dim}, weight {weight}")
    return [tuple(data) + (weight[1],)]


def _sub_shapes(sub, known):
    shapes = _infer_all_shapes(sub, known, strict=True)
    return [shapes[("__out__", i)] for i in range(len(sub._outputs))]


def _foreach_shapes(node, in_shapes):
    p = node.params
    names = list(p["in_names"])
    nd, ns = int(p["n_data"]), int(p["n_states"])
    known = {n: tuple(s[1:]) for n, s in zip(names[:nd], in_shapes[:nd])}
    known.update(zip(names[nd:], in_shapes[nd:]))
    outs = _sub_shapes(p["__subgraph__"], known)
    steps = in_shapes[0][0]
    n_loop = len(outs) - ns
    return [(steps,) + tuple(s) for s in outs[:n_loop]] + outs[n_loop:]


def _while_loop_shapes(node, in_shapes):
    p = node.params
    outs = _sub_shapes(p["__func__"], dict(zip(p["in_names"], in_shapes)))
    n_out = len(outs) - int(p["n_vars"])
    return [(int(p["max_iterations"]),) + tuple(s)
            for s in outs[:n_out]] + outs[n_out:]


def _cond_shapes(node, in_shapes):
    p = node.params
    return _sub_shapes(p["__then__"], dict(zip(p["in_names"], in_shapes)))


def _rnn_shapes(node, in_shapes):
    p = node.params
    T, N, _ = in_shapes[0]
    H = int(p["state_size"])
    ndir = 2 if _bool(p.get("bidirectional", False)) else 1
    state = (int(p.get("num_layers", 1)) * ndir, N, H)
    return [(T, N, ndir * H), state, state]


def _ctc_shapes(node, in_shapes):
    return [(in_shapes[0][1],)]


def _bool(v) -> bool:
    from ..ops.registry import parse_bool_param
    return parse_bool_param(v)


# op -> rule(node, input shapes) -> output shapes, for the ops whose
# result shape cannot come from a run on meta tensors: an index input
# (Embedding), a kernel wrapper (_fused_attention), a loop or branch the
# data decides (the control-flow nodes), a library call with no meta
# kernel (RNN, CTCLoss)
SHAPE_RULES: Dict[str, Callable] = {
    "RNN": _rnn_shapes,
    "CTCLoss": _ctc_shapes,
    "_fused_attention": _attention_shapes,
    "Embedding": _take_rows_shapes,
    "_contrib_SparseEmbedding": _take_rows_shapes,
    "_foreach": _foreach_shapes,
    "_while_loop": _while_loop_shapes,
    "_cond": _cond_shapes,
}

_META = torch.device("meta")


def _meta_shapes(node, in_shapes):
    """Output shapes from a run of the op on meta tensors (an op without
    inputs runs on the CPU: it only creates)."""
    info = node.info
    if not in_shapes:
        with Context("cpu"), torch.no_grad():
            out = info.fn(**_call_params(node, False, torch.device("cpu")))
    else:
        specs = [torch.empty(s, dtype=torch.float32, device=_META)
                 for s in in_shapes]
        with torch.no_grad():
            out = info.fn(*specs, **_call_params(node, False, _META))
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [tuple(o.shape) for o in outs]


def _infer_all_shapes(symbol: Symbol, known: Dict[str, tuple],
                      strict: bool = False) -> Dict[object, tuple]:
    """Shapes of every variable and entry reachable from ``known``: an
    auto-created parameter's from its op's parameters
    (:func:`_solve_param_shapes`), an op's outputs from :data:`SHAPE_RULES`
    or a meta run. With ``strict``, an op whose inputs are all known but
    disagree raises."""
    shapes: Dict[object, tuple] = dict(known)
    nodes = symbol._topo_nodes()
    for n in nodes:
        if n.is_variable and n.name not in shapes:
            hint = n.attrs.get("__shape__")
            if hint:
                shapes[n.name] = tuple(hint)

    def entry_shape(entry):
        node, oi = entry
        if node.is_variable:
            return shapes.get(node.name)
        return shapes.get((id(node), oi))

    for node in nodes:
        if node.is_variable:
            continue
        in_shapes = [entry_shape(e) for e in node.inputs]
        _solve_param_shapes(node, in_shapes, shapes)
        in_shapes = [entry_shape(e) for e in node.inputs]
        if any(s is None for s in in_shapes):
            continue
        rule = SHAPE_RULES.get(node.op, _meta_shapes)
        try:
            outs = rule(node, in_shapes)
        except Exception as e:
            if strict:
                raise MXNetError(
                    f"shape inference failed at op '{node.op}' "
                    f"(node '{node.name}') with input shapes "
                    f"{in_shapes}: {e}") from e
            continue
        for i, s in enumerate(outs):
            shapes[(id(node), i)] = tuple(s)
    for i, e in enumerate(symbol._outputs):
        shapes[("__out__", i)] = entry_shape(e)
    return shapes


def _solve_param_shapes(node: _Node, in_shapes, shapes):
    """Shapes of an op's auto-created weight, bias, gamma, ... variables
    from its data shape and parameters (the JAX package's rules)."""
    op = node.op
    p = node.params
    data_shape = in_shapes[0] if in_shapes else None
    if data_shape is None:
        return

    def setvar(pos, shape):
        if pos < len(node.inputs):
            var_node, _ = node.inputs[pos]
            if var_node.is_variable and shapes.get(var_node.name) is None:
                shapes[var_node.name] = tuple(int(x) for x in shape)

    if op == "FullyConnected":
        nh = int(p.get("num_hidden"))
        flat_in = data_shape[1] if len(data_shape) == 2 or not p.get(
            "flatten", True) else int(onp.prod(data_shape[1:]))
        if p.get("flatten", True) is False:
            flat_in = data_shape[-1]
        setvar(1, (nh, flat_in))
        setvar(2, (nh,))
    elif op in ("Convolution", "Convolution_v1"):
        nf = int(p.get("num_filter"))
        kern = tuple(p.get("kernel"))
        ng = int(p.get("num_group", 1))
        setvar(1, (nf, data_shape[1] // ng) + kern)
        setvar(2, (nf,))
    elif op == "Deconvolution":
        nf = int(p.get("num_filter"))
        kern = tuple(p.get("kernel"))
        ng = int(p.get("num_group", 1))
        setvar(1, (data_shape[1], nf // ng) + kern)
        setvar(2, (nf,))
    elif op in ("BatchNorm", "BatchNorm_v1", "_contrib_SyncBatchNorm"):
        c = data_shape[int(p.get("axis", 1))]
        for pos in (1, 2, 3, 4):
            setvar(pos, (c,))
    elif op == "LayerNorm":
        c = data_shape[int(p.get("axis", -1))]
        setvar(1, (c,))
        setvar(2, (c,))
    elif op in ("GroupNorm", "InstanceNorm"):
        setvar(1, (data_shape[1],))
        setvar(2, (data_shape[1],))
    elif op in ("SoftmaxOutput", "Softmax"):
        if p.get("multi_output"):
            setvar(1, (data_shape[0],) + tuple(data_shape[2:]))
        else:
            setvar(1, data_shape[:-1])
    elif op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                "MAERegressionOutput", "SVMOutput"):
        setvar(1, data_shape)
    elif op == "Embedding":
        setvar(1, (int(p.get("input_dim")), int(p.get("output_dim"))))
    elif op == "RNN" and len(data_shape) == 3:
        from ..ops.rnn import rnn_param_size
        H = int(p["state_size"])
        layers = int(p.get("num_layers", 1))
        bidir = _bool(p.get("bidirectional", False))
        mode = p.get("mode", "lstm")
        setvar(1, (rnn_param_size(mode, layers, data_shape[2], H, bidir),))
        state = (layers * (2 if bidir else 1), data_shape[1], H)
        setvar(2, state)
        if mode == "lstm":
            setvar(3, state)
    elif op == "LeakyReLU" and p.get("act_type") == "prelu":
        setvar(1, (data_shape[1],))
