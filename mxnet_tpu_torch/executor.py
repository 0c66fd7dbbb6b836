"""Executor: a Symbol bound to arrays.

Counterpart of ``mxnet_tpu/executor.py``, with the JAX package's surface
(``forward``, ``backward``, ``forward_backward``, ``grad_req``
write/add/null, ``out_grads``, ``arg_dict``/``grad_dict``/``aux_dict``/
``output_dict``, ``copy_params_from``, ``reshape``,
``set_monitor_callback``, ``compile_signature``, ``debug_str``). It runs
the graph op by op on torch tensors
(:func:`~mxnet_tpu_torch.symbol.symbol.eval_graph`):

- ``forward(is_train=True)`` records the run with autograd, the
  arguments whose ``grad_req`` is not ``"null"`` as its leaves, and
  writes the aux states it updates (BatchNorm's moving statistics) once;
- ``backward`` differentiates that recorded run with
  ``torch.autograd.grad``, so a Dropout's gradient is taken under the mask
  that made the outputs. Only when no training forward came first does it
  run one itself. The JAX package's ``backward`` runs the training forward
  again and applies its aux updates a second time; the port does not
  (ROADMAP, "Differences kept on purpose");
- a head gradient defaults to ones; a loss layer (``SoftmaxOutput``)
  ignores its head gradient;
- a gradient is written by rebinding the array (``write``) or adding to it
  (``add``), so it keeps the gradient's dtype, as in the JAX package.

``MXNET_EXEC_BULK_EXEC_TRAIN`` / ``_INFERENCE`` are accepted and change
nothing: the graph runs op by op either way. One captured program per
input signature is the fused step's (:class:`~mxnet_tpu_torch.step.
StepFunction`), whose symbol mode runs :func:`graph_forward_backward`:
the training forward and its backward in one call, sharing
:meth:`Executor.backward`'s gradient rule. ``MXNET_GRAPH_OPT`` > 0
raises: the graph optimizer is ROADMAP Queue A item 5, and
:attr:`opt_report` is None.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch

from .base import MXNetError
from .context import Context
from .ndarray.ndarray import NDArray, _wrap
from .symbol.symbol import Symbol, _infer_all_shapes, eval_graph

__all__ = ["Executor", "graph_forward_backward"]


def _tensor_of(v, like: torch.Tensor) -> torch.Tensor:
    t = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
    return t.detach().to(device=like.device, dtype=like.dtype)


def _vjp(outs, leaves, ograds):
    """Gradients of ``outs`` with respect to ``leaves``: each output's head
    gradient from ``ograds`` (ones where None; outputs that take no
    gradient left out), zeros for a leaf the outputs do not reach."""
    heads, cots = [], []
    for o, og in zip(outs, ograds):
        if not o.requires_grad:
            continue
        heads.append(o)
        cots.append(torch.ones_like(o) if og is None else _tensor_of(og, o))
    grads = torch.autograd.grad(heads, leaves, cots, allow_unused=True) \
        if heads else [None] * len(leaves)
    return [torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, grads)]


def graph_forward_backward(symbol: Symbol, grad_names: List[str]):
    """The training forward of ``symbol`` and its backward in one call::

        fb(arg_vals, aux_vals, ograds=None, device=None)
            -> (outputs, aux_updates, {name: gradient})

    over tensors by name, gradients taken with respect to ``grad_names``
    by ``torch.autograd.grad`` (head gradients ``ograds``, ones by
    default). Counterpart of ``mxnet_tpu/executor.py::
    graph_forward_backward``, shared with :class:`Executor`'s backward
    (:func:`_vjp`); the fused step's symbol mode runs it."""
    names = list(grad_names)

    def fb(arg_vals, aux_vals, ograds=None, device=None):
        leaves = {n: arg_vals[n].detach().requires_grad_(True)
                  for n in names}
        vm = dict(arg_vals)
        vm.update(leaves)
        vm.update(aux_vals)
        with torch.enable_grad():
            outs, aux_updates = eval_graph(symbol, vm, True, device)
        grads = _vjp(outs, [leaves[n] for n in names],
                     ograds if ograds is not None else [None] * len(outs))
        return outs, aux_updates, dict(zip(names, grads))

    return fb


class Executor:
    """A bound Symbol (see the module docstring)."""

    def __init__(self, symbol: Symbol, ctx: Context, args: Dict[str, NDArray],
                 args_grad: Dict[str, NDArray], grad_reqs: Dict[str, str],
                 aux_states: Dict[str, NDArray]):
        if int(os.environ.get("MXNET_GRAPH_OPT", "0") or 0) > 0:
            raise NotImplementedError(
                "MXNET_GRAPH_OPT > 0: the graph optimizer is not ported "
                "yet (ROADMAP Queue A item 5)")
        self._symbol = symbol
        self._ctx = ctx
        self.arg_dict = args
        self.grad_dict = args_grad
        self.grad_req = grad_reqs
        self.aux_dict = aux_states
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.outputs: List[NDArray] = []
        self._monitor_callback = None
        self._monitor_all = False
        self._recorded = None  # (leaves, outputs) of the last training run

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def opt_report(self):
        """The graph optimizer's report: None (no optimizer yet)."""
        return None

    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, array)`` on every output after each forward."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    def collect_monitor_stats(self, helper):
        for name, out in zip(self._symbol.list_outputs(), self.outputs):
            helper(name, out)

    # -- execution ------------------------------------------------------------
    @property
    def _device(self) -> torch.device:
        return self._ctx.torch_device

    def _value_map(self, leaves=None) -> Dict[str, torch.Tensor]:
        vm = {n: self.arg_dict[n]._data.detach() for n in self._arg_names}
        vm.update({n: self.aux_dict[n]._data.detach()
                   for n in self._aux_names})
        vm.update(leaves or {})
        return vm

    def _set_args(self, kwargs):
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k]._data = _tensor_of(v, self.arg_dict[k]._data)

    def _run(self, is_train: bool):
        """One run of the graph; a training run is recorded for
        :meth:`backward`. Returns ``(outputs, aux updates)``."""
        self._recorded = None
        if not is_train:
            with torch.no_grad():
                return eval_graph(self._symbol, self._value_map(), False,
                                  self._device)
        # an integer argument (token ids, labels) takes no gradient
        leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                  for n in self._arg_names
                  if self.grad_req.get(n, "null") != "null"
                  and self.arg_dict[n]._data.is_floating_point()}
        with torch.enable_grad():
            outs, aux = eval_graph(self._symbol, self._value_map(leaves),
                                   True, self._device)
        if leaves:
            self._recorded = (leaves, outs)
        return outs, aux

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays (``kwargs`` set arguments
        first); a training run updates the aux states, once."""
        self._set_args(kwargs)
        outs, aux_updates = self._run(is_train)
        for name, val in aux_updates.items():
            self.aux_dict[name]._data = val.detach()
        self.outputs = [_wrap(o.detach()) for o in outs]
        if self._monitor_callback is not None:
            for name, out in zip(self._symbol.list_outputs(), self.outputs):
                self._monitor_callback(name, out)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward into ``grad_dict`` (see
        the module docstring); ``out_grads`` are the head gradients."""
        if self._recorded is None:
            self.forward(is_train=True)
        if self._recorded is None:
            return  # no argument takes a gradient
        leaves, outs = self._recorded
        self._recorded = None
        if out_grads is None:
            ograds = [None] * len(outs)
        elif isinstance(out_grads, (NDArray, torch.Tensor)):
            ograds = [out_grads]
        else:
            ograds = list(out_grads)
        names = list(leaves)
        grads = _vjp(outs, [leaves[n] for n in names], ograds)
        for name, g in zip(names, grads):
            tgt = self.grad_dict.get(name)
            if tgt is None:
                continue
            if self.grad_req.get(name) == "add":
                tgt._data = tgt._data + g
            else:
                tgt._data = g

    def forward_backward(self, out_grads=None, is_train=True, **kwargs):
        """A training forward, then :meth:`backward`; the outputs."""
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self.outputs

    def compile_signature(self, is_train: bool = False):
        """Run the graph once on the bound arrays and keep nothing: no
        outputs, no aux update, no draw from a generator (their states
        are put back). Returns self."""
        from .random import generator
        gen = generator(self._device)
        state = gen.get_state()
        try:
            with torch.no_grad():
                eval_graph(self._symbol, self._value_map(), is_train,
                           self._device)
        finally:
            gen.set_state(state)
        return self

    # -- the rest of the surface ----------------------------------------------
    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy arrays into the bound arguments (in their dtype) and aux
        states; a name the graph lacks raises unless
        ``allow_extra_params``."""
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name]._data = _tensor_of(
                    arr, self.arg_dict[name]._data).clone()
            elif not allow_extra_params:
                raise MXNetError(f"Found name '{name}' not in arguments")
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name]._data = _tensor_of(
                    arr, self.aux_dict[name]._data).clone()
            elif not allow_extra_params:
                raise MXNetError(f"Found name '{name}' not in aux states")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new Executor for the shapes in ``kwargs``: an array whose
        shape is unchanged is shared, the others are new zeros."""
        from .ndarray.ndarray import zeros as nd_zeros
        inferred = _infer_all_shapes(self._symbol, {
            k: tuple(v) for k, v in kwargs.items()})
        new_args = {}
        for n in self._arg_names:
            old = self.arg_dict[n]
            s = inferred.get(n) or tuple(kwargs.get(n, old.shape))
            new_args[n] = old if tuple(old.shape) == tuple(s) \
                else nd_zeros(s, self._ctx, dtype=str(old.dtype))
        new_auxs = {}
        for n in self._aux_names:
            old = self.aux_dict[n]
            s = inferred.get(n) or old.shape
            new_auxs[n] = old if tuple(old.shape) == tuple(s) \
                else nd_zeros(s, self._ctx)
        grads = {n: nd_zeros(new_args[n].shape, self._ctx)
                 for n in self.grad_dict}
        return Executor(self._symbol, self._ctx, new_args, grads,
                        dict(self.grad_req), new_auxs)

    def debug_str(self):
        return self._symbol.tojson()
