"""StepFunction: one captured CUDA graph per training-step signature.

Counterpart of ``mxnet_tpu/step/stepfn.py``, whose step is one donated
``jax.jit`` program. The reference-shaped loop runs forward, backward,
gradient exchange and the optimizer as separate dispatch streams, one
optimizer update per parameter; ``StepFunction`` runs all four as one
function of the step's inputs:

- forward and backward: the block's training forward over its own
  parameters (``gluon.block.functional_call``) and the loss, gradients by
  ``torch.autograd.grad`` with respect to the trainable parameters,
  seeded with ones as ``loss.backward()`` seeds them; or, for a Symbol,
  ``executor.graph_forward_backward``;
- gradient exchange: the identity on one device (the sharded and
  elastic steps wait for ROADMAP Queue A items 6 and 7);
- the optimizer: the multi-tensor ``Optimizer.fused_apply`` over every
  trainable parameter, its results copied into the parameters' and the
  states' own storage. The per-step scalars (lr, wd, Adam's bias
  correction) are computed on the host in float64 by ``fused_hyper``, as
  the eager loop computes them, and reach the update as device scalars
  that a host copy fills before each step, so a schedule never re-keys.

On CUDA the first step of a signature warms the function up on a side
stream (cuBLAS workspaces, the kernels' lazy build and attributes), puts
back everything the warm-up wrote (weights, optimizer states, BatchNorm's
running statistics, every generator the step draws from), and captures it
into one ``torch.cuda.CUDAGraph``; each step then copies the inputs and
the scalars into the graph's static buffers and replays it. The dropout
generators are registered with each graph, so every replay draws new
masks from the generator's current state, as the eager loop does. All
graphs of one StepFunction share one memory pool. A step that cannot be
captured raises ``MXNetError``; there is no eager fallback on CUDA. On
the CPU (tests) the same function runs eagerly, under the same cache keys,
miss counting and write-back.

The fused step is bit-equal to the eager ``record`` -> ``backward`` ->
``Trainer.step`` loop for the optimizers with a ``fused_apply``: the
same ATen calls run on the same values, no compiler re-fuses them
(``torch.compile`` is not used), and a device scalar of the weight's
dtype gives the same products as the Python float the eager loop passes.
(For a 16-bit weight without multi-precision the scalar is rounded to the
weight's dtype, as the JAX package's weakly typed scalars are.)

Programs are keyed by the inputs' shapes and dtypes, the parameters'
dtypes and storage (a ``Parameter.cast``, ``load_parameters`` to another
dtype or ``Trainer.load_states`` re-keys instead of replaying stale
addresses), the optimizer's ``fused_signature()`` and the device. Hits
and misses feed ``fused_step_cache_hits_total`` / ``_misses_total``;
each miss is recorded by the recompile auditor (kind ``fused_step``) and
its capture time by ``fused_step_compile_seconds``.

Not ported yet, each raising ``MXNetError`` that names its item: the
mxguard integrity taps and the replay recorder (item 7), the Monitor
surface and ``cost_analysis`` (item 8).
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.nn.parameter import UninitializedParameter
from torch import nn

from .. import optimizer as opt_mod
from .. import random as _random
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, _wrap
from ..optimizer import _state_write

__all__ = ["StepFunction"]

# eager runs of the step on a side stream before its capture
WARMUP_STEPS = 1


def _raw(a) -> torch.Tensor:
    if isinstance(a, NDArray):
        return a._data
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a))


def _grad_req(p) -> str:
    return getattr(p, "grad_req", "write") if p.requires_grad else "null"


def _leaves(state) -> List[torch.Tensor]:
    """The tensors of an optimizer state (None, a tensor or a tuple)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return [state]


def _scalar_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a parameter's device scalars: its own for fp32/fp64,
    fp32 for a 16-bit parameter (rounded to it by type promotion)."""
    return dtype if dtype in (torch.float32, torch.float64) \
        else torch.float32


class _Program:
    """One signature's program: the scalar buffers (by dtype) and the 0-d
    views the update reads; on CUDA also the static inputs, the graph and
    its loss output."""

    __slots__ = ("order", "buffers", "lrs", "wds", "inputs", "graph",
                 "loss")

    def __init__(self, dtypes, device):
        self.order: Dict[torch.dtype, List[int]] = {}
        for k, dt in enumerate(dtypes):
            self.order.setdefault(dt, []).append(k)
        self.buffers = {dt: torch.zeros(2 * len(ks), dtype=dt, device=device)
                        for dt, ks in self.order.items()}
        self.lrs: List[Optional[torch.Tensor]] = [None] * len(dtypes)
        self.wds: List[Optional[torch.Tensor]] = [None] * len(dtypes)
        for dt, ks in self.order.items():
            for j, k in enumerate(ks):
                self.lrs[k] = self.buffers[dt][j]
                self.wds[k] = self.buffers[dt][len(ks) + j]
        self.inputs = self.graph = self.loss = None

    def fill(self, lrs, wds) -> None:
        """Copy the host's scalars into the buffers: from pinned memory,
        asynchronously, on CUDA (the host allocator keeps the block until
        the copy has run)."""
        for dt, ks in self.order.items():
            host = torch.tensor([lrs[k] for k in ks] + [wds[k] for k in ks],
                                dtype=dt)
            buf = self.buffers[dt]
            if buf.is_cuda:
                buf.copy_(host.pin_memory(), non_blocking=True)
            else:
                buf.copy_(host)


def _release_generators(gens, states) -> None:
    """After an aborted capture every generator the graph registered still
    counts as capturing, and its next draw outside a graph raises ("Offset
    increment outside graph capture"). Each gets a fresh state object (the
    same ``torch.Generator``, so the layers that hold it keep it), set to
    its state before the warm-up."""
    for g, state in zip(gens, states):
        fresh = torch.Generator(device=g.device)
        fresh.set_state(state)
        g.graphsafe_set_state(fresh.graphsafe_get_state())


class StepFunction:
    """The fused whole training step of a Gluon block (or a Symbol).

    Block mode::

        trainer = gluon.Trainer(net.collect_params(), "sgd", {...})
        fused = trainer.fuse_step(net, loss_fn)   # or StepFunction(...)
        for x, y in batches:
            loss = fused.step(x, y)

    is the fused equivalent of::

        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss)
        trainer.step(x.shape[0])

    and bit-equal to it for every optimizer with a ``fused_apply`` (SGD,
    NAG, Adam, AdamW, RMSProp). Without a trainer, ``optimizer=`` and
    ``optimizer_params=`` make the step's own optimizer and Updater.

    Symbol mode::

        fused = StepFunction(loss_sym, arg_dict=args, aux_dict=auxs,
                             input_names=("data", "softmax_label"),
                             optimizer="sgd")

    runs the symbol through ``executor.graph_forward_backward``; its first
    output is what ``step`` returns, and each output takes a ones head
    gradient. The argument and aux NDArrays are updated in place.

    ``step`` returns the loss as an NDArray when ``x`` is one, else as a
    tensor (a copy, not the graph's buffer).
    """

    def __init__(self, net, loss_fn=None, trainer=None, optimizer="sgd",
                 optimizer_params=None, arg_dict=None, aux_dict=None,
                 input_names=("data", "softmax_label"), grad_names=None,
                 name=None):
        from ..symbol.symbol import Symbol
        self._net = net
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._symbol_mode = isinstance(net, Symbol)
        self._name = name or getattr(net, "name", None) \
            or type(net).__name__
        self._cache: Dict[tuple, _Program] = {}
        self._pool = None  # one CUDA graph memory pool for every program
        self._plist = None

        if trainer is not None:
            if optimizer_params or optimizer != "sgd":
                raise MXNetError("pass either trainer= or optimizer=/"
                                 "optimizer_params=, not both")
            self._own = None
        else:
            own = opt_mod.create(optimizer, **(optimizer_params or {}))
            self._own = (own, opt_mod.get_updater(own))
        opt = self._optimizer
        if opt.multi_precision:
            raise MXNetError("StepFunction does not support "
                             "multi_precision optimizers; use the eager "
                             "per-param path")
        if not opt.has_fused_apply:
            raise MXNetError(
                f"optimizer {type(opt).__name__} has no functional "
                "fused_apply — the fused step would downgrade to eager; "
                "implement fused_apply (see steplint) or use the eager "
                "Trainer loop")
        if self._symbol_mode:
            self._init_symbol(net, arg_dict or {}, aux_dict or {},
                              tuple(input_names), grad_names)

    # -- the optimizer (the trainer's, which load_states may replace) -----
    @property
    def _optimizer(self):
        if self._trainer is not None:
            return self._trainer._optimizer
        return self._own[0]

    @property
    def _updater(self):
        if self._trainer is not None:
            return self._trainer._updaters[0]
        return self._own[1]

    @property
    def _scale(self) -> float:
        return self._trainer._scale if self._trainer is not None else 1.0

    # -- parameter resolution ---------------------------------------------
    def _init_symbol(self, sym, arg_dict, aux_dict, input_names, grad_names):
        if int(os.environ.get("MXNET_GRAPH_OPT", "0") or 0) > 0:
            raise NotImplementedError(
                "MXNET_GRAPH_OPT > 0: the graph optimizer is not ported "
                "yet (ROADMAP Queue A item 5)")
        self._input_names = tuple(input_names)
        missing = [n for n in sym.list_arguments()
                   if n not in arg_dict and n not in self._input_names]
        if missing:
            raise MXNetError(f"symbol-mode StepFunction: arg_dict is "
                             f"missing {missing}")
        self._param_objs = dict(arg_dict)
        self._aux_objs = {n: aux_dict[n]
                          for n in sym.list_auxiliary_states()}
        self._trainable = tuple(sorted(grad_names if grad_names is not None
                                       else self._param_objs))
        self._indices = list(range(len(self._trainable)))
        from ..executor import graph_forward_backward
        self._fb = graph_forward_backward(sym, list(self._trainable))
        self._ensure_states()

    def _resolve_deferred(self, x):
        """Resolve deferred parameter shapes before the first step, by one
        forward of the first sample outside recording and training (as
        the JAX package's fused step does), on the device their
        ``initialize`` chose."""
        pending = [p for p in self._net.parameters()
                   if isinstance(p, UninitializedParameter)]
        if not pending:
            return
        param = pending[0].__dict__.get("_mx_param")
        dev = param._deferred_init[1] if param is not None and \
            param._deferred_init else x.device
        from .. import autograd
        with autograd.pause():
            self._net(x[:1].to(dev))

    def _resolve_block_params(self):
        from ..gluon.parameter import collect_params
        plist = list(collect_params(self._net).items())
        by_id = {}
        for n, p in plist:
            if id(p) in by_id:
                raise MXNetError(
                    f"StepFunction: parameter '{n}' is shared between "
                    f"blocks (as '{by_id[id(p)]}' and '{n}'); weight-tied "
                    "models are not supported by the fused step — use the "
                    "eager record/backward/step loop")
            by_id[id(p)] = n
        self._plist = plist
        if self._trainer is not None:
            index_of = self._trainer._param2idx
            trainable = [(n, p) for n, p in plist
                         if id(p) in index_of and _grad_req(p) != "null"]
            self._indices = [index_of[id(p)] for _, p in trainable]
        else:
            trainable = [(n, p) for n, p in plist if _grad_req(p) != "null"]
            self._indices = list(range(len(trainable)))
            self._optimizer.param_dict = {
                i: p for i, (_, p) in zip(self._indices, trainable)}
        self._trainable = tuple(n for n, _ in trainable)
        self._trainable_params = [p for _, p in trainable]
        for n, p in trainable:
            if _grad_req(p) == "add":
                warnings.warn(
                    f"StepFunction: parameter {n} has grad_req='add'; the "
                    "fused step computes fresh per-step gradients "
                    "(accumulation is not folded in)")
        self._ensure_states()
        self._psig = tuple(_grad_req(p) for _, p in plist)

    def _ensure_states(self):
        upd = self._updater
        for i, w in zip(self._indices, self._weights()):
            if i not in upd.states:
                upd.states[i] = \
                    self._optimizer.create_state_multi_precision(i, w)
                upd.states_synced[i] = True

    def _weights(self) -> List[torch.Tensor]:
        """The trainable weights' tensors (their storage is written)."""
        if self._symbol_mode:
            return [self._param_objs[n]._data for n in self._trainable]
        return [p.detach() for p in self._trainable_params]

    def _bound(self) -> List[torch.Tensor]:
        """Every tensor the step reads or writes besides its inputs: the
        parameters (aux states included) and the optimizer states."""
        if self._symbol_mode:
            ts = [v._data for _, v in sorted(self._param_objs.items())]
            ts += [v._data for _, v in sorted(self._aux_objs.items())]
        else:
            ts = [p.detach() for _, p in self._plist]
        for i in self._indices:
            ts += _leaves(self._updater.states[i])
        return ts

    def _device(self) -> torch.device:
        if self._symbol_mode:
            return next(iter(self._param_objs.values()))._data.device
        return self._plist[0][1].device

    def _param_dtypes(self):
        if self._symbol_mode:
            return tuple(str(v._data.dtype)
                         for _, v in sorted(self._param_objs.items()))
        return tuple(str(p.dtype) for _, p in self._plist)

    # -- the step's function -------------------------------------------------
    def _forward_backward(self, inputs):
        """``(gradients in trainable order, loss)``; aux writes land in
        their tensors."""
        if self._symbol_mode:
            arg_vals = {n: v._data for n, v in self._param_objs.items()}
            arg_vals.update(zip(self._input_names, inputs))
            aux_vals = {n: v._data for n, v in self._aux_objs.items()}
            outs, aux_updates, grads = self._fb(arg_vals, aux_vals,
                                                device=inputs[0].device)
            with torch.no_grad():
                for n, v in aux_updates.items():
                    if n in self._aux_objs:
                        self._aux_objs[n]._data.copy_(v)
            return [grads[n] for n in self._trainable], outs[0]
        from ..gluon.block import functional_call
        out = functional_call(self._net, [inputs[0]], training=True)[0]
        loss = out if self._loss_fn is None else functional_call(
            self._loss_fn, [out, *inputs[1:]], training=True)[0]
        params = self._trainable_params
        grads = torch.autograd.grad([loss], params, [torch.ones_like(loss)],
                                    allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(params, grads)], loss

    def _body(self, inputs, lrs, wds) -> torch.Tensor:
        """Forward, backward, exchange (the identity on one device) and
        the update, written into the weights' and states' storage; the
        loss. What a CUDA graph captures."""
        grads, loss = self._forward_backward(inputs)
        weights = self._weights()
        states = [self._updater.states[i] for i in self._indices]
        with torch.no_grad():
            new_w, new_s = self._optimizer.fused_apply(
                self._indices, weights, grads, states, lrs, wds)
            for w, nw in zip(weights, new_w):
                w.copy_(nw)
            for s, ns in zip(states, new_s):
                _state_write(s, ns)
        return loss.detach()

    # -- programs --------------------------------------------------------------
    def _generators(self, device) -> List[torch.Generator]:
        """Every generator the step may draw from on ``device``: the
        layers' own (Dropout's) and the port's generator of the device
        (nd and symbol ops)."""
        found, seen = [], set()
        roots = [self._net] if not self._symbol_mode else []
        if isinstance(self._loss_fn, nn.Module):
            roots.append(self._loss_fn)
        for root in roots:
            for m in root.modules():
                make = getattr(m, "_generator", None)
                if callable(make):
                    make(device)   # a Dropout makes its own at first use
                for v in vars(m).values():
                    if isinstance(v, torch.Generator) \
                            and v.device == device and id(v) not in seen:
                        seen.add(id(v))
                        found.append(v)
        g = _random.generator(device)
        if id(g) not in seen:
            found.append(g)
        return found

    def _capture(self, prog: _Program, inputs, device) -> None:
        """Warm the step up on a side stream, put back what the warm-up
        wrote, and capture it into ``prog``'s graph."""
        prog.inputs = [torch.empty(tuple(x.shape), dtype=x.dtype,
                                   device=device).copy_(x) for x in inputs]
        bound = self._bound()
        saved = [t.clone() for t in bound]
        gens = self._generators(device) + [
            torch.cuda.default_generators[device.index or 0]]
        gen_states = [g.get_state() for g in gens]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(device)
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._body(prog.inputs, prog.lrs, prog.wds)
            current.wait_stream(side)
            with torch.no_grad():
                for t, s in zip(bound, saved):
                    t.copy_(s)
            for g, s in zip(gens, gen_states):
                g.set_state(s)
            del saved
            graph = torch.cuda.CUDAGraph()
            for g in gens[:-1]:  # the default generator registers itself
                graph.register_generator_state(g)
            # thread_local: a CUDA call that is unsafe during a capture
            # still raises from this thread (a host read in the step), but
            # one from another thread, such as a record iterator's staging
            # copy or decoder, no longer invalidates the capture (under
            # "global" it did, now and then); torch.compile's CUDA graphs
            # capture the same way
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                prog.loss = self._body(prog.inputs, prog.lrs, prog.wds)
        except Exception as e:
            _release_generators(gens, gen_states)
            raise MXNetError(
                f"StepFunction '{self._name}': the CUDA graph capture of "
                f"the training step failed ({type(e).__name__}: {e}); the "
                "fused step has no eager fallback on CUDA — remove the "
                "host synchronisation or dynamic shape from the step, or "
                "train with the eager record/backward/step loop") from e
        prog.graph = graph

    def _prepare(self):
        """Resolve the parameters, and re-derive the trainable set on a
        ``grad_req`` flip (dropping the programs of the old set)."""
        if self._symbol_mode:
            return
        if self._plist is None:
            self._resolve_block_params()
        elif self._psig != tuple(_grad_req(p) for _, p in self._plist):
            self._resolve_block_params()
            self._cache.clear()

    def _key(self, inputs, device) -> tuple:
        return (tuple((tuple(v.shape), str(v.dtype)) for v in inputs),
                self._param_dtypes(),
                tuple(t.data_ptr() for t in self._bound()),
                self._optimizer.fused_signature(), str(device))

    def _record_miss(self, inputs, key) -> None:
        from ..telemetry import metrics as _metrics
        from ..telemetry import recompile as _recompile
        _metrics.counter(
            "fused_step_cache_misses_total",
            "fused-step signature-cache misses (captures)").inc()
        sig = _recompile.signature_of(inputs, True)
        # the non-shape keys: a cast, a new storage or a changed optimizer
        # scalar is a key change, not an eviction
        sig.update({"param_dtypes": list(key[1]),
                    "storage": hash(key[2]), "optimizer": repr(key[3])})
        _recompile.record_recompile(f"StepFunction:{self._name}", sig,
                                    kind="fused_step")

    def step(self, x, *labels, batch_size=None):
        """Run one fused training step; returns the loss."""
        from .. import telemetry as _telemetry
        from ..telemetry import metrics as _metrics
        t0 = time.perf_counter()
        inputs = [_raw(a) for a in (x,) + labels]
        if self._plist is None and not self._symbol_mode:
            self._resolve_deferred(inputs[0])
        self._prepare()
        device = self._device()
        if batch_size is None:
            batch_size = int(inputs[0].shape[0]) if inputs[0].dim() else 1
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        key = self._key(inputs, device)
        prog = self._cache.get(key)
        if prog is None:
            self._record_miss(inputs, key)
            tb = time.perf_counter()
            prog = _Program([_scalar_dtype(w.dtype) for w in self._weights()],
                            device)
            if device.type == "cuda":
                self._capture(prog, inputs, device)
            self._cache[key] = prog
            _metrics.histogram(
                "fused_step_compile_seconds",
                "fused-step warm-up and capture latency").observe(
                time.perf_counter() - tb)
        else:
            _metrics.counter("fused_step_cache_hits_total",
                             "fused-step signature-cache hits").inc()
        hyper = [opt.fused_hyper(i) for i in self._indices]
        prog.fill([h[0] for h in hyper], [h[1] for h in hyper])
        t1 = time.perf_counter()
        if prog.graph is not None:
            for s, v in zip(prog.inputs, inputs):
                s.copy_(v, non_blocking=True)
            prog.graph.replay()
        else:
            loss = self._body([v.to(device) for v in inputs], prog.lrs,
                              prog.wds)
        t2 = time.perf_counter()
        if prog.graph is not None:
            # the graph's loss buffer is rewritten by the next replay
            loss = prog.loss.clone()
        t3 = time.perf_counter()
        _metrics.histogram(
            "fused_step_host_seconds",
            "fused-step host prep (signature, capture on a miss, scalars)"
            ).observe(t1 - t0)
        _metrics.histogram(
            "fused_step_dispatch_seconds",
            "fused-step replay launch (asynchronous; the device not "
            "waited for)").observe(t2 - t1)
        # the update is written into the parameters' and states' storage
        # inside the step: what is left to hand back is the loss
        _metrics.histogram(
            "fused_step_writeback_seconds",
            "fused-step hand-back (the loss copied out of the graph)"
            ).observe(t3 - t2)
        _telemetry.record_step(batch_size, time.perf_counter() - t0)
        return _wrap(loss) if isinstance(x, NDArray) else loss

    __call__ = step

    # -- not ported yet ------------------------------------------------------
    def _not_yet(self, what: str, item: int):
        raise MXNetError(f"StepFunction.{what}: waits for ROADMAP Queue A "
                         f"item {item}")

    def attach_recorder(self, recorder):
        """The mxguard replay recorder (``guard/``): item 7."""
        self._not_yet("attach_recorder", 7)

    @property
    def guard_probe(self):
        """The mxguard anomaly probe: item 7."""
        return self._not_yet("guard_probe", 7)

    @property
    def last_fingerprints(self):
        """The mxguard tap matrix: item 7."""
        return self._not_yet("last_fingerprints", 7)

    def flush_guard(self):
        self._not_yet("flush_guard", 7)

    def guard_state(self):
        self._not_yet("guard_state", 7)

    def set_monitor_callback(self, callback, monitor_all=False):
        """The Monitor surface (``monitor.py``): item 8."""
        self._not_yet("set_monitor_callback", 8)

    def collect_monitor_stats(self, helper):
        self._not_yet("collect_monitor_stats", 8)

    def cost_analysis(self, x, *labels):
        """XLA's cost model of the compiled step; the port's counterpart
        belongs to ``tune/``: item 8."""
        self._not_yet("cost_analysis", 8)

    # -- introspection ---------------------------------------------------------
    @property
    def opt_report(self):
        """The graph optimizer's report: None (ROADMAP Queue A item 5)."""
        return None

    def cache_info(self) -> Dict[str, int]:
        """Programs of this step function; hits and misses of every fused
        step in the process (the telemetry counters)."""
        from ..telemetry import metrics as _metrics
        return {
            "programs": len(self._cache),
            "hits": _metrics.counter(
                "fused_step_cache_hits_total").value(),
            "misses": _metrics.counter(
                "fused_step_cache_misses_total").value(),
        }
