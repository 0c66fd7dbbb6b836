"""Carry weights between the JAX package's naming and the port's models.

``mxnet_tpu`` names a block's parameters by ``_collect_params_with_prefix()``
(``layers.0.attn.qkv.weight``, ``ln_f.gamma``, ``features.1.running_var``,
``features.3.out.1.gamma``, ...). The port keeps the same attribute paths
and layouts, in every zoo family and layer, and names a normalization
layer's (BatchNorm, LayerNorm, InstanceNorm, GroupNorm) ``gamma``/``beta``
``weight``/``bias``, as PyTorch does; BatchNorm's
``running_mean``/``running_var`` and PReLU's ``alpha`` keep their names
and are carried like any parameter. A model built without input sizes
takes weights once a forward resolved its shapes.

The recurrent layers and cells keep the JAX package's names too: a
Gluon ``RNN``/``LSTM``/``GRU``'s per-gate ``l0_i2h_weight`` ...
``r1_h2h_bias``, a cell's ``i2h_*``/``h2h_*``, ``LSTMPCell``'s
``h2r_weight``. A symbolic graph (``mx.rnn``'s cells under ``Module``)
takes its arguments by their graph names (``lstm_l0_i2h_weight``): give
:func:`params_from_mxnet_tpu` the port's ``Symbol`` as the model, and
its :class:`~mxnet_tpu_torch.rnn.rnn_cell.FusedRNNCell` cells as
``cells``, whose flat ``<prefix>parameters`` vector is packed from the
JAX package's unfused names for that cell (the JAX package's fused cell
is a stack of unfused cells).

The serving LM stack (``parallel/pipeline_lm.py``) is a nested dict in
both packages, with the same keys and layouts:
:func:`pipeline_lm_from_mxnet_tpu` carries it across.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .base import MXNetError
from .context import resolve_device
from .gluon.parameter import JAX_NAMES, collect_params
from .parallel.pipeline_lm import pipeline_lm_spec

__all__ = ["params_from_mxnet_tpu", "params_to_mxnet_tpu", "port_name",
           "mxnet_tpu_shapes", "pipeline_lm_from_mxnet_tpu"]

_RENAMES = {v: k for k, v in JAX_NAMES.items()}


def port_name(name: str) -> str:
    """The port's name for one of the JAX package's parameter names."""
    head, _, last = name.rpartition(".")
    last = _RENAMES.get(last, last)
    return f"{head}.{last}" if head else last


def mxnet_tpu_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of ``model``'s parameters under the JAX package's
    names: the inverse of :func:`port_name`, for making weights in that
    naming (from a seed, or to hand to both packages)."""
    return {name: tuple(p.shape)
            for name, p in collect_params(model).items()}


def params_to_mxnet_tpu(model: nn.Module) -> Dict[str, np.ndarray]:
    """``{name: array}`` of ``model``'s parameters under the JAX package's
    names, as CPU numpy copies in the model's dtypes: the inverse of
    :func:`params_from_mxnet_tpu`."""
    return {name: p.detach().cpu().numpy()
            for name, p in collect_params(model).items()}


def params_from_mxnet_tpu(named: Mapping[str, np.ndarray],
                          model, cells=()) -> Dict[str, torch.Tensor]:
    """A state dict for ``model`` from the JAX package's ``{name: array}``.

    Every shape is checked against ``model``; a parameter missing on
    either side raises, and so does one whose deferred shape is not
    resolved yet (run one forward, or ``load_parameters``, first). The
    tensors are CPU copies in the model's dtypes:
    ``model.load_state_dict(result)`` moves them to its device.

    ``model`` may instead be a ``Symbol``: the result is then
    ``{argument or aux name: tensor}`` for the names ``named`` gives
    (after packing each of ``cells``' flat vector, see the module's
    docstring), for ``Module.set_params`` or an executor; a name the
    graph lacks raises."""
    from .symbol.symbol import Symbol
    if isinstance(model, Symbol):
        return _symbol_args(named, model, cells)
    pending = [n for n, p in model.named_parameters()
               if isinstance(p, UninitializedParameter)]
    if pending:
        raise MXNetError(f"{len(pending)} parameter(s) of the model wait "
                         f"for their first forward ({pending[:4]}); run "
                         "one forward before carrying weights in")
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for name, arr in named.items():
        key = port_name(name)
        if key not in target:
            raise MXNetError(f"parameter {name!r} (as {key!r}) has no "
                             "counterpart in the model")
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(target[key].shape):
            raise MXNetError(f"parameter {name!r}: shape {arr.shape} != "
                             f"{tuple(target[key].shape)}")
        out[key] = torch.from_numpy(arr.copy()).to(target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise MXNetError(f"no value given for {len(missing)} parameter(s): "
                         f"{missing[:8]}")
    return out


def _symbol_args(named, sym, cells) -> Dict[str, torch.Tensor]:
    from .rnn.rnn_cell import FusedRNNCell
    arrays = {k: np.asarray(v) for k, v in named.items()}
    for cell in cells:
        if not isinstance(cell, FusedRNNCell):
            raise MXNetError(f"cells: {type(cell).__name__} is not a "
                             "FusedRNNCell")
        first = arrays[f"{cell._prefix}l0_i2h_weight"]
        keys = [k for k, _, _ in cell._slices(first.shape[1])]
        arrays[f"{cell._prefix}parameters"] = np.concatenate(
            [arrays.pop(k).reshape(-1) for k in keys])
    known = set(sym.list_arguments()) | set(sym.list_auxiliary_states())
    extra = sorted(set(arrays) - known)
    if extra:
        raise MXNetError(f"{len(extra)} name(s) the graph lacks: "
                         f"{extra[:8]}")
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def _flat_tree(tree: Mapping, prefix=()) -> Dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def pipeline_lm_from_mxnet_tpu(tree: Mapping, device="cuda") -> Dict:
    """The port's ``init_pipeline_lm`` tree from the JAX package's (a
    nested dict of arrays, e.g. ``jax.tree.map(numpy.asarray, params)``):
    float32 tensors on ``device``. The widths are read from ``embed``,
    ``layers/wqkv``, ``layers/w1`` and ``head``; every leaf's shape is
    checked against them, and a missing or extra key raises."""
    dev = resolve_device(device)
    flat = {k: np.asarray(v) for k, v in _flat_tree(tree).items()}
    for need in (("embed",), ("layers", "wqkv"), ("layers", "w1"),
                 ("head",)):
        if need not in flat or flat[need].ndim not in (2, 4, 5):
            raise MXNetError(f"pipeline_lm tree: no usable {'/'.join(need)}")
    vocab, d_model = flat[("embed",)].shape
    n_layers, _, _, n_heads, d_head = flat[("layers", "wqkv")].shape
    _, n_experts, _, d_ff = flat[("layers", "w1")].shape
    spec = pipeline_lm_spec(vocab=vocab, d_model=d_model,
                            n_layers=n_layers, n_heads=n_heads,
                            d_head=d_head, d_ff=d_ff, n_experts=n_experts)
    want = {path: tuple(shape) for path, shape, _ in spec}
    extra = sorted("/".join(k) for k in set(flat) - set(want))
    missing = sorted("/".join(k) for k in set(want) - set(flat))
    if extra or missing:
        raise MXNetError(f"pipeline_lm tree: missing {missing}, "
                         f"unexpected {extra}")
    out: Dict = {}
    for path, shape in want.items():
        arr = flat[path]
        if tuple(arr.shape) != shape:
            raise MXNetError(f"pipeline_lm tree: {'/'.join(path)} has "
                             f"shape {arr.shape}, expected {shape}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.from_numpy(
            np.array(arr, dtype=np.float32)).to(dev)
    return out
