"""Tensor op corpus: elementwise, broadcast, reductions, ordering,
matrix manipulation and indexing, as functions on tensors.

Counterpart of ``mxnet_tpu/ops/tensor.py``, registration for
registration, with the JAX package's semantics where torch's differ:

- dtypes: index-valued outputs (``argmax``, ``argsort``, ``topk``) are
  float32; a sum or product of integers stays 32-bit (torch widens it to
  int64); ``int / int`` divides toward zero and stays integer;
- out-of-range indices (:func:`take_fill`, behind ``pick``,
  ``batch_take`` and ``Embedding``): an index in ``[-n, -1]`` wraps and
  any other index outside ``[0, n)`` gives NaN, computed on the device
  with no host sync (wrap, clamp the gather, then ``where(valid, ...,
  nan)``). A bare ``torch.gather`` would raise on the CPU and trip a
  device-side assert on CUDA, which ends the CUDA context;
- ``MXNET_SAFE_ACCUMULATION=1``: reductions of 16-bit floats accumulate
  in fp32 and round back.

None of these is a hand-written kernel, in either package: the JAX
package lowers them to XLA, the port to ATen.
"""
from __future__ import annotations

import math
import operator

import numpy as onp
import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = ["take_fill", "expand_reshape_spec", "REDUCTIONS"]

_INDEX_FLOAT = torch.float32
_INDEX_INT = torch.int64   # gathers index with int64 (torch's own)


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex()
                    or x.dtype is torch.bool)
    return isinstance(x, int) and not isinstance(x, bool)


def _div(lhs, rhs):
    """Division; integer by integer divides toward zero and keeps the
    dtype, as the reference's elemwise/broadcast div does."""
    if _is_int(lhs) and _is_int(rhs):
        if not isinstance(lhs, torch.Tensor):
            lhs = torch.as_tensor(lhs, dtype=rhs.dtype, device=rhs.device)
        return torch.div(lhs, rhs, rounding_mode="trunc")
    return operator.truediv(lhs, rhs)


def _torch_dtype(dtype):
    from ..ndarray.ndarray import as_torch_dtype
    return as_torch_dtype(dtype)


def _scalar(x, like: torch.Tensor):
    """A Python number in the tensor's dtype (the JAX package casts a
    scalar operand to the data's dtype)."""
    if like.dtype is torch.bool:
        return bool(x)
    if like.is_floating_point() or like.is_complex():
        return float(x)
    return int(x)


def _device():
    from ..context import as_device
    return as_device(None)


# -- elementwise binary and broadcast families --------------------------------

_BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": _div, "mod": torch.remainder, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": torch.hypot,
}

for _name, _fn in _BINARY.items():
    register_op(f"elemwise_{_name}",
                aliases=[f"_{_name}",
                         "_Plus" if _name == "add" else f"_x{_name}"],
                doc=f"Elementwise {_name} of two same-shape tensors.")(
        (lambda f: lambda lhs, rhs: f(lhs, rhs))(_fn))
    register_op(f"broadcast_{_name}", aliases=[f"_broadcast_{_name}"],
                doc=f"Elementwise {_name} with numpy-style "
                    f"broadcasting.")(
        (lambda f: lambda lhs, rhs: f(lhs, rhs))(_fn))

_CMP = {
    "equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
    "greater_equal": torch.ge, "lesser": torch.lt, "lesser_equal": torch.le,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}
for _name, _fn in _CMP.items():
    register_op(f"broadcast_{_name}", differentiable=False,
                doc=f"Broadcasting {_name}; 0/1 in the lhs dtype.")(
        (lambda f: lambda lhs, rhs: f(lhs, rhs).to(lhs.dtype))(_fn))

_SCALAR = {
    "plus": operator.add, "minus": operator.sub, "mul": operator.mul,
    "div": operator.truediv, "mod": torch.remainder, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
    "greater_equal": torch.ge, "lesser": torch.lt, "lesser_equal": torch.le,
}
_TENSOR_ONLY = {torch.maximum, torch.minimum, torch.remainder}


def _scalar_op(f, name):
    def op(data, scalar=1.0):
        s = _scalar(scalar, data)
        if f in _TENSOR_ONLY:
            s = torch.tensor(s, dtype=data.dtype, device=data.device)
        out = f(data, s)
        if name == "div" and _is_int(data):
            return out.trunc().to(data.dtype)
        return out.to(data.dtype)
    return op


for _name, _fn in _SCALAR.items():
    register_op(f"_{_name}_scalar",
                differentiable=_name in ("plus", "minus", "mul", "div",
                                         "mod", "power", "maximum",
                                         "minimum"),
                doc=f"Elementwise {_name} against a scalar cast to the "
                    f"data's dtype.")(_scalar_op(_fn, _name))

register_op("_rminus_scalar", doc="scalar - data, elementwise.")(
    lambda data, scalar=1.0: _scalar(scalar, data) - data)
register_op("_rdiv_scalar", doc="scalar / data, elementwise (toward zero "
            "on integers).")(
    lambda data, scalar=1.0: _div(_scalar(scalar, data), data))
register_op("_rpower_scalar", doc="scalar ** data, elementwise.")(
    lambda data, scalar=1.0: torch.pow(_scalar(scalar, data), data))
register_op("_rmod_scalar", doc="scalar % data, elementwise.")(
    lambda data, scalar=1.0: torch.remainder(
        torch.tensor(_scalar(scalar, data), dtype=data.dtype,
                     device=data.device), data))


@register_op("add_n", aliases=["ElementWiseSum", "_sum"])
def add_n(*args):
    """Sum of any number of same-shape tensors."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


register_op("_grad_add", doc="Gradient accumulation add (plain "
            "addition).")(lambda lhs, rhs: lhs + rhs)


# -- unary math ---------------------------------------------------------------

def _rcbrt(x):
    return 1.0 / _cbrt(x)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "cbrt": _cbrt, "exp": torch.exp, "expm1": torch.expm1,
    "log": torch.log, "log10": torch.log10, "log1p": torch.log1p,
    "log2": torch.log2, "negative": torch.neg,
    "reciprocal": torch.reciprocal, "sqrt": torch.sqrt,
    "square": torch.square, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "arcsin": torch.arcsin, "arccos": torch.arccos,
    "arctan": torch.arctan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "arcsinh": torch.arcsinh,
    "arccosh": torch.arccosh, "arctanh": torch.arctanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma, "erf": torch.erf, "erfinv": torch.erfinv,
    "relu": torch.relu, "sigmoid": torch.sigmoid,
    "softsign": torch.nn.functional.softsign,
    "rsqrt": torch.rsqrt, "rcbrt": _rcbrt, "identity": lambda x: x,
}
for _name, _fn in _UNARY.items():
    register_op(_name, doc=f"Elementwise {_name}.")(
        (lambda f: lambda data: f(data))(_fn))

register_op("_copy", doc="Copy of the input tensor.")(
    lambda data: data.clone())

_UNARY_NONDIFF = {
    "ceil": torch.ceil, "floor": torch.floor, "rint": torch.round,
    "round": torch.round, "trunc": torch.trunc, "fix": torch.trunc,
    "sign": torch.sign,
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
}
for _name, _fn in _UNARY_NONDIFF.items():
    register_op(_name, differentiable=False,
                doc=f"Elementwise {_name}; zero gradient everywhere, so "
                    f"registered non-differentiable.")(
        (lambda f: lambda data: f(data))(_fn))


@register_op("clip")
def clip(data, a_min=0.0, a_max=1.0):
    """Clamp values into [a_min, a_max]."""
    return torch.clamp(data, a_min, a_max)


@register_op("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """``|x| < 1/s^2 ? 0.5 (s x)^2 : |x| - 0.5 / s^2``."""
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2, 0.5 * s2 * data * data,
                       torch.abs(data) - 0.5 / s2)


@register_op("BlockGrad", aliases=["stop_gradient"], differentiable=False)
def block_grad(data):
    """The input, with no gradient flowing back through it."""
    return data.detach()


@register_op("make_loss")
def make_loss(data):
    """Marks a loss head: the identity, whose backward starts from the
    head gradient (ones by default)."""
    return data


# -- reductions ---------------------------------------------------------------

def _axes(axis, ndim):
    """``axis`` (None, an int or a sequence) as a tuple of dims; None
    (or ``()``) is every dim."""
    if axis is None or axis == ():
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % max(ndim, 1) for a in axis)
    return (int(axis) % max(ndim, 1),)


def _safe_acc(data):
    """``(data, dtype to round back to or None)``: a 16-bit float goes to
    fp32 under ``MXNET_SAFE_ACCUMULATION``."""
    from .. import config
    if config.get("MXNET_SAFE_ACCUMULATION") \
            and data.dtype in (torch.float16, torch.bfloat16):
        return data.float(), data.dtype
    return data, None


def _int32(out, data):
    """A sum or product of integers as int32 (torch widens to int64)."""
    if out.dtype is torch.int64 and data.dtype is not torch.int64:
        return out.to(torch.int32)
    return out


def _red_sum(x, dims, keepdims):
    return _int32(torch.sum(x, dims, keepdim=keepdims), x)


def _red_nansum(x, dims, keepdims):
    return torch.nansum(x, dims, keepdim=keepdims)


def _red_mean(x, dims, keepdims):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    return torch.mean(x, dims, keepdim=keepdims)


def _red_prod(x, dims, keepdims):
    out = x
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, d, keepdim=keepdims)
    return _int32(out, x)


def _red_nanprod(x, dims, keepdims):
    return _red_prod(torch.where(torch.isnan(x), torch.ones_like(x), x),
                     dims, keepdims)


def _red_max(x, dims, keepdims):
    return torch.amax(x, dims, keepdim=keepdims)


def _red_min(x, dims, keepdims):
    return torch.amin(x, dims, keepdim=keepdims)


def _make_reduce(red):
    def reduce_op(data, axis=None, keepdims=False, exclude=False):
        dims = _axes(axis, data.dim())
        if exclude and axis is not None:
            dims = tuple(d for d in range(data.dim()) if d not in dims)
        data, restore = _safe_acc(data)
        out = red(data, dims, keepdims) if data.dim() else data.clone()
        return out.to(restore) if restore is not None else out
    return reduce_op


REDUCTIONS = {name: _make_reduce(red) for name, red in (
    ("sum", _red_sum), ("nansum", _red_nansum), ("mean", _red_mean),
    ("prod", _red_prod), ("nanprod", _red_nanprod), ("max", _red_max),
    ("min", _red_min))}
_REDUCE_DOC = ("Reduce with {0} over `axis` (None: every axis); keepdims, "
               "exclude, and MXNET_SAFE_ACCUMULATION.")
register_op("sum", aliases=["sum_axis"],
            doc=_REDUCE_DOC.format("summation"))(REDUCTIONS["sum"])
register_op("nansum", doc=_REDUCE_DOC.format("NaN-ignoring summation"))(
    REDUCTIONS["nansum"])
register_op("mean", doc=_REDUCE_DOC.format("the mean"))(REDUCTIONS["mean"])
register_op("prod", doc=_REDUCE_DOC.format("the product"))(
    REDUCTIONS["prod"])
register_op("nanprod", doc=_REDUCE_DOC.format("NaN-ignoring product"))(
    REDUCTIONS["nanprod"])
register_op("max", aliases=["max_axis"], doc=_REDUCE_DOC.format("maximum"))(
    REDUCTIONS["max"])
register_op("min", aliases=["min_axis"], doc=_REDUCE_DOC.format("minimum"))(
    REDUCTIONS["min"])


def moment(data, axis=None, keepdims=False, std=False):
    """Population variance (or standard deviation) over ``axis``."""
    dims = _axes(axis, data.dim())
    if not data.is_floating_point():
        data = data.float()
    v = torch.var(data, dims, correction=0, keepdim=keepdims)
    return torch.sqrt(v) if std else v


@register_op("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    """Vector norm over ``axis`` (of the flattened input when None), or
    the matrix norm over two axes."""
    if axis is None:
        out = torch.linalg.vector_norm(data.reshape(-1), ord)
        return out.reshape((1,) * data.dim()) if keepdims else out
    dims = _axes(axis, data.dim())
    if len(dims) == 2:
        return torch.linalg.matrix_norm(data, "fro" if ord == 2 else ord,
                                        dims, keepdim=keepdims)
    return torch.linalg.vector_norm(data, ord, dims, keepdim=keepdims)


@register_op("moments", n_out=2)
def moments(data, axes=None, keepdims=False):
    """Mean and population variance over ``axes``."""
    dims = _axes(axes, data.dim())
    return (torch.mean(data, dims, keepdim=keepdims),
            torch.var(data, dims, correction=0, keepdim=keepdims))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.dim())
        return out.to(_INDEX_FLOAT)
    return fn(data, int(axis), keepdim=keepdims).to(_INDEX_FLOAT)


@register_op("argmax", differentiable=False)
def argmax(data, axis=None, keepdims=False):
    """Index of the maximum along ``axis``, as float32."""
    return _arg(torch.argmax, data, axis, keepdims)


@register_op("argmin", differentiable=False)
def argmin(data, axis=None, keepdims=False):
    """Index of the minimum along ``axis``, as float32."""
    return _arg(torch.argmin, data, axis, keepdims)


@register_op("argmax_channel", differentiable=False)
def argmax_channel(data):
    """Argmax over axis 1, as float32."""
    return torch.argmax(data, 1).to(_INDEX_FLOAT)


# -- out-of-range indices: wrap, else NaN -------------------------------------

def _wrap_index(index: torch.Tensor, n: int):
    """``(safe, valid)``: ``index`` as int64 in ``[0, n)`` (``[-n, -1]``
    wrapped, the rest folded in, to be masked) and where it was in
    ``[-n, n)``."""
    idx = index.to(_INDEX_INT)
    return idx.remainder(max(n, 1)), (idx >= -n) & (idx < n)


def _nan_where(valid: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, out, float("nan")) \
        if out.is_floating_point() else out


def take_fill(data: torch.Tensor, index: torch.Tensor, axis: int
              ) -> torch.Tensor:
    """``data`` gathered along ``axis`` at ``index`` (any shape, any
    numeric dtype, truncated to integers): the result has ``index``'s
    shape in place of that axis. Indices in ``[-n, -1]`` wrap; any other
    index outside ``[0, n)`` gives NaN (the JAX package's fill mode; an
    integer ``data`` has no NaN and gives the row the index folds to).
    Runs on the device with no host sync, so a bad index cannot trip a
    device-side assert."""
    axis = axis % data.dim()
    safe, valid = _wrap_index(index, data.shape[axis])
    # rows of the axis through F.embedding, whose CUDA backward sums a
    # repeated index's gradients in a fixed order (index_select's
    # backward adds them atomically, so a resumed run would not be
    # bit-equal to an uninterrupted one)
    moved = data.movedim(axis, 0)
    out = F.embedding(safe, moved.reshape(moved.shape[0], -1))
    out = out.reshape(safe.shape + moved.shape[1:])
    out = _nan_where(valid.reshape(valid.shape + (1,) * (data.dim() - 1)),
                     out)
    k = safe.dim()
    return out.movedim(tuple(range(k)), tuple(range(axis, axis + k))) \
        if axis else out


@register_op("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data[..., index[...], ...]`` along ``axis``: one element per
    position of the other axes. ``mode`` is accepted and ignored, as in
    the JAX package: an index in ``[-n, -1]`` wraps and any other
    out-of-range index gives NaN (:func:`take_fill`)."""
    axis = axis % data.dim()
    idx = index
    if idx.dim() == data.dim():
        idx = idx.squeeze(axis)
    # one gather per row: the picked axis last, the rest flattened
    moved = data.movedim(axis, -1)
    safe, valid = _wrap_index(idx.reshape(-1), moved.shape[-1])
    got = torch.gather(moved.reshape(-1, moved.shape[-1]), 1,
                       safe.unsqueeze(1)).squeeze(1)
    out = _nan_where(valid, got).reshape(moved.shape[:-1])
    return out.unsqueeze(axis) if keepdims else out


# -- ordering -----------------------------------------------------------------

@register_op("topk", differentiable=False)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype=None):
    """Top-``k`` values, indices (float32 unless ``dtype``), both, or a
    0/1 mask along ``axis``."""
    dt = _torch_dtype(dtype) or _INDEX_FLOAT
    vals, idx = torch.topk(data, int(k), dim=axis, largest=not is_ascend,
                           sorted=True)
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter_(axis, idx, 1)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(dt)
    return idx.to(dt)


@register_op("sort")
def sort(data, axis=-1, is_ascend=True):
    """Sort along ``axis``."""
    r = torch.sort(data, dim=axis, stable=True).values
    return r if is_ascend else torch.flip(r, (axis,))


@register_op("argsort", differentiable=False)
def argsort(data, axis=-1, is_ascend=True, dtype=None):
    """The sorting permutation along ``axis`` (float32 unless
    ``dtype``); descending is the ascending one reversed."""
    r = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        r = torch.flip(r, (axis,))
    return r.to(_torch_dtype(dtype) or _INDEX_FLOAT)


# -- dot / batch_dot ----------------------------------------------------------

@register_op("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    """Contract ``lhs``'s last axis with ``rhs``'s first; a transpose
    flag reverses that operand's axes first."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register_op("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
              forward_stype=None):
    """Batched matrix product over the leading axes."""
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


# -- matrix manipulation ------------------------------------------------------

def expand_reshape_spec(cur, spec):
    """MXNet's reshape codes: 0 copies the input dim, -1 infers one, -2
    copies every remaining dim, -3 merges two, -4 splits one into the two
    that follow (one may be -1)."""
    spec = tuple(spec)
    if not any(s in (0, -2, -3, -4) for s in spec):
        return spec
    out = []
    i = j = 0
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(cur[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(cur[i:])
            i = len(cur)
        elif s == -3:
            out.append(cur[i] * cur[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = cur[i] // d2
            if d2 == -1:
                d2 = cur[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return tuple(out)


@register_op("reshape", aliases=["Reshape"])
def reshape(data, shape=None, reverse=False):
    """Reshape with MXNet's codes (:func:`expand_reshape_spec`)."""
    return data.reshape(expand_reshape_spec(tuple(data.shape), shape))


@register_op("reshape_like")
def reshape_like(lhs, rhs):
    """``lhs`` in ``rhs``'s shape."""
    return lhs.reshape(rhs.shape)


@register_op("shape_array", differentiable=False)
def shape_array(data):
    """The shape as a 1-D int32 tensor."""
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register_op("size_array", differentiable=False)
def size_array(data):
    """The element count as a 1-element int32 tensor."""
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register_op("cast", aliases=["Cast", "amp_cast"])
def cast(data, dtype="float32"):
    """``data`` in ``dtype``."""
    return data.to(_torch_dtype(dtype))


@register_op("transpose")
def transpose(data, axes=None):
    """Permute the axes (reverse them when ``axes`` is None)."""
    return data.permute(tuple(axes) if axes else
                        tuple(reversed(range(data.dim()))))


@register_op("expand_dims")
def expand_dims(data, axis=0):
    """A size-1 axis inserted at ``axis``."""
    return data.unsqueeze(axis)


@register_op("squeeze")
def squeeze(data, axis=None):
    """Size-1 axes removed (every one when ``axis`` is None)."""
    if axis is None:
        return data.squeeze()
    return data.squeeze(tuple(axis) if isinstance(axis, (list, tuple))
                        else axis)


@register_op("Flatten", aliases=["flatten"])
def flatten(data):
    """Every axis but the first collapsed: (N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


def index_slices(x: torch.Tensor, slices) -> torch.Tensor:
    """``x[slices]`` for a tuple of slices, negative steps included
    (torch slicing takes positive steps only)."""
    out = x
    for d, sl in enumerate(slices):
        if not isinstance(sl, slice) or sl == slice(None):
            continue
        if sl.step is not None and sl.step < 0:
            idx = torch.arange(*sl.indices(out.shape[d]), device=x.device)
            out = torch.index_select(out, d, idx)
        else:
            out = out[(slice(None),) * d + (sl,)]
    return out


@register_op("slice")
def slice_op(data, begin=None, end=None, step=None):
    """Strided slice by ``begin``/``end``/``step`` per leading axis
    (None entries take the axis's default)."""
    return index_slices(data, tuple(
        slice(b, e, s) for b, e, s in
        zip(begin, end, step or [None] * len(begin))))


@register_op("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    """``[begin, end)`` along one axis."""
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register_op("slice_like")
def slice_like(data, shape_like, axes=None):
    """``data`` cut to ``shape_like``'s extents on ``axes`` (every
    shared axis when None)."""
    tgt = shape_like.shape
    idx = [slice(None)] * data.dim()
    for ax in (axes if axes else range(min(data.dim(), len(tgt)))):
        idx[ax] = slice(0, tgt[ax])
    return data[tuple(idx)]


@register_op("SliceChannel", aliases=["slice_channel", "split"], n_out=-1)
def slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``."""
    if data.shape[axis] % num_outputs:
        raise ValueError(f"SliceChannel: axis {axis} of {data.shape[axis]} "
                         f"does not split into {num_outputs}")
    parts = torch.tensor_split(data, num_outputs, axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register_op("_split_v2", n_out=-1)
def split_v2(data, indices_or_sections=1, axis=0, squeeze_axis=False,
             sections=0):
    """Split along ``axis`` into equal sections or at given indices."""
    n = sections if sections else indices_or_sections
    if isinstance(n, int) and data.shape[axis] % n:
        raise ValueError(f"split: axis {axis} of {data.shape[axis]} does "
                         f"not split into {n}")
    parts = torch.tensor_split(data, list(n) if isinstance(n, (list, tuple))
                               else n, axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register_op("Concat", aliases=["concat"])
def concat(*args, dim=1, num_args=0):
    """Join along ``dim``."""
    return torch.cat(args, dim)


@register_op("stack")
def stack(*args, axis=0, num_args=0):
    """Same-shape tensors along a new axis."""
    return torch.stack(args, axis)


@register_op("tile")
def tile(data, reps=None):
    """The whole tensor repeated ``reps`` times per axis."""
    return data.tile(tuple(reps))


@register_op("repeat")
def repeat(data, repeats=1, axis=None):
    """Each element repeated ``repeats`` times along ``axis`` (of the
    flattened input when None)."""
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, axis)


@register_op("reverse", aliases=["flip"])
def reverse(data, axis=None):
    """Element order reversed along the given axes."""
    ax = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    return torch.flip(data, ax)


@register_op("SwapAxis", aliases=["swapaxes"])
def swapaxes(data, dim1=0, dim2=0):
    """Two axes interchanged."""
    return data.transpose(dim1, dim2)


@register_op("depth_to_space")
def depth_to_space(data, block_size=1):
    """Channel blocks into spatial blocks, NCHW."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register_op("space_to_depth")
def space_to_depth(data, block_size=1):
    """Spatial blocks into channel blocks, NCHW."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register_op("diag")
def diag(data, k=0, axis1=0, axis2=1):
    """A diagonal matrix from a 1-D input, or the ``k``-th diagonal of an
    N-D one."""
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, k, axis1, axis2).clone()


@register_op("where")
def where(condition, x, y):
    """``x`` where ``condition`` is nonzero, else ``y``; a 1-D condition
    of length ``x.shape[0]`` selects whole rows."""
    cond = condition.to(torch.bool)
    if cond.dim() == 1 and x.dim() > 1 and cond.shape[0] == x.shape[0]:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond, x, y)


@register_op("broadcast_to")
def broadcast_to(data, shape=None):
    """Broadcast to ``shape``; a 0 keeps the current extent."""
    shape = tuple(shape)
    if len(shape) == data.dim():
        shape = tuple(c if s == 0 else s for s, c in zip(shape, data.shape))
    return data.expand(shape)


@register_op("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """``lhs`` broadcast to ``rhs``'s shape."""
    return lhs.expand(rhs.shape)


@register_op("broadcast_axis", aliases=["broadcast_axes"])
def broadcast_axis(data, axis=None, size=None):
    """Size-1 axes broadcast to the given sizes."""
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    sizes = size if isinstance(size, (list, tuple)) else [size]
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return data.expand(tuple(tgt))


@register_op("Pad", aliases=["pad"])
def pad_alias(data, mode="constant", pad_width=None, constant_value=0):
    """Pad with constant, edge or reflect modes; ``pad_width`` is
    (before, after) per axis, first axis first."""
    from .nn import pad_op
    return pad_op(data, mode=mode, pad_width=tuple(pad_width),
                  constant_value=constant_value)


@register_op("zeros_like", differentiable=False)
def zeros_like(data):
    """Zeros of the input's shape and dtype."""
    return torch.zeros_like(data)


@register_op("ones_like", differentiable=False)
def ones_like(data):
    """Ones of the input's shape and dtype."""
    return torch.ones_like(data)


@register_op("_identity_with_attr_like_rhs")
def identity_with_attr_like_rhs(lhs, rhs):
    """``lhs`` (carries ``rhs``'s attributes in a graph)."""
    return lhs


# -- indexing -----------------------------------------------------------------

@register_op("take")
def take(a, indices, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` at integer ``indices``; an index out
    of range is clipped (``clip``, ``raise``) or wrapped (``wrap``)."""
    n = a.shape[axis]
    idx = indices.to(_INDEX_INT)
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    ax = axis % a.dim()
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register_op("batch_take")
def batch_take(a, indices):
    """``out[i] = a[i, indices[i]]`` (out-of-range as :func:`take_fill`)."""
    return pick(a, indices.reshape(-1), axis=1)


@register_op("one_hot", differentiable=False)
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """One-hot rows of ``depth`` classes; an index outside ``[0, depth)``
    gives a row of ``off_value``."""
    idx = indices.to(_INDEX_INT)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)).to(
        _torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


def _nd_index(indices):
    """The rows of an (M, ...) index tensor as an index tuple, negative
    entries counted from the end."""
    return tuple(indices.to(_INDEX_INT))


@register_op("gather_nd")
def gather_nd(data, indices):
    """N-dimensional gather: ``indices``' leading axis indexes ``data``'s
    leading axes."""
    idx = _nd_index(indices)
    idx = tuple(i.clamp(-n, n - 1) for i, n in zip(idx, data.shape))
    return data[idx]


@register_op("scatter_nd")
def scatter_nd(data, indices, shape=None):
    """``data`` scatter-added into zeros of ``shape`` at ``indices``."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data, accumulate=True)


@register_op("_ravel_multi_index", differentiable=False)
def ravel_multi_index(data, shape=None):
    """(ndim, N) coordinates folded into flat indices of ``shape``."""
    mult = onp.cumprod((1,) + tuple(shape)[::-1][:-1])[::-1]
    m = torch.tensor(mult.copy(), dtype=data.dtype, device=data.device)
    return torch.sum(data * m[:, None], 0).to(data.dtype)


@register_op("_unravel_index", differentiable=False)
def unravel_index(data, shape=None):
    """Flat indices unfolded into an (ndim, N) coordinate matrix."""
    flat = data.to(_INDEX_INT)
    coords = []
    for n in reversed(tuple(shape)):
        coords.append(flat.remainder(n))
        flat = torch.div(flat, n, rounding_mode="floor")
    return torch.stack(coords[::-1]).to(data.dtype)


@register_op("boolean_mask")
def boolean_mask(data, index, axis=0):
    """The rows where ``index`` is nonzero, padded with row 0 to the
    mask's length (a static shape, as the JAX package keeps one)."""
    idx = torch.nonzero(index.to(torch.bool))[:index.shape[0], 0]
    pad = index.shape[0] - idx.numel()
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
    return torch.index_select(data, axis, idx)


@register_op("khatri_rao")
def khatri_rao(*args):
    """Column-wise Kronecker product of the input matrices."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ir,jr->ijr", out, m).reshape(-1, out.shape[1])
    return out


@register_op("_square_sum")
def square_sum(data, axis=None, keepdims=False):
    """Sum of squares over ``axis``."""
    return torch.sum(torch.square(data), _axes(axis, data.dim()),
                     keepdim=keepdims)


@register_op("cast_storage")
def cast_storage(data, stype="default"):
    """Storage-type cast of a dense input: the identity, as in the JAX
    package (a sparse input takes ``ndarray/sparse_ops.py``'s cast, and
    ``nd.sparse.cast_storage`` converts a dense one)."""
    return data


@register_op("_contrib_arange_like", differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * arange`` shaped like the input (or its ``axis``
    extent)."""
    if axis is None:
        n, shape = data.numel(), data.shape
    else:
        n, shape = data.shape[axis], (data.shape[axis],)
    return (start + step * torch.arange(n, dtype=data.dtype,
                                        device=data.device)).reshape(shape)


@register_op("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """``data / sqrt(data.shape[-1])``."""
    return data / math.sqrt(data.shape[-1])


@register_op("_sym_zeros", differentiable=False)
def _sym_zeros(shape=(), dtype="float32"):
    """Input-free zeros on the current context."""
    return torch.zeros(tuple(shape), dtype=_torch_dtype(dtype),
                       device=_device())


@register_op("_sym_ones", differentiable=False)
def _sym_ones(shape=(), dtype="float32"):
    """Input-free ones on the current context."""
    return torch.ones(tuple(shape), dtype=_torch_dtype(dtype),
                      device=_device())


@register_op("_graph_const", differentiable=False)
def _graph_const(data=(), shape=(), dtype="float32"):
    """A constant given as (nested) lists, of ``shape`` and ``dtype``, on
    the current context."""
    from ..ndarray.ndarray import as_numpy_dtype
    td = _torch_dtype(dtype)
    host = onp.asarray(data, onp.float32 if td is torch.bfloat16
                       else as_numpy_dtype(td))
    return torch.from_numpy(host.reshape(tuple(shape))).to(_device(), td)
