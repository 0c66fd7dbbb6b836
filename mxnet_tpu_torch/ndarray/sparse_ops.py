"""Sparse-aware op implementations: the FComputeEx dispatch tier.

Counterpart of ``mxnet_tpu/ndarray/sparse_ops.py``. The reference runs an
op's sparse kernel when its inputs' storage types allow (ref:
src/imperative/imperative_utils.h:99; dot-inl.h; square_sum-inl.h), and
:func:`maybe_sparse_dispatch` is that choice here: ``nd.<op>`` and
``nd.dot`` ask it before the dense path, and a registered implementation
computes on the compact payload. A leaf weight's gradient through ``dot`` and
the sparse ``Embedding`` leaves the ``torch.autograd.Function`` below as a
sparse COO tensor of the weight's shape (one row per stored entry,
duplicates unsummed, as ``F.embedding(sparse=True)``'s does), so the dense
gradient is never built; :func:`mxnet_tpu_torch.autograd.backward` turns
it into a ``row_sparse`` gradient with :meth:`SparseCotangent.to_rowsparse`.
A gradient with respect to a payload (a ``row_sparse`` operand's values)
is values-shaped and flows through torch's own graph.

Every reduction over duplicate indices sorts them stably and sums each
segment in order, in the next wider float type
(:func:`~mxnet_tpu_torch.ndarray.sparse.segment_sum`,
:func:`~mxnet_tpu_torch.ndarray.sparse.merge_rows`), never with atomics,
so results have the same bits in every run. These backwards cannot be differentiated again:
``create_graph=True`` through one raises, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..base import MXNetError
from .ndarray import NDArray, _wrap
from .sparse import (BaseSparseNDArray, CSRNDArray, RowSparseNDArray,
                     merge_rows, segment_sum)

__all__ = ["SparseCotangent", "register_sparse_op", "maybe_sparse_dispatch"]


class SparseCotangent:
    """A row-sparse gradient: ``values: (nnz,) + row_shape`` at
    ``indices: (nnz,)``, duplicates allowed (they sum)."""

    __slots__ = ("values", "indices", "shape")

    def __init__(self, values, indices, shape):
        self.values = values
        self.indices = indices.reshape(-1).to(torch.int64)
        self.shape = tuple(shape)

    @classmethod
    def from_coo(cls, t: torch.Tensor) -> "SparseCotangent":
        """The rows of a sparse COO tensor with one sparse dimension."""
        return cls(t._values(), t._indices()[0], t.shape)

    def to_coo(self) -> torch.Tensor:
        # no invariant check: it would read the indices on the host
        with torch.sparse.check_sparse_tensor_invariants(enable=False):
            return torch.sparse_coo_tensor(self.indices[None], self.values,
                                           self.shape, check_invariants=False)

    def __add__(self, other: "SparseCotangent") -> "SparseCotangent":
        return SparseCotangent(torch.cat([self.values, other.values]),
                               torch.cat([self.indices, other.indices]),
                               self.shape)

    def densify(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_put((self.indices,), self.values, accumulate=True)

    def to_rowsparse(self) -> RowSparseNDArray:
        """The ``row_sparse`` gradient: sorted unique rows with their
        values summed (the reference's row_sparse invariant)."""
        uniq, vals = merge_rows(self.values, self.indices)
        return RowSparseNDArray(vals, uniq, self.shape)


_SPARSE_OPS: Dict[str, Callable] = {}


def register_sparse_op(name: str):
    def deco(fn):
        _SPARSE_OPS[name] = fn
        return fn
    return deco


def maybe_sparse_dispatch(name: str, inputs, params):
    """The sparse implementation's result, or ``NotImplemented`` for the
    dense path (which densifies, with a storage-fallback warning)."""
    fn = _SPARSE_OPS.get(name)
    if fn is None:
        return NotImplemented
    if not any(isinstance(i, BaseSparseNDArray) for i in inputs) \
            and not params.get("sparse_grad"):
        return NotImplemented
    return fn(*inputs, **params)


def _no_double_backward():
    # the engine runs a backward with gradient recording on exactly when
    # it was asked to create a graph
    if torch.is_grad_enabled():
        raise MXNetError(
            "create_graph=True through sparse gradients "
            "(row_sparse/SparseCotangent paths) is not supported")


def _rhs_grad(pernnz, at, rhs_shape, sparse_out):
    """The gradient of a ``dot``'s right operand (or an embedding's table)
    from each stored entry's contribution ``pernnz`` to row ``at``: a
    sparse COO tensor for a leaf (``sparse_out``), else dense, as the
    JAX package densifies a sparse cotangent at the op that consumes it
    (a ``row_sparse`` operand's dense view takes it so, and its own
    backward gathers the values' gradient)."""
    cot = SparseCotangent(pernnz, at, rhs_shape)
    return cot.to_coo() if sparse_out else cot.densify()


def _sparse_out(t: torch.Tensor, stored_sparse: bool) -> bool:
    """Whether the gradient of operand ``t`` may leave sparse: ``t`` is a
    leaf (its gradient is deposited, not propagated) and not the dense
    view of a sparse array."""
    return t.grad_fn is None and not stored_sparse


# -- dot (ref: src/operator/tensor/dot-inl.h) ---------------------------------

class _CsrDot(torch.autograd.Function):
    """``csr (m, k) x rhs (k, n)`` -> dense ``(m, n)``: each entry's
    product summed per row in order."""

    @staticmethod
    def forward(ctx, vals, rhs, rows, cols, lengths, rhs_stored_sparse):
        ctx.save_for_backward(vals, rows, cols)
        ctx.rhs_shape = rhs.shape
        ctx.sparse_out = _sparse_out(rhs, rhs_stored_sparse)
        return segment_sum(vals[:, None] * rhs[cols], lengths)

    @staticmethod
    def backward(ctx, g):
        _no_double_backward()
        vals, rows, cols = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[1]:
            grad = _rhs_grad(vals[:, None] * g[rows], cols, ctx.rhs_shape,
                             ctx.sparse_out)
        return None, grad, None, None, None, None


class _CsrTDot(torch.autograd.Function):
    """``csr (m, k)^T x rhs (m, n)`` -> the values ``(u, n)`` of a
    ``row_sparse (k, n)`` whose rows are the csr's ``u`` distinct columns
    (``perm`` sorts the entries by column, ``lengths`` counts each)."""

    @staticmethod
    def forward(ctx, vals, rhs, rows, perm, inv, lengths, rhs_stored_sparse):
        ctx.save_for_backward(vals, rows, inv)
        ctx.rhs_shape = rhs.shape
        ctx.sparse_out = _sparse_out(rhs, rhs_stored_sparse)
        return segment_sum((vals[:, None] * rhs[rows])[perm], lengths)

    @staticmethod
    def backward(ctx, g_vals):
        _no_double_backward()
        vals, rows, inv = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[1]:
            grad = _rhs_grad(vals[:, None] * g_vals[inv], rows,
                             ctx.rhs_shape, ctx.sparse_out)
        return None, grad, None, None, None, None, None


def _column_segments(cols):
    """``(sorted distinct columns, stable sort order, each entry's
    position among the distinct columns, entries per column)``; the
    count of distinct columns costs one host sync."""
    sidx, perm = torch.sort(cols, stable=True)
    uniq, inv_sorted, counts = torch.unique_consecutive(
        sidx, return_inverse=True, return_counts=True)
    inv = torch.empty_like(inv_sorted)
    inv[perm] = inv_sorted
    return uniq, perm, inv, counts


@register_sparse_op("dot")
def sparse_dot(lhs, rhs, transpose_a=False, transpose_b=False,
               forward_stype=None):
    if not isinstance(lhs, CSRNDArray):
        return NotImplemented
    if transpose_b:
        raise MXNetError("sparse dot: transpose_b is not supported")
    vals = lhs._aux["values"]
    cols = lhs._aux["indices"]
    rows = lhs._row_ids()
    m, k = lhs.shape
    # a row_sparse rhs is read through its dense view, the layout the
    # gather wants; its gradient reaches the values through that view
    stored = isinstance(rhs, RowSparseNDArray)
    rhs_t = rhs._data if isinstance(rhs, NDArray) else rhs
    if not transpose_a:
        iptr = lhs._aux["indptr"]
        return _wrap(_CsrDot.apply(vals, rhs_t, rows, cols,
                                   iptr[1:] - iptr[:-1], stored))
    uniq, perm, inv, counts = _column_segments(cols)
    out_vals = _CsrTDot.apply(vals, rhs_t, rows, perm, inv, counts, stored)
    return RowSparseNDArray(out_vals, uniq, (k, rhs_t.shape[1]))


# -- elementwise on the payload -------------------------------------------------

@register_sparse_op("square")
def sparse_square(data):
    if isinstance(data, CSRNDArray):
        a = data._aux
        return CSRNDArray(torch.square(a["values"]), a["indices"],
                          a["indptr"], data.shape)
    if isinstance(data, RowSparseNDArray):
        return RowSparseNDArray(torch.square(data._aux["values"]),
                                data._aux["indices"], data.shape)
    return NotImplemented


@register_sparse_op("_square_sum")
def sparse_square_sum(data, axis=None, keepdims=False):
    """``row_sparse`` in, ``row_sparse`` out for ``axis=1`` (the FM
    model's v_s term; ref: square_sum-inl.h)."""
    if not isinstance(data, RowSparseNDArray):
        return NotImplemented
    vals = data._aux["values"]
    out = torch.sum(torch.square(vals), 1, keepdim=bool(keepdims))
    shape = (data.shape[0], 1) if keepdims else (data.shape[0],)
    return RowSparseNDArray(out, data._aux["indices"], shape)


@register_sparse_op("_sparse_retain")
def sparse_retain(data, indices):
    if not isinstance(data, RowSparseNDArray):
        return NotImplemented
    return data.retain(indices)


@register_sparse_op("cast_storage")
def sparse_cast_storage(data, stype="default"):
    from .sparse import cast_storage
    return cast_storage(data, stype)


# -- Embedding with sparse_grad (ref: src/operator/tensor/indexing_op.cc) -----

class _SparseEmbedding(torch.autograd.Function):
    """Rows of the table; the table's gradient is one row per id."""

    @staticmethod
    def forward(ctx, weight, ids, weight_stored_sparse):
        from ..ops.tensor import _wrap_index, take_fill
        safe, valid = _wrap_index(ids, weight.shape[0])
        ctx.save_for_backward(safe, valid)
        ctx.shape = weight.shape
        ctx.sparse_out = _sparse_out(weight, weight_stored_sparse)
        return take_fill(weight, ids, 0)

    @staticmethod
    def backward(ctx, g):
        _no_double_backward()
        safe, valid = ctx.saved_tensors
        flat = g.reshape(-1, ctx.shape[1])
        # an id outside the table takes no gradient
        flat = flat * valid.reshape(-1, 1).to(flat.dtype)
        return _rhs_grad(flat, safe.reshape(-1), ctx.shape,
                         ctx.sparse_out), None, None


@register_sparse_op("Embedding")
def sparse_embedding(data, weight, input_dim=0, output_dim=0,
                     dtype="float32", sparse_grad=False, **_ignored):
    if not sparse_grad:
        return NotImplemented
    stored = isinstance(weight, RowSparseNDArray)
    return _wrap(_SparseEmbedding.apply(weight._data, data._data, stored))


_SPARSE_OPS["_contrib_SparseEmbedding"] = \
    lambda data, weight, **kw: sparse_embedding(
        data, weight, **{**kw, "sparse_grad": True})
