"""Sparse NDArrays: ``row_sparse`` and ``csr``.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (the reference's
``python/mxnet/ndarray/sparse.py``). A sparse array holds its compact
payload as plain torch tensors on one device: ``values`` and ``indices``
(int64 inside; ``.indices`` and ``.indptr`` show them as int32 NDArrays,
as the JAX package does), and ``indptr`` for csr. The sparse code paths
(the sparse ``dot``, ``square``, ``_square_sum``, ``retain``, the lazy
optimizer updates, ``.params`` files) read the payload only. The dense
view is built the first time a dense op reads ``_data`` (the reference's
storage fallback, which warns through :func:`log_storage_fallback`), and
:meth:`BaseSparseNDArray.densified` says whether that happened. A
``repr`` shows the payload's sizes and builds nothing.

A dense write into the array (``_data = ...``, ``out=``, a dense
optimizer step) marks the payload stale; the next payload read extracts
it again from the dense view, so a sparse reader never sees old values.
Everything runs on the payload's device: a cast from dense finds the
nonzero rows there (one host sync for their count), and a csr's per-entry
row ids come from ``repeat_interleave`` with the known output size (no
sync).
"""
from __future__ import annotations

import warnings
import weakref

import numpy as onp
import torch

from .. import config
from ..base import MXNetError
from ..context import Context, as_device
from .ndarray import NDArray, _wrap, array as _dense_array, \
    as_numpy_dtype, as_torch_dtype

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros",
           "log_storage_fallback"]

_fallback_warned = set()


def log_storage_fallback(op_name: str) -> None:
    """Warn (once per op) that a sparse input runs through the op's dense
    implementation; ``MXNET_STORAGE_FALLBACK_LOG_VERBOSE=0`` silences it
    (the reference's ``LogStorageFallback``)."""
    if not config.get("MXNET_STORAGE_FALLBACK_LOG_VERBOSE"):
        return
    if op_name in _fallback_warned:
        return
    _fallback_warned.add(op_name)
    warnings.warn(
        f"op {op_name}: sparse input falls back to the dense "
        "implementation (set MXNET_STORAGE_FALLBACK_LOG_VERBOSE=0 to "
        "silence)", stacklevel=3)


def _index_tensor(x, device) -> torch.Tensor:
    """``x`` (an NDArray, a tensor, a numpy array or a list) as an int64
    tensor on ``device``."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.int64)
    return torch.as_tensor(onp.asarray(x, dtype=onp.int64), device=device)


def _value_tensor(x, ctx=None) -> torch.Tensor:
    """``x`` as a tensor on ``ctx`` (an NDArray's or a tensor's own device
    when ``ctx`` is None; a numpy array or a list takes
    :func:`~mxnet_tpu_torch.ndarray.array`'s dtype rules and the current
    context)."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x if ctx is None else x.to(as_device(ctx))
    return _dense_array(x, ctx=ctx)._data


_WIDER = {torch.float32: torch.float64, torch.float16: torch.float32,
          torch.bfloat16: torch.float32}


def segment_sum(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The sums of consecutive segments of ``lengths`` rows of ``values``,
    each summed in order by one thread (no atomics: the same bits in every
    run) in the next wider float type and rounded once, so that a row
    that sums hundreds of terms is within an ulp or two of the exact sum
    (a sum in the values' own type drifts with the count)."""
    if values.shape[0] == 0:
        return values.new_zeros((lengths.numel(),) + values.shape[1:])
    wide = _WIDER.get(values.dtype, values.dtype)
    return torch.segment_reduce(values.to(wide), "sum", lengths=lengths,
                                axis=0, unsafe=True).to(values.dtype)


def merge_rows(values: torch.Tensor, indices: torch.Tensor):
    """``(sorted unique indices, values summed per index)``: a stable sort,
    then :func:`segment_sum` of each index's values in their input order,
    so the result has the same bits in every run. The count of unique
    rows costs one host sync."""
    if indices.numel() == 0:
        return indices.to(torch.int64), values
    sidx, perm = torch.sort(indices.to(torch.int64), stable=True)
    uniq, counts = torch.unique_consecutive(sidx, return_counts=True)
    return uniq, segment_sum(values[perm], counts)


class BaseSparseNDArray(NDArray):
    """The payload, the lazily built dense view and the gradient slot
    shared by both storage types."""

    __slots__ = ("_aux_store", "_dense_cache", "_shape", "_payload_stale",
                 "__weakref__")

    def _init_base(self, shape):
        self._shape = tuple(int(s) for s in shape)
        self._dense_cache = None
        self._payload_stale = False

    # the dense view every generic op reads; sparse-aware code never does
    @property
    def _data(self):
        d = self._dense_cache
        if d is not None:
            return d
        d = self._densify()
        # a view that carries a gradient to the payload is built anew for
        # each reader (it belongs to one recorded graph)
        if not d.requires_grad:
            self._dense_cache = d
        return d

    @_data.setter
    def _data(self, v):
        self._dense_cache = v
        self._payload_stale = True

    @property
    def _aux(self):
        if self._payload_stale:
            self._aux_store = self._payload_of(self._dense_cache.detach())
            self._payload_stale = False
        return self._aux_store

    @_aux.setter
    def _aux(self, v):
        self._aux_store = v
        self._payload_stale = False

    def _dense_for_write(self) -> torch.Tensor:
        """The dense view, for a caller that writes into it in place: the
        payload is read from it again afterwards."""
        d = self._data
        self._dense_cache = d
        self._payload_stale = True
        return d

    def _assign(self, value, recorded: bool) -> None:
        self._data = value.to(self.dtype_torch).expand(self._shape).clone()

    def densified(self) -> bool:
        """Whether the dense view has been built."""
        return self._dense_cache is not None

    # -- properties ------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @property
    def dtype_torch(self) -> torch.dtype:
        return self._aux["values"].dtype

    @property
    def dtype(self):
        return as_numpy_dtype(self.dtype_torch)

    @property
    def size(self) -> int:
        return int(onp.prod(self._shape)) if self._shape else 1

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def ctx(self) -> Context:
        return Context(self._aux["values"].device)

    context = ctx

    @property
    def device(self) -> torch.device:
        return self._aux["values"].device

    @property
    def data(self) -> NDArray:
        return _wrap(self._aux["values"])

    @property
    def indices(self) -> NDArray:
        return _wrap(self._aux["indices"].to(torch.int32))

    # -- gradient slot (a sparse leaf: its values are the torch leaf) ----
    @property
    def grad(self):
        return getattr(self._aux["values"], "_mx_sparse_grad", None)

    @property
    def grad_req(self) -> str:
        v = self._aux["values"]
        return getattr(v, "grad_req", "write") if v.requires_grad \
            else "null"

    def attach_grad(self, grad_req: str = "write", stype=None):
        """Make the payload's values the leaf: after a backward ``.grad``
        is a ``row_sparse`` array on this array's indices (its values
        the gradient of the values)."""
        v = self._aux["values"]
        if v.grad_fn is not None:
            v = v.detach()
            self._aux["values"] = v
        if grad_req == "null":
            v.requires_grad_(False)
            v._mx_grad_stype = None
            return
        if grad_req not in ("write", "add"):
            raise MXNetError(f"grad_req {grad_req!r} (write, add or null)")
        v.requires_grad_(True)
        v.grad = None
        v.grad_req = grad_req
        v._mx_grad_stype = "payload"
        v._mx_owner = weakref.ref(self)
        v._mx_sparse_grad = zeros("row_sparse", self._shape, ctx=v.device,
                                  dtype=v.dtype)

    # -- conversion ------------------------------------------------------
    def asnumpy(self) -> onp.ndarray:
        return _wrap(self._data).asnumpy()

    def as_in_context(self, ctx):
        dev = as_device(ctx)
        if dev == self.device:
            return self
        return self._like({k: v.to(dev) for k, v in self._aux.items()})

    as_in_ctx = as_in_context

    def copy(self):
        return self._like({k: v.detach().clone()
                           for k, v in self._aux.items()})

    def __getstate__(self):
        out = {"shape": self._shape, "dtype": str(self.dtype_torch)}
        for k in self._AUX:
            v = self._aux[k].detach()
            out[k] = (v.float() if v.dtype is torch.bfloat16 else v) \
                .cpu().numpy()
        return out

    def __setstate__(self, state):
        aux = {k: torch.from_numpy(onp.ascontiguousarray(state[k]))
               for k in self._AUX}
        if state["dtype"] == "torch.bfloat16":
            aux["values"] = aux["values"].to(torch.bfloat16)
        self._init_base(state["shape"])
        self._aux = aux

    def __repr__(self):
        shape = "x".join(map(str, self._shape))
        return (f"\n<{type(self).__name__} {shape} @{self.ctx} "
                f"({self._aux['values'].shape[0]} stored)>")

    def _like(self, aux):
        out = type(self).__new__(type(self))
        out._init_base(self._shape)
        out._aux = aux
        return out


class RowSparseNDArray(BaseSparseNDArray):
    """``values: (nnz_rows,) + shape[1:]``, ``indices: (nnz_rows,)``.
    Duplicate indices are allowed and sum in the dense view (gradient
    accumulation semantics)."""

    __slots__ = ()
    _AUX = ("values", "indices")

    def __init__(self, data, indices, shape, ctx=None):
        if shape is None:
            raise MXNetError("row_sparse_array requires an explicit shape")
        self._init_base(shape)
        values = _value_tensor(data, ctx)
        self._aux = {"values": values,
                     "indices": _index_tensor(indices, values.device)}

    @property
    def stype(self):
        return "row_sparse"

    def _densify(self):
        vals = self._aux["values"]
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        return dense.index_put((self._aux["indices"],), vals,
                               accumulate=True)

    @staticmethod
    def _payload_of(dense):
        nz = (dense != 0).reshape(dense.shape[0], -1).any(1).nonzero()[:, 0]
        return {"values": dense[nz], "indices": nz}

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return _wrap(self._data)
        raise MXNetError(f"cast_storage row_sparse->{stype} unsupported")

    def retain(self, indices) -> "RowSparseNDArray":
        """The rows ``indices`` (in that order): each row's first stored
        slot, zeros for a row with none. A sort and a binary search, on
        the device."""
        vals, own = self._aux["values"], self._aux["indices"]
        want = _index_tensor(indices, vals.device)
        if own.numel() == 0:
            return RowSparseNDArray(
                vals.new_zeros((want.numel(),) + vals.shape[1:]), want,
                self._shape)
        order = torch.argsort(own, stable=True)
        sorted_own = own[order]
        pos = torch.searchsorted(sorted_own, want).clamp_(max=own.numel() - 1)
        has = sorted_own[pos] == want
        got = vals[order[pos]]
        got = torch.where(has.reshape((-1,) + (1,) * (vals.dim() - 1)), got,
                          torch.zeros((), dtype=vals.dtype,
                                      device=vals.device))
        return RowSparseNDArray(got, want, self._shape)


class CSRNDArray(BaseSparseNDArray):
    """2-D compressed rows: ``data: (nnz,)``, ``indices: (nnz,)`` column
    ids, ``indptr: (rows + 1,)``."""

    __slots__ = ()
    _AUX = ("values", "indices", "indptr")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        if shape is None:
            raise MXNetError("csr_matrix requires an explicit shape")
        if len(shape) != 2:
            raise MXNetError("csr requires 2D")
        self._init_base(shape)
        values = _value_tensor(data, ctx)
        self._aux = {"values": values,
                     "indices": _index_tensor(indices, values.device),
                     "indptr": _index_tensor(indptr, values.device)}

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self) -> NDArray:
        return _wrap(self._aux["indptr"].to(torch.int32))

    def _row_ids(self) -> torch.Tensor:
        """Each stored entry's row, expanded from ``indptr`` on the
        device (memoized)."""
        aux = self._aux
        rows = aux.get("_row_ids")
        if rows is None:
            iptr = aux["indptr"]
            rows = torch.repeat_interleave(
                torch.arange(self._shape[0], device=iptr.device),
                iptr[1:] - iptr[:-1], output_size=aux["values"].shape[0])
            aux["_row_ids"] = rows
        return rows

    def _densify(self):
        vals = self._aux["values"]
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        return dense.index_put((self._row_ids(), self._aux["indices"]),
                               vals, accumulate=True)

    @staticmethod
    def _payload_of(dense):
        nz = dense.nonzero()
        counts = torch.bincount(nz[:, 0], minlength=dense.shape[0])
        indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                             device=dense.device)
        torch.cumsum(counts, 0, out=indptr[1:])
        return {"values": dense[nz[:, 0], nz[:, 1]], "indices": nz[:, 1],
                "indptr": indptr}

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return _wrap(self._data)
        raise MXNetError(f"cast_storage csr->{stype} unsupported")

    def slice(self, start, stop) -> "CSRNDArray":
        """Rows ``[start, stop)`` on the compact payload (reads two
        entries of ``indptr`` on the host)."""
        iptr = self._aux["indptr"]
        lo, hi = (int(v) for v in iptr[[start, stop]].tolist())
        return CSRNDArray(self._aux["values"][lo:hi],
                          self._aux["indices"][lo:hi],
                          iptr[start:stop + 1] - lo,
                          (stop - start, self._shape[1]))

    def _like(self, aux):
        aux = {k: v for k, v in aux.items() if not k.startswith("_")}
        return super()._like(aux)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A ``row_sparse`` array from ``(data, indices)`` (with ``shape``) or
    from a dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if dtype is not None and not isinstance(data, NDArray):
            data = _dense_array(data, ctx=ctx, dtype=dtype)
        return RowSparseNDArray(data, indices, shape, ctx=ctx)
    return cast_storage(_dense_array(arg1, ctx=ctx, dtype=dtype),
                        "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A ``csr`` array from ``(data, indices, indptr)`` (with ``shape``)
    or from a dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if dtype is not None and not isinstance(data, NDArray):
            data = _dense_array(data, ctx=ctx, dtype=dtype)
        return CSRNDArray(data, indices, indptr, shape, ctx=ctx)
    return cast_storage(_dense_array(arg1, ctx=ctx, dtype=dtype), "csr")


def cast_storage(arr: NDArray, stype: str):
    """``arr`` in storage ``stype`` (``default``, ``row_sparse`` or
    ``csr``), computed on its device (ref: cast_storage.cc)."""
    if stype == "default":
        return _wrap(arr._data)
    if getattr(arr, "stype", "default") == stype:
        return arr
    if stype not in ("row_sparse", "csr"):
        raise MXNetError(f"unknown stype {stype}")
    dense = arr._data.detach()
    if stype == "csr" and dense.dim() != 2:
        raise MXNetError("csr requires 2D")
    cls = RowSparseNDArray if stype == "row_sparse" else CSRNDArray
    out = cls.__new__(cls)
    out._init_base(dense.shape)
    out._aux = cls._payload_of(dense)
    return out


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero array of ``stype``: nothing stored."""
    shape = (int(shape),) if isinstance(shape, (int, onp.integer)) \
        else tuple(int(s) for s in shape)
    if stype == "default":
        from .ndarray import zeros as dense_zeros
        return dense_zeros(shape, ctx, dtype)
    dev = as_device(ctx)
    dt = as_torch_dtype(dtype)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev), empty,
            shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros(0, dtype=dt, device=dev), empty,
                          torch.zeros(shape[0] + 1, dtype=torch.int64,
                                      device=dev), shape)
    raise MXNetError(f"unknown stype {stype}")

