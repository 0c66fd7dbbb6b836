"""NDArray: MXNet's array type over one ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. An NDArray holds one
tensor (``_data``) and is not a ``torch.Tensor`` subclass: the layers of
the port run plain torch inside, and an NDArray is unwrapped once at the
boundary (``Block.__call__``, the generated ``nd.<op>`` functions). What
each part maps to:

- the engine's asynchrony is CUDA's stream order: ``wait_to_read``
  synchronizes the array's stream, ``waitall`` the device, and
  ``asnumpy``/``asscalar`` copy to the host (and so wait);
- gradients live on the tensor: ``attach_grad`` makes it a leaf that
  requires a gradient with a zero ``.grad`` and a ``grad_req`` attribute
  (``"write"`` or ``"add"``), which :func:`mxnet_tpu_torch.autograd.backward`
  honours; ``.grad`` is that tensor as an NDArray. With
  ``stype="row_sparse"`` the slot is sparse instead: ``.grad`` is a
  ``RowSparseNDArray`` (:mod:`.sparse`), empty until a backward deposits
  into it;
- an operation outside ``autograd.record()`` runs under ``torch.no_grad()``
  (the reference records nothing there), so ``w[:] = w - lr * w.grad`` or
  ``nd.sgd_update(w, g, out=w)`` may update a parameter in place;
- basic indexing gives a view (writes go through to the base, as the
  reference's write-back does); ``+=`` and the other in-place operators
  write in place outside ``record`` and rebind inside it, where torch
  would refuse an in-place write into a leaf that requires a gradient.

Dtypes follow the JAX package: a Python list becomes float32, a numpy
source keeps its dtype but 64-bit types narrow to 32 bits (int64 ->
int32, float64 -> float32), index-valued outputs (``argmax``,
``argsort``, ``topk``) are float32, and a scalar operand takes the
array's dtype (``int_array + 1.5`` adds 1). An explicit ``dtype=``
is honoured as given.

``asnumpy`` of a bfloat16 array returns float32 values (bfloat16 widens
to float32 exactly; numpy has no bfloat16 of its own), and
``dtype`` of a bfloat16 array is ``torch.bfloat16``; every other
``dtype`` is a numpy dtype. Pickling keeps the values and ``grad_req``;
the array comes back on the CPU.
"""
from __future__ import annotations

import operator
from typing import Optional, Tuple

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError
from ..context import Context, as_device
from ..ops.registry import call_op
from ..ops.tensor import _div, expand_reshape_spec

__all__ = [
    "NDArray", "array", "zeros", "ones", "full", "empty", "arange", "eye",
    "linspace", "concat", "concatenate", "stack", "split", "dot", "save",
    "load", "load_frombuffer", "waitall", "from_numpy", "moveaxis",
    "to_dlpack_for_read", "to_dlpack_for_write", "from_dlpack",
    "as_torch_dtype", "as_numpy_dtype",
]

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NUMPY_OF = {v: k for k, v in _TORCH_DTYPES.items()}
# implicit 64-bit dtypes narrow to 32 bits, as JAX's defaults do
_NARROW = {onp.dtype("int64"): onp.dtype("int32"),
           onp.dtype("uint64"): onp.dtype("uint32"),
           onp.dtype("float64"): onp.dtype("float32"),
           onp.dtype("complex128"): onp.dtype("complex64")}


def as_torch_dtype(dtype) -> Optional[torch.dtype]:
    """A dtype given as a name, a numpy dtype or type, or a torch dtype,
    as a ``torch.dtype`` (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else onp.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def as_numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype; ``torch.bfloat16`` stays itself
    (numpy has none)."""
    if dtype is torch.bfloat16:
        return dtype
    return onp.dtype(_NUMPY_OF[dtype])


def _unwrap(a):
    return a._data if isinstance(a, NDArray) else a


def _wrap(data: torch.Tensor) -> "NDArray":
    out = NDArray.__new__(NDArray)
    out._data = data
    return out


def _wrap_out(res):
    """An op's result as NDArrays: a tensor as one, a tuple or list as a
    list (as the JAX package returns several outputs)."""
    if isinstance(res, torch.Tensor):
        return _wrap(res)
    if isinstance(res, (tuple, list)):
        return [_wrap_out(r) for r in res]
    return res


def _op(fn, tensors, differentiable=True, **kw) -> "NDArray":
    """``fn(*tensors, **kw)`` recorded as an nd op is (see
    :func:`mxnet_tpu_torch.ops.registry.call_op`), wrapped."""
    rec = differentiable and autograd.is_recording()
    return _wrap_out(call_op(fn, rec, *tensors, **kw))


def _host_array(source, dtype) -> onp.ndarray:
    """``source`` as a numpy array of the dtype :func:`array` gives it."""
    if dtype is not None:
        td = as_torch_dtype(dtype)
        if td is torch.bfloat16:
            return onp.asarray(source, dtype=onp.float32)
        return onp.asarray(source, dtype=as_numpy_dtype(td))
    if isinstance(source, (onp.ndarray, onp.generic)):
        a = onp.asarray(source)
        return a.astype(_NARROW[a.dtype]) if a.dtype in _NARROW else a
    # Python lists and scalars default to float32, as in the reference
    return onp.asarray(source, dtype=onp.float32)


def _has_negative_step(key) -> bool:
    keys = key if isinstance(key, tuple) else (key,)
    return any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in keys)


def _dims_of(key, ndim):
    """``key`` as a tuple with the Ellipsis expanded, and the input dim
    each entry indexes (None for a new axis)."""
    keys = list(key) if isinstance(key, tuple) else [key]
    used = sum(1 for k in keys if k is not None and k is not Ellipsis)
    out, dims, d = [], [], 0
    for k in keys:
        if k is Ellipsis:
            for _ in range(ndim - used):
                out.append(slice(None))
                dims.append(d)
                d += 1
        elif k is None:
            out.append(k)
            dims.append(None)
        else:
            out.append(k)
            dims.append(d)
            d += 1
    return out, dims


def _negative_step_get(x, key):
    """``x[key]`` where a slice steps backwards (torch slices step
    forwards only): such an axis is flipped and sliced forwards."""
    keys, dims = _dims_of(key, x.dim())
    flips, fixed = [], []
    for k, d in zip(keys, dims):
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = x.shape[d]
            r = range(*k.indices(n))
            flips.append(d)
            k = slice(n - 1 - r[0], n - r[-1], -k.step) if len(r) \
                else slice(0, 0)
        fixed.append(k)
    return x.flip(flips)[tuple(fixed)]


def _negative_step_index(key, shape):
    """``key`` with its one backward-stepping slice as an index tensor,
    for a write."""
    keys, dims = _dims_of(key, len(shape))
    neg = [i for i, k in enumerate(keys) if isinstance(k, slice)
           and k.step is not None and k.step < 0]
    if len(neg) > 1:
        raise MXNetError("a write through more than one backward-stepping "
                         "slice")
    i = neg[0]
    keys[i] = torch.arange(*keys[i].indices(shape[dims[i]]))
    return tuple(keys)


class NDArray:
    """Multi-dimensional array over one ``torch.Tensor`` (see the module
    docstring)."""

    __slots__ = ("_data",)
    __array_priority__ = 100.0

    def __init__(self, data, ctx=None, dtype=None):
        self._data = array(data, ctx=ctx, dtype=dtype)._data

    # -- properties ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return as_numpy_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def ctx(self) -> Context:
        return Context(self._data.device)

    context = ctx

    @property
    def stype(self) -> str:
        return "default"

    @property
    def grad(self) -> Optional["NDArray"]:
        t = self._data
        sparse = getattr(t, "_mx_sparse_grad", None)
        if sparse is not None:
            return sparse
        g = t.grad
        return None if g is None else _wrap(g)

    @property
    def grad_req(self) -> str:
        if not self._data.requires_grad:
            return "null"
        return getattr(self._data, "grad_req", "write")

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def handle(self) -> torch.Tensor:
        return self._data

    # -- sync and conversion ---------------------------------------------
    def wait_to_read(self):
        """Wait until the work queued on this array's stream is done."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self) -> onp.ndarray:
        """A copy of the values on the host (never a view of a CPU
        array's storage, which a later in-place write would change)."""
        t = self._data.detach()
        if t.dtype is torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __getstate__(self):
        return {"data": self.asnumpy(), "dtype": str(self._data.dtype),
                "grad_req": self.grad_req}

    def __setstate__(self, state):
        t = torch.from_numpy(onp.ascontiguousarray(state["data"]))
        if state.get("dtype") == "torch.bfloat16":
            t = t.to(torch.bfloat16)
        self._data = t
        if state.get("grad_req", "null") != "null":
            self.attach_grad(state["grad_req"])

    def __dlpack__(self, **kwargs):
        return self._data.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def astype(self, dtype, copy=True) -> "NDArray":
        dt = as_torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return _op(lambda x: x.to(dt), [self._data])

    def copy(self) -> "NDArray":
        return _op(torch.clone, [self._data])

    def copyto(self, other) -> "NDArray":
        """A copy on a device (``other`` a Context), or written into the
        NDArray ``other`` in its dtype."""
        if isinstance(other, Context):
            return _op(lambda x: x.to(other.torch_device, copy=True),
                       [self._data])
        if isinstance(other, NDArray):
            other._assign(self._data, autograd.is_recording())
            return other
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, ctx) -> "NDArray":
        dev = as_device(ctx)
        if dev == self._data.device:
            return self
        return _op(lambda x: x.to(dev), [self._data])

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype: str):
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Make this array a variable: a leaf that requires a gradient,
        with a zero ``.grad`` deposited into by ``grad_req``;
        ``stype="row_sparse"`` (or ``"csr"``) makes the slot sparse, an
        empty ``row_sparse`` gradient (see
        :func:`mxnet_tpu_torch.autograd.backward` for the deposit)."""
        if stype not in (None, "default", "row_sparse", "csr"):
            raise MXNetError(f"attach_grad: unknown stype {stype!r}")
        if self._data.grad_fn is not None:
            self._data = self._data.detach()
        t = self._data
        t._mx_grad_stype = t._mx_sparse_grad = None
        if grad_req == "null":
            t.requires_grad_(False)
            t.grad = None
            return
        if grad_req not in ("write", "add"):
            raise MXNetError(f"grad_req {grad_req!r} (write, add or null)")
        t.requires_grad_(True)
        t.grad_req = grad_req
        if stype in ("row_sparse", "csr"):
            from .sparse import zeros as sparse_zeros
            t.grad = None
            t._mx_keep_grad = False
            t._mx_grad_stype = "row_sparse"
            t._mx_sparse_grad = sparse_zeros("row_sparse", self.shape,
                                             ctx=t.device, dtype=t.dtype)
            return
        t.grad = torch.zeros_like(t)
        t._mx_keep_grad = True

    def detach(self) -> "NDArray":
        return _wrap(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- writes ------------------------------------------------------------
    def _assign(self, value, recorded: bool) -> None:
        """Write ``value`` (a tensor, broadcast and cast to this array's
        dtype) into this array: in place into its storage outside
        ``record``, as a recorded rebind inside it."""
        if recorded and autograd.is_recording():
            self._data = value.to(self._data.dtype).expand_as(
                self._data).clone()
            return
        call_op(self._data.copy_, False, value)

    @staticmethod
    def _clean_index(key):
        def one(k):
            if isinstance(k, NDArray):
                k = k._data
            if isinstance(k, torch.Tensor) and k.is_floating_point():
                k = k.long()
            return k
        if isinstance(key, tuple):
            return tuple(one(k) for k in key)
        return one(key)

    def __getitem__(self, key):
        ckey = self._clean_index(key)
        if _has_negative_step(ckey):
            return _op(_negative_step_get, [self._data], key=ckey)
        return _op(lambda x: x[ckey], [self._data])

    def __setitem__(self, key, value):
        ckey = self._clean_index(key)
        if _has_negative_step(ckey):
            ckey = _negative_step_index(ckey, self.shape)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor) \
                and not isinstance(value, (int, float, bool)):
            value = torch.as_tensor(onp.asarray(value),
                                    device=self._data.device)
        if autograd.is_recording():
            new = self._data.clone()
            new[ckey] = value
            self._data = new
            return

        def write(x):
            x[ckey] = value
        call_op(write, False, self._data)

    # -- arithmetic ----------------------------------------------------------
    def _operand(self, other):
        """``other`` as the second operand of a binary op with this
        array: a tensor, or a Python number cast to this array's dtype
        (as the JAX package casts a scalar operand)."""
        if isinstance(other, NDArray):
            return other._data
        if isinstance(other, torch.Tensor):
            return other
        dt = self._data.dtype
        if isinstance(other, (int, float, bool, onp.number)):
            if dt is torch.bool:
                return bool(other)
            if dt.is_floating_point or dt.is_complex:
                return float(other)
            return int(other)
        return torch.as_tensor(onp.asarray(other), device=self._data.device
                               ).to(dt)

    def _binary(self, other, fn):
        return _op(fn, [self._data, self._operand(other)])

    def _rbinary(self, other, fn):
        return _op(lambda b, a: fn(a, b), [self._data, self._operand(other)])

    def __add__(self, o): return self._binary(o, operator.add)
    def __radd__(self, o): return self._rbinary(o, operator.add)
    def __sub__(self, o): return self._binary(o, operator.sub)
    def __rsub__(self, o): return self._rbinary(o, operator.sub)
    def __mul__(self, o): return self._binary(o, operator.mul)
    def __rmul__(self, o): return self._rbinary(o, operator.mul)
    def __truediv__(self, o): return self._binary(o, _div)
    def __rtruediv__(self, o): return self._rbinary(o, _div)
    def __floordiv__(self, o): return self._binary(o, operator.floordiv)
    def __rfloordiv__(self, o): return self._rbinary(o, operator.floordiv)
    def __mod__(self, o): return self._binary(o, operator.mod)
    def __rmod__(self, o): return self._rbinary(o, operator.mod)
    def __pow__(self, o): return self._binary(o, operator.pow)
    def __rpow__(self, o): return self._rbinary(o, operator.pow)
    def __matmul__(self, o): return self._binary(o, operator.matmul)
    def __neg__(self): return _op(operator.neg, [self._data])
    def __abs__(self): return _op(torch.abs, [self._data])

    def _inplace(self, other, fn):
        o = self._operand(other)
        if autograd.is_recording():
            self._data = fn(self._data, o).to(self._data.dtype)
        else:
            self._assign(call_op(fn, False, self._data, o), False)
        return self

    def __iadd__(self, o): return self._inplace(o, operator.add)
    def __isub__(self, o): return self._inplace(o, operator.sub)
    def __imul__(self, o): return self._inplace(o, operator.mul)
    def __itruediv__(self, o): return self._inplace(o, _div)

    def _cmp(self, other, fn):
        dt = self._data.dtype
        return _op(lambda a, b: fn(a, b).to(dt),
                   [self._data, self._operand(other)], differentiable=False)

    def __eq__(self, o):
        if o is None:
            return False
        return self._cmp(o, torch.eq)

    def __ne__(self, o):
        if o is None:
            return True
        return self._cmp(o, torch.ne)

    def __lt__(self, o): return self._cmp(o, torch.lt)
    def __le__(self, o): return self._cmp(o, torch.le)
    def __gt__(self, o): return self._cmp(o, torch.gt)
    def __ge__(self, o): return self._cmp(o, torch.ge)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        shape = "x".join(map(str, self.shape))
        return f"\n{self.asnumpy()}\n<NDArray {shape} @{self.ctx}>"

    # -- shape -------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """Reshape with MXNet's codes: 0 keeps a dim, -1 infers one, -2
        copies the rest, -3 merges two, -4 splits one in two."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        spec = expand_reshape_spec(self.shape, shape)
        return _op(lambda x: x.reshape(spec), [self._data])

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        perm = axes if axes else tuple(reversed(range(self.ndim)))
        return _op(lambda x: x.permute(perm), [self._data])

    def swapaxes(self, a1, a2):
        return _op(lambda x: x.transpose(a1, a2), [self._data])

    def flatten(self):
        n = self.shape[0] if self.ndim > 0 else 1
        return _op(lambda x: x.reshape(n, -1), [self._data])

    def expand_dims(self, axis):
        return _op(lambda x: x.unsqueeze(axis), [self._data])

    def squeeze(self, axis=None):
        from ..ops import tensor as t
        return _op(t.squeeze, [self._data], axis=axis)

    def broadcast_to(self, shape):
        from ..ops import tensor as t
        return _op(t.broadcast_to, [self._data], shape=tuple(shape))

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def tile(self, reps):
        return _op(lambda x: x.tile(tuple(reps)), [self._data])

    def repeat(self, repeats, axis=None):
        from ..ops import tensor as t
        return _op(t.repeat, [self._data], repeats=repeats, axis=axis)

    def pad(self, mode="constant", pad_width=None, constant_value=0):
        from ..ops import nn
        return _op(nn.pad_op, [self._data], mode=mode,
                   pad_width=tuple(pad_width), constant_value=constant_value)

    def slice(self, begin, end, step=None):
        idx = tuple(slice(b, e, s) for b, e, s in
                    zip(begin, end, step or [None] * len(begin)))
        return self[idx]

    def slice_axis(self, axis, begin, end):
        idx = [slice(None)] * self.ndim
        idx[axis] = slice(begin, end)
        return self[tuple(idx)]

    def take(self, indices, axis=0, mode="clip"):
        from ..ops import tensor as t
        ind = _unwrap(indices) if isinstance(indices, (NDArray,
                                                       torch.Tensor)) \
            else torch.as_tensor(indices, device=self._data.device)
        return _op(t.take, [self._data, ind], axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        from ..ops import tensor as t
        return _op(t.pick, [self._data, _unwrap(index)], axis=axis,
                   keepdims=keepdims)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        from ..ops import tensor as t
        return _op(t.one_hot, [self._data], differentiable=False,
                   depth=depth, on_value=on_value, off_value=off_value,
                   dtype=dtype)

    # -- reductions --------------------------------------------------------
    def _reduce(self, opname, axis=None, keepdims=False):
        from ..ops import tensor as t
        return _op(t.REDUCTIONS[opname], [self._data], axis=axis,
                   keepdims=keepdims)

    def sum(self, axis=None, keepdims=False, **kw):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return self._reduce("prod", axis, keepdims)

    def std(self, axis=None, keepdims=False, **kw):
        from ..ops import tensor as t
        return _op(t.moment, [self._data], axis=axis, keepdims=keepdims,
                   std=True)

    def var(self, axis=None, keepdims=False, **kw):
        from ..ops import tensor as t
        return _op(t.moment, [self._data], axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        from ..ops import tensor as t
        return _op(t.norm, [self._data], ord=ord, axis=axis,
                   keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        from ..ops import tensor as t
        return _op(t.argmax, [self._data], differentiable=False, axis=axis,
                   keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        from ..ops import tensor as t
        return _op(t.argmin, [self._data], differentiable=False, axis=axis,
                   keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        from ..ops import tensor as t
        return _op(t.argsort, [self._data], differentiable=False, axis=axis,
                   is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        from ..ops import tensor as t
        return _op(t.sort, [self._data], axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False,
             dtype="float32"):
        from ..ops import tensor as t
        return _op(t.topk, [self._data], differentiable=ret_typ == "value",
                   axis=axis, k=k, ret_typ=ret_typ, is_ascend=is_ascend,
                   dtype=dtype)

    def clip(self, a_min, a_max):
        from ..ops import tensor as t
        return _op(t.clip, [self._data], a_min=a_min, a_max=a_max)

    # -- elementwise -------------------------------------------------------
    def abs(self): return _op(torch.abs, [self._data])
    def sign(self): return _op(torch.sign, [self._data], False)
    def sqrt(self): return _op(torch.sqrt, [self._data])
    def square(self): return _op(torch.square, [self._data])
    def exp(self): return _op(torch.exp, [self._data])
    def log(self): return _op(torch.log, [self._data])
    def relu(self): return _op(torch.relu, [self._data])
    def sigmoid(self): return _op(torch.sigmoid, [self._data])
    def tanh(self): return _op(torch.tanh, [self._data])
    def round(self): return _op(torch.round, [self._data], False)
    def floor(self): return _op(torch.floor, [self._data], False)
    def ceil(self): return _op(torch.ceil, [self._data], False)

    def softmax(self, axis=-1):
        return _op(lambda x: torch.softmax(x, axis), [self._data])

    def log_softmax(self, axis=-1):
        return _op(lambda x: torch.log_softmax(x, axis), [self._data])

    def dot(self, other, transpose_a=False, transpose_b=False):
        return dot(self, other, transpose_a=transpose_a,
                   transpose_b=transpose_b)

    def batch_dot(self, other, transpose_a=False, transpose_b=False):
        from ..ops import tensor as t
        return _op(t.batch_dot, [self._data, _unwrap(other)],
                   transpose_a=transpose_a, transpose_b=transpose_b)

    def zeros_like(self):
        return _op(torch.zeros_like, [self._data], False)

    def ones_like(self):
        return _op(torch.ones_like, [self._data], False)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        from ..ops import tensor as t
        return _op(t.slice_channel, [self._data], num_outputs=num_outputs,
                   axis=axis, squeeze_axis=squeeze_axis)

    def tojson(self):
        raise MXNetError("NDArray has no tojson; use Symbol")


# -- creation ----------------------------------------------------------------

def _shape_of(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, onp.integer)) \
        else tuple(int(s) for s in shape)


def array(source, ctx=None, dtype=None) -> NDArray:
    """An NDArray of ``source`` (an NDArray, a tensor, a numpy array, a
    list or a scalar) on ``ctx`` (default :func:`current_context`); see
    the module docstring for the dtype."""
    dev = as_device(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach()
        if dtype is not None:
            t = t.to(as_torch_dtype(dtype))
        elif t.dtype is torch.int64:
            t = t.to(torch.int32)
        elif t.dtype is torch.float64:
            t = t.to(torch.float32)
        return _wrap(t.to(dev, copy=True))
    host = onp.asarray(_host_array(source, dtype), order="C")
    if not host.flags.writeable:
        host = host.copy()
    t = torch.from_numpy(host)
    if as_torch_dtype(dtype) is torch.bfloat16:
        t = t.to(torch.bfloat16)
    # a copy on the CPU too: the array must not share the source's memory
    return _wrap(t.to(dev, copy=True))


def from_numpy(a, zero_copy=False) -> NDArray:
    return array(a, dtype=a.dtype)


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    return _wrap(torch.empty(_shape_of(shape), dtype=as_torch_dtype(dtype),
                             device=as_device(ctx)))


def zeros(shape, ctx=None, dtype="float32", **kwargs) -> NDArray:
    return _wrap(torch.zeros(_shape_of(shape), dtype=as_torch_dtype(dtype),
                             device=as_device(ctx)))


def ones(shape, ctx=None, dtype="float32", **kwargs) -> NDArray:
    return _wrap(torch.ones(_shape_of(shape), dtype=as_torch_dtype(dtype),
                            device=as_device(ctx)))


def full(shape, val, ctx=None, dtype="float32") -> NDArray:
    return _wrap(torch.full(_shape_of(shape), val,
                            dtype=as_torch_dtype(dtype),
                            device=as_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    from ..ops.extra_ops import _arange
    return _wrap(_arange(start, stop, step, repeat, ctx=ctx, dtype=dtype))


def eye(N, M=0, k=0, ctx=None, dtype="float32") -> NDArray:
    from ..ops.extra_ops import _eye
    return _wrap(_eye(N, M, k, ctx=ctx, dtype=dtype))


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype="float32") -> NDArray:
    from ..ops.extra_ops import _linspace
    return _wrap(_linspace(start, stop, num, endpoint, ctx=ctx, dtype=dtype))


def concat(*arrays, dim=1, **kwargs) -> NDArray:
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = arrays[0]
    return _op(lambda *xs: torch.cat(xs, dim), [_unwrap(a) for a in arrays])


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return _op(lambda *xs: torch.cat(xs, axis), [_unwrap(a) for a in arrays])


def stack(*arrays, axis=0) -> NDArray:
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = arrays[0]
    return _op(lambda *xs: torch.stack(xs, axis),
               [_unwrap(a) for a in arrays])


def split(ary, indices_or_sections, axis=0):
    from ..ops.tensor import split_v2
    return _op(split_v2, [_unwrap(ary)],
               indices_or_sections=indices_or_sections, axis=axis)


def dot(lhs, rhs, transpose_a=False, transpose_b=False) -> NDArray:
    """The matrix product; a ``csr`` ``lhs`` takes the sparse product
    (:mod:`.sparse_ops`), another sparse operand its dense view."""
    from ..ops.registry import _sparse_hook
    from ..ops.tensor import dot as _dot
    res = _sparse_hook("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                           "transpose_b": transpose_b})
    if res is not NotImplemented:
        return res
    return _op(_dot, [_unwrap(lhs), _unwrap(rhs)], transpose_a=transpose_a,
               transpose_b=transpose_b)


def moveaxis(tensor, source, destination) -> NDArray:
    return _op(lambda x: torch.movedim(x, source, destination),
               [_unwrap(tensor)])


def waitall() -> None:
    """Wait for every queued operation on every CUDA device."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- files (MXNet's .params format, ndarray/serialization.py) -----------------

def save(fname: str, data) -> None:
    """Write an NDArray (or tensor), a list of them or a ``{name: array}``
    dict to ``fname`` in MXNet's format (``mx.nd.save``); a sparse array
    is written as its payload."""
    from . import serialization
    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]

    def entry(v):
        return v if getattr(v, "stype", "default") != "default" \
            else _unwrap(v)
    if isinstance(data, dict):
        data = {k: entry(v) for k, v in data.items()}
    else:
        data = [entry(v) for v in data]
    serialization.save(fname, data)


def load_frombuffer(buf: bytes, ctx=None):
    """The arrays of a file's bytes as NDArrays on ``ctx`` (default
    :func:`current_context`; a sparse entry as a ``RowSparseNDArray`` or
    a ``CSRNDArray``): a ``{name: array}`` dict where the file names them,
    else a list."""
    from . import serialization
    dev = as_device(ctx)
    arrays, names = serialization.load_buffer(buf)
    arrays = [None if a is None else
              a.as_in_context(dev) if getattr(a, "stype", "default")
              != "default" else _wrap(a.to(dev)) for a in arrays]
    if names:
        return dict(zip(names, arrays))
    return arrays


def load(fname: str, ctx=None):
    """``mx.nd.load``: see :func:`load_frombuffer`."""
    dev = as_device(ctx)
    with open(fname, "rb") as f:
        return load_frombuffer(f.read(), dev)


# -- DLPack ------------------------------------------------------------------

def to_dlpack_for_read(data: NDArray):
    """A DLPack capsule sharing the array's storage, after its stream's
    pending work."""
    data.wait_to_read()
    return torch.utils.dlpack.to_dlpack(data._data.detach())


def to_dlpack_for_write(data: NDArray):
    """A DLPack capsule sharing the array's storage; a consumer's writes
    show in the array (torch storage is mutable)."""
    data.wait_to_read()
    return torch.utils.dlpack.to_dlpack(data._data.detach())


def from_dlpack(dlpack) -> NDArray:
    """An NDArray over the storage of any DLPack producer (an object with
    ``__dlpack__``, or a capsule), zero-copy."""
    return _wrap(torch.utils.dlpack.from_dlpack(dlpack))

