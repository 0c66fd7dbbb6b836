"""The ``mx.nd`` namespace: NDArray, its creation functions, and one
function per registered op, generated from the registry
(:func:`mxnet_tpu_torch.ops.registry.make_nd_function`), as the
reference generates its ``nd`` functions at import.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``. An op registered after
this module is imported appears on first access (``__getattr__``).
``nd.random`` is :mod:`mxnet_tpu_torch.random`; ``nd.contrib`` names the
``_contrib_*`` ops without their prefix. ``save``/``load`` read and write
MXNet's ``.params`` format (:mod:`.serialization`). ``nd.sparse`` holds
the sparse storage types (:mod:`.sparse`: ``row_sparse_array``,
``csr_matrix``, ``cast_storage``, ``zeros``), whose ops are in
:mod:`.sparse_ops`.
"""
import sys as _sys

from .ndarray import (  # noqa: F401
    NDArray, array, zeros, ones, full, empty, arange, eye, linspace,
    concat, concatenate, stack, split, dot, save, load, load_frombuffer,
    waitall, from_numpy, moveaxis, to_dlpack_for_read, to_dlpack_for_write,
    from_dlpack,
)
from .. import ops as _ops  # noqa: F401  (registers the op corpus)
from .. import random  # noqa: F401
from . import sparse, sparse_ops  # noqa: F401
from ..ops.registry import (has_op as _has_op, list_ops as _list_ops,
                            make_nd_function as _make)

_this_module = _sys.modules[__name__]
for _name in _list_ops():
    if not hasattr(_this_module, _name):
        setattr(_this_module, _name, _make(_name))


def __getattr__(name):
    """An op registered after import, made on first access."""
    if _has_op(name):
        fn = _make(name)
        setattr(_this_module, name, fn)
        return fn
    raise AttributeError(f"module 'mxnet_tpu_torch.ndarray' has no "
                         f"attribute {name!r}")


class _Contrib:
    """``nd.contrib``: the ``_contrib_<name>`` ops as ``<name>``."""

    def __getattr__(self, name):
        for cand in (f"_contrib_{name}", name):
            if _has_op(cand):
                return getattr(_this_module, cand)
        raise AttributeError(name)


contrib = _Contrib()
