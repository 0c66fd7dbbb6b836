"""The ``sym`` namespace: Symbol and one function per registered op.

Counterpart of ``mxnet_tpu/symbol/__init__.py``: ``sym.<op>`` is made
from the port's op registry (:func:`~.symbol.make_symbol_function`), an op
registered after import appears on first access, and ``sym.contrib``
names the ``_contrib_*`` ops without their prefix, and ``foreach``,
``while_loop`` and ``cond``.
"""
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the op corpus)
from ..ops.registry import has_op as _has_op, list_ops as _list_ops
from .symbol import (  # noqa: F401
    Symbol, Variable, var, Group, load, load_json, zeros, ones,
    make_symbol_function as _make,
)

_mod = _sys.modules[__name__]
for _name in _list_ops():
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make(_name))


def __getattr__(name):
    """An op registered after import, made on first access."""
    if _has_op(name):
        fn = _make(name)
        setattr(_mod, name, fn)
        return fn
    raise AttributeError(f"module 'mxnet_tpu_torch.symbol' has no "
                         f"attribute {name!r}")


class _Contrib:
    """``sym.contrib``: the control-flow builders and the ``_contrib_<name>``
    ops as ``<name>``."""

    def __getattr__(self, name):
        if name in ("foreach", "while_loop", "cond"):
            from . import control_flow as _cf
            return getattr(_cf, name)
        for cand in (f"_contrib_{name}", name):
            if _has_op(cand):
                return getattr(_mod, cand)
        raise AttributeError(name)


contrib = _Contrib()
