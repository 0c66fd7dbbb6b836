"""Attribute scoping for symbol construction: ``AttrScope``.

Counterpart of ``mxnet_tpu/attribute.py``: the scope attaches its
attributes (``ctx_group``, ``__layout__``, ...) to every symbol created
inside it."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]

_state = threading.local()


def _stack():
    st = getattr(_state, "stack", None)
    if st is None:
        st = _state.stack = [AttrScope()]
    return st


class AttrScope:
    """Attach attributes to symbols created within the scope
    (ref: attribute.py AttrScope; used for model-parallel ctx_group):

        with mx.AttrScope(ctx_group="dev1"):
            h = mx.sym.FullyConnected(x, num_hidden=128)
        h.attr("ctx_group")  # -> "dev1"

    Nested scopes merge, inner keys winning.
    """

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings")
        self._attrs = dict(kwargs)

    @staticmethod
    def current() -> "AttrScope":
        return _stack()[-1]

    def get(self, attrs=None) -> dict:
        """Merge scope attrs with explicit `attrs` (explicit wins)."""
        out = dict(self._attrs)
        if attrs:
            out.update(attrs)
        return out

    def __enter__(self):
        merged = AttrScope()
        merged._attrs = {**_stack()[-1]._attrs, **self._attrs}
        _stack().append(merged)
        self._pushed = merged
        return self

    def __exit__(self, *exc):
        _stack().pop()
