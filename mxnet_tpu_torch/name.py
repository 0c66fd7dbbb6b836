"""Automatic symbol naming: ``NameManager`` and ``Prefix``.

Counterpart of ``mxnet_tpu/name.py``: the context managers that give an
op created without a ``name`` its ``<op><n>`` name, so that a graph built
the same way in either package names its nodes alike."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]

_state = threading.local()


def _stack():
    st = getattr(_state, "stack", None)
    if st is None:
        st = _state.stack = [NameManager()]
    return st


class NameManager:
    """Assigns names to operators created without an explicit name
    (ref: name.py NameManager). Use as a context manager:

        with mx.name.NameManager():
            net = mx.sym.FullyConnected(x, num_hidden=8)
    """

    def __init__(self):
        self._counter = {}

    @staticmethod
    def current() -> "NameManager":
        return _stack()[-1]

    def get(self, name, hint: str) -> str:
        """Return `name` if given, else '<hint><n>' with a per-manager
        counter (ref: NameManager.get)."""
        if name:
            return name
        self._counter[hint] = self._counter.get(hint, -1) + 1
        return f"{hint}{self._counter[hint]}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


class Prefix(NameManager):
    """NameManager that prepends a prefix to every auto name
    (ref: name.py Prefix):

        with mx.name.Prefix("encoder_"):
            h = mx.sym.FullyConnected(x, num_hidden=8)
            # h.name == "encoder_fullyconnected0"
    """

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint: str) -> str:
        if name:
            return name
        return self._prefix + super().get(None, hint)
