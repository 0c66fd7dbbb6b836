"""NDArray-level functions of the port: ``save``/``load`` of tensors in
MXNet's ``.params`` format (:mod:`.serialization`). The ``mx.nd`` surface
itself (an NDArray over ``torch.Tensor`` and its ops) comes with the
``mx.nd`` slice (ROADMAP Queue A item 3)."""
from .serialization import load, load_frombuffer, save  # noqa: F401

__all__ = ["save", "load", "load_frombuffer"]
