"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu.

The JAX package ``mxnet_tpu`` is the reference this package is held
against; the two share module names so that each counterpart can be
found, but this package imports neither JAX nor ``mxnet_tpu``. Entry
points default to CUDA (``device="cuda"``, ``mx.gpu(0)`` as the current
context) and raise without a GPU unless the caller names the CPU
(``device="cpu"``, ``with mx.cpu():``). The hand-written kernels (the
flash-attention forward and backward, mixed-precision SGD) live in
``csrc/`` and are built at first use.

``import mxnet_tpu_torch as mx`` gives MXNet's namespaces: ``mx.nd``
(NDArray and the op corpus), ``mx.autograd``, ``mx.gluon``,
``mx.metric``, ``mx.random``, ``mx.initializer``, ``mx.optimizer``,
``mx.lr_scheduler``, ``mx.sym`` (Symbol and its op corpus), ``mx.mod``
(Module, BucketingModule, SequentialModule), ``mx.rnn`` (the symbolic
recurrent cells), ``mx.io`` (with the record iterators),
``mx.recordio``, ``mx.image`` (``mx.img``), ``mx.model``,
``mx.callback``, ``mx.name``, ``mx.AttrScope``, and ``mx.cpu()`` /
``mx.gpu(i)``.
"""
from . import autograd, initializer, lr_scheduler, optimizer  # noqa: F401
from . import metric, ndarray, random  # noqa: F401
from . import attribute, name, symbol  # noqa: F401
from . import callback, executor, executor_manager, io, model  # noqa: F401
from . import module  # noqa: F401
from . import rnn  # noqa: F401
from . import gluon  # noqa: F401
from . import image, recordio  # noqa: F401
from . import image as img  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import (Context, cpu, current_context, gpu,  # noqa: F401
                      num_gpus, resolve_device)

nd = ndarray
sym = symbol
mod = module
init = initializer

__version__ = "0.1.0"
__all__ = ["MXNetError", "resolve_device", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "nd", "ndarray", "autograd",
           "gluon", "metric", "random", "initializer", "optimizer",
           "lr_scheduler", "sym", "symbol", "mod", "module", "io", "model",
           "callback", "executor", "executor_manager", "name", "attribute",
           "rnn", "AttrScope", "init", "image", "img", "recordio"]
