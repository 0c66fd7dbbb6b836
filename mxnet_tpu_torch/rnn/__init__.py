"""``mx.rnn``: the symbolic recurrent cells for ``Module`` and
``BucketingModule``, bucketed sequence IO and cell-aware checkpoints.

Counterpart of ``mxnet_tpu/rnn/``."""
from .rnn_cell import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
