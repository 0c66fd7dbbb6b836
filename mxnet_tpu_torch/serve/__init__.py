"""mxnet_tpu_torch.serve: dynamic-batching inference serving.

- :mod:`~mxnet_tpu_torch.serve.buckets` — shape bucketing: pad requests
  onto a closed ladder of batch/sequence shapes, so after warmup no
  request brings a new padded signature;
- :mod:`~mxnet_tpu_torch.serve.batcher` — thread-safe dynamic
  micro-batching: max batch, max linger, per-request deadlines, bounded
  queue with load-shed backpressure;
- :mod:`~mxnet_tpu_torch.serve.engine` — :class:`ServingEngine`: warmup
  over every ladder rung and double-buffered host staging, over a
  ``torch.nn.Module`` or a plain callable;
- :mod:`~mxnet_tpu_torch.serve.loadgen` — closed- and open-loop load;
- :mod:`~mxnet_tpu_torch.serve.endpoint` — :class:`ModelRegistry`
  (version pinning, atomic swap) and :class:`ServingEndpoint`, the HTTP
  JSON front door over ``ThreadingHTTPServer``.

Autoregressive LMs are served by :mod:`mxnet_tpu_torch.serve2`.
"""
from .batcher import (BatcherStoppedError, DeadlineExceededError,  # noqa: F401
                      DynamicBatcher, InvalidRequestError,
                      QueueFullError, RequestTooLargeError, Request)
from .buckets import (BucketLadder, BucketOverflowError,  # noqa: F401
                      default_ladder, parse_bucket_spec)
from .engine import InputSpec, ServingEngine  # noqa: F401
from .endpoint import ModelRegistry, ServingEndpoint  # noqa: F401
from .loadgen import run_loadgen, run_loadgen_open  # noqa: F401

__all__ = [
    "BucketLadder", "BucketOverflowError", "parse_bucket_spec",
    "default_ladder", "DynamicBatcher", "Request", "QueueFullError",
    "DeadlineExceededError", "BatcherStoppedError",
    "RequestTooLargeError", "InvalidRequestError", "ServingEngine",
    "InputSpec", "run_loadgen", "run_loadgen_open", "ModelRegistry",
    "ServingEndpoint",
]
