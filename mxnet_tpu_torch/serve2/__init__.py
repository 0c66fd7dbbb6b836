"""mxnet_tpu_torch.serve2: autoregressive LM serving with continuous
batching over a paged KV cache.

Counterpart of ``mxnet_tpu/serve2/``:

- :mod:`~mxnet_tpu_torch.serve2.kvcache` — fixed-size KV pages,
  per-sequence block tables, a refcounting host allocator (page 0 is the
  null page);
- :mod:`~mxnet_tpu_torch.serve2.prefix` — the prefix cache: full prompt
  pages content-hashed and shared, copy-on-write;
- :mod:`~mxnet_tpu_torch.serve2.decode` — :class:`PagedLM`: the
  ``pipeline_lm`` stack as prefill, decode and verify over pools written
  in place (f32, bf16 or int8 pages);
- :mod:`~mxnet_tpu_torch.serve2.scheduler` — :class:`DecodeEngine`:
  iteration-level batching, recompute preemption, speculative decoding
  with exact greedy acceptance, behind ``predict``/``submit``;
- :mod:`~mxnet_tpu_torch.serve2.router` — :class:`Router`: replicas per
  model group, breaker-aware routing, rolling reload.

The HTTP front door is :class:`~mxnet_tpu_torch.serve.ServingEndpoint`;
``passes/servelint.py`` lints the engines' reports and page audits.
"""
from .kvcache import (BlockTable, PageAllocator,  # noqa: F401
                      PagePoolExhausted, pages_needed)
from .prefix import PrefixCache, page_keys  # noqa: F401
from .decode import KV_DTYPES, PagedLM, decode_rungs_for  # noqa: F401
from .scheduler import (DecodeEngine, EngineCrashedError,  # noqa: F401
                        GenerationHandle)
from .router import (AllReplicasUnavailable, RoutedModel,  # noqa: F401
                     Router)

__all__ = [
    "BlockTable", "PageAllocator", "PagePoolExhausted", "pages_needed",
    "PrefixCache", "page_keys", "KV_DTYPES",
    "PagedLM", "decode_rungs_for", "DecodeEngine", "EngineCrashedError",
    "GenerationHandle",
    "Router", "RoutedModel", "AllReplicasUnavailable",
]
