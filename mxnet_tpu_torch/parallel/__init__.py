"""Attention oracles and the dense LM stack of the port (context,
pipeline and tensor parallelism come later). Paged attention is in
:mod:`mxnet_tpu_torch.parallel.paged_attention`."""
from .ring_attention import local_attention  # noqa: F401
from .pipeline_lm import (dense_lm_logits, dense_lm_loss,  # noqa: F401
                          init_pipeline_lm, truncate_pipeline_lm)

__all__ = ["local_attention", "init_pipeline_lm", "truncate_pipeline_lm",
           "dense_lm_logits", "dense_lm_loss"]
