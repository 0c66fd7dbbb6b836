"""Gradient bucketing: per-parameter gradients coalesced into size-capped
flat buckets for the gradient exchange.

Counterpart of ``mxnet_tpu/step/buckets.py``: gradients of one dtype
share a flat buffer up to ``MXNET_GRAD_BUCKET_BYTES`` (a DDP-style cap),
so a distributed exchange makes O(buckets) transfers instead of
O(params); a parameter larger than the cap gets a bucket of its own.
The assignment depends only on shapes and dtypes, so it is computed once;
:meth:`GradientBuckets.layout_key` names what invalidates it. The
Trainer's bucketed kvstore exchange waits for the distribution slice
(ROADMAP Queue A item 6): on one device the exchange is the identity.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .. import config

__all__ = ["GradientBuckets", "DEFAULT_BUCKET_BYTES"]

DEFAULT_BUCKET_BYTES = 4 << 20  # 4 MiB


class _Bucket:
    __slots__ = ("dtype", "entries", "nbytes")

    def __init__(self, dtype):
        self.dtype = dtype
        self.entries: List[Tuple[int, Tuple[int, ...], int]] = []
        self.nbytes = 0


def _dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32``, ``"float32"``, a numpy dtype:
    the JAX package's spelling, so one layout key names both."""
    return str(dtype).replace("torch.", "")


class GradientBuckets:
    """Static assignment of parameter indices to flat buckets.

    ``items`` is a sequence of ``(index, shape, dtype, nbytes)`` rows, one
    per dense gradient to exchange. Parameters of different dtypes never
    share a bucket; a bucket closes once it reaches the cap."""

    def __init__(self, items: Sequence[Tuple[int, Tuple[int, ...], object,
                                             int]],
                 cap_bytes: int = 0, world_size: int = 1):
        self.cap_bytes = int(cap_bytes) if cap_bytes else int(
            config.get("MXNET_GRAD_BUCKET_BYTES"))
        # a rebuilt group must never exchange under a layout made for
        # another world size
        self.world_size = int(world_size)
        open_by_dtype: Dict[str, _Bucket] = {}
        self.buckets: List[_Bucket] = []
        for index, shape, dtype, nbytes in items:
            key = _dtype_name(dtype)
            b = open_by_dtype.get(key)
            if b is None or b.nbytes + nbytes > self.cap_bytes:
                b = _Bucket(dtype)
                self.buckets.append(b)
                open_by_dtype[key] = b
            b.entries.append((index, tuple(shape), nbytes))
            b.nbytes += nbytes
            if b.nbytes >= self.cap_bytes:
                open_by_dtype.pop(key, None)  # closed: full
        self._record_metrics()

    def _record_metrics(self):
        from ..telemetry import metrics as _metrics
        _metrics.gauge("grad_bucket_count",
                       "flat gradient-exchange buckets per step").set(
            len(self.buckets))
        h = _metrics.histogram("grad_bucket_bytes",
                               "bytes per gradient-exchange bucket")
        for b in self.buckets:
            h.observe(b.nbytes)

    def layout_key(self) -> Tuple:
        """Everything that invalidates the assignment: the rows, the byte
        cap and the world size."""
        entries = tuple((_dtype_name(b.dtype), tuple(b.entries))
                        for b in self.buckets)
        return (entries, self.cap_bytes, self.world_size)

    def __len__(self):
        return len(self.buckets)

    def flatten(self, bucket: _Bucket, grads: Dict[int, torch.Tensor]
                ) -> torch.Tensor:
        """The bucket's gradients (tensors by parameter index) as one flat
        buffer."""
        parts = [grads[i].reshape(-1) for i, _, _ in bucket.entries]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def unflatten(self, bucket: _Bucket, flat: torch.Tensor
                  ) -> Dict[int, torch.Tensor]:
        """A reduced flat buffer split back into ``{index: tensor}`` of the
        original shapes (views of ``flat``)."""
        out = {}
        offset = 0
        for index, shape, _ in bucket.entries:
            n = 1
            for s in shape:
                n *= s
            out[index] = flat[offset:offset + n].reshape(shape)
            offset += n
        return out
