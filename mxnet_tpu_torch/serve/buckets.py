"""Shape-bucketing policy: pad requests to a closed ladder of shapes.

Counterpart of ``mxnet_tpu/serve/buckets.py``, unchanged in its decisions.
A :class:`BucketLadder` maps an arbitrary request shape onto a closed set:

- the **batch axis** (axis 0 of every dispatch) is padded up to the next
  rung of ``batch_buckets``;
- optional **dim ladders** pad named non-batch axes (sequence length,
  image side) the same way.

In the port a padded signature is one "program": the shapes the model and
its kernels run at. After :meth:`ServingEngine.warmup` has run every rung
combination, no request can bring a new signature, which the engine's
``recompiles_after_warmup`` counts.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .. import config
from ..base import MXNetError

__all__ = ["BucketLadder", "BucketOverflowError", "parse_bucket_spec",
           "default_ladder"]

# axis aliases accepted in MXSERVE_BUCKETS specs ("seq:16,32" == "axis1:...")
_AXIS_ALIASES = {"batch": 0, "seq": 1, "axis0": 0}


class BucketOverflowError(MXNetError):
    """A request dimension exceeds the top rung of its ladder."""


def _parse_rungs(text: str, what: str) -> Tuple[int, ...]:
    try:
        rungs = tuple(sorted({int(tok) for tok in text.split(",") if tok}))
    except ValueError as e:
        raise MXNetError(f"invalid {what} bucket list {text!r}: {e}") from e
    if not rungs or any(r <= 0 for r in rungs):
        raise MXNetError(f"{what} buckets must be positive ints, got {text!r}")
    return rungs


def parse_bucket_spec(spec: str) -> "BucketLadder":
    """Parse an ``MXSERVE_BUCKETS`` spec into a :class:`BucketLadder`.

    Two forms::

        "1,2,4,8,16"                     # batch-axis ladder only
        "batch:1,2,4,8;seq:16,32,64"     # named axes; axis<k> addresses
                                         # BATCHED-array axis k (= item
                                         # axis k-1); seq == axis1
    """
    spec = spec.strip()
    if not spec:
        raise MXNetError("empty MXSERVE_BUCKETS spec")
    if ":" not in spec:
        return BucketLadder(_parse_rungs(spec, "batch"))
    batch: Optional[Tuple[int, ...]] = None
    dims: Dict[int, Tuple[int, ...]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, rungs = part.partition(":")
        name = name.strip().lower()
        if name in _AXIS_ALIASES:
            axis = _AXIS_ALIASES[name]
        elif name.startswith("axis"):
            try:
                axis = int(name[4:])
            except ValueError:
                raise MXNetError(f"bad axis name {name!r} in bucket spec")
        else:
            raise MXNetError(
                f"unknown axis {name!r} in bucket spec {spec!r} "
                "(use batch, seq, or axis<k>)")
        parsed = _parse_rungs(rungs, name)
        if axis == 0:
            batch = parsed
        else:
            dims[axis] = parsed
    if batch is None:
        raise MXNetError(f"bucket spec {spec!r} has no batch ladder")
    return BucketLadder(batch, dims)


def default_ladder() -> "BucketLadder":
    """The process-default ladder, from the ``MXSERVE_BUCKETS`` flag."""
    return parse_bucket_spec(config.get("MXSERVE_BUCKETS"))


class BucketLadder:
    """A closed set of padded shapes.

    ``batch_buckets`` pads the dispatch batch axis; ``dim_buckets`` maps
    *item* axis index (axis 0 of the per-item shape = axis 1 of the
    batched array) to its rung list.

    Dim ladders apply by axis index to EVERY input that has the axis: a
    multi-input model whose inputs disagree about what axis 1 means (a
    token sequence vs a fixed-width feature vector) needs non-laddered
    extents on the disagreeing axes, or separate engines — there are no
    per-input ladders.
    """

    def __init__(self, batch_buckets: Sequence[int],
                 dim_buckets: Optional[Dict[int, Sequence[int]]] = None):
        self.batch_buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        if not self.batch_buckets or min(self.batch_buckets) <= 0:
            raise MXNetError("batch_buckets must be positive ints")
        self.dim_buckets = {int(k): tuple(sorted(set(int(v) for v in vs)))
                            for k, vs in (dim_buckets or {}).items()}
        for axis, rungs in self.dim_buckets.items():
            if axis <= 0:
                raise MXNetError(
                    f"dim_buckets axis {axis} invalid: axis 0 is the batch "
                    "axis (use batch_buckets)")
            if min(rungs) <= 0:
                raise MXNetError(f"axis {axis} buckets must be positive")

    # -- rung lookup ----------------------------------------------------
    @staticmethod
    def _ceil(rungs: Tuple[int, ...], n: int, what: str) -> int:
        for r in rungs:
            if n <= r:
                return r
        raise BucketOverflowError(
            f"{what}={n} exceeds the top bucket {rungs[-1]} "
            f"(ladder {list(rungs)}); raise MXSERVE_BUCKETS or shard the "
            "request")

    def batch_bucket(self, n: int) -> int:
        """Smallest batch rung holding ``n`` rows."""
        return self._ceil(self.batch_buckets, n, "batch")

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def pad_item_shape(self, item_shape: Sequence[int]) -> Tuple[int, ...]:
        """Pad the non-batch dims of one item shape onto the ladder.

        ``item_shape`` excludes the batch axis; ``dim_buckets`` axis *k*
        addresses ``item_shape[k-1]`` (i.e. batched-array axis *k*).
        """
        out = list(int(s) for s in item_shape)
        for axis, rungs in self.dim_buckets.items():
            idx = axis - 1
            if idx < len(out):
                out[idx] = self._ceil(rungs, out[idx], f"axis{axis}")
        return tuple(out)

    def padded_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """Full padded shape for a batched array ``shape`` (axis 0 = rows)."""
        return ((self.batch_bucket(int(shape[0])),)
                + self.pad_item_shape(shape[1:]))

    def signature(self, arrays) -> Tuple:
        """Coalescing key: the padded per-item signature of a request.

        Requests sharing a signature can be concatenated along axis 0
        into one dispatch; the batch rung is chosen per dispatch, so it
        is deliberately NOT part of the key.
        """
        return tuple((self.pad_item_shape(a.shape[1:]),
                      str(a.dtype)) for a in arrays)

    # -- warmup enumeration ---------------------------------------------
    def item_shape_combos(
            self, item_shape: Sequence[int]) -> List[Tuple[int, ...]]:
        """All padded item shapes reachable from ``item_shape``'s rank —
        the cartesian product of each laddered axis's rungs (non-laddered
        axes are fixed). This is the warmup set for one input."""
        axes: List[Tuple[int, ...]] = []
        for idx, s in enumerate(item_shape):
            rungs = self.dim_buckets.get(idx + 1)
            axes.append(tuple(rungs) if rungs else (int(s),))
        return [tuple(combo) for combo in itertools.product(*axes)] \
            if axes else [()]

    def warmup_shapes(
            self, item_shape: Sequence[int]) -> List[Tuple[int, ...]]:
        """Every full padded shape warmup must compile for one input:
        ``len(batch_buckets) * prod(len(ladder) per laddered axis)``
        programs. Keep that product small — it bounds both warmup time
        and device program memory (docs/serving.md has the tuning
        guide)."""
        return [(b,) + item for b in self.batch_buckets
                for item in self.item_shape_combos(item_shape)]

    def program_count(self, item_shape: Sequence[int]) -> int:
        return len(self.batch_buckets) * len(
            self.item_shape_combos(item_shape))

    def __repr__(self):
        dims = "".join(f";axis{k}:{','.join(map(str, v))}"
                       for k, v in sorted(self.dim_buckets.items()))
        return (f"BucketLadder(batch:"
                f"{','.join(map(str, self.batch_buckets))}{dims})")

    def spec(self) -> str:
        """Round-trippable spec string (the MXSERVE_BUCKETS form)."""
        if not self.dim_buckets:
            return ",".join(map(str, self.batch_buckets))
        parts = ["batch:" + ",".join(map(str, self.batch_buckets))]
        parts += [f"axis{k}:" + ",".join(map(str, v))
                  for k, v in sorted(self.dim_buckets.items())]
        return ";".join(parts)
