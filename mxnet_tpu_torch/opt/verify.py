"""Tolerance classes: the declared bounds parity checks are held to.

Counterpart of the class table of ``mxnet_tpu/opt/verify.py`` (:36-60).
A rewrite or a storage format moves numerics by a known amount, and its
parity check uses the class that names that amount instead of a bound
picked by hand. The graph optimizer that the rest of the JAX module
verifies waits for its slice of the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["TOLERANCE_CLASSES", "tolerance_for"]

# (rtol, atol), weakest guarantee last. The quant_* classes are the
# quantized KV pools': bf16 pools round each cached element to 8 mantissa
# bits, int8 pools add a per-slot absmax requantization
TOLERANCE_CLASSES: Dict[str, Tuple[float, float]] = {
    "bitwise": (0.0, 0.0),
    "layout": (2e-5, 1e-6),      # conv/pool reduce order changes
    "fusion": (2e-5, 1e-6),      # fused contraction / online softmax
    "quant_bf16": (5e-2, 5e-2),  # bf16 KV pages
    "quant_int8": (2e-1, 3e-1),  # int8 KV pages, per-slot scales
}
def tolerance_for(cls: str, dtype=None) -> Tuple[float, float]:
    """(rtol, atol) of ``cls``; x100 for a ``dtype`` under 4 bytes."""
    rtol, atol = TOLERANCE_CLASSES[cls]
    if dtype is not None and np.dtype(dtype).itemsize < 4:
        rtol, atol = rtol * 100, atol * 100
    return rtol, atol
