"""Flash-attention forward: the CUDA kernel, its wrapper and its plain version.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``'s forward
(``flash_attention`` -> ``_flash_fwd``). The kernel is
``csrc/flash_fwd.cu``, hand-written for Hopper; its source note gives the
bound and the design. The wrapper takes ``(B, H, T, D)`` tensors:

- on CUDA tensors it launches the kernel or raises; nothing falls back;
- on CPU tensors it computes the plain version, :func:`flash_attention_ref_fwd`
  (dense masked softmax in fp32), which is also what the kernel is held
  against on the card.

Causal masking is top-left aligned (query ``i`` sees keys ``j <= i``), as
in the Pallas kernel and ``local_attention``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_ref_fwd", "LAUNCHES", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
LAUNCHES = _build.LaunchCounter("flash_fwd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention takes (B, H, T, D) tensors")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D or v.shape != k.shape:
        raise MXNetError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")


def flash_attention_ref_fwd(q, k, v, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(out, lse)`` with dense ``softmax(q.k^T*scale).v``
    in fp32; ``out`` in the input dtype, ``lse`` ``(B, H, Tq)`` fp32."""
    _check_shapes(q, k, v)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        keep = (torch.arange(Tq, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        logits = logits.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.matmul(torch.exp(logits - lse[..., None]), v.float())
    return out.to(q.dtype), lse


def flash_attention_ref(q, k, v, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    return flash_attention_ref_fwd(q, k, v, causal, scale)[0]


def _launch(q, k, v, causal: bool, scale: float):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if q.dtype not in _DTYPES:
        raise MXNetError(f"flash_attention: unsupported dtype {q.dtype} "
                         "(float32 or bfloat16)")
    if D > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    if min(B * H, Tq, Tk, D) < 1:
        raise MXNetError(f"flash_attention: empty shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise MXNetError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_attention: {name} is not contiguous")
        if t.device != q.device or not t.is_cuda:
            raise MXNetError(f"flash_attention: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors on one device")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), device=q.device, dtype=torch.float32)
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    vec = int(D % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    lib = _build.load("flash_fwd")
    fn = lib.mx_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, lse.data_ptr(), B * H, Tq, Tk, D, float(scale),
                 int(bool(causal)), _DTYPES[q.dtype], vec, stream)
    _build.check(lib, err, "flash_fwd launch")
    LAUNCHES.add()
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` for ``(B, H, T, D)`` q/k/v (``Tq != Tk`` allowed).
    ``lse`` is the row log-sum-exp ``(B, H, Tq)`` in fp32, kept for the
    backward. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    _check_shapes(q, k, v)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_ref_fwd(q, k, v, causal, s)
    return _launch(q, k, v, causal, s)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention output ``(B, H, Tq, D)``; see :func:`flash_attention_fwd`."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
