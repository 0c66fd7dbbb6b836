"""Flash attention: the CUDA kernels, their wrappers and their plain versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``'s ``flash_attention``
(a ``custom_vjp`` over ``_flash_fwd`` and ``_flash_bwd``). The kernels are
hand-written for Hopper: ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (the dQ pass and the dK/dV pass of the backward);
their source notes give the bounds and the designs. The wrappers take
``(B, H, T, D)`` tensors:

- on CUDA tensors they launch the kernels or raise; nothing falls back;
- on CPU tensors they compute the plain versions,
  :func:`flash_attention_ref_fwd` and :func:`flash_attention_ref_bwd`
  (dense masked softmax in fp32), which are also what the kernels are held
  against on the card.

:func:`flash_attention` is differentiable: a :class:`torch.autograd.Function`
whose forward launches the forward kernel and keeps ``q, k, v, out, lse``,
and whose backward launches the two backward kernels. Where no gradient is
wanted (``torch.inference_mode``, ``torch.no_grad`` or inputs that do not
require one) it runs the forward alone and keeps nothing.

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

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_ref", "flash_attention_ref_fwd",
           "flash_attention_ref_bwd", "LAUNCHES", "LAUNCHES_DQ",
           "LAUNCHES_DKV", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
LAUNCHES = _build.LaunchCounter("flash_fwd")
LAUNCHES_DQ = _build.LaunchCounter("flash_bwd_dq")
LAUNCHES_DKV = _build.LaunchCounter("flash_bwd_dkv")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention takes (B, H, T, D) tensors")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D or v.shape != k.shape:
        raise MXNetError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")


def _scale(q, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _logits(q, k, causal: bool, s: float) -> torch.Tensor:
    """Masked ``q.k^T * s`` in fp32, ``-inf`` where causal masks."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        keep = (torch.arange(Tq, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def flash_attention_ref_fwd(q, k, v, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(out, lse)`` with dense ``softmax(q.k^T*scale).v``
    in fp32; ``out`` in the input dtype, ``lse`` ``(B, H, Tq)`` fp32."""
    _check_shapes(q, k, v)
    logits = _logits(q, k, causal, _scale(q, scale))
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.matmul(torch.exp(logits - lse[..., None]), v.float())
    return out.to(q.dtype), lse


def flash_attention_ref(q, k, v, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The dense oracle as one differentiable torch expression (autograd
    goes through it), for reference runs."""
    return flash_attention_ref_fwd(q, k, v, causal, scale)[0]


def flash_attention_ref_bwd(q, k, v, out, lse, dout, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the backward: ``(dq, dk, dv)`` from the forward's
    ``out`` and ``lse``, in fp32 with the kernels' formulas
    (``pallas_kernels.py`` ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``):
    ``p = exp(q.k^T*s - lse)``, ``ds = p * (dO.v^T - rowsum(dO*O))``,
    ``dq = s * ds.k``, ``dk = s * ds^T.q``, ``dv = p^T.dO``; each in its
    input's dtype."""
    _check_shapes(q, k, v)
    s = _scale(q, scale)
    p = torch.exp(_logits(q, k, causal, s) - lse[..., None].float())
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do, v.float().transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, k.float()) * s
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * s
    dv = torch.matmul(p.transpose(-1, -2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_launch(named, dtype) -> None:
    """What every kernel of this module refuses: another dtype, a
    non-contiguous operand, a CPU tensor or a second device."""
    if dtype not in _DTYPES:
        raise MXNetError(f"flash_attention: unsupported dtype {dtype} "
                         "(float32, bfloat16 or float16)")
    device = named[0][1].device
    for name, t, want in named:
        if t.dtype != want:
            raise MXNetError(f"flash_attention: {name} is {t.dtype}, "
                             f"expected {want}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_attention: {name} is not contiguous")
        if t.device != device or not t.is_cuda:
            raise MXNetError(f"flash_attention: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors on one device")


def _check_dims(q, k) -> None:
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    if min(B * H, Tq, Tk, D) < 1:
        raise MXNetError(f"flash_attention: empty shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def _vec(D: int, tensors) -> int:
    """1 when the kernels may use 16-byte accesses: D % 4 == 0 and every
    pointer 16-byte aligned."""
    return int(D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _fn(lib, name: str, argtypes):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, scale: float):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _check_launch([("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype)],
                  q.dtype)
    _check_dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), device=q.device, dtype=torch.float32)
    lib = _build.load("flash_fwd")
    fn = _fn(lib, "mx_flash_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B * H, Tq, Tk, D, float(scale),
                 int(bool(causal)), _DTYPES[q.dtype], _vec(D, (q, k, v, out)),
                 stream)
    _build.check(lib, err, "flash_fwd launch")
    LAUNCHES.add()
    return out, lse


_BWD_IN = [ctypes.c_void_p] * 6
_BWD_TAIL = ([ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def _bwd_pass(which, q, k, v, dout, lse, delta, grads, causal, scale):
    """One launch of the dQ kernel (``grads = (dq,)``) or the dK/dV kernel
    (``grads = (dk, dv)``) on checked, contiguous CUDA tensors."""
    B, H, Tq, D = q.shape
    lib = _build.load("flash_bwd")
    fn = _fn(lib, f"mx_flash_bwd_{which}",
             _BWD_IN + [ctypes.c_void_p] * len(grads) + _BWD_TAIL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, dout, lse, delta)),
                 *(g.data_ptr() for g in grads), B * H, Tq, k.shape[2], D,
                 float(scale), int(bool(causal)), _DTYPES[q.dtype],
                 _vec(D, (q, k, v, dout) + tuple(grads)), stream)
    _build.check(lib, err, f"flash_bwd_{which} launch")
    (LAUNCHES_DQ if which == "dq" else LAUNCHES_DKV).add()


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, scale: float):
    """``(dq, dk, dv)`` from the two backward kernels. ``delta =
    rowsum(dO * O)`` is one fp32 torch reduction before them, as JAX
    computes it in XLA outside its kernels."""
    B, H, Tq, D = q.shape
    dt = q.dtype
    _check_launch([("q", q, dt), ("k", k, dt), ("v", v, dt), ("out", out, dt),
                   ("dout", dout, dt), ("lse", lse, torch.float32)], dt)
    _check_dims(q, k)
    if tuple(lse.shape) != (B, H, Tq) or out.shape != q.shape \
            or dout.shape != q.shape:
        raise MXNetError(f"flash_attention backward: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    delta = torch.sum(dout.float() * out.float(), dim=-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _bwd_pass("dq", q, k, v, dout, lse, delta, (dq,), causal, scale)
    _bwd_pass("dkv", q, k, v, dout, lse, delta, (dk, dv), causal, scale)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` for ``(B, H, T, D)`` q/k/v (``Tq != Tk`` allowed).
    ``lse`` is the row log-sum-exp ``(B, H, Tq)`` in fp32, kept for the
    backward. CUDA tensors launch the kernel; CPU tensors take the plain
    version. Not differentiable: see :func:`flash_attention`."""
    _check_shapes(q, k, v)
    s = _scale(q, scale)
    if _on_cpu(q, k, v):
        return flash_attention_ref_fwd(q, k, v, causal, s)
    return _launch(q, k, v, causal, s)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` given the forward's ``out`` and ``lse`` and the
    output gradient ``dout``. CUDA tensors launch the two backward kernels
    (``dout`` is made contiguous first); CPU tensors take the plain
    version."""
    _check_shapes(q, k, v)
    s = _scale(q, scale)
    if _on_cpu(q, k, v, out, lse, dout):
        return flash_attention_ref_bwd(q, k, v, out, lse, dout, causal, s)
    return _launch_bwd(q, k, v, out, lse, dout.contiguous(), causal, s)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the ``custom_vjp``: the forward keeps ``q, k, v,
    out, lse``; the backward recomputes ``p`` from ``lse`` per tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention output ``(B, H, Tq, D)``, differentiable in ``q, k, v``;
    see :func:`flash_attention_fwd` and :func:`flash_attention_bwd`."""
    _check_shapes(q, k, v)
    s = _scale(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, s)
    return flash_attention_fwd(q, k, v, causal, s)[0]
