"""The optimizer's hand-written kernel: mixed-precision SGD with momentum.

Counterpart of ``mxnet_tpu/opt/kernels.py``'s ``mp_sgd_mom_update_pallas``.
The kernel is ``csrc/mp_sgd.cu``: one elementwise pass that reads the fp16
gradient, the fp32 momentum and the fp32 master weight and writes the fp16
weight, the momentum and the master weight, 20 bytes per element. ``lr``,
``wd`` and ``rescale_grad`` (and ``momentum`` and ``clip_gradient``) are
launch arguments, so a learning-rate schedule never rebuilds anything.

- On CUDA tensors :func:`mp_sgd_mom_update_kernel` launches the kernel or
  raises; nothing falls back.
- On CPU tensors it computes the plain version,
  :func:`mp_sgd_mom_update_ref`, which is also what the kernel is held
  against on the card (bit for bit: the kernel rounds each operation on
  its own, in the plain version's order).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["mp_sgd_mom_update_kernel", "mp_sgd_mom_update_ref", "LAUNCHES"]

LAUNCHES = _build.LaunchCounter("mp_sgd")


def mp_sgd_mom_update_ref(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version: ``(new_weight, new_mom, new_weight32)``, the formula
    of ``mp_sgd_mom_update`` in fp32 (``clip_gradient`` < 0 or None: no
    clip); ``new_weight`` in ``weight``'s dtype."""
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    g = g + wd * weight32
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def _vec(tensors16, tensors32) -> int:
    """1 when every fp16 pointer is 8-byte and every fp32 pointer 16-byte
    aligned, so the kernel may move 4 elements per access."""
    return int(all(t.data_ptr() % 8 == 0 for t in tensors16)
               and all(t.data_ptr() % 16 == 0 for t in tensors32))


def _launch(weight, grad, mom, weight32, lr, momentum, wd, rescale_grad,
            clip, out):
    named = [("weight", weight, torch.float16), ("grad", grad, torch.float16),
             ("mom", mom, torch.float32), ("weight32", weight32, torch.float32)]
    if out is not None:
        if len(out) != 3:
            raise MXNetError("mp_sgd_mom_update: out is (weight, mom, "
                             "weight32)")
        named += [(f"out[{i}]", t, dt) for i, (t, dt) in enumerate(zip(
            out, (torch.float16, torch.float32, torch.float32)))]
    n = weight.numel()
    for name, t, want in named:
        if t.dtype != want:
            raise MXNetError(f"mp_sgd_mom_update: {name} is {t.dtype}, the "
                             f"kernel takes {want}")
        if t.numel() != n:
            raise MXNetError(f"mp_sgd_mom_update: {name} has {t.numel()} "
                             f"elements, weight {n}")
        if not t.is_contiguous():
            raise MXNetError(f"mp_sgd_mom_update: {name} is not contiguous")
    for name, t, _ in named:
        if t.device != weight.device or not t.is_cuda:
            raise MXNetError(f"mp_sgd_mom_update: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors on one device")
    if n == 0:
        raise MXNetError("mp_sgd_mom_update: empty parameter")
    w_out, m_out, w32_out = out if out is not None else (
        torch.empty_like(weight), torch.empty_like(mom),
        torch.empty_like(weight32))
    lib = _build.load("mp_sgd")
    fn = lib.mx_mp_sgd_mom_update
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    vec = _vec((grad, w_out), (mom, weight32, m_out, w32_out))
    with torch.cuda.device(weight.device):
        stream = torch.cuda.current_stream(weight.device).cuda_stream
        err = fn(grad.data_ptr(), mom.data_ptr(), weight32.data_ptr(),
                 w_out.data_ptr(), m_out.data_ptr(), w32_out.data_ptr(), n,
                 float(lr), float(momentum), float(wd), float(rescale_grad),
                 float(clip), vec, stream)
    _build.check(lib, err, "mp_sgd launch")
    LAUNCHES.add()
    return w_out, m_out, w32_out


def mp_sgd_mom_update_kernel(weight, grad, mom, weight32, lr=0.01,
                             momentum=0.0, wd=0.0, rescale_grad=1.0,
                             clip_gradient=-1.0,
                             out: Optional[Sequence[torch.Tensor]] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """One launch of the fused update and cast: ``(new_weight, new_mom,
    new_weight32)``, the contract of ``mp_sgd_mom_update``. ``weight`` and
    ``grad`` are fp16, ``mom`` and ``weight32`` fp32. ``out`` names the
    three result tensors; passing ``(weight, mom, weight32)`` updates in
    place, which the optimizer does to keep no second copy of the state."""
    clip = -1.0 if clip_gradient is None else float(clip_gradient)
    if all(t.device.type == "cpu" for t in (weight, grad, mom, weight32)):
        res = mp_sgd_mom_update_ref(weight, grad, mom, weight32, lr,
                                    momentum, wd, rescale_grad, clip)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return tuple(out)
    return _launch(weight, grad, mom, weight32, lr, momentum, wd,
                   rescale_grad, clip, out)
