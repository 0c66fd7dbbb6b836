"""Flash attention: the CUDA kernels, their wrappers and their plain versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``'s ``flash_attention``
(a ``custom_vjp`` over ``_flash_fwd`` and ``_flash_bwd``). The kernels are
hand-written for Hopper, chosen per call by :func:`_fwd_route` and
:func:`_bwd_route`:

- the forward and the backward's dQ and dK/dV passes each have three
  designs: ``csrc/flash_fwd_tc.cu`` / ``csrc/flash_bwd_tc.cu`` (tensor
  cores, wgmma and TMA) for fp16/bf16 with ``D % 8 == 0`` and 16-byte-aligned
  pointers; ``csrc/flash_fwd_tc32.cu`` / ``csrc/flash_bwd_tc32.cu`` for
  fp32 with ``D % 8 == 0``, ``D <= 64`` and aligned pointers: the tensor
  cores on bf16 planes of the fp32 operands (:func:`split_bf16x3`), six
  plane products per product, which keeps fp32's accuracy;
  ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu`` (CUDA cores) for the rest
  (odd head dims, fp32 with ``D > 64``).

The source notes give the bounds and the designs. The wrappers take
``(B, H, T, D)`` tensors of any strides (the kernels read contiguous
copies) and head dims up to :data:`MAX_HEAD_DIM`, which
:func:`flash_attention_available` tells a caller before it calls:

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
           "flash_attention_ref_bwd", "flash_attention_available",
           "LAUNCHES", "LAUNCHES_TC", "LAUNCHES_TC32",
           "LAUNCHES_DQ", "LAUNCHES_DKV", "LAUNCHES_DQ_TC",
           "LAUNCHES_DKV_TC", "LAUNCHES_DQ_TC32", "LAUNCHES_DKV_TC32",
           "LAUNCHES_SPLIT", "split_bf16x3", "split_bf16x3_ref",
           "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
LAUNCHES = _build.LaunchCounter("flash_fwd")
LAUNCHES_DQ = _build.LaunchCounter("flash_bwd_dq")
LAUNCHES_DKV = _build.LaunchCounter("flash_bwd_dkv")
# the launches of each kernel that took the tensor-core route (also counted
# in LAUNCHES / LAUNCHES_DQ / LAUNCHES_DKV)
LAUNCHES_TC = _build.LaunchCounter("flash_fwd_tc")
# the forward launches that took the fp32 tensor-core route (also counted in
# LAUNCHES)
LAUNCHES_TC32 = _build.LaunchCounter("flash_fwd_tc32")
LAUNCHES_DQ_TC = _build.LaunchCounter("flash_bwd_tc_dq")
LAUNCHES_DKV_TC = _build.LaunchCounter("flash_bwd_tc_dkv")
# the backward launches that took the fp32 tensor-core route (also counted in
# LAUNCHES_DQ / LAUNCHES_DKV), and the launches of the split kernel (one per
# fp32 tensor-core forward and one per such backward)
LAUNCHES_DQ_TC32 = _build.LaunchCounter("flash_bwd_tc32_dq")
LAUNCHES_DKV_TC32 = _build.LaunchCounter("flash_bwd_tc32_dkv")
LAUNCHES_SPLIT = _build.LaunchCounter("split_bf16x3")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def flash_attention_available(q_len: int, k_len: int, head_dim: int) -> bool:
    """True where the kernels take the shape: ``head_dim <= MAX_HEAD_DIM``
    (and nothing empty). Counterpart of ``pallas_kernels.py``'s
    ``flash_attention_available``, by which a model picks the kernel or
    dense attention before any launch. The reference also wants
    ``min(q_len, k_len) >= 64``, because the TPU kernel pads sequences to
    128-row blocks; the port's kernels mask ragged tiles instead of padding
    them, so they take every length."""
    return min(q_len, k_len, head_dim) >= 1 and head_dim <= MAX_HEAD_DIM


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


def split_bf16x3_ref(*xs) -> torch.Tensor:
    """Plain version of :func:`split_bf16x3`: the three bf16 planes of the
    fp32 tensors ``xs``, one ``(3, N)`` tensor (``N`` their elements, back
    to back in each plane): ``x0 = bf16(x)``, ``x1 = bf16(x - x0)``,
    ``x2 = bf16(x - x0 - x1)``, each rounded to nearest even. Each plane
    takes the next 8 significant bits, so ``x0 + x1 + x2 == x`` exactly
    but for what lies below bf16's smallest subnormal (2^-133). Where
    ``bf16(x)`` would overflow, ``x0`` is ``x`` truncated instead, so that
    the planes stay finite."""
    x = torch.cat([t.reshape(-1) for t in xs]).float()
    x0 = x.to(torch.bfloat16)
    trunc = (x.view(torch.int32) & -65536).view(torch.float32)
    x0 = torch.where(torch.isinf(x0) & torch.isfinite(x),
                     trunc.to(torch.bfloat16), x0)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    return torch.stack([x0, x1, (r - x1.float()).to(torch.bfloat16)])


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


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


_SPLIT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p] * 2


def split_bf16x3(*xs) -> torch.Tensor:
    """The three bf16 planes of up to four fp32 tensors, as
    :func:`split_bf16x3_ref` computes them: the operands of the fp32
    tensor-core forward and backward (``csrc/flash_fwd_tc32.cu``,
    ``csrc/flash_bwd_tc32.cu``). CUDA tensors
    (contiguous, on one device, 16-byte aligned, each with a multiple of
    4 elements) launch its split kernel once, bit-equal to the plain
    version; CPU tensors take the plain version."""
    if not 1 <= len(xs) <= 4:
        raise MXNetError(f"split_bf16x3 takes 1 to 4 tensors, not {len(xs)}")
    for x in xs:
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise MXNetError("split_bf16x3 takes contiguous float32 tensors")
    if _on_cpu(*xs):
        return split_bf16x3_ref(*xs)
    device = xs[0].device
    for x in xs:
        if not x.is_cuda or x.device != device or x.numel() % 4 \
                or x.data_ptr() % 16:
            raise MXNetError("split_bf16x3 takes CUDA tensors on one "
                             "device, 16-byte aligned, each with a "
                             "multiple of 4 elements")
    planes = torch.empty((3, sum(x.numel() for x in xs)),
                         dtype=torch.bfloat16, device=device)
    lib = _build.load("flash_bwd_tc32")
    fn = _fn(lib, "mx_split_bf16x3", _SPLIT_ARGS)
    pad = 4 - len(xs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(x.data_ptr() for x in xs), *([None] * pad),
                 *(x.numel() for x in xs), *([0] * pad), planes.data_ptr(),
                 stream)
    _build.check(lib, err, "split_bf16x3 launch")
    LAUNCHES_SPLIT.add()
    return planes


def _fwd_route(dtype, D: int, aligned: bool) -> str:
    """Which design takes a launch of the forward: ``"tc"``
    (``csrc/flash_fwd_tc.cu``: tensor cores) for fp16/bf16 and ``"tc32"``
    (``csrc/flash_fwd_tc32.cu``: bf16 planes of the fp32 operands, six
    plane products per product, fp32-grade) for fp32 with ``D <= 64``,
    both with ``D % 8 == 0`` (TMA needs 16-byte row strides) and every
    pointer 16-byte aligned; ``"cc"`` (``csrc/flash_fwd.cu``: CUDA cores)
    for the rest: odd head dims, and fp32 with ``D > 64``, whose planes
    would need 288 KB of shared memory in the fp32 kernel's two-warpgroup
    layout (the source note says why no other layout was taken)."""
    if D % 8 == 0 and aligned:
        if dtype in (torch.float16, torch.bfloat16):
            return "tc"
        if dtype == torch.float32 and D <= 64:
            return "tc32"
    return "cc"


def _bwd_route(dtype, D: int, aligned: bool) -> str:
    """Which design takes a launch of a backward pass: ``"tc"``
    (``csrc/flash_bwd_tc.cu``) for fp16/bf16 and ``"tc32"``
    (``csrc/flash_bwd_tc32.cu``: bf16 planes of the fp32 operands, six
    plane products per product, fp32-grade) for fp32 with ``D <= 64``,
    both with ``D % 8 == 0`` and every pointer 16-byte aligned; ``"cc"``
    (``csrc/flash_bwd.cu``: CUDA cores) for the rest: odd head dims, and
    fp32 with ``D > 64``, whose planes would not fit a double-buffered
    ring in shared memory."""
    if D % 8 == 0 and aligned:
        if dtype in (torch.float16, torch.bfloat16):
            return "tc"
        if dtype == torch.float32 and D <= 64:
            return "tc32"
    return "cc"

# q, k, v, out, lse; B*H, Tq, Tk, D; scale; causal, dtype (then the
# CUDA-core kernel's vec); stream
_FWD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 2)


# planes of q, k, v; plane stride; out, lse; B*H, Tq, Tk, D; scale; causal;
# stream
_FWD_TC32_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_planes(planes, n: int, what: str) -> None:
    """``planes`` must be the :func:`split_bf16x3` of ``n`` elements."""
    if planes is None or planes.dtype != torch.bfloat16 \
            or not planes.is_contiguous() or tuple(planes.shape) != (3, n):
        raise MXNetError(f"{what} (tc32) takes the split_bf16x3 planes of "
                         "its operands")


def _fwd_pass(route, q, k, v, out, lse, causal, scale, planes=None):
    """One launch of ``route``'s forward kernel on checked, contiguous CUDA
    tensors, writing ``out`` and ``lse``. The ``"tc32"`` route reads
    ``planes``, the :func:`split_bf16x3` of ``(q, k, v)``."""
    B, H, Tq, D = q.shape
    scalars = (B * H, Tq, k.shape[2], D, float(scale), int(bool(causal)))
    if route == "tc32":
        nq, nk = q.numel(), k.numel()
        _check_planes(planes, nq + 2 * nk, "flash_fwd")
        lib = _build.load("flash_fwd_tc32")
        fn = _fn(lib, "mx_flash_fwd_tc32", _FWD_TC32_ARGS)
        at = planes.data_ptr()  # plane 0 of q, k, v, 2 bytes each
        args = (at, at + 2 * nq, at + 2 * (nq + nk), planes.shape[1],
                out.data_ptr(), lse.data_ptr(), *scalars)
    elif route == "tc":
        lib = _build.load("flash_fwd_tc")
        fn = _fn(lib, "mx_flash_fwd_tc", _FWD_ARGS + [ctypes.c_void_p])
        args = (*_ptrs((q, k, v, out, lse)), *scalars, _DTYPES[q.dtype])
    else:
        lib = _build.load("flash_fwd")
        fn = _fn(lib, "mx_flash_fwd",
                 _FWD_ARGS + [ctypes.c_int, ctypes.c_void_p])
        args = (*_ptrs((q, k, v, out, lse)), *scalars, _DTYPES[q.dtype],
                _vec(D, (q, k, v, out)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    _build.check(lib, err, f"flash_fwd ({route}) launch")
    LAUNCHES.add()
    if route == "tc":
        LAUNCHES_TC.add()
    elif route == "tc32":
        LAUNCHES_TC32.add()


def _launch(q, k, v, causal: bool, scale: float):
    """``(out, lse)`` from the forward kernel :func:`_fwd_route` picks; the
    fp32 tensor-core route splits q, k and v into bf16 planes first (one
    launch of :func:`split_bf16x3`)."""
    B, H, Tq, D = q.shape
    _check_launch([("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype)],
                  q.dtype)
    _check_dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), device=q.device, dtype=torch.float32)
    route = _fwd_route(q.dtype, D, all(t.data_ptr() % 16 == 0
                                       for t in (q, k, v, out)))
    planes = split_bf16x3(q, k, v) if route == "tc32" else None
    _fwd_pass(route, q, k, v, out, lse, causal, scale, planes)
    return out, lse


_BWD_IN = [ctypes.c_void_p] * 6
_BWD_TAIL = ([ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
_TC_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# planes of q, k, v, dout; plane stride; lse, delta, grads; B*H, Tq, Tk, D;
# scale; causal; stream
_TC32_HEAD = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_void_p]
_TC32_TAIL = ([ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p])


def _bwd_pass(which, route, q, k, v, out, dout, lse, delta, grads, causal,
              scale, planes=None):
    """One launch of the dQ pass (``grads = (dq,)``) or the dK/dV pass
    (``grads = (dk, dv)``) of ``route``'s kernels on checked, contiguous
    CUDA tensors. ``delta`` (fp32, ``(B, H, Tq)``) is read, except by the
    tensor-core dQ pass, which computes it from ``out`` and ``dout`` and
    writes it. The ``"tc32"`` route reads ``planes``, the
    :func:`split_bf16x3` of ``(q, k, v, dout)``."""
    B, H, Tq, D = q.shape
    scalars = [B * H, Tq, k.shape[2], D, float(scale), int(bool(causal))]
    if route == "tc":
        lib = _build.load("flash_bwd_tc")
        fn = _fn(lib, f"mx_flash_bwd_tc_{which}", _TC_ARGS)
        args = _ptrs(((q, k, v, out, dout, lse, delta) if which == "dq"
                     else (q, k, v, dout, lse, delta)) + tuple(grads)) \
            + scalars + [_DTYPES[q.dtype]]
    elif route == "tc32":
        nq, nk = q.numel(), k.numel()
        _check_planes(planes, 2 * nq + 2 * nk, f"flash_bwd_{which}")
        lib = _build.load("flash_bwd_tc32")
        fn = _fn(lib, f"mx_flash_bwd_tc32_{which}",
                 _TC32_HEAD + [ctypes.c_void_p] * len(grads) + _TC32_TAIL)
        at = planes.data_ptr()  # plane 0 of q, k, v, dout, 2 bytes each
        args = [at, at + 2 * nq, at + 2 * (nq + nk), at + 2 * (nq + 2 * nk),
                planes.shape[1]] + _ptrs((lse, delta) + tuple(grads)) \
            + scalars
    else:
        lib = _build.load("flash_bwd")
        fn = _fn(lib, f"mx_flash_bwd_{which}",
                 _BWD_IN + [ctypes.c_void_p] * len(grads) + _BWD_TAIL)
        args = _ptrs((q, k, v, dout, lse, delta) + tuple(grads)) + scalars \
            + [_DTYPES[q.dtype], _vec(D, (q, k, v, dout) + tuple(grads))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    _build.check(lib, err, f"flash_bwd_{which} ({route}) launch")
    (LAUNCHES_DQ if which == "dq" else LAUNCHES_DKV).add()
    if route == "tc":
        (LAUNCHES_DQ_TC if which == "dq" else LAUNCHES_DKV_TC).add()
    elif route == "tc32":
        (LAUNCHES_DQ_TC32 if which == "dq" else LAUNCHES_DKV_TC32).add()


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, scale: float):
    """``(dq, dk, dv)`` from the two passes of the route
    :func:`_bwd_route` picks. On the CUDA-core and fp32 tensor-core routes
    ``delta = rowsum(dO * O)`` is one fp32 torch reduction before them, as
    JAX computes it in XLA outside its kernels; on the 16-bit tensor-core
    route the dQ pass computes it for its rows and the dK/dV pass reads
    it. The fp32 tensor-core route splits q, k, v and dO into bf16 planes
    first (one launch of :func:`split_bf16x3`), read by both passes."""
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
    route = _bwd_route(dt, D, all(t.data_ptr() % 16 == 0
                                  for t in (q, k, v, out, dout)))
    planes = None
    if route == "tc":
        delta = torch.empty((B, H, Tq), device=q.device, dtype=torch.float32)
    else:
        delta = torch.sum(dout.float() * out.float(), dim=-1)
        if route == "tc32":
            planes = split_bf16x3(q, k, v, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _bwd_pass("dq", route, q, k, v, out, dout, lse, delta, (dq,), causal,
              scale, planes)
    _bwd_pass("dkv", route, q, k, v, out, dout, lse, delta, (dk, dv), causal,
              scale, planes)
    return dq, dk, dv


def _contiguous(*tensors):
    return tuple(t.contiguous() for t in tensors)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` for ``(B, H, T, D)`` q/k/v (``Tq != Tk`` allowed).
    ``lse`` is the row log-sum-exp ``(B, H, Tq)`` in fp32, kept for the
    backward. CUDA tensors launch the kernel on contiguous copies (the
    tensors themselves where they are contiguous); CPU tensors take the
    plain version. Not differentiable: see :func:`flash_attention`."""
    _check_shapes(q, k, v)
    s = _scale(q, scale)
    if _on_cpu(q, k, v):
        return flash_attention_ref_fwd(q, k, v, causal, s)
    return _launch(*_contiguous(q, k, v), causal, s)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` given the forward's ``out`` and ``lse`` and the
    output gradient ``dout``. CUDA tensors launch the two backward kernels
    on contiguous copies, as the forward; CPU tensors take the plain
    version."""
    _check_shapes(q, k, v)
    s = _scale(q, scale)
    if _on_cpu(q, k, v, out, lse, dout):
        return flash_attention_ref_bwd(q, k, v, out, lse, dout, causal, s)
    return _launch_bwd(*_contiguous(q, k, v, out, lse, dout), causal, s)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the ``custom_vjp``: the forward keeps ``q, k, v,
    out, lse`` (q, k, v as the contiguous tensors the kernel read); the
    backward recomputes ``p`` from ``lse`` per tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = _contiguous(q, k, v)
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
