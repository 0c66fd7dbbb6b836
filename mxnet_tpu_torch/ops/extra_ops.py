"""The dense part of the op-corpus completion: init ops, slice and
scatter assignment, ``cumsum``, ``_histogram``, ``_sparse_retain``,
``amp_multicast``, the boolean mask, and the multi-tensor optimizer
updates.

Counterpart of the dense ops of ``mxnet_tpu/ops/extra_ops.py``. The
init ops take ``ctx`` (default: the current context) and ``dtype``.
The multi-tensor updates take their inputs interleaved (``w0, g0, w1,
g1, ...``, or triples and quads with momenta and fp32 master weights)
and return the new weights first, then the new states, as the JAX
package does; with ``out=`` the nd layer writes the weights into the
given arrays and the states into the state inputs (MXNet's contract).
``multi_mp_sgd_mom_update`` of fp16 weights is the kernel's list form
(:func:`~mxnet_tpu_torch.opt.kernels.mp_sgd_mom_update_multi_kernel`: one
launch per ``capacity()`` tensors on CUDA), bit-equal to the loop of the
single-tensor update. The detection, DGL, quantized, OpenCV, ``Custom``
and TensorRT ops of that module are registered stubs
(:mod:`~mxnet_tpu_torch.ops.deferred`).
"""
from __future__ import annotations

import torch

from ..opt.kernels import (mp_sgd_mom_update_multi_kernel,
                           mp_sgd_mom_update_ref)
from .registry import register_op

__all__ = []


def _shape_t(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(shape or ())


def _dt(dtype, default="float32"):
    from ..ndarray.ndarray import as_torch_dtype
    return as_torch_dtype(dtype or default)


def _dev(ctx):
    from ..context import as_device
    return as_device(ctx)


# -- init ops -----------------------------------------------------------------

@register_op("_zeros", differentiable=False)
def _zeros(shape=(), ctx=None, dtype="float32"):
    """Zeros of ``shape``."""
    return torch.zeros(_shape_t(shape), dtype=_dt(dtype), device=_dev(ctx))


@register_op("_zeros_without_dtype", differentiable=False)
def _zeros_without_dtype(shape=(), ctx=None, dtype=None):
    """Zeros of ``shape`` (float32 unless ``dtype``)."""
    return _zeros(shape, ctx, dtype)


@register_op("_ones", differentiable=False)
def _ones(shape=(), ctx=None, dtype="float32"):
    """Ones of ``shape``."""
    return torch.ones(_shape_t(shape), dtype=_dt(dtype), device=_dev(ctx))


@register_op("_full", differentiable=False)
def _full(shape=(), value=0.0, ctx=None, dtype="float32"):
    """``shape`` filled with ``value``."""
    return torch.full(_shape_t(shape), value, dtype=_dt(dtype),
                      device=_dev(ctx))


@register_op("_eye", differentiable=False)
def _eye(N=0, M=0, k=0, ctx=None, dtype="float32"):
    """Ones on the ``k``-th diagonal of an N x M (N x N) matrix."""
    n, m = int(N), int(M) if M else int(N)
    ones = torch.ones(max(min(n, m - k) if k >= 0 else min(n + k, m), 0),
                      dtype=_dt(dtype), device=_dev(ctx))
    out = torch.zeros(n, m, dtype=_dt(dtype), device=_dev(ctx))
    if ones.numel():
        out.diagonal(int(k)).copy_(ones)
    return out


@register_op("_arange", differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            ctx=None, dtype="float32"):
    """``[start, stop)`` in steps of ``step`` (``[0, start)`` without
    ``stop``), each value ``repeat`` times."""
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=torch.float64,
                       device=_dev(ctx)).to(_dt(dtype))
    return out.repeat_interleave(int(repeat)) if repeat != 1 else out


@register_op("_linspace", differentiable=False)
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, ctx=None,
              dtype="float32"):
    """``num`` evenly spaced values from ``start`` to ``stop``."""
    num = int(num)
    if endpoint or num == 0:
        out = torch.linspace(start, stop, num, dtype=torch.float64,
                             device=_dev(ctx))
    else:
        out = torch.linspace(start, stop, num + 1, dtype=torch.float64,
                             device=_dev(ctx))[:-1]
    return out.to(_dt(dtype))


# -- assignment, scatter, scans -----------------------------------------------

def _region_index(shape, begin, end, step=None):
    idx = []
    step = step or [None] * len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        s = 1 if s in (None, 0) else int(s)
        b = 0 if b is None else int(b)
        e = shape[d] if e is None else int(e)
        idx.append(slice(b, e, s))
    return tuple(idx)


@register_op("_slice_assign", aliases=["_crop_assign", "_npi_slice_assign"])
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """``lhs`` with its [begin, end) region set to ``rhs``."""
    out = lhs.clone()
    out[_region_index(lhs.shape, begin, end, step)] = rhs.to(lhs.dtype)
    return out


@register_op("_slice_assign_scalar",
             aliases=["_crop_assign_scalar", "_npi_slice_assign_scalar"])
def _slice_assign_scalar(data, begin=(), end=(), step=(), scalar=0.0):
    """``data`` with its [begin, end) region set to ``scalar``."""
    out = data.clone()
    out[_region_index(data.shape, begin, end, step)] = scalar
    return out


@register_op("_scatter_set_nd", aliases=["_npi_scatter_set_nd"])
def _scatter_set_nd(lhs, rhs, indices, shape=None):
    """``lhs`` with ``lhs[indices] = rhs``, ``indices`` an (M, N) array of
    index rows."""
    return lhs.index_put(tuple(indices.to(torch.int64)), rhs.to(lhs.dtype))


@register_op("cumsum", aliases=["_np_cumsum", "_npi_cumsum"])
def cumsum(a, axis=None, dtype=None):
    """Cumulative sum along ``axis`` (of the flattened input when
    None)."""
    x = a.reshape(-1) if axis is None else a
    out = torch.cumsum(x, 0 if axis is None else axis, dtype=_dt(dtype)
                       if dtype else None)
    if dtype is None and out.dtype is torch.int64 \
            and a.dtype is not torch.int64:
        out = out.to(torch.int32)
    return out


@register_op("_sparse_retain")
def _sparse_retain(data, indices):
    """The listed rows of a dense input, every other row zero (a
    ``row_sparse`` input keeps its stored rows instead, in
    ``ndarray/sparse_ops.py``)."""
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[indices.to(torch.int64)] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


@register_op("_histogram", n_out=2, differentiable=False,
             aliases=["histogram"])
def _histogram(data, *bins, bin_cnt=None, range=None):
    """Counts (float32, as the JAX package's) over the bin edges tensor,
    or over ``bin_cnt`` equal bins of ``range`` (the data's range when
    None); returns ``(counts, edges)``."""
    x = data.reshape(-1).float()
    if bins:
        edges = bins[0].float()
    else:
        lo, hi = (x.min().item(), x.max().item()) if range is None \
            else range
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, int(bin_cnt or 10) + 1,
                               device=x.device)
    # numpy's rule: bins half-open, the last closed
    idx = torch.bucketize(x, edges, right=True) - 1
    idx = torch.where(x == edges[-1], idx - 1, idx)
    n = edges.numel() - 1
    ok = (idx >= 0) & (idx < n)
    counts = torch.zeros(n, dtype=torch.int64, device=x.device)
    counts.index_add_(0, idx[ok], torch.ones_like(idx[ok]))
    return counts.to(torch.float32), edges.to(data.dtype)


@register_op("amp_multicast", n_out=-1)
def amp_multicast(*data, num_outputs=1, cast_narrow=False):
    """Every input cast to the widest (or, with ``cast_narrow``, the
    narrowest) floating dtype among them; non-float inputs never set
    it."""
    floats = [d.dtype for d in data if d.is_floating_point()]
    if not floats:
        return tuple(data)
    pick = min if cast_narrow else max
    target = pick(floats, key=lambda t: torch.finfo(t).bits)
    return tuple(d.to(target) for d in data)


@register_op("_contrib_boolean_mask", differentiable=False)
def boolean_mask_raw(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero
    (a shape known only after the mask is read, so one host sync)."""
    keep = torch.nonzero(index.to(torch.bool)).reshape(-1)
    return torch.index_select(data, axis, keep.to(data.device))


@register_op("_contrib_tvm_vadd")
def tvm_vadd(a, b):
    """``a + b``."""
    return a + b


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, target, penalty):
        ctx.save_for_backward(x)
        ctx.params = (target, penalty)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        target, penalty = ctx.params
        rho = torch.clamp(torch.mean(torch.sigmoid(x)), 1e-6, 1 - 1e-6)
        kl = penalty * (-target / rho + (1.0 - target) / (1.0 - rho))
        return g + kl / x.numel(), None, None


@register_op("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """The identity, whose backward adds the KL sparseness penalty's
    gradient on the mean sigmoid activation."""
    return _KLSparseReg.apply(data, sparseness_target, penalty)


register_op("_copyto", aliases=["_npi_copyto"],
            doc="A copy of the input (on its device).")(
    lambda data: data.clone())


# -- multi-tensor optimizer updates -------------------------------------------

def _listify(v, n):
    if v is None:
        return [None] * n
    if isinstance(v, (int, float)):
        return [v] * n
    return list(v)


def _clip_rescale(g, rescale_grad, clip_gradient):
    g = g * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register_op("multi_sgd_update", n_out=-1)
def multi_sgd_update(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """SGD over ``(w, g)`` pairs; returns the new weights."""
    n = int(num_weights)
    lrs, wds = _listify(lrs, n), _listify(wds, n)
    out = []
    for i in range(n):
        w, g = arrays[2 * i], arrays[2 * i + 1]
        g = _clip_rescale(g, rescale_grad, clip_gradient) + wds[i] * w
        out.append(w - lrs[i] * g)
    return tuple(out)


def _states(k, *slots):
    """The state map of a multi-tensor update over ``k``-tuples: output
    ``(j + 1) * n + i`` is the state at input ``k * i + slot_j``."""
    def mutates(params):
        n = int(params.get("num_weights", 1))
        return {(j + 1) * n + i: k * i + slot
                for j, slot in enumerate(slots) for i in range(n)}
    return mutates


@register_op("multi_sgd_mom_update", n_out=-1, mutates=_states(3, 2))
def multi_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """SGD with momentum over ``(w, g, mom)`` triples; returns the new
    weights, then the new momenta."""
    n = int(num_weights)
    lrs, wds = _listify(lrs, n), _listify(wds, n)
    ws, moms = [], []
    for i in range(n):
        w, g, m = arrays[3 * i:3 * i + 3]
        g = _clip_rescale(g, rescale_grad, clip_gradient) + wds[i] * w
        new_m = momentum * m - lrs[i] * g
        ws.append(w + new_m)
        moms.append(new_m)
    return tuple(ws + moms)


@register_op("multi_mp_sgd_update", n_out=-1, mutates=_states(3, 2))
def multi_mp_sgd_update(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1):
    """Mixed-precision SGD over ``(w, g, w32)`` triples; returns the new
    weights (``w``'s dtype), then the new fp32 master weights."""
    n = int(num_weights)
    lrs, wds = _listify(lrs, n), _listify(wds, n)
    ws, w32s = [], []
    for i in range(n):
        w, g, w32 = arrays[3 * i:3 * i + 3]
        g32 = _clip_rescale(g.float(), rescale_grad, clip_gradient) \
            + wds[i] * w32
        new_w32 = w32 - lrs[i] * g32
        ws.append(new_w32.to(w.dtype))
        w32s.append(new_w32)
    return tuple(ws + w32s)


@register_op("multi_mp_sgd_mom_update", n_out=-1,
             mutates=_states(4, 2, 3))
def multi_mp_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1):
    """Mixed-precision SGD with momentum over ``(w, g, mom, w32)`` quads;
    returns the new weights, then the momenta, then the fp32 master
    weights. fp16 weights and gradients go to the kernel's list form
    (on copies of the states, so the inputs stay as they were); other
    dtypes take the plain formula, tensor by tensor."""
    n = int(num_weights)
    lrs, wds = _listify(lrs, n), _listify(wds, n)
    quads = [arrays[4 * i:4 * i + 4] for i in range(n)]
    if quads and all(w.dtype == g.dtype == torch.float16
                     for w, g, _, _ in quads):
        ws = [w.clone() for w, _, _, _ in quads]
        moms = [m.clone() for _, _, m, _ in quads]
        w32s = [w32.clone() for _, _, _, w32 in quads]
        mp_sgd_mom_update_multi_kernel(
            ws, [g for _, g, _, _ in quads], moms, w32s, lrs, wds, momentum,
            rescale_grad, clip_gradient)
        return tuple(ws + moms + w32s)
    new = [mp_sgd_mom_update_ref(w, g, m, w32, lr, momentum, wd,
                                 rescale_grad, clip_gradient)
           for (w, g, m, w32), lr, wd in zip(quads, lrs, wds)]
    return tuple([r[0] for r in new] + [r[1] for r in new]
                 + [r[2] for r in new])


@register_op("mp_nag_mom_update", n_out=3, mutates={1: 2, 2: 3})
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Mixed-precision Nesterov momentum; returns ``(new_weight, new_mom,
    new_weight32)``."""
    g = _clip_rescale(grad.float(), rescale_grad, clip_gradient) \
        + wd * weight32
    new_mom = momentum * mom + g
    new_w32 = weight32 - lr * (g + momentum * new_mom)
    return new_w32.to(weight.dtype), new_mom, new_w32


@register_op("_contrib_group_adagrad_update", n_out=2, mutates={1: 2})
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """AdaGrad with one accumulated value per row; returns
    ``(new_weight, new_history)``."""
    g = _clip_rescale(grad, rescale_grad, clip_gradient)
    if g.dim() > 1:
        new_hist = history + torch.mean(torch.square(g),
                                        tuple(range(1, g.dim())),
                                        keepdim=True)
    else:
        new_hist = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_hist) + epsilon), new_hist


# -- deformable convolution ---------------------------------------------------

def _bilinear_at(img, y, x):
    """``img`` (N, G, C, H, W) sampled bilinearly at the fractional
    positions ``y``, ``x`` (N, G, ...): (N, G, C, ...). A read past an edge
    takes the clamped pixel, and a position outside (-1, H) x (-1, W) gives
    0, as in the JAX package."""
    N, G, C, H, W = img.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy, wx = y - y0, x - x0
    y0i = y0.long().clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    x0i = x0.long().clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    flat = img.reshape(N, G, C, H * W)
    pts = y.shape[2:]

    def at(yi, xi):
        idx = (yi * W + xi).reshape(N, G, 1, -1).expand(N, G, C, -1)
        return torch.gather(flat, 3, idx).reshape((N, G, C) + pts)

    valid = ((y > -1) & (y < H) & (x > -1) & (x < W)).to(img.dtype)
    wy, wx, valid = wy[:, :, None], wx[:, :, None], valid[:, :, None]
    out = (at(y0i, x0i) * (1 - wy) * (1 - wx) + at(y0i, x1i) * (1 - wy) * wx
           + at(y1i, x0i) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return out * valid


@register_op("_contrib_DeformableConvolution",
             aliases=["DeformableConvolution"],
             input_names=("data", "offset", "weight", "bias"))
def deformable_convolution(data, offset, weight, *bias, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=0, num_group=1, num_deformable_group=1,
                           workspace=1024, no_bias=False, layout=None):
    """Deformable convolution v1 (Dai et al. 2017): the zero-padded input
    sampled bilinearly at each kernel tap moved by its offset (``offset``
    is (N, 2 * num_deformable_group * kh * kw, Ho, Wo), (dy, dx) per tap),
    then one (grouped) matrix product with ``weight``."""
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    N, C, H, W = data.shape
    DG, ng = int(num_deformable_group), int(num_group)
    K = kh * kw
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xpad = torch.nn.functional.pad(data, (pw, pw, ph, ph))
    off = offset.reshape(N, DG, K, 2, Ho, Wo)
    dev = data.device
    ky = (torch.arange(K, device=dev) // kw) * dh
    kx = (torch.arange(K, device=dev) % kw) * dw
    oy = torch.arange(Ho, device=dev) * sh
    ox = torch.arange(Wo, device=dev) * sw
    y = (oy[None, :, None] + ky[:, None, None]).to(data.dtype) \
        + off[:, :, :, 0]
    x = (ox[None, None, :] + kx[:, None, None]).to(data.dtype) \
        + off[:, :, :, 1]
    img = xpad.reshape(N, DG, C // DG, xpad.shape[2], xpad.shape[3])
    cols = _bilinear_at(img, y, x)  # (N, DG, C/DG, K, Ho, Wo)
    F_ = weight.shape[0]
    cols = cols.reshape(N, ng, (C // ng) * K, Ho * Wo)
    wmat = weight.reshape(ng, F_ // ng, (C // ng) * K)
    out = torch.einsum("gfk,ngkp->ngfp", wmat, cols).reshape(N, F_, Ho, Wo)
    if bias and not no_bias:
        out = out + bias[0].reshape(1, -1, 1, 1)
    return out
