"""Image ops: the ``_image_*`` ops and the OpenCV-role ``_cv*`` ops.

Counterpart of ``mxnet_tpu/ops/image_ops.py``, of
``mxnet_tpu/ops/legacy_aliases.py``'s ``_image_adjust_lighting`` and of
``mxnet_tpu/ops/extra_ops.py``'s ``_cvimdecode``, ``_cvimread``,
``_cvimresize`` and ``_cvcopyMakeBorder`` (ref: src/operator/image/ and
src/io/image_io.cc). Images are HWC (or NHWC batches), uint8 or float,
except ``to_tensor``'s CHW output. Resizing is bilinear, antialiased when
shrinking, as ``jax.image.resize(method="linear")`` (nearest for
``interp=0``). The random ops draw from the device's generator, which
the nd layer passes as ``_generator`` (the JAX package draws from its
threefry key: the same distributions, not the same values). Each op is
also registered as ``_npx__image_<name>`` (and the four of the legacy
namespace as ``image_<name>``), the ``_cv*`` ops as ``_npi_<name>``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import _OPS, register_op

__all__ = ["resize_hwc", "cvimresize"]

_GRAY = (0.299, 0.587, 0.114)
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))


def resize_hwc(x, h, w, mode="bilinear", round_ints=True):
    """Resize the H, W axes of an HWC (NHWC) tensor in float32, keeping
    its dtype; an integer result is rounded (half to even) and clipped to
    its dtype's range where ``round_ints``, else truncated."""
    batch = x.unsqueeze(0) if x.dim() == 3 else x
    t = batch.permute(0, 3, 1, 2).to(torch.float32)
    if mode.startswith("nearest"):
        out = F.interpolate(t, size=(h, w), mode=mode)
    else:
        out = F.interpolate(t, size=(h, w), mode=mode, align_corners=False,
                            antialias=True)
    out = out.permute(0, 2, 3, 1)
    if not x.dtype.is_floating_point and round_ints:
        info = torch.iinfo(x.dtype)
        out = out.round().clamp(info.min, info.max)
    out = out.to(x.dtype)
    return out[0] if x.dim() == 3 else out


def _uniform(g, lo, hi):
    """One draw from U[lo, hi) on the generator's device."""
    return float(lo) + (float(hi) - float(lo)) * torch.rand(
        (), generator=g, device=g.device).item()


def _coin(g):
    return torch.rand((), generator=g, device=g.device).item() < 0.5


@register_op("_image_to_tensor", aliases=["image_to_tensor"])
def to_tensor(data):
    """HWC [0, 255] -> CHW [0, 1] float32 (NHWC -> NCHW)."""
    x = data.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)


@register_op("_image_normalize", aliases=["image_normalize"])
def normalize(data, mean=0.0, std=1.0):
    """Channel-wise ``(x - mean) / std`` of CHW float input."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=data.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=data.device)
    if mean.dim() == 0:
        return (data - mean) / std
    return (data - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)


@register_op("_image_resize", aliases=["image_resize"])
def resize(data, size=(0, 0), keep_ratio=False, interp=1):
    """Bilinear resize of HWC/NHWC images to ``size`` (w, h); an integer
    image is truncated back to its dtype, as the JAX package's cast."""
    w, h = (size, size) if isinstance(size, int) else size
    if h == 0 or w == 0:
        shape = list(data.shape)
        shape[-3:-1] = [h, w]
        return data.new_zeros(shape)
    return resize_hwc(data, int(h), int(w), round_ints=False)


@register_op("_image_crop", aliases=["image_crop"])
def crop(data, x=0, y=0, width=1, height=1):
    """The window (x, y, width, height) of HWC/NHWC images."""
    return data[..., y:y + height, x:x + width, :]


def _flip_axis(data, horizontal):
    return data.dim() - (2 if horizontal else 3)


@register_op("_image_flip_left_right", differentiable=False)
def flip_left_right(data):
    return torch.flip(data, (_flip_axis(data, True),))


@register_op("_image_flip_top_bottom", differentiable=False)
def flip_top_bottom(data):
    return torch.flip(data, (_flip_axis(data, False),))


@register_op("_image_random_flip_left_right", needs_rng=True,
             differentiable=False)
def random_flip_left_right(data, _generator=None):
    """Horizontal flip with probability 1/2."""
    return flip_left_right(data) if _coin(_generator) else data.clone()


@register_op("_image_random_flip_top_bottom", needs_rng=True,
             differentiable=False)
def random_flip_top_bottom(data, _generator=None):
    """Vertical flip with probability 1/2."""
    return flip_top_bottom(data) if _coin(_generator) else data.clone()


def _gray(x):
    return (x * torch.tensor(_GRAY, device=x.device)).sum(-1, keepdim=True)


@register_op("_image_random_brightness", needs_rng=True)
def random_brightness(data, min_factor=0.0, max_factor=1.0,
                      _generator=None):
    """Scale by a factor drawn from U[min_factor, max_factor)."""
    return data.to(torch.float32) * _uniform(_generator, min_factor,
                                             max_factor)


@register_op("_image_random_contrast", needs_rng=True)
def random_contrast(data, min_factor=0.0, max_factor=1.0, _generator=None):
    """Blend toward the image's mean by a drawn factor."""
    f = _uniform(_generator, min_factor, max_factor)
    x = data.to(torch.float32)
    return x * f + x.mean() * (1 - f)


@register_op("_image_random_saturation", needs_rng=True)
def random_saturation(data, min_factor=0.0, max_factor=1.0,
                      _generator=None):
    """Blend toward each pixel's luma by a drawn factor."""
    f = _uniform(_generator, min_factor, max_factor)
    x = data.to(torch.float32)
    return x * f + _gray(x) * (1 - f)


@register_op("_image_random_hue", needs_rng=True)
def random_hue(data, min_factor=0.0, max_factor=1.0, _generator=None):
    """Blend toward each pixel's channel mean by a drawn factor (the JAX
    package's simplified hue)."""
    f = _uniform(_generator, min_factor, max_factor)
    x = data.to(torch.float32)
    return x * f + x.mean(-1, keepdim=True) * (1 - f)


@register_op("_image_random_color_jitter", needs_rng=True)
def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0, _generator=None):
    """Brightness, contrast, saturation and hue jitter in that order, each
    factor drawn from U[1 - m, 1 + m) where its magnitude m is set."""
    x = data.to(torch.float32)
    if brightness:
        x = x * _uniform(_generator, 1 - brightness, 1 + brightness)
    if contrast:
        f = _uniform(_generator, 1 - contrast, 1 + contrast)
        x = x * f + x.mean() * (1 - f)
    if saturation:
        f = _uniform(_generator, 1 - saturation, 1 + saturation)
        x = x * f + _gray(x) * (1 - f)
    if hue:
        f = _uniform(_generator, 1 - hue, 1 + hue)
        x = x * f + x.mean(-1, keepdim=True) * (1 - f)
    return x


def _lighting_shift(alpha, device, dtype=torch.float32):
    eigval = torch.tensor(_EIGVAL, dtype=dtype, device=device)
    eigvec = torch.tensor(_EIGVEC, dtype=dtype, device=device)
    return (eigvec * (alpha * eigval)).sum(1)


@register_op("_image_random_lighting", needs_rng=True)
def random_lighting(data, alpha_std=0.05, _generator=None):
    """AlexNet-style PCA lighting noise on the RGB channels, its three
    coefficients drawn from N(0, alpha_std)."""
    alpha = alpha_std * torch.randn(3, generator=_generator,
                                    device=_generator.device)
    return data.to(torch.float32) + _lighting_shift(alpha.to(data.device),
                                                    data.device)


@register_op("_image_adjust_lighting", differentiable=False)
def adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """The PCA lighting shift with fixed coefficients ``alpha``: on the
    channel axis of CHW input, else on the last axis."""
    shift = _lighting_shift(torch.as_tensor(alpha, dtype=data.dtype,
                                            device=data.device),
                            data.device, data.dtype)
    if data.shape[-3] == 3:
        return data + shift.reshape((3,) + (1,) * (data.dim() - 3) + (1, 1))
    return data + shift


for _img in ("adjust_lighting", "crop", "flip_left_right", "flip_top_bottom",
             "normalize", "random_brightness", "random_color_jitter",
             "random_contrast", "random_flip_left_right",
             "random_flip_top_bottom", "random_hue", "random_lighting",
             "random_saturation", "resize", "to_tensor"):
    _OPS.setdefault(f"_npx__image_{_img}", _OPS[f"_image_{_img}"])


# -- the OpenCV-role ops (src/io/image_io.cc) ----------------------------------

@register_op("_cvimdecode", aliases=["_npi_cvimdecode"],
             differentiable=False)
def cvimdecode(data, flag=1, to_rgb=True):
    """Decode an encoded image held as a 1-D uint8 tensor to (H, W, C)
    (through :func:`mxnet_tpu_torch.image.imdecode`'s decoder); on the
    input's device. Host-side: the output shape depends on the data."""
    import numpy as onp
    from ..image import _decode
    img = _decode(data.cpu().numpy().tobytes(), int(flag), bool(to_rgb))
    return torch.from_numpy(onp.ascontiguousarray(img)).to(data.device)


@register_op("_cvimread", aliases=["_npi_cvimread"], differentiable=False)
def cvimread(filename="", flag=1, to_rgb=True, ctx=None):
    """Read and decode an image file (no tensor input): on ``ctx``."""
    import numpy as onp
    from ..context import as_device
    from ..image import _decode
    with open(filename, "rb") as f:
        img = _decode(f.read(), int(flag), bool(to_rgb))
    return torch.from_numpy(onp.ascontiguousarray(img)).to(as_device(ctx))


@register_op("_cvimresize", aliases=["_npi_cvimresize"])
def cvimresize(data, w=0, h=0, interp=1):
    """Resize an (H, W, C) image to ``w`` x ``h``: nearest for
    ``interp=0``, else bilinear; an integer image is rounded and
    saturated to its own dtype's range, as OpenCV does."""
    if int(w) <= 0 or int(h) <= 0:
        raise ValueError(f"imresize requires positive w/h, got "
                         f"w={w}, h={h}")
    return resize_hwc(data, int(h), int(w),
                      "nearest-exact" if int(interp) == 0 else "bilinear")


def _border_index(n, before, after, mode, device):
    """Source row (column) of each padded position, as numpy's ``pad``
    modes ``edge``, ``symmetric``, ``wrap`` and ``reflect`` choose it."""
    i = torch.arange(-before, n + after, device=device)
    if mode == 1:  # REPLICATE: numpy's edge
        return i.clamp(0, n - 1)
    if mode == 3:  # WRAP
        return torch.remainder(i, n)
    if mode == 2:  # REFLECT: numpy's symmetric, period 2n
        i = torch.remainder(i, 2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    if n == 1:  # REFLECT_101 of one row repeats it
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * n - 2)  # REFLECT_101: numpy's reflect
    return torch.where(i >= n, 2 * n - 2 - i, i)


@register_op("_cvcopyMakeBorder", aliases=["_npi_copyMakeBorder"])
def cvcopy_make_border(data, top=0, bot=0, left=0, right=0, type=0,
                       value=0.0, values=()):
    """Pad an (H, W, C) image: OpenCV's border types 0 CONSTANT (``value``,
    or one value per channel in ``values``), 1 REPLICATE, 2 REFLECT (the
    edge repeated), 3 WRAP, 4 REFLECT_101 (unknown types: REPLICATE)."""
    top, bot, left, right = int(top), int(bot), int(left), int(right)
    mode = int(type) if int(type) in (0, 1, 2, 3, 4) else 1
    if mode == 0:
        if values:
            chans = [F.pad(data[:, :, c], (left, right, top, bot),
                           value=float(values[min(c, len(values) - 1)]))
                     for c in range(data.shape[2])]
            return torch.stack(chans, dim=2)
        return F.pad(data, (0, 0, left, right, top, bot),
                     value=float(value))
    rows = _border_index(data.shape[0], top, bot, mode, data.device)
    cols = _border_index(data.shape[1], left, right, mode, data.device)
    return data[rows][:, cols]
