"""Vision transforms: image (HWC, or NHWC batch) to tensor, with the
crops, resizes, flips and colour jitters of training pipelines.

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py``. A transform
is a Block that takes an NDArray (and returns one on its device), a torch
tensor, or a numpy array (and returns numpy, so that a DataLoader worker
never reaches a device). The random transforms draw from numpy: from its
global generator, as the JAX package does (``numpy.random.seed`` fixes
both), or from the ``numpy.random.RandomState`` given as ``generator=``.
Resizing is bilinear with antialiasing when shrinking, as
``jax.image.resize(method="linear")``.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ....ndarray.ndarray import NDArray, _wrap, as_torch_dtype
from ....ops.image_ops import resize_hwc as _resize
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "CropResize", "RandomResizedCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomHue",
           "RandomColorJitter", "RandomLighting"]


class _Transform(Block):
    """Runs :meth:`_apply` on a tensor: an NDArray's, a tensor, or a numpy
    array's (the result back to numpy)."""

    def __call__(self, x):
        if isinstance(x, NDArray):
            return _wrap(self._apply(x._data))
        if isinstance(x, torch.Tensor):
            return self._apply(x)
        return self._apply(torch.from_numpy(onp.asarray(x))).numpy()

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Compose(Sequential):
    """The transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)

    def __call__(self, x):
        for t in self:
            x = t(x)
        return x


class Cast(_Transform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = as_torch_dtype(dtype)

    def _apply(self, x):
        return x.to(self._dtype)


class ToTensor(_Transform):
    """HWC (or NHWC) uint8 in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""

    def _apply(self, x):
        out = x.to(torch.float32) / 255.0
        return out.permute(2, 0, 1) if out.dim() == 3 \
            else out.permute(0, 3, 1, 2)


class Normalize(_Transform):
    """``(x - mean) / std`` per channel of a CHW (NCHW) tensor."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = torch.as_tensor(onp.asarray(mean, onp.float32)
                                     .reshape(-1, 1, 1))
        self._std = torch.as_tensor(onp.asarray(std, onp.float32)
                                    .reshape(-1, 1, 1))

    def _apply(self, x):
        return (x - self._mean.to(x.device)) / self._std.to(x.device)


class Resize(_Transform):
    """Resize to ``size`` (width, height), or ``(size, size)``."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply(self, x):
        return _resize(x, self._size[1], self._size[0])


class CenterCrop(_Transform):
    """The central ``size`` (width, height) window."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0, x0 = max((H - h) // 2, 0), max((W - w) // 2, 0)
        return x[..., y0:y0 + h, x0:x0 + w, :]


class CropResize(_Transform):
    """The fixed window (x, y, width, height), then a resize to ``size``
    where given; a window outside the image raises."""

    _MODES = {0: "nearest", 1: "bilinear", 2: "bilinear", 3: "bicubic"}

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y, self._w, self._h = x, y, width, height
        self._size = (size, size) if isinstance(size, int) else size
        self._interp = interpolation

    def _apply(self, img):
        H, W = img.shape[-3], img.shape[-2]
        if self._w <= 0 or self._h <= 0 or self._x < 0 or self._y < 0 \
                or self._x + self._w > W or self._y + self._h > H:
            raise ValueError(
                f"crop window (x={self._x}, y={self._y}, w={self._w}, "
                f"h={self._h}) exceeds image bounds {W}x{H}")
        out = img[..., self._y:self._y + self._h,
                  self._x:self._x + self._w, :]
        if self._size is not None:
            tw, th = self._size
            out = _resize(out, th, tw,
                          self._MODES.get(self._interp, "bilinear"))
        return out


class _Random(_Transform):
    def __init__(self, generator=None):
        super().__init__()
        self._rng = generator

    @property
    def rng(self):
        return self._rng if self._rng is not None else onp.random


class RandomResizedCrop(_Random):
    """A random window of ``scale`` of the area and aspect ``ratio``,
    resized to ``size``; the whole image resized after ten misses."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1, generator=None):
        super().__init__(generator)
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def _apply(self, x):
        H, W = x.shape[-3], x.shape[-2]
        area = H * W
        rng = self.rng
        for _ in range(10):
            target_area = rng.uniform(*self._scale) * area
            aspect = math.exp(rng.uniform(math.log(self._ratio[0]),
                                          math.log(self._ratio[1])))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = rng.randint(0, W - w + 1)
                y0 = rng.randint(0, H - h + 1)
                x = x[..., y0:y0 + h, x0:x0 + w, :]
                break
        return _resize(x, self._size[1], self._size[0])


class RandomFlipLeftRight(_Random):
    def _apply(self, x):
        return x.flip(-2) if self.rng.rand() < 0.5 else x


class RandomFlipTopBottom(_Random):
    def _apply(self, x):
        return x.flip(-3) if self.rng.rand() < 0.5 else x


class _RandomJitter(_Random):
    def __init__(self, magnitude, generator=None):
        super().__init__(generator)
        self._m = magnitude

    def _factor(self):
        return 1.0 + self.rng.uniform(-self._m, self._m)


class RandomBrightness(_RandomJitter):
    def _apply(self, x):
        return x * self._factor()


class RandomContrast(_RandomJitter):
    def _apply(self, x):
        f = self._factor()
        x = x.to(torch.float32)
        return x * f + x.mean() * (1 - f)


class RandomSaturation(_RandomJitter):
    def _apply(self, x):
        f = self._factor()
        x = x.to(torch.float32)
        coef = torch.tensor([0.299, 0.587, 0.114], device=x.device)
        gray = (x * coef).sum(-1, keepdim=True)
        return x * f + gray * (1 - f)


class RandomHue(_RandomJitter):
    """The JAX package's simplified hue jitter: each pixel's channels
    pulled toward (or pushed from) their mean."""

    def _apply(self, x):
        f = self._factor()
        x = x.to(torch.float32)
        return x * f + x.mean(-1, keepdim=True) * (1 - f)


class RandomColorJitter(_Random):
    """The non-zero jitters of brightness, contrast, saturation and hue in
    a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 generator=None):
        super().__init__(generator)
        self._ts = [klass(m, generator) for klass, m in (
            (RandomBrightness, brightness), (RandomContrast, contrast),
            (RandomSaturation, saturation), (RandomHue, hue)) if m]

    def _apply(self, x):
        for i in self.rng.permutation(len(self._ts)):
            x = self._ts[i]._apply(x)
        return x


class RandomLighting(_Random):
    """AlexNet's PCA lighting noise of scale ``alpha``."""

    _eigval = onp.asarray([55.46, 4.794, 1.148], onp.float32)
    _eigvec = onp.asarray([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]], onp.float32)

    def __init__(self, alpha, generator=None):
        super().__init__(generator)
        self._alpha = alpha

    def _apply(self, x):
        alpha = self.rng.normal(0, self._alpha, size=(3,))
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return x.to(torch.float32) + torch.as_tensor(
            rgb.astype(onp.float32), device=x.device)
