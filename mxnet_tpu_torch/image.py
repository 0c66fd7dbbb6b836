"""Image API: decode, resize, crop, augment, and the image iterators.

Counterpart of ``mxnet_tpu/image.py`` (ref: python/mxnet/image/image.py
and detection.py): ``imdecode``/``imread``/``imresize``, the crops,
``color_normalize``, every ``Augmenter`` and ``CreateAugmenter``,
``ImageIter`` and ``ImageRecordIterPy``, and the detection tier
(the ``DetAugmenter`` classes, ``CreateDetAugmenter``, ``ImageDetIter``).

Decoding takes OpenCV, else Pillow, as the JAX package's does, else the
native library's JPEG codec (:func:`mxnet_tpu_torch.native.decode`);
:func:`decoder` says which, chosen once. Random draws come from Python's
``random`` and numpy's global generator, as the JAX package's do, so one
seed of both gives the same crops, flips and jitters in both packages.
Resizing is the ``_cvimresize`` op (bilinear, antialiased when
shrinking). The functions and augmenters return NDArrays on the current
context (numpy in, numpy out for the jitter augmenters, as in the JAX
package). The iterators decode and augment each sample on the CPU and put
each batch on the context current when the iterator was made (the card
unless the caller asks for the CPU).
"""
from __future__ import annotations

import json
import os
import random as pyrandom
from typing import List

import numpy as onp

from .base import MXNetError
from .context import cpu, current_context
from .io.io import DataBatch, DataDesc, DataIter
from .ndarray.ndarray import NDArray, array

__all__ = ["imdecode", "imread", "imresize", "resize_short", "center_crop",
           "random_crop", "fixed_crop", "color_normalize", "decoder",
           "CreateAugmenter", "Augmenter",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "ColorNormalizeAug", "CastAug",
           "SequentialAug", "RandomOrderAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "RandomGrayAug", "ImageIter",
           "ImageRecordIterPy", "DetAugmenter", "DetBorrowAug",
           "DetRandomSelectAug", "DetHorizontalFlipAug", "DetRandomCropAug",
           "DetRandomPadAug", "DetForceResizeAug", "CreateDetAugmenter",
           "ImageDetIter"]

_DECODER = []  # the decoder's name, chosen at the first decode


def decoder() -> str:
    """The image decoder ``imdecode`` uses: ``"cv2"``, ``"pillow"`` or
    ``"native-<codec>"``; raises where there is none."""
    if not _DECODER:
        try:
            import cv2  # noqa: F401
            name = "cv2"
        except ImportError:
            try:
                import PIL.Image  # noqa: F401
                name = "pillow"
            except ImportError:
                from . import native
                name = f"native-{native.codec()}"
        _DECODER.append(name)
    return _DECODER[0]


def _decode(buf, flag=1, to_rgb=True):
    """HWC (or HW where ``flag == 0``) uint8 numpy image of ``buf``."""
    name = decoder()
    if name == "cv2":
        import cv2
        img = cv2.imdecode(onp.frombuffer(buf, onp.uint8),
                           cv2.IMREAD_COLOR if flag else
                           cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise MXNetError("imdecode failed")
        return img[:, :, ::-1] if to_rgb and flag else img
    if name == "pillow":
        import io as _io
        from PIL import Image
        # honor flag/to_rgb like the cv2 path: flag=0 -> grayscale;
        # to_rgb=False means BGR channel order (OpenCV native)
        img = onp.asarray(Image.open(_io.BytesIO(buf))
                          .convert("L" if not flag else "RGB"))
    else:
        from . import native
        img = native.decode(bytes(buf), 3 if flag else 1)
        if not flag:
            img = img[:, :, 0]
    return img[:, :, ::-1] if flag and not to_rgb else img


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Decode an encoded image (JPEG, or PNG where OpenCV or Pillow
    decodes): a uint8 NDArray, HWC (RGB unless ``to_rgb=False``) or HW
    gray where ``flag == 0``."""
    return array(onp.ascontiguousarray(_decode(buf, flag, to_rgb)),
                 dtype="uint8")


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w, h, interp=1):
    """Resize an HWC image to ``w`` x ``h`` through the ``_cvimresize``
    op, so ``mx.image`` and ``nd._cvimresize`` cannot drift."""
    import torch
    from .ndarray.ndarray import _wrap
    from .ops.image_ops import cvimresize
    data = src._data if isinstance(src, NDArray) else \
        torch.from_numpy(onp.ascontiguousarray(src)).to(
            current_context().torch_device)
    return _wrap(cvimresize(data, w=w, h=h, interp=interp))


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = src[y0:y0 + new_h, x0:x0 + new_w]
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = pyrandom.randint(0, max(w - new_w, 0))
    y0 = pyrandom.randint(0, max(h - new_h, 0))
    out = src[y0:y0 + new_h, x0:x0 + new_w]
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    if mean is not None:  # std-only normalization is valid
        src = src - mean
    if std is not None:
        src = src / std
    return src


class Augmenter:
    """ref: image.py Augmenter."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return src[:, ::-1]
        return src


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = onp.asarray(mean, onp.float32) \
            if mean is not None else None
        self.std = onp.asarray(std, onp.float32) \
            if std is not None else None

    def __call__(self, src):
        def on(v):  # the statistics on the image's context
            return v if v is None or not isinstance(src, NDArray) \
                else array(v, ctx=src.ctx)
        return color_normalize(src.astype("float32"), on(self.mean),
                               on(self.std))


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """ref: image.py fixed_crop — crop the (x0, y0, w, h) window, then
    optionally resize to `size` (w, h)."""
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def _as_host(src):
    """Augmenter-internal host view: jitter math runs in numpy; NDArray
    inputs round-trip, numpy inputs stay numpy (no device hops when
    augs are chained)."""
    if hasattr(src, "asnumpy"):
        return onp.asarray(src.asnumpy(), onp.float32), True
    return onp.asarray(src, onp.float32), False


def _from_host(a, was_nd):
    return array(a) if was_nd else a


class SequentialAug(Augmenter):
    """ref: image.py SequentialAug — apply children in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    """ref: image.py RandomOrderAug — children in random order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [t.dumps() for t in self.ts]]

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class BrightnessJitterAug(Augmenter):
    """ref: image.py BrightnessJitterAug — scale by 1±U(0, brightness)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    """ref: image.py ContrastJitterAug — blend with the mean gray."""

    _GRAY = onp.array([0.299, 0.587, 0.114], onp.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        a, was_nd = _as_host(src)
        gray = (a * self._GRAY).sum(axis=-1).mean()
        return _from_host(a * alpha + gray * (1.0 - alpha), was_nd)


class SaturationJitterAug(Augmenter):
    """ref: image.py SaturationJitterAug — blend with per-pixel gray."""

    _GRAY = ContrastJitterAug._GRAY

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        a, was_nd = _as_host(src)
        gray = (a * self._GRAY).sum(axis=-1, keepdims=True)
        return _from_host(a * alpha + gray * (1.0 - alpha), was_nd)


class HueJitterAug(Augmenter):
    """ref: image.py HueJitterAug — rotate color about the gray axis
    (the yiq-matrix formulation)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = onp.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], onp.float32)
        self.ityiq = onp.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], onp.float32)

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u, w = onp.cos(alpha * onp.pi), onp.sin(alpha * onp.pi)
        bt = onp.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       onp.float32)
        t = self.ityiq @ bt @ self.tyiq
        a, was_nd = _as_host(src)
        return _from_host(a @ t.T, was_nd)


class LightingAug(Augmenter):
    """ref: image.py LightingAug — AlexNet-style PCA color noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd,
                         eigval=onp.asarray(eigval).tolist(),
                         eigvec=onp.asarray(eigvec).tolist())
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, onp.float32)
        self.eigvec = onp.asarray(eigvec, onp.float32)

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        rgb = rgb.astype(onp.float32)
        return src + (array(rgb, ctx=src.ctx) if isinstance(src, NDArray)
                      else rgb)


class RandomGrayAug(Augmenter):
    """ref: image.py RandomGrayAug — with prob p convert to gray
    (luminance weights, matching the reference's gray matrix)."""

    _MAT = onp.tile(onp.array([[0.21], [0.72], [0.07]], onp.float32),
                    (1, 3))

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            a, was_nd = _as_host(src)
            return _from_host(a @ self._MAT, was_nd)
        return src


class ColorJitterAug(RandomOrderAug):
    """ref: image.py ColorJitterAug — brightness/contrast/saturation in
    random order."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """ref: image.py CreateAugmenter."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        # ImageNet eigval/eigvec (ref: image.py CreateAugmenter)
        auglist.append(LightingAug(
            pca_noise,
            [55.46, 4.794, 1.148],
            [[-0.5675, 0.7192, 0.4009],
             [-0.5808, -0.0045, -0.8140],
             [-0.5836, -0.6948, 0.4203]]))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = onp.asarray([123.68, 116.28, 103.53])
    if std is True:
        std = onp.asarray([58.395, 57.12, 57.375])
    if mean is not None and (std is not None or True):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Batches of images from a ``.rec`` file (keyed through its ``.idx``
    where there is one), a ``.lst`` file or an in-memory list, through the
    augmenters (``aug_list``, or ``CreateAugmenter`` of the augmentation
    keywords). Each sample is decoded and augmented on the CPU; each batch
    lands on the context current when the iterator was made."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self.ctx = current_context()
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        # forward augmentation kwargs to CreateAugmenter like the
        # reference ImageIter; unknown kwargs must not silently disable
        # the requested augmentation
        aug_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if k in ("resize", "rand_crop", "rand_resize",
                               "rand_mirror", "mean", "std", "brightness",
                               "contrast", "saturation", "hue",
                               "pca_noise", "rand_gray", "inter_method")}
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **aug_kwargs)
        self.data_name = data_name
        self.label_name = label_name
        self.shuffle = shuffle
        self.seq = []
        self.imgrec = None
        self.imglist = {}
        if path_imgrec:
            from .recordio import MXIndexedRecordIO, MXRecordIO
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self.imgrec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = MXRecordIO(path_imgrec, "r")
                self.seq = None
        elif path_imglist:
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = onp.asarray(parts[1:-1], dtype=onp.float32)
                    key = int(parts[0])
                    self.imglist[key] = (label, parts[-1])
                    self.seq.append(key)
            self.path_root = path_root
        elif imglist:
            for i, (label, fname) in enumerate(imglist):
                self.imglist[i] = (onp.asarray(label, onp.float32)
                                   if not onp.isscalar(label)
                                   else onp.asarray([label], onp.float32),
                                   fname)
                self.seq.append(i)
            self.path_root = path_root
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        if self.shuffle and self.seq:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        from .recordio import unpack
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), "rb") as f:
                img = f.read()
            return label, img
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = unpack(s)
        return header.label, img

    def _sample(self):
        """The next sample decoded and augmented: (label, CHW float32)."""
        label, s = self.next_sample()
        with cpu():
            img = imdecode(s) if isinstance(s, bytes) else array(s)
            for aug in self.auglist:
                img = aug(img)
        arr = img.asnumpy() if isinstance(img, NDArray) else img
        if arr.ndim == 3 and arr.shape[2] == self.data_shape[0]:
            arr = arr.transpose(2, 0, 1)
        return label, arr

    def next(self):
        batch_data = onp.zeros((self.batch_size,) + self.data_shape,
                               onp.float32)
        batch_label = onp.zeros((self.batch_size, self.label_width),
                                onp.float32)
        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                label, batch_data[i] = self._sample()
                batch_label[i] = onp.asarray(label).reshape(-1)[
                    :self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = self.batch_size - i
        label_out = batch_label[:, 0] if self.label_width == 1 \
            else batch_label
        return DataBatch(data=[array(batch_data, ctx=self.ctx)],
                         label=[array(label_out, ctx=self.ctx)], pad=pad)

    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False


def ImageRecordIterPy(path_imgrec=None, data_shape=(3, 224, 224),
                      batch_size=1, label_width=1, shuffle=False,
                      mean_r=0, mean_g=0, mean_b=0, std_r=1, std_g=1,
                      std_b=1, rand_crop=False, rand_mirror=False,
                      resize=0, **kwargs):
    mean = None
    if mean_r or mean_g or mean_b:
        mean = onp.asarray([mean_r, mean_g, mean_b])
    std = None
    if (std_r, std_g, std_b) != (1, 1, 1):
        std = onp.asarray([std_r, std_g, std_b])
    jitter = {k: kwargs.pop(k) for k in list(kwargs)
              if k in ("brightness", "contrast", "saturation", "hue",
                       "pca_noise", "rand_gray", "inter_method")}
    augs = CreateAugmenter(data_shape, resize=resize, rand_crop=rand_crop,
                           rand_mirror=rand_mirror, mean=mean, std=std,
                           **jitter)
    return ImageIter(batch_size, data_shape, label_width,
                     path_imgrec=path_imgrec, shuffle=shuffle,
                     aug_list=augs, **kwargs)


# ---------------------------------------------------------------------------
# Detection tier (ref: python/mxnet/image/detection.py — DetAugmenter set,
# CreateDetAugmenter, ImageDetIter; backs the SSD input pipeline together
# with io.ImageDetRecordIter / src/io/image_det_aug_default.cc)
#
# Label convention (reference lst/rec detection format): a flat float row
# [A, B, <A-2 extra header>, obj0(B values), obj1(B values), ...] where
# A = header width (>=2), B = per-object width (>=5) and each object is
# [class_id, xmin, ymin, xmax, ymax, ...] with coordinates normalized to
# [0, 1]. Parsed object matrices have shape (num_objs, B).
# ---------------------------------------------------------------------------


class DetAugmenter:
    """ref: detection.py DetAugmenter — image+label joint augmenter."""

    def __call__(self, src, label):
        raise NotImplementedError

    def dumps(self):
        """Name + json-serializable config (ref: detection.py dumps)."""
        def enc(v):
            if isinstance(v, (int, float, str, bool, type(None))):
                return v
            if isinstance(v, (tuple, list)):
                return [enc(x) for x in v]
            if isinstance(v, (Augmenter, DetAugmenter)):
                return v.dumps()
            return str(v)
        kw = {k: enc(v) for k, v in self.__dict__.items()
              if not k.startswith("_")}
        return json.dumps([self.__class__.__name__.lower(), kw])


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter; label passes through
    (ref: detection.py DetBorrowAug)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly select one augmenter from a list, or skip entirely
    (ref: detection.py DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or pyrandom.random() < self.skip_prob:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and box x-coordinates with probability p
    (ref: detection.py DetHorizontalFlipAug)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            arr = _as_host(src)[0]
            src = arr[:, ::-1, :].copy()
            label = label.copy()
            xmin = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - xmin
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping enough object coverage; boxes are re-projected
    into crop coordinates and objects whose center falls outside are
    dropped (ref: detection.py DetRandomCropAug)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), max_attempts=50):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _try_crop(self, h, w):
        import math
        ratio = pyrandom.uniform(*self.aspect_ratio_range)
        area = pyrandom.uniform(*self.area_range) * h * w
        ch = int(round(math.sqrt(area / ratio)))
        cw = int(round(math.sqrt(area * ratio)))
        if ch > h or cw > w or ch < 1 or cw < 1:
            return None
        y0 = pyrandom.randint(0, h - ch)
        x0 = pyrandom.randint(0, w - cw)
        return x0, y0, cw, ch

    def _project(self, label, x0, y0, cw, ch, w, h):
        out = []
        for obj in label:
            cx = (obj[1] + obj[3]) / 2 * w
            cy = (obj[2] + obj[4]) / 2 * h
            if not (x0 <= cx < x0 + cw and y0 <= cy < y0 + ch):
                continue
            o = obj.copy()
            o[1] = onp.clip((obj[1] * w - x0) / cw, 0, 1)
            o[2] = onp.clip((obj[2] * h - y0) / ch, 0, 1)
            o[3] = onp.clip((obj[3] * w - x0) / cw, 0, 1)
            o[4] = onp.clip((obj[4] * h - y0) / ch, 0, 1)
            # coverage check: remaining box area vs original
            orig = max(obj[3] - obj[1], 1e-12) * max(obj[4] - obj[2], 1e-12)
            new = (o[3] - o[1]) * cw * (o[4] - o[2]) * ch / (w * h)
            if new / orig >= self.min_object_covered:
                out.append(o)
        return onp.asarray(out, onp.float32) if out else None

    def __call__(self, src, label):
        arr = _as_host(src)[0]
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            crop = self._try_crop(h, w)
            if crop is None:
                continue
            x0, y0, cw, ch = crop
            new_label = self._project(label, x0, y0, cw, ch, w, h)
            if new_label is not None:
                return arr[y0:y0 + ch, x0:x0 + cw, :].copy(), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Pad the image into a larger canvas, shrinking boxes accordingly
    (ref: detection.py DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        import math
        arr = _as_host(src)[0]
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = pyrandom.uniform(*self.area_range) * h * w
            nh = int(round(math.sqrt(area / ratio)))
            nw = int(round(math.sqrt(area * ratio)))
            if nh < h or nw < w:
                continue
            y0 = pyrandom.randint(0, nh - h)
            x0 = pyrandom.randint(0, nw - w)
            canvas = onp.empty((nh, nw, arr.shape[2]), arr.dtype)
            canvas[:] = onp.asarray(self.pad_val, arr.dtype)
            canvas[y0:y0 + h, x0:x0 + w, :] = arr
            new_label = label.copy()
            new_label[:, 1] = (label[:, 1] * w + x0) / nw
            new_label[:, 2] = (label[:, 2] * h + y0) / nh
            new_label[:, 3] = (label[:, 3] * w + x0) / nw
            new_label[:, 4] = (label[:, 4] * h + y0) / nh
            return canvas, new_label
        return src, label


class DetForceResizeAug(DetAugmenter):
    """Resize to exact (w, h); normalized boxes are size-invariant."""

    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        arr, was_nd = _as_host(src)
        out = imresize(array(arr), self.size[0], self.size[1],
                       self.interp)
        return (out if was_nd else out.asnumpy()), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """ref: detection.py CreateDetAugmenter — standard SSD train-time
    augmentation list."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetForceResizeAug((data_shape[2], data_shape[1]),
                                     inter_method))
    color_augs = []
    if brightness or contrast or saturation:
        color_augs.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        color_augs.append(HueJitterAug(hue))
    if pca_noise > 0:
        color_augs.append(LightingAug(
            pca_noise,
            onp.asarray([55.46, 4.794, 1.148]),
            onp.asarray([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]])))
    if rand_gray > 0:
        color_augs.append(RandomGrayAug(rand_gray))
    for a in color_augs:
        auglist.append(DetBorrowAug(a))
    if mean is not None or std is not None:
        if mean is True:
            mean = onp.asarray([123.68, 116.28, 103.53])
        if std is True:
            std = onp.asarray([58.395, 57.12, 57.375])
        auglist.append(DetBorrowAug(CastAug()))
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator over .rec/.lst/in-memory lists
    (ref: detection.py ImageDetIter). Emits data (B, C, H, W) and label
    (B, max_objs, obj_width) padded with -1 rows."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="label", last_batch_handle="pad",
                 label_shape=None, **kwargs):
        if last_batch_handle not in ("pad", "discard"):
            raise ValueError(
                f"last_batch_handle={last_batch_handle!r} not supported; "
                "use 'pad' or 'discard'")
        self._last_batch_handle = last_batch_handle
        aug_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if k in ("resize", "rand_crop", "rand_pad",
                               "rand_gray", "rand_mirror", "mean", "std",
                               "brightness", "contrast", "saturation",
                               "pca_noise", "hue", "inter_method",
                               "min_object_covered", "aspect_ratio_range",
                               "area_range", "max_attempts", "pad_val")}
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         **kwargs)
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **aug_kwargs)
        # size the padded label tensor: explicit label_shape wins, else a
        # full pass over the labels (imglist AND .rec headers — sizing
        # from only the first record would silently drop boxes)
        if label_shape is not None:
            self._max_objs, self._obj_width = label_shape
        else:
            self._obj_width, self._max_objs = self._scan_label_shape()

    @staticmethod
    def _parse_label(raw):
        """Flat [A, B, ...header..., objs...] -> (num_objs, B) matrix."""
        raw = onp.asarray(raw, onp.float32).reshape(-1)
        if raw.size >= 2 and raw[0] >= 2 and raw[1] >= 5 and \
                (raw.size - int(raw[0])) % int(raw[1]) == 0 and \
                raw.size > int(raw[0]):
            a, b = int(raw[0]), int(raw[1])
            return raw[a:].reshape(-1, b)
        if raw.size % 5 == 0 and raw.size >= 5:  # plain (N, 5) rows
            return raw.reshape(-1, 5)
        raise ValueError(f"invalid detection label of size {raw.size}")

    def _scan_label_shape(self):
        width, n = 5, 1
        if self.imglist:
            for label, _ in self.imglist.values():
                objs = self._parse_label(label)
                width = max(width, objs.shape[1])
                n = max(n, objs.shape[0])
        elif self.imgrec is not None:
            from .recordio import unpack

            def _labels():  # full header pass, then rewind
                if self.seq is not None:
                    for idx in self.seq:
                        yield unpack(self.imgrec.read_idx(idx))[0].label
                else:
                    while True:
                        s = self.imgrec.read()
                        if s is None:
                            return
                        yield unpack(s)[0].label

            for label in _labels():
                objs = self._parse_label(label)
                width = max(width, objs.shape[1])
                n = max(n, objs.shape[0])
            self.imgrec.reset()
        return width, n

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self._max_objs,
                          self._obj_width))]

    def label_shape(self):
        return (self._max_objs, self._obj_width)

    def sync_label_shape(self, it, verbose=False):
        """Synchronize padded label shapes with another ImageDetIter
        (ref: detection.py sync_label_shape — train/val iters must agree)."""
        width = max(self._obj_width, it._obj_width)
        n = max(self._max_objs, it._max_objs)
        self._obj_width = it._obj_width = width
        self._max_objs = it._max_objs = n
        return it

    def next(self):
        bd = onp.zeros((self.batch_size,) + self.data_shape, onp.float32)
        bl = onp.full((self.batch_size, self._max_objs, self._obj_width),
                      -1.0, onp.float32)
        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                with cpu():
                    img = imdecode(s) if isinstance(s, bytes) else array(s)
                    objs = self._parse_label(label)
                    arr = img.asnumpy() if isinstance(img, NDArray) else \
                        onp.asarray(img)
                    for aug in self.auglist:
                        arr, objs = aug(arr, objs)
                arr = arr.asnumpy() if isinstance(arr, NDArray) else arr
                if arr.ndim == 3 and arr.shape[2] == self.data_shape[0]:
                    arr = arr.transpose(2, 0, 1)
                bd[i] = arr
                k = min(objs.shape[0], self._max_objs)
                bl[i, :k, :objs.shape[1]] = objs[:k]
                i += 1
        except StopIteration:
            if i == 0 or self._last_batch_handle == "discard":
                raise
            pad = self.batch_size - i
        return DataBatch(data=[array(bd, ctx=self.ctx)],
                         label=[array(bl, ctx=self.ctx)], pad=pad)
