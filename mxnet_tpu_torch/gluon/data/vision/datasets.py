"""Vision datasets over files already on disk.

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``: ``MNIST`` and
``FashionMNIST`` (idx-ubyte files, optionally gzipped), ``CIFAR10`` and
``CIFAR100`` (the python-pickle batches under ``cifar-10-batches-py`` /
``cifar-100-python``) and ``ImageFolderDataset`` (``root/<class>/<image>``,
decoded with Pillow). Nothing downloads: a missing file raises and names
its path. A sample is ``(image, label)``: the image an HWC uint8 numpy
array, the label an int32 (``transform(image, label)`` where given).
``ImageRecordDataset`` decodes the images of a ``.rec`` file with
:func:`mxnet_tpu_torch.image.imdecode`: a sample is an HWC uint8 NDArray
on the current context and the record's label.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as onp

from ....base import MXNetError
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]


def _default_root(name):
    return os.path.join(os.path.expanduser("~"), ".mxnet", "datasets", name)


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._root = os.path.expanduser(root)
        self._data = self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _read_idx(path):
    for cand in (path, path + ".gz"):
        if os.path.exists(cand):
            opener = gzip.open if cand.endswith(".gz") else open
            with opener(cand, "rb") as f:
                magic = struct.unpack(">I", f.read(4))[0]
                ndim = magic & 0xFF
                dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
                return onp.frombuffer(f.read(), dtype=onp.uint8) \
                    .reshape(dims)
    raise MXNetError(f"dataset file not found: {path} (or {path}.gz); the "
                     "port downloads nothing: place the file there")


class MNIST(_DownloadedDataset):
    """The MNIST digits (28x28x1) from its idx-ubyte files in ``root``."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=_default_root("mnist"), train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        imgs = _read_idx(os.path.join(self._root, files[0]))
        labels = _read_idx(os.path.join(self._root, files[1]))
        self._data = imgs.reshape(-1, 28, 28, 1)
        self._label = labels.astype(onp.int32)


class FashionMNIST(MNIST):
    """Fashion-MNIST, in MNIST's file format."""

    def __init__(self, root=_default_root("fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 (32x32x3) from its python-pickle batches."""

    _folder = "cifar-10-batches-py"

    def __init__(self, root=_default_root("cifar10"), train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _files(self):
        return [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]

    def _labels(self, d):
        return d[b"labels"]

    def _get_data(self):
        data, labels = [], []
        for fname in self._files():
            path = os.path.join(self._root, self._folder, fname)
            if not os.path.exists(path):
                raise MXNetError(f"dataset file not found: {path}; the port "
                                 "downloads nothing: place the file there")
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data.append(onp.asarray(d[b"data"], onp.uint8)
                        .reshape(-1, 3, 32, 32))
            labels.extend(self._labels(d))
        self._data = onp.concatenate(data).transpose(0, 2, 3, 1)
        self._label = onp.asarray(labels, onp.int32)


class CIFAR100(CIFAR10):
    """CIFAR-100: coarse labels, or fine ones where ``fine_label``."""

    _folder = "cifar-100-python"

    def __init__(self, root=_default_root("cifar100"), fine_label=False,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _files(self):
        return ["train" if self._train else "test"]

    def _labels(self, d):
        return d[b"fine_labels" if self._fine else b"coarse_labels"]


class ImageFolderDataset(Dataset):
    """Images under ``root/<class>/``, labelled by the sorted class
    folders (``synsets``); ``flag=1`` reads RGB, 0 greyscale."""

    _exts = (".jpg", ".jpeg", ".png")

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            raise MXNetError(f"image folder not found: {self._root}")
        self._flag = flag
        self._transform = transform
        self.synsets, self.items = [], []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from PIL import Image
        path, label = self.items[idx]
        with Image.open(path) as im:
            img = onp.asarray(im.convert("RGB" if self._flag else "L"))
        if img.ndim == 2:
            img = img[:, :, None]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(RecordFileDataset):
    """The images of a ``.rec`` file (``pack_img`` records): ``(image,
    label)``, the image decoded with ``flag`` (1 colour, 0 gray)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....image import imdecode
        from ....recordio import unpack
        header, img_bytes = unpack(super().__getitem__(idx))
        img = imdecode(img_bytes, flag=self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label
