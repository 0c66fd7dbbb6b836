"""The port's ``gluon.data`` against the JAX package's, on the CPU.

- the samplers' orders (``RandomSampler`` from numpy's global generator
  as in the JAX package, or from a ``RandomState`` it is given) and
  ``BatchSampler``'s ``last_batch`` modes over two epochs;
- the datasets' ``transform``, ``transform_first``, ``filter``, ``shard``
  and ``take``;
- ``DataLoader`` with no workers and with two worker processes: the
  same batches as the JAX package's loader without
  workers, as NDArrays on the current context;
- the vision transforms on numpy images (the random ones from the same
  numpy seed), rtol 1e-4 / atol 1e-4 (fp32) and within 1 for resized
  uint8 images; a transform keeps numpy as numpy and an NDArray as an
  NDArray;
- ``MNIST``, ``FashionMNIST``, ``CIFAR10``, ``CIFAR100`` and
  ``ImageFolderDataset`` over files this test writes in the reference's
  formats; a missing file raises and names its path.
"""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, nd
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf

RTOL, ATOL = 1e-4, 1e-4
CPU = mx.cpu()


def _epochs(sampler, n=2):
    return [list(sampler) for _ in range(n)]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler_modes_match_the_jax_package(last_batch):
    got = tdata.BatchSampler(tdata.SequentialSampler(10), 4, last_batch)
    want = jdata.BatchSampler(jdata.SequentialSampler(10), 4, last_batch)
    assert _epochs(got, 3) == _epochs(want, 3)
    assert len(got) == len(want)
    with pytest.raises(ValueError, match="last_batch"):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "drop")


def test_samplers_orders_match_the_jax_package():
    assert list(tdata.SequentialSampler(5, start=3)) == \
        list(jdata.SequentialSampler(5, start=3))
    np.random.seed(11)
    want = _epochs(jdata.RandomSampler(9))
    np.random.seed(11)
    got = _epochs(tdata.RandomSampler(9))
    assert got == want and sorted(got[0]) == list(range(9))
    rs = _epochs(tdata.RandomSampler(9, generator=np.random.RandomState(11)))
    assert rs == want


def test_dataset_transforms_shard_take_and_filter():
    x = np.arange(20, dtype="float32").reshape(10, 2)
    y = np.arange(10)
    for pkg in (jdata, tdata):
        ds = pkg.ArrayDataset(x, y)
        assert len(ds) == 10 and ds[3][1] == 3
    t = tdata.ArrayDataset(x, y)
    j = jdata.ArrayDataset(x, y)
    for lazy in (True, False):
        a = t.transform_first(lambda v: v * 2, lazy)
        b = j.transform_first(lambda v: v * 2, lazy)
        assert all(np.array_equal(a[i][0], b[i][0]) and a[i][1] == b[i][1]
                   for i in range(10))
    s = tdata.SimpleDataset(list(range(10)))
    assert [list(s.shard(3, i)) for i in range(3)] == \
        [list(jdata.SimpleDataset(list(range(10))).shard(3, i))
         for i in range(3)]
    assert list(s.take(4)) == [0, 1, 2, 3]
    assert list(s.filter(lambda v: v % 3 == 0)) == [0, 3, 6, 9]
    assert list(s.transform(lambda v: v + 1)) == list(range(1, 11))
    with pytest.raises(ValueError, match="same length"):
        tdata.ArrayDataset(x, y[:3])


def _images(n=12, size=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
            rng.randint(0, 10, n).astype(np.int32))


def _jax_batches(x, y, batch):
    tf = jtf.Compose([jtf.ToTensor(), jtf.Normalize(0.5, 0.25)])
    ds = jdata.ArrayDataset(x, y).transform_first(tf)
    return [(a.asnumpy(), b.asnumpy()) for a, b in
            jdata.DataLoader(ds, batch_size=batch, last_batch="keep")]


@pytest.mark.parametrize("mode", ["no_workers", "two_workers"])
def test_data_loader_gives_the_jax_packages_batches(mode):
    x, y = _images()
    want = _jax_batches(x, y, 5)
    tf = ttf.Compose([ttf.ToTensor(), ttf.Normalize(0.5, 0.25)])
    ds = tdata.ArrayDataset(x, y).transform_first(tf)
    kw = {"no_workers": {}, "two_workers": dict(num_workers=2)}[mode]
    loader = tdata.DataLoader(ds, batch_size=5, **kw)
    assert len(loader) == 3
    with CPU:
        got = list(loader)
    assert len(got) == len(want)
    for (ga, gb), (wa, wb) in zip(got, want):
        assert isinstance(ga, nd.NDArray) and ga.context == CPU
        np.testing.assert_allclose(ga.asnumpy(), wa, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(gb.asnumpy(), wb)


def test_data_loader_shuffles_with_numpy_and_checks_its_arguments():
    x, y = _images(n=8)
    np.random.seed(3)
    want = [b.asnumpy() for _, b in jdata.DataLoader(
        jdata.ArrayDataset(x, y), batch_size=3, shuffle=True)]
    np.random.seed(3)
    with CPU:
        got = [b.asnumpy() for _, b in tdata.DataLoader(
            tdata.ArrayDataset(x, y), batch_size=3, shuffle=True)]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="batch_size"):
        tdata.DataLoader(tdata.ArrayDataset(x, y))
    with pytest.raises(ValueError, match="shuffle"):
        tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=2,
                         sampler=tdata.SequentialSampler(8), shuffle=True)


# name -> build(transforms module); the random ones draw from numpy
TRANSFORMS = {
    "to_tensor": lambda T: T.ToTensor(),
    "normalize": lambda T: T.Compose([T.ToTensor(), T.Normalize(
        (0.4, 0.5, 0.6), (0.2, 0.3, 0.25))]),
    "cast": lambda T: T.Cast("float16"),
    "center_crop": lambda T: T.CenterCrop((5, 4)),
    "crop_resize": lambda T: T.CropResize(1, 2, 6, 5),
    "flip_left_right": lambda T: T.RandomFlipLeftRight(),
    "flip_top_bottom": lambda T: T.RandomFlipTopBottom(),
    "brightness": lambda T: T.RandomBrightness(0.3),
    "contrast": lambda T: T.RandomContrast(0.3),
    "saturation": lambda T: T.RandomSaturation(0.3),
    "hue": lambda T: T.RandomHue(0.3),
    "color_jitter": lambda T: T.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
    "lighting": lambda T: T.RandomLighting(0.1),
}
RESIZES = {
    "resize_down": lambda T: T.Resize((5, 4)),
    "resize_up": lambda T: T.Resize(13),
    "crop_resize_sized": lambda T: T.CropResize(1, 1, 6, 6, size=4),
    "random_resized_crop": lambda T: T.RandomResizedCrop(5),
}


def _apply(T, make, img, seed):
    np.random.seed(seed)
    outs = []
    t = make(T)
    for _ in range(3):            # three draws of a random transform
        out = t(jmx.nd.array(img, dtype=img.dtype) if T is jtf else img)
        outs.append(np.asarray(out.asnumpy() if T is jtf else out,
                               dtype=np.float32))
    return outs


@pytest.mark.parametrize("name", sorted(TRANSFORMS) + sorted(RESIZES))
def test_transform_matches_the_jax_package(name):
    make = TRANSFORMS.get(name) or RESIZES[name]
    img = np.random.RandomState(2).randint(0, 256, (9, 8, 3)) \
        .astype(np.uint8)
    if name in ("brightness", "contrast", "saturation", "hue",
                "color_jitter", "lighting"):
        img = img.astype(np.float32) / 255
    want = _apply(jtf, make, img, 5)
    got = _apply(ttf, make, img, 5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if name in RESIZES:
            np.testing.assert_allclose(g, w, atol=1.0)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_transform_keeps_the_kind_of_its_input():
    img = np.zeros((4, 4, 3), np.uint8)
    out = ttf.ToTensor()(img)
    assert isinstance(out, np.ndarray) and out.shape == (3, 4, 4)
    with CPU:
        out = ttf.ToTensor()(nd.array(img, dtype="uint8"))
    assert isinstance(out, nd.NDArray) and out.shape == (3, 4, 4)
    assert isinstance(ttf.ToTensor()(torch.from_numpy(img)), torch.Tensor)
    with pytest.raises(ValueError, match="exceeds"):
        ttf.CropResize(0, 0, 9, 9)(img)


def _write_idx(path, arr):
    with gzip.open(path + ".gz", "wb") as f:
        f.write(struct.pack(">I", 0x800 + arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("which", ["MNIST", "FashionMNIST"])
def test_mnist_from_files_matches_the_jax_package(which, tmp_path):
    rng = np.random.RandomState(0)
    for prefix, n in (("train", 6), ("t10k", 4)):
        _write_idx(str(tmp_path / f"{prefix}-images-idx3-ubyte"),
                   rng.randint(0, 256, (n, 28, 28)))
        _write_idx(str(tmp_path / f"{prefix}-labels-idx1-ubyte"),
                   rng.randint(0, 10, n))
    for train in (True, False):
        j = getattr(jdata.vision, which)(str(tmp_path), train=train)
        t = getattr(tdata.vision, which)(str(tmp_path), train=train)
        assert len(t) == len(j) == (6 if train else 4)
        for i in range(len(t)):
            assert t[i][0].shape == (28, 28, 1)
            np.testing.assert_array_equal(t[i][0], j[i][0].asnumpy())
            assert t[i][1] == j[i][1]


@pytest.mark.parametrize("which", ["CIFAR10", "CIFAR100"])
def test_cifar_from_files_matches_the_jax_package(which, tmp_path):
    rng = np.random.RandomState(1)
    if which == "CIFAR10":
        d = tmp_path / "cifar-10-batches-py"
        d.mkdir()
        names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
        for name in names:
            with open(d / name, "wb") as f:
                pickle.dump({b"data": rng.randint(0, 256, (2, 3072))
                             .astype(np.uint8),
                             b"labels": rng.randint(0, 10, 2).tolist()}, f)
        j = jdata.vision.CIFAR10(str(tmp_path))
        t = tdata.vision.CIFAR10(str(tmp_path))
        assert len(t) == len(j) == 10
        for i in range(len(t)):
            np.testing.assert_array_equal(t[i][0], j[i][0].asnumpy())
            assert t[i][1] == j[i][1]
    else:
        d = tmp_path / "cifar-100-python"
        d.mkdir()
        fine = rng.randint(0, 100, 3).tolist()
        coarse = rng.randint(0, 20, 3).tolist()
        data = rng.randint(0, 256, (3, 3072)).astype(np.uint8)
        with open(d / "train", "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": fine,
                         b"coarse_labels": coarse}, f)
        for fine_label, want in ((True, fine), (False, coarse)):
            t = tdata.vision.CIFAR100(str(tmp_path), fine_label=fine_label)
            assert [t[i][1] for i in range(3)] == want
            np.testing.assert_array_equal(
                t[0][0], data[0].reshape(3, 32, 32).transpose(1, 2, 0))


def test_missing_files_raise_and_name_the_path(tmp_path):
    with pytest.raises(MXNetError, match="train-images-idx3-ubyte"):
        tdata.vision.MNIST(str(tmp_path))
    with pytest.raises(MXNetError, match="data_batch_1"):
        tdata.vision.CIFAR10(str(tmp_path))
    with pytest.raises(MXNetError, match="not found"):
        tdata.vision.ImageFolderDataset(str(tmp_path / "none"))


def test_image_folder_dataset_reads_the_class_folders(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(4)
    imgs = {}
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / cls)
        for k in range(2):
            a = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
            Image.fromarray(a).save(tmp_path / cls / f"{k}.png")
            imgs[(cls, k)] = a
    (tmp_path / "cat" / "notes.txt").write_text("not an image")
    ds = tdata.vision.ImageFolderDataset(
        str(tmp_path), transform=lambda x, y: (x.astype(np.float32), y))
    assert ds.synsets == ["cat", "dog"] and len(ds) == 4
    img, label = ds[2]
    assert label == 1 and img.dtype == np.float32
    np.testing.assert_array_equal(img, imgs[("dog", 0)])
    grey = tdata.vision.ImageFolderDataset(str(tmp_path), flag=0)
    assert grey[0][0].shape == (5, 7, 1)
