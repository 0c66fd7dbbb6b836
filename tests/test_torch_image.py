"""The port's ``mx.image`` against the JAX package's, on the CPU.

Each side runs under the same seed of Python's ``random`` and numpy's
global generator (both restored afterwards), which is where both
packages draw their crops, flips and jitters. Decoding is exact (both
take OpenCV here); a resized image agrees within 1 count (uint8) or
1e-3 of 255 (float32: XLA's and ATen's antialiased bilinear sums differ
in order); normalized batches within 1 count over the std; the colour
jitters within rtol 1e-5 / atol 1e-3. Covered: ``imdecode``/``imread``,
``imresize``, ``resize_short``, the crops, ``color_normalize``, every
augmenter and ``CreateAugmenter`` (with ``dumps``), ``ImageIter`` over a
``.rec`` file and an image list, ``ImageRecordIterPy``, the detection
augmenters, ``CreateDetAugmenter`` and ``ImageDetIter``.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import recordio as trio

from test_torch_native_io import smooth_image, write_image_records

RESIZE_ATOL = 1e-3 * 255


@pytest.fixture(autouse=True)
def _restore_generators():
    py, npy = random.getstate(), np.random.get_state()
    yield
    random.setstate(py)
    np.random.set_state(npy)


def _seeded(fn, seed=0):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _both(jfn, tfn, seed=0):
    """``jfn()`` and ``tfn()`` (the latter on the CPU) from one seed."""
    want = _np(_seeded(jfn, seed))
    with mx.cpu():
        got = _np(_seeded(tfn, seed))
    return got, want


@pytest.fixture(scope="module")
def image():
    return smooth_image(np.random.RandomState(3), 37, 52)


@pytest.fixture(scope="module")
def jpeg(image):
    import cv2
    return cv2.imencode(".jpg", image, [cv2.IMWRITE_JPEG_QUALITY, 90])[1] \
        .tobytes()


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_and_imread_are_exact(jpeg, tmp_path, flag, to_rgb):
    got, want = _both(lambda: jimage.imdecode(jpeg, flag, to_rgb),
                      lambda: timage.imdecode(jpeg, flag, to_rgb))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    (tmp_path / "a.jpg").write_bytes(jpeg)
    with mx.cpu():
        np.testing.assert_array_equal(
            timage.imread(str(tmp_path / "a.jpg"), flag, to_rgb).asnumpy(),
            want)
    assert timage.decoder() == "cv2"


@pytest.mark.parametrize("w,h,interp", [(20, 15, 1), (80, 61, 2),
                                        (26, 37, 0)])
def test_imresize_and_resize_short_within_one_count(image, w, h, interp):
    got, want = _both(lambda: jimage.imresize(jmx.nd.array(image, dtype="uint8"), w, h, interp),
                      lambda: timage.imresize(mx.nd.array(image, dtype="uint8"), w, h, interp))
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    got, want = _both(
        lambda: jimage.resize_short(jmx.nd.array(image, dtype="uint8"), w),
        lambda: timage.resize_short(mx.nd.array(image, dtype="uint8"), w))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_crops_and_color_normalize_are_exact(image):
    for fn in ("center_crop", "random_crop"):
        for seed in range(3):
            (got, gbox), (want, wbox) = [
                _seeded(lambda m=m: getattr(m, fn)(
                    arr(image, dtype="uint8"), (20, 16)), seed)
                for m, arr in ((timage, _cpu_array), (jimage, jmx.nd.array))]
            assert gbox == wbox
            np.testing.assert_array_equal(_np(got), _np(want))
    got, want = _both(
        lambda: jimage.fixed_crop(jmx.nd.array(image), 3, 4, 20, 18,
                                  (10, 9)),
        lambda: timage.fixed_crop(mx.nd.array(image), 3, 4, 20, 18,
                                  (10, 9)))
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL)
    mean, std = np.array([120.0, 110.0, 100.0]), np.array([50.0, 51, 52])
    got, want = _both(
        lambda: jimage.color_normalize(jmx.nd.array(image), jmx.nd.array(mean), jmx.nd.array(std)),
        lambda: timage.color_normalize(mx.nd.array(image), mx.nd.array(mean), mx.nd.array(std)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _cpu_array(x, dtype=None):
    with mx.cpu():
        return mx.nd.array(x, dtype=dtype)


EIGVAL = [55.46, 4.794, 1.148]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]
AUGMENTERS = {
    "ResizeAug": lambda m: m.ResizeAug(24),
    "ForceResizeAug": lambda m: m.ForceResizeAug((30, 20)),
    "RandomCropAug": lambda m: m.RandomCropAug((20, 16)),
    "CenterCropAug": lambda m: m.CenterCropAug((20, 16)),
    "HorizontalFlipAug": lambda m: m.HorizontalFlipAug(0.5),
    "ColorNormalizeAug": lambda m: m.ColorNormalizeAug([120.0, 110, 100],
                                                       [50.0, 51, 52]),
    "CastAug": lambda m: m.CastAug(),
    "BrightnessJitterAug": lambda m: m.BrightnessJitterAug(0.3),
    "ContrastJitterAug": lambda m: m.ContrastJitterAug(0.3),
    "SaturationJitterAug": lambda m: m.SaturationJitterAug(0.3),
    "HueJitterAug": lambda m: m.HueJitterAug(0.2),
    "ColorJitterAug": lambda m: m.ColorJitterAug(0.2, 0.2, 0.2),
    "LightingAug": lambda m: m.LightingAug(0.1, EIGVAL, EIGVEC),
    "RandomGrayAug": lambda m: m.RandomGrayAug(0.5),
    "SequentialAug": lambda m: m.SequentialAug(
        [m.CastAug(), m.BrightnessJitterAug(0.3)]),
    "RandomOrderAug": lambda m: m.RandomOrderAug(
        [m.CastAug(), m.ContrastJitterAug(0.3),
         m.SaturationJitterAug(0.3)]),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
def test_each_augmenter_matches_under_one_seed(image, name):
    src = image.astype(np.float32)
    for seed in (0, 1, 2):
        got, want = _both(
            lambda: AUGMENTERS[name](jimage)(jmx.nd.array(src)),
            lambda: AUGMENTERS[name](timage)(mx.nd.array(src)), seed)
        assert got.shape == want.shape and got.dtype == want.dtype
        atol = RESIZE_ATOL if "Resize" in name else 1e-3
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    assert AUGMENTERS[name](timage).dumps() == \
        AUGMENTERS[name](jimage).dumps()


def test_create_augmenter_chain_matches(image):
    kw = dict(resize=30, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.1, contrast=0.1, saturation=0.1,
              hue=0.1, pca_noise=0.1, rand_gray=0.2)

    def run(m, arr):
        img = arr(image, dtype="uint8")
        for aug in m.CreateAugmenter((3, 20, 20), **kw):
            img = aug(img)
        return img
    for seed in (0, 5):
        got, want = _both(lambda: run(jimage, jmx.nd.array),
                          lambda: run(timage, mx.nd.array), seed)
        # one resize (1 count) through the jitters and the normalisation
        np.testing.assert_allclose(got, want, atol=2.0 / 57.0)
    # the JAX package's dumps cannot write numpy statistics: without them
    kw.update(mean=None, std=None)
    assert [a.dumps() for a in timage.CreateAugmenter((3, 20, 20), **kw)] \
        == [a.dumps() for a in jimage.CreateAugmenter((3, 20, 20), **kw)]


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("image") / "imgs.rec")
    write_image_records(path, 7, seed=9)
    return path


def _iter_batches(it):
    out = []
    for batch in it:
        out.append((batch.data[0].asnumpy(), batch.label[0].asnumpy(),
                    batch.pad))
    return out


def _iters_match(jmake, tmake, atol, seed=0):
    want = _seeded(lambda: _iter_batches(jmake()), seed)
    made = []

    def port():
        made.append(tmake())
        return _iter_batches(made[0])
    with mx.cpu():
        got = _seeded(port, seed)
    it = made[0]
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.shape == wd.shape and gp == wp
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gd, wd, atol=atol)
    return it


def test_image_iter_over_a_record_file_matches(rec):
    kw = dict(batch_size=3, data_shape=(3, 16, 16), path_imgrec=rec,
              shuffle=True, resize=20, rand_crop=True, rand_mirror=True,
              mean=np.array([120.0, 110, 100]), std=np.array([50.0, 51, 52]))
    it = _iters_match(lambda: jimage.ImageIter(**kw),
                      lambda: timage.ImageIter(**kw), atol=1.0 / 50)
    assert it.ctx == mx.cpu()
    assert it.provide_data[0].shape == (3, 3, 16, 16)


def test_image_iter_over_an_image_list_matches(tmp_path, image):
    import cv2
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i}.png"), np.roll(image, i, axis=1))
    lst = tmp_path / "a.lst"
    lst.write_text("".join(f"{i}\t{i * 2.0}\t{i}.png\n" for i in range(3)))
    kw = dict(batch_size=2, data_shape=(3, 12, 12), path_imglist=str(lst),
              path_root=str(tmp_path))
    _iters_match(lambda: jimage.ImageIter(**kw),
                 lambda: timage.ImageIter(**kw), atol=0)


def test_image_record_iter_py_matches(rec):
    kw = dict(path_imgrec=rec, data_shape=(3, 16, 16), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=18,
              mean_r=123.0, mean_g=116.0, mean_b=103.0, std_r=58.0,
              std_g=57.0, std_b=57.0, brightness=0.1)
    _iters_match(lambda: jimage.ImageRecordIterPy(**kw),
                 lambda: timage.ImageRecordIterPy(**kw), atol=1.0 / 57)


def _det_label(rs, n_obj):
    boxes = []
    for _ in range(n_obj):
        x0, y0 = rs.uniform(0, 0.5, 2)
        boxes.append([float(rs.randint(3)), x0, y0, x0 + rs.uniform(0.2, 0.5),
                      y0 + rs.uniform(0.2, 0.5)])
    return np.asarray([2.0, 5.0] + sum(boxes, []), np.float32)


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("det") / "det.rec")
    rs = np.random.RandomState(4)
    w = trio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(5):
        img = smooth_image(rs, 30 + i, 40 - i)
        w.write_idx(i, trio.pack_img(
            trio.IRHeader(0, _det_label(rs, 1 + i % 3), i, 0), img,
            quality=90))
    w.close()
    return path


DET_AUGMENTERS = {
    "DetBorrowAug": lambda m: m.DetBorrowAug(m.BrightnessJitterAug(0.2)),
    "DetHorizontalFlipAug": lambda m: m.DetHorizontalFlipAug(0.5),
    "DetRandomCropAug": lambda m: m.DetRandomCropAug(
        min_object_covered=0.3, area_range=(0.3, 1.0)),
    "DetRandomPadAug": lambda m: m.DetRandomPadAug(area_range=(1.0, 2.0)),
    "DetForceResizeAug": lambda m: m.DetForceResizeAug((20, 16)),
    "DetRandomSelectAug": lambda m: m.DetRandomSelectAug(
        [m.DetHorizontalFlipAug(1.0), m.DetForceResizeAug((10, 10))], 0.3),
}


@pytest.mark.parametrize("name", sorted(DET_AUGMENTERS))
def test_each_detection_augmenter_matches(image, name):
    label = _det_label(np.random.RandomState(1), 3)[2:].reshape(-1, 5)
    src = image.astype(np.float32)
    for seed in (0, 1, 2):
        want = _seeded(lambda: DET_AUGMENTERS[name](jimage)(src, label),
                       seed)
        with mx.cpu():
            got = _seeded(lambda: DET_AUGMENTERS[name](timage)(src, label),
                          seed)
        atol = RESIZE_ATOL if "Resize" in name or "Select" in name else 1e-3
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5,
                                   atol=atol)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert DET_AUGMENTERS[name](timage).dumps() == \
        DET_AUGMENTERS[name](jimage).dumps()


def test_image_det_iter_and_create_det_augmenter_match(det_rec):
    kw = dict(batch_size=2, data_shape=(3, 16, 16), path_imgrec=det_rec,
              shuffle=True, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
              mean=True, std=True)
    it = _iters_match(lambda: jimage.ImageDetIter(**kw),
                      lambda: timage.ImageDetIter(**kw), atol=1.0 / 57)
    assert it.label_shape() == (3, 5)
    assert [a.dumps() for a in timage.CreateDetAugmenter((3, 16, 16))] == \
        [a.dumps() for a in jimage.CreateDetAugmenter((3, 16, 16))]
