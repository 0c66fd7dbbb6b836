"""The port's native record reader, batch server and JPEG pipeline against
the JAX package's (``mxnet_tpu/native``), on the CPU.

Both libraries decode with libjpeg here, so for one ``.rec`` file, seed
and set of arguments the batches must be bit-equal: NCHW and NHWC,
shuffled or not, random crop, mirror, resize, mean/std, 1 and 4 decode
threads, and the wrap-padded final batch with its pad count. A corrupt
record counts in ``decode_failures`` (zeros in its slot) in both. A file
of PNG records takes the Python pipeline through ``ImageRecordIter``,
which says so. :func:`write_image_records` is the other image tests'
record writer.
"""
import os

import numpy as np
import pytest

from mxnet_tpu import native as jnative
from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import native as tnative
from mxnet_tpu_torch import recordio as trio


def smooth_image(rs, h, w):
    """A smooth random field plus noise: JPEG-sized like a photograph."""
    import cv2
    coarse = rs.randint(0, 255, (h // 8 + 2, w // 8 + 2, 3)).astype(
        np.uint8)
    base = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR)
    noise = rs.randint(-12, 13, base.shape)
    return np.clip(base.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def write_image_records(path, n, seed=0, sides=(24, 48), fmt=".jpg",
                        label_width=1, quality=90):
    """``n`` ``pack_img`` records of random sizes in ``sides`` to ``path``
    (with its ``.idx``); the labels written, as a list."""
    rs = np.random.RandomState(seed)
    idx = os.path.splitext(path)[0] + ".idx"
    w = trio.MXIndexedRecordIO(idx, path, "w")
    labels = []
    for i in range(n):
        h, wd = rs.randint(*sides, size=2)
        img = smooth_image(rs, int(h), int(wd))
        label = float(i % 7) if label_width == 1 else \
            rs.rand(label_width).astype("float32")
        labels.append(label)
        w.write_idx(i, trio.pack_img(trio.IRHeader(0, label, i, 0), img,
                                     quality=quality, img_fmt=fmt))
    w.close()
    return labels


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "imgs.rec")
    write_image_records(path, 11, seed=5)
    return path


def _batches(pipe):
    out = []
    for data, labels in pipe:
        out.append((data, labels, pipe.last_pad))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (d1, l1, p1), (d2, l2, p2) in zip(a, b):
        assert d1.dtype == d2.dtype == np.float32 and d1.shape == d2.shape
        assert np.array_equal(d1, d2) and np.array_equal(l1, l2)
        assert p1 == p2


CASES = {
    "center_nchw": dict(),
    "nhwc": dict(layout="NHWC"),
    "shuffle_crop_mirror": dict(shuffle=True, rand_crop=True,
                                rand_mirror=True),
    "resize_mean_std": dict(resize=20, mean=(120.0, 110.0, 100.0),
                            std=(58.0, 57.0, 56.0), rand_crop=True),
    "all_nhwc_4_threads": dict(shuffle=True, rand_crop=True,
                               rand_mirror=True, resize=30,
                               mean=(1.0, 2.0, 3.0), layout="NHWC",
                               num_workers=4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_batches_are_bit_equal_to_the_jax_package(rec, name):
    kw = dict(num_workers=1, seed=3)
    kw.update(CASES[name])
    want = _batches(jnative.NativeImagePipeline(rec, 4, (3, 16, 16), **kw))
    pipe = tnative.NativeImagePipeline(rec, 4, (3, 16, 16), **kw)
    assert pipe.codec == "libjpeg"
    got = _batches(pipe)
    _same(got, want)
    # 11 records in batches of 4: the last batch holds one duplicate
    assert len(got) == 3 and got[-1][2] == 1
    # a second epoch after reset: the next epoch's order in both
    pipe.reset()
    jpipe = jnative.NativeImagePipeline(rec, 4, (3, 16, 16), **kw)
    list(jpipe)
    jpipe.reset()
    _same(_batches(pipe), _batches(jpipe))


def test_one_thread_and_four_give_the_same_batches(rec):
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=11)
    one = _batches(tnative.NativeImagePipeline(rec, 3, (3, 12, 12),
                                               num_workers=1, **kw))
    four = _batches(tnative.NativeImagePipeline(rec, 3, (3, 12, 12),
                                                num_workers=4, **kw))
    _same(one, four)


def test_reader_and_batch_server_match_the_jax_package(rec):
    mine, theirs = tnative.NativeRecordIO(rec), jnative.NativeRecordIO(rec)
    assert len(mine) == len(theirs) == 11
    assert [mine.read_idx(i) for i in range(11)] == \
        [theirs.read_idx(i) for i in range(11)]
    with pytest.raises(IndexError):
        mine.read_idx(11)
    for kw in (dict(), dict(shuffle=True, seed=4)):
        got = list(tnative.NativeBatchServer(rec, 4, num_workers=1, **kw))
        want = list(jnative.NativeBatchServer(rec, 4, num_workers=1, **kw))
        assert got == want and len(got) == 3


def test_a_corrupt_record_counts_as_a_decode_failure(tmp_path):
    path = str(tmp_path / "bad.rec")
    write_image_records(path, 4, seed=2)
    r = trio.MXIndexedRecordIO(str(tmp_path / "bad.idx"), path, "r")
    payloads = [r.read_idx(i) for i in range(4)]
    r.close()
    w = trio.MXIndexedRecordIO(str(tmp_path / "bad.idx"), path, "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p[:40] if i == 2 else p)  # record 2 cut short
    w.close()
    pipes = [m.NativeImagePipeline(path, 4, (3, 8, 8), num_workers=1)
             for m in (tnative, jnative)]
    (got,), (want,) = [list(p) for p in pipes]
    assert [p.decode_failures for p in pipes] == [1, 1]
    assert not got[0][2].any() and got[0][1].any()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_png_records_take_the_python_pipeline_and_say_so(tmp_path):
    path = str(tmp_path / "png.rec")
    write_image_records(path, 3, seed=1, fmt=".png", quality=3)
    with mx.cpu():
        it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                   batch_size=2)
    assert it.backend == "python"
    assert it.reason == "the first record is not a JPEG"
    batch = it.next()
    assert batch.data[0].shape == (2, 3, 8, 8)
    assert batch.data[0].context == mx.cpu()


def test_decode_through_the_codec_matches_opencv(rec):
    import cv2
    payload = trio.unpack(tnative.NativeRecordIO(rec).read_idx(0))[1]
    rgb = tnative.decode(payload)
    want = cv2.imdecode(np.frombuffer(payload, np.uint8),
                        cv2.IMREAD_COLOR)[:, :, ::-1]
    np.testing.assert_array_equal(rgb, want)
    gray = tnative.decode(payload, channels=1)
    assert gray.shape == rgb.shape[:2] + (1,)
    with pytest.raises(mx.MXNetError, match="could not decode"):
        tnative.decode(payload[:30])
    assert jrio.unpack(tnative.NativeRecordIO(rec).read_idx(3))[0].label \
        == 3.0


def test_no_codec_raises_when_the_library_is_built(monkeypatch):
    """Where neither ``jpeglib.h`` nor nvJPEG is found there is no codec
    to build with: ``codec``, ``build`` and the JPEG decode raise
    ``MXNetError`` naming both, and ``available`` says False. (The
    choice is made once per process; the test restores it.)"""
    monkeypatch.setattr(tnative, "_STATE", {})
    monkeypatch.setattr(tnative, "_find_codec", lambda: None)
    assert not tnative.available()
    for call in (tnative.codec, tnative.build,
                 lambda: tnative.decode(b"\xff\xd8")):
        with pytest.raises(mx.MXNetError, match="jpeglib.h.*nvjpeg.h"):
            call()
    with pytest.raises(ValueError, match="codec 'none'"):
        tnative.build("none")
