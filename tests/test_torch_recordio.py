"""The port's ``recordio`` against the JAX package's, on the CPU.

- records and ``.idx`` files written by either package read back by the
  other, and the two packages' files byte for byte the same (the
  sequential and the indexed writer, the native writer);
- ``pack``/``unpack`` of scalar and vector labels, with the same bytes;
- ``pack_img``/``unpack_img`` (OpenCV JPEG and PNG) round-trips, the same
  bytes in both packages;
- a reader reopens after a fork (``pickle`` of an open reader), a bad
  magic raises, and a file open for writing refuses to read.
"""
import os
import pickle

import numpy as np
import pytest

from mxnet_tpu import recordio as jrio

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import native as tnative
from mxnet_tpu_torch import recordio as trio


def _payloads(seed=0, n=12):
    rs = np.random.RandomState(seed)
    # lengths 0-9 cover every padding, the rest longer records
    return [rs.bytes(int(k)) for k in list(range(10))
            + list(rs.randint(10, 5000, n - 10))]


def _write_indexed(rio, tmp_path, name, payloads):
    rec, idx = str(tmp_path / f"{name}.rec"), str(tmp_path / f"{name}.idx")
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    for i, p in enumerate(payloads):
        w.write_idx(i * 3 + 1, p)
    w.close()
    return rec, idx


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_indexed_files_are_byte_identical_and_cross_readable(tmp_path):
    payloads = _payloads()
    jrec, jidx = _write_indexed(jrio, tmp_path, "jax", payloads)
    trec, tidx = _write_indexed(trio, tmp_path, "port", payloads)
    assert _read(jrec) == _read(trec) and _read(jidx) == _read(tidx)
    for rio, (rec, idx) in ((trio, (jrec, jidx)), (jrio, (trec, tidx))):
        r = rio.MXIndexedRecordIO(idx, rec, "r")
        assert r.keys == [i * 3 + 1 for i in range(len(payloads))]
        for i, p in reversed(list(enumerate(payloads))):
            assert r.read_idx(i * 3 + 1) == p
        r.close()


def test_sequential_reader_and_native_writer_agree(tmp_path):
    payloads = _payloads(seed=1)
    w = trio.MXRecordIO(str(tmp_path / "seq.rec"), "w")
    for p in payloads:
        w.write(p)
    w.close()
    nw = tnative.NativeRecordIOWriter(str(tmp_path / "native.rec"))
    for p in payloads:
        nw.write(p)
    nw.close()
    assert _read(tmp_path / "seq.rec") == _read(tmp_path / "native.rec")
    r = jrio.MXRecordIO(str(tmp_path / "native.rec"), "r")
    got = []
    while (buf := r.read()) is not None:
        got.append(buf)
    assert got == payloads
    reader = tnative.NativeRecordIO(str(tmp_path / "seq.rec"))
    assert [reader.read_idx(i) for i in range(len(reader))] == payloads
    reader.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0],
                                   np.arange(7, dtype="float32")],
                         ids=["scalar", "list", "vector"])
def test_pack_unpack_labels_match_the_jax_package(label):
    header = (0, label, 17, 4)
    packed = trio.pack(trio.IRHeader(*header), b"payload")
    assert packed == jrio.pack(jrio.IRHeader(*header), b"payload")
    got, body = trio.unpack(packed)
    want, wbody = jrio.unpack(packed)
    assert body == wbody == b"payload"
    assert got.flag == want.flag and got.id == want.id == 17
    assert got.id2 == want.id2 == 4
    np.testing.assert_array_equal(np.asarray(got.label),
                                  np.asarray(want.label))
    if np.isscalar(label):
        assert got.flag == 0 and got.label == label
    else:
        assert got.label.dtype == np.float32 and got.flag == len(label)


@pytest.mark.parametrize("fmt,quality", [(".jpg", 90), (".png", 3)])
def test_pack_img_round_trips_with_the_same_bytes(fmt, quality):
    rs = np.random.RandomState(2)
    img = rs.randint(0, 255, (24, 31, 3)).astype(np.uint8)
    header = trio.IRHeader(0, 5.0, 9, 0)
    packed = trio.pack_img(header, img, quality=quality, img_fmt=fmt)
    assert packed == jrio.pack_img(jrio.IRHeader(0, 5.0, 9, 0), img,
                                   quality=quality, img_fmt=fmt)
    got_header, got = trio.unpack_img(packed, 1)
    _, want = jrio.unpack_img(packed, 1)
    assert got_header.label == 5.0 and got_header.id == 9
    np.testing.assert_array_equal(got, want)
    if fmt == ".png":  # lossless
        np.testing.assert_array_equal(got, img)


def test_reader_reopens_after_pickle_and_refuses_misuse(tmp_path):
    payloads = _payloads(seed=3)
    rec, idx = _write_indexed(trio, tmp_path, "p", payloads)
    r = trio.MXIndexedRecordIO(idx, rec, "r")
    r.read_idx(4)
    clone = pickle.loads(pickle.dumps(r))
    assert clone.read_idx(1) == payloads[0]
    assert clone.read_idx(4) == payloads[1]
    r.close()
    clone.close()
    w = trio.MXRecordIO(str(tmp_path / "w.rec"), "w")
    with pytest.raises(MXNetError):
        w.read()
    w.close()
    with open(tmp_path / "bad.rec", "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(MXNetError, match="magic"):
        trio.MXRecordIO(str(tmp_path / "bad.rec"), "r").read()
    with pytest.raises(IOError, match="magic"):
        tnative.NativeRecordIO(str(tmp_path / "bad.rec"))
    assert os.path.exists(rec)
