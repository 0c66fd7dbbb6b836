"""RecordIO: the packed-record dataset format.

Counterpart of ``mxnet_tpu/recordio.py`` (ref: python/mxnet/recordio.py,
MXRecordIO :37, MXIndexedRecordIO :216, IRHeader/pack/unpack/pack_img
:362-495). Files are byte-identical to the JAX package's and the
reference's: records framed by kMagic=0xced7230a and an lrec word
encoding cflag (upper 3 bits) + length (lower 29), payload padded to 4
bytes; an ``.idx`` file of ``key<TAB>offset`` lines. The native C++
reader (:mod:`mxnet_tpu_torch.native`) is the input pipeline's fast path;
this module is the portable Python one. ``pack_img``/``unpack_img`` use
OpenCV, as the JAX package's do.
"""
from __future__ import annotations

import collections
import numbers
import os
import struct
from typing import Optional

import numpy as onp

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_KMAGIC = 0xced7230a

IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def _encode_lrec(cflag: int, length: int) -> int:
    return (cflag << 29) | length


def _decode_lrec(rec: int):
    return rec >> 29, rec & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential record reader/writer (ref: recordio.py:37)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.fp = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"Invalid flag {self.flag}")
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.fp.close()
            self.is_open = False
            self.pid = None

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["fp"] = None
        d["is_open"] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if d.get("uri"):
            self.open()

    def _check_pid(self):
        if self.pid != os.getpid():
            # reopen after fork (ref: recordio.py _check_pid)
            self.reset()

    def write(self, buf: bytes):
        if not self.writable:
            raise MXNetError(f"{self.uri} is open for reading")
        self._check_pid()
        self.fp.write(struct.pack("<II", _KMAGIC,
                                  _encode_lrec(0, len(buf))))
        self.fp.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fp.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        if self.writable:
            raise MXNetError(f"{self.uri} is open for writing")
        self._check_pid()
        head = self.fp.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _KMAGIC:
            raise MXNetError("Invalid record magic")
        cflag, length = _decode_lrec(lrec)
        buf = self.fp.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fp.read(pad)
        return buf

    def tell(self):
        return self.fp.tell()

    def seek(self, pos):
        if self.writable:
            raise MXNetError(f"{self.uri} is open for writing")
        # reopen first after a fork: a seek on the descriptor shared with
        # the parent would move the parent's offset, and the reopen in
        # read() would then read from the file's start
        self._check_pid()
        self.fp.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Keyed access via .idx file (ref: recordio.py:216)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos


def pack(header: IRHeader, s: bytes) -> bytes:
    """The record of ``s`` under ``header``: a scalar label in the header
    itself, an array label (float32) after it, its length in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
        return hdr + s
    label = onp.asarray(header.label, dtype=onp.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s: bytes):
    """``(IRHeader, payload)`` of a record; an array label comes back as
    float32."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = onp.frombuffer(s[:flag * 4], dtype=onp.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """``pack`` with ``img`` (HWC uint8, BGR as OpenCV takes it) encoded by
    OpenCV as JPEG (``quality`` 0-100) or PNG (``quality`` the compression
    level 0-9)."""
    import cv2
    encode_params = None
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ret:
        raise MXNetError(f"OpenCV could not encode the image as {img_fmt}")
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """The header and the image OpenCV decodes (BGR; ``iscolor`` as
    ``cv2.imdecode``'s flag)."""
    import cv2
    header, s = unpack(s)
    img = cv2.imdecode(onp.frombuffer(s, dtype=onp.uint8), iscolor)
    return header, img
