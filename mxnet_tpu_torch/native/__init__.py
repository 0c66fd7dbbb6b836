"""The host-side native record reader and JPEG pipeline (C++ over ctypes).

Counterpart of ``mxnet_tpu/native/__init__.py`` without its C predict
API: ``NativeRecordIO`` (an mmap'd indexed reader), ``NativeRecordIOWriter``,
``NativeBatchServer`` (shuffled batches of raw records from a thread
pool) and ``NativeImagePipeline`` (JPEG decode, resize, crop, mirror and
normalise into float32 batches, in the epoch's order for one seed
whatever the thread count). The sources sit beside this file:
``recordio.cc``, ``image_pipeline.cc`` and one JPEG codec behind
``jpeg_codec.h``.

The library is built with ``g++`` at first use, never at import, into the
port's build directory (:func:`mxnet_tpu_torch._build.build_dir`), named
by a hash of its sources, its codec and its flags. The codec is chosen
once, from what the build finds: libjpeg where ``jpeglib.h`` compiles
(the JAX package's codec: the same file, seed and arguments give
bit-equal batches), else the CUDA toolkit's nvJPEG where
``$CUDA_HOME/include/nvjpeg.h`` exists; where neither is found, building
raises. :func:`codec` reports the choice. A build that fails raises, and
so does a fault of the decoder at run time (a CUDA or nvJPEG call that
failed): nothing falls back silently. A record that does not decode is a
bad record, counted in ``decode_failures`` as the JAX package counts it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as onp

from .. import config
from ..base import MXNetError

__all__ = ["available", "codec", "build", "lib", "decode", "NativeRecordIO",
           "NativeRecordIOWriter", "NativeBatchServer", "NativeImagePipeline"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("recordio.cc", "image_pipeline.cc")
HEADERS = ("jpeg_codec.h",)
CODEC_SOURCES = {"libjpeg": "jpeg_libjpeg.cc", "nvjpeg": "jpeg_nvjpeg.cc"}
BAD_IMAGE, DECODER_FAULT = 1, 2  # jpeg_codec.h's JpegStatus
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_STATE = {}  # "codec", "lib": chosen and loaded once per process


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _has_libjpeg() -> bool:
    """Whether ``#include <jpeglib.h>`` compiles here."""
    with tempfile.TemporaryDirectory() as d:
        probe = os.path.join(d, "probe.cc")
        with open(probe, "w") as f:
            f.write("#include <cstddef>\n#include <cstdio>\n"
                    "#include <jpeglib.h>\nint main() { return 0; }\n")
        try:
            return subprocess.run(
                ["g++", "-fsyntax-only", probe], capture_output=True,
                timeout=60).returncode == 0
        except FileNotFoundError:
            raise MXNetError("g++ not found: the native record reader is "
                             "built with g++ at first use") from None


def _find_codec():
    if _has_libjpeg():
        return "libjpeg"
    if os.path.exists(os.path.join(_cuda_home(), "include", "nvjpeg.h")):
        return "nvjpeg"
    return None


def codec() -> str:
    """The JPEG codec the native library is built with, ``"libjpeg"`` or
    ``"nvjpeg"``, chosen once per process; raises where neither is
    found."""
    with _LOCK:
        if "codec" not in _STATE:
            _STATE["codec"] = _find_codec()
    if _STATE["codec"] is None:
        raise MXNetError(
            "no JPEG codec for the native library: neither jpeglib.h "
            f"compiles nor {_cuda_home()}/include/nvjpeg.h exists")
    return _STATE["codec"]


def _link_flags(name: str):
    if name == "libjpeg":
        return ["-ljpeg"]
    cuda = _cuda_home()
    return [f"-I{cuda}/include", f"-L{cuda}/lib64", "-lnvjpeg",
            "-lcudart_static", "-ldl", "-lrt", f"-Wl,-rpath,{cuda}/lib64"]


def build(name: str = None) -> str:
    """Build the library with codec ``name`` (default: :func:`codec`) if
    it is not built yet; its path."""
    from .._build import build_dir
    name = name or codec()
    if name not in CODEC_SOURCES:
        raise ValueError(f"codec {name!r}: one of {sorted(CODEC_SOURCES)}")
    srcs = [os.path.join(_HERE, s) for s in SOURCES + (CODEC_SOURCES[name],)]
    digest = hashlib.sha256(" ".join([*CXX_FLAGS,
                                      *_link_flags(name)]).encode())
    for s in srcs + [os.path.join(_HERE, h) for h in HEADERS]:
        with open(s, "rb") as f:
            digest.update(f.read())
    out = os.path.join(build_dir(),
                       f"native-{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    # the flags go after the sources: -l options resolve left to right
    cmd = ["g++", *CXX_FLAGS, *srcs, "-o", tmp, *_link_flags(name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise MXNetError(f"building the native record library with codec "
                         f"{name} failed (exit {proc.returncode}):\n"
                         f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads half a file
    return out


def _declare(L) -> None:
    P, I64, I, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
        ctypes.c_float
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    for fn, res, args in (
            ("rio_open", P, [ctypes.c_char_p]),
            ("rio_error", ctypes.c_char_p, [P]),
            ("rio_count", I64, [P]),
            ("rio_get", I64, [P, I64, ctypes.POINTER(u8p)]),
            ("rio_close", None, [P]),
            ("rio_writer_open", P, [ctypes.c_char_p]),
            ("rio_writer_write", I, [P, ctypes.c_char_p, I64]),
            ("rio_writer_close", None, [P]),
            ("rio_batch_server_create", P, [P, I, I, ctypes.c_uint64, I]),
            ("rio_batch_next", P, [P]),
            ("rio_batch_total_bytes", I64, [P]),
            ("rio_batch_data", u8p, [P]),
            ("rio_batch_offsets", ctypes.POINTER(I64), [P]),
            ("rio_batch_lengths", ctypes.POINTER(I64), [P]),
            ("rio_batch_size", I64, [P]),
            ("rio_batch_free", None, [P]),
            ("rio_batch_server_reset", None, [P]),
            ("rio_batch_server_destroy", None, [P]),
            ("imgpipe_create", P, [P, I, I, I, I, I, I, I, I, I, I, fp, fp,
                                   ctypes.c_uint64, I, F, I]),
            ("imgpipe_next", P, [P]),
            ("imgpipe_batch_data", fp, [P]),
            ("imgpipe_batch_labels", fp, [P]),
            ("imgpipe_batch_n", I64, [P]),
            ("imgpipe_batch_pad", I64, [P]),
            ("imgpipe_batch_free", None, [P]),
            ("imgpipe_reset", None, [P]),
            ("imgpipe_decode_failures", I64, [P]),
            ("imgpipe_destroy", None, [P]),
            ("imgpipe_error", ctypes.c_char_p, [P]),
            ("imgpipe_decode", u8p, [ctypes.c_char_p, I64, I, ip, ip, ip,
                                     ctypes.c_char_p, I64]),
            ("imgpipe_decode_free", None, [u8p]),
            ("imgpipe_codec", ctypes.c_char_p, [])):
        f = getattr(L, fn)
        f.restype = res
        f.argtypes = args


def lib(name: str = None) -> ctypes.CDLL:
    """The loaded library with codec ``name`` (default: :func:`codec`),
    built first if needed. Raises where it cannot be built."""
    name = name or codec()
    libs = _STATE.setdefault("libs", {})
    L = libs.get(name)
    if L is None:
        path = build(name)
        with _LOCK:
            L = libs.get(name)
            if L is None:
                L = ctypes.CDLL(path)
                _declare(L)
                libs[name] = L
    return L


def available() -> bool:
    """Whether the native library can be built here: a JPEG codec was
    found."""
    with _LOCK:
        if "codec" not in _STATE:
            _STATE["codec"] = _find_codec()
    return _STATE["codec"] is not None


def decode(buf: bytes, channels: int = 3, codec: str = None) -> onp.ndarray:
    """One JPEG through the pipeline's codec (or the library built with
    ``codec``): an HWC uint8 array (RGB, or one gray channel where
    ``channels == 1``). A stream that does not decode and a fault of the
    decoder both raise ``MXNetError``."""
    L = lib(codec)
    w, h, status = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    ptr = L.imgpipe_decode(buf, len(buf), int(channels), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(status), err,
                           len(err))
    if not ptr:
        name = L.imgpipe_codec().decode()
        if status.value == DECODER_FAULT:
            raise MXNetError(f"{name}: decoder fault: {err.value.decode()}")
        raise MXNetError(f"{name} could not decode the image "
                         f"({len(buf)} bytes)")
    try:
        c = 1 if channels == 1 else 3
        return onp.ctypeslib.as_array(
            ptr, shape=(h.value, w.value, c)).copy()
    finally:
        L.imgpipe_decode_free(ptr)


def _num_workers(n: int) -> int:
    if n > 0:
        return n
    return max(2, int(config.get("MXNET_CPU_WORKER_NTHREADS")))


class NativeRecordIO:
    """mmap'd zero-copy indexed reader of a ``.rec`` file."""

    def __init__(self, path: str):
        self._L = lib()
        self._h = self._L.rio_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot open {path}")
        err = self._L.rio_error(self._h)
        if err:
            self.close()
            raise IOError(err.decode())

    def __len__(self):
        return int(self._L.rio_count(self._h))

    def read_idx(self, i: int) -> bytes:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        n = self._L.rio_get(self._h, i, ctypes.byref(ptr))
        if n < 0:
            raise IndexError(i)
        return ctypes.string_at(ptr, n)

    def close(self):
        if getattr(self, "_h", None):
            self._L.rio_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeRecordIOWriter:
    """Writes records in the reader's framing."""

    def __init__(self, path: str):
        self._L = lib()
        self._h = self._L.rio_writer_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot open {path}")

    def write(self, buf: bytes):
        if self._L.rio_writer_write(self._h, buf, len(buf)) != 0:
            raise IOError("write failed")

    def close(self):
        if getattr(self, "_h", None):
            self._L.rio_writer_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeBatchServer:
    """Shuffled batches of raw record payloads from a thread pool (the
    final batch wrap-padded, as the reference's ``last_batch_handle=
    "pad"``); a list of ``bytes`` per batch."""

    def __init__(self, path: str, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 0):
        self._reader = NativeRecordIO(path)
        self._L = self._reader._L
        self._h = self._L.rio_batch_server_create(
            self._reader._h, batch_size, int(shuffle), seed,
            _num_workers(num_workers))
        self.batch_size = batch_size

    def __iter__(self):
        while True:
            b = self._L.rio_batch_next(self._h)
            if not b:
                return
            try:
                n = int(self._L.rio_batch_size(b))
                total = int(self._L.rio_batch_total_bytes(b))
                data = ctypes.string_at(self._L.rio_batch_data(b), total)
                offs = onp.ctypeslib.as_array(self._L.rio_batch_offsets(b),
                                              shape=(n,)).tolist()
                lens = onp.ctypeslib.as_array(self._L.rio_batch_lengths(b),
                                              shape=(n,)).tolist()
            finally:
                self._L.rio_batch_free(b)
            yield [data[o:o + n_] for o, n_ in zip(offs, lens)]

    def reset(self):
        self._L.rio_batch_server_reset(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._L.rio_batch_server_destroy(self._h)
            self._h = None
            self._reader.close()

    def __del__(self):
        self.close()


class NativeImagePipeline:
    """Threaded JPEG decode, augment and batch (``image_pipeline.cc``).

    Iterating yields ``(data, labels)`` float32 numpy batches, NCHW by
    default (``layout="NHWC"`` for channels last); ``last_pad`` is the
    count of wrap-padded duplicates in the batch just yielded. With
    :meth:`batches` a caller reads each batch straight out of the
    library's buffer instead of a copy (the record iterator stages it
    into pinned memory from there). ``decode_failures`` counts records
    that did not decode (their slots hold zeros). A fault of the decoder
    itself (a CUDA or nvJPEG call that failed) raises ``MXNetError``, at
    construction or at the next batch, and again at every batch after."""

    def __init__(self, path: str, batch_size: int, data_shape=(3, 224, 224),
                 label_width: int = 1, shuffle: bool = False, resize: int = 0,
                 rand_crop: bool = False, rand_mirror: bool = False,
                 mean=None, std=None, seed: int = 0, num_workers: int = 0,
                 layout: str = "NCHW", label_pad_value: float = 0.0,
                 force_resize: bool = False):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"layout {layout!r}: NCHW or NHWC")
        self._reader = NativeRecordIO(path)
        self._L = self._reader._L
        c, h, w = data_shape
        m = (ctypes.c_float * 3)(*(mean if mean is not None else (0, 0, 0)))
        s = (ctypes.c_float * 3)(*(std if std is not None else (1, 1, 1)))
        self._nhwc = layout == "NHWC"
        self.num_workers = _num_workers(num_workers)
        self._h = self._L.imgpipe_create(
            self._reader._h, batch_size, c, h, w, int(resize),
            int(label_width), int(rand_crop), int(rand_mirror),
            int(shuffle), int(self._nhwc), m, s, seed, self.num_workers,
            float(label_pad_value), int(force_resize))
        if not self._h:
            self._reader.close()
            raise ValueError(
                f"imgpipe_create rejected batch_size={batch_size}")
        self._raise_fault()
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.last_pad = 0

    @property
    def codec(self) -> str:
        return self._L.imgpipe_codec().decode()

    def _raise_fault(self):
        err = self._L.imgpipe_error(self._h)
        if err:
            raise MXNetError(f"the native image pipeline stopped: "
                             f"{err.decode()}")

    @property
    def batch_shape(self):
        c, h, w = self.data_shape
        return (self.batch_size, h, w, c) if self._nhwc \
            else (self.batch_size, c, h, w)

    def batches(self):
        """``(data, labels, pad)`` per batch, ``data`` and ``labels`` views
        of the library's buffer that stay valid only until the generator
        resumes (it frees the batch then)."""
        n_img = int(onp.prod(self.batch_shape))
        n_lbl = self.batch_size * self.label_width
        while True:
            b = self._L.imgpipe_next(self._h)
            if not b:
                self._raise_fault()
                return
            try:
                data = onp.ctypeslib.as_array(
                    self._L.imgpipe_batch_data(b), shape=(n_img,))
                labels = onp.ctypeslib.as_array(
                    self._L.imgpipe_batch_labels(b), shape=(n_lbl,))
                yield (data.reshape(self.batch_shape),
                       labels.reshape(self.batch_size, self.label_width),
                       int(self._L.imgpipe_batch_pad(b)))
            finally:
                self._L.imgpipe_batch_free(b)

    def __iter__(self):
        for data, labels, pad in self.batches():
            self.last_pad = pad
            yield data.copy(), labels.copy()

    def reset(self):
        self._L.imgpipe_reset(self._h)

    @property
    def decode_failures(self) -> int:
        return int(self._L.imgpipe_decode_failures(self._h))

    def close(self):
        if getattr(self, "_h", None):
            self._L.imgpipe_destroy(self._h)
            self._h = None
        if getattr(self, "_reader", None) is not None:
            self._reader.close()
            self._reader = None

    def __del__(self):
        self.close()
