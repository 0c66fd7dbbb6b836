"""MXNet's binary NDArray format (``.params`` files) for torch tensors.

The port's own copy of ``mxnet_tpu/ndarray/serialization.py`` (numpy and
``struct`` only), over torch tensors: the byte layout of the reference's
``NDArray::Save`` / ``NDArray::Load`` (src/ndarray/ndarray.cc:1594-1860),
so that a file either package writes loads in the other, bit for bit:

file      := uint64 list_magic (0x112) | uint64 reserved (0)
           | uint64 n_arrays | n_arrays * ndarray
           | uint64 n_names  | n_names * (uint64 len | bytes)
ndarray   := uint32 magic (V2 0xF993fac9 / V3 0xF993faca)
           | int32 stype (0 dense, 1 row_sparse, 2 csr)
           | [storage_shape: shape]         (sparse only)
           | shape
           | int32 dev_type | int32 dev_id  (Context::Save, base.h:157)
           | int32 type_flag                (mshadow dtype enum)
           | nad * (int32 aux_type | shape) (sparse only)
           | raw data bytes (storage_shape elems * dtype size, LE)
           | nad * raw aux bytes
shape     := int32 ndim | ndim * int64      (Tuple<dim_t>::Save,
                                             include/mxnet/tuple.h:704)

Legacy loads: V1 magic 0xF993fac8 (shape/ctx/type/data, no stype), the
ancient header where the leading uint32 is ndim with uint32 dims
(ndarray.cc LegacyTShapeLoad), and the JAX package's round-1 interim
layout. Dense arrays only: a ``row_sparse`` or ``csr`` entry raises until
the sparse types come with the ``mx.nd`` slice (ROADMAP Queue A item 3).
bfloat16, which numpy lacks, travels as its 16-bit pattern.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple, Union

import numpy as onp
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["save", "load", "load_frombuffer", "save_bytes", "load_buffer"]

LIST_MAGIC = 0x112
V1_MAGIC = 0xF993FAC8
V2_MAGIC = 0xF993FAC9
V3_MAGIC = 0xF993FACA

# mshadow type flags (3rdparty/mshadow/mshadow/base.h kFloat32...)
_TYPE_FLAG = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
              torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
              torch.bfloat16: 7}
_FLAG_TYPE = {v: k for k, v in _TYPE_FLAG.items()}
_NP_OF = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.uint8: "uint8",
          torch.int32: "int32", torch.int8: "int8", torch.int64: "int64",
          torch.bfloat16: "uint16"}

_STYPE_ID = {"default": 0, "row_sparse": 1, "csr": 2}
_ID_STYPE = {v: k for k, v in _STYPE_ID.items()}
# aux tensors per storage type (include/mxnet/ndarray.h num_aux_data)
_NUM_AUX = {0: 0, 1: 1, 2: 2}

_DEV_TYPE = {"cpu": 1, "cuda": 2}  # Context: kCPU 1, kGPU 2

_SPARSE_WAITS = ("sparse (row_sparse, csr) arrays come with the mx.nd "
                 "slice (ROADMAP Queue A item 3)")


def _write_shape(out: List[bytes], shape: Sequence[int]):
    out.append(struct.pack("<i", len(shape)))
    if shape:
        out.append(struct.pack(f"<{len(shape)}q", *shape))


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _save_one(out: List[bytes], arr: torch.Tensor) -> None:
    if not isinstance(arr, torch.Tensor) or arr.layout != torch.strided:
        raise NotImplementedError(f"save: {_SPARSE_WAITS}")
    if arr.dtype not in _TYPE_FLAG:
        raise MXNetError(f"dtype {arr.dtype} has no reference type flag")
    # 0-dim arrays only exist under np-shape semantics: V2's ndim==0
    # means "none" (ndarray.cc:1770), so scalars get the V3 magic
    out.append(struct.pack("<I", V3_MAGIC if arr.dim() == 0 else V2_MAGIC))
    out.append(struct.pack("<i", _STYPE_ID["default"]))
    _write_shape(out, tuple(arr.shape))
    out.append(struct.pack("<ii", _DEV_TYPE.get(arr.device.type, 1), 0))
    out.append(struct.pack("<i", _TYPE_FLAG[arr.dtype]))
    out.append(_host_bytes(arr))


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise MXNetError("Invalid NDArray file format (truncated)")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def shape_ndim(self) -> Tuple[Tuple[int, ...], int]:
        ndim = self.i32()
        if ndim <= 0:
            return (), ndim
        return struct.unpack(f"<{ndim}q", self.read(8 * ndim)), ndim

    def shape(self) -> Tuple[int, ...]:
        return self.shape_ndim()[0]

    def legacy_shape_u32(self, ndim: int) -> Tuple[int, ...]:
        return struct.unpack(f"<{ndim}I", self.read(4 * ndim))


def _dtype_of_flag(flag: int) -> torch.dtype:
    if flag not in _FLAG_TYPE:
        raise MXNetError(f"unknown mshadow type flag {flag}")
    return _FLAG_TYPE[flag]


def _tensor(r: _Reader, dtype: torch.dtype, shape) -> torch.Tensor:
    """``prod(shape)`` elements of ``dtype`` from the reader, as a CPU
    tensor that owns its memory."""
    npdt = onp.dtype(_NP_OF[dtype])
    n = int(onp.prod(shape)) if shape else 1
    data = onp.frombuffer(r.read(n * npdt.itemsize), dtype=npdt).copy()
    t = torch.from_numpy(data.reshape(shape))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _load_one(r: _Reader):
    """The next entry: a CPU tensor, or None for a ``none`` placeholder."""
    magic = r.u32()
    if magic in (V2_MAGIC, V3_MAGIC):
        sid = r.i32()
        if sid not in _NUM_AUX:
            raise MXNetError(f"unknown storage type id {sid}")
        if sid != 0:
            raise NotImplementedError(
                f"load: a {_ID_STYPE[sid]} entry: {_SPARSE_WAITS}")
        shape, ndim = r.shape_ndim()
        # V2: ndim==0 is the is_none() placeholder (ndarray.cc:1770);
        # V3 (np semantics): ndim==0 is a real scalar, ndim==-1 is none
        if (magic == V2_MAGIC and ndim == 0) \
                or (magic == V3_MAGIC and ndim < 0):
            return None
        r.i32(); r.i32()  # context (dev_type, dev_id): data is host-side
        return _tensor(r, _dtype_of_flag(r.i32()), shape)
    # legacy paths (ndarray.cc LegacyLoad)
    if magic == V1_MAGIC:
        shape = r.shape()
    else:  # ancient: magic itself is ndim, dims are uint32
        shape = r.legacy_shape_u32(magic)
    if not shape:
        return None
    r.i32(); r.i32()  # context
    return _tensor(r, _dtype_of_flag(r.i32()), shape)


def save_bytes(arrays: Sequence[torch.Tensor], names: Sequence[str]) -> bytes:
    """The file's bytes for ``arrays`` (names empty: an unnamed list)."""
    out: List[bytes] = [struct.pack("<QQ", LIST_MAGIC, 0),
                        struct.pack("<Q", len(arrays))]
    for a in arrays:
        _save_one(out, a)
    names = [n for n in names if n] if any(names) else []
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        nb = n.encode()
        out.append(struct.pack("<Q", len(nb)))
        out.append(nb)
    return b"".join(out)


def load_buffer(buf: bytes):
    """``(list of CPU tensors or None, names)`` of a file's bytes."""
    r = _Reader(buf)
    header = r.u64()
    if header != LIST_MAGIC:
        raise MXNetError(f"Invalid NDArray file format (magic {header:#x})")
    second = r.u64()
    if second != 0:
        # round-1 interim layout: magic | count | (name,dtype,shape,bytes)*
        return _load_legacy_interim(r, second)
    n = r.u64()
    arrays = [_load_one(r) for _ in range(n)]
    n_names = r.u64()
    names = [r.read(r.u64()).decode() for _ in range(n_names)]
    if names and len(names) != len(arrays):
        raise MXNetError("Invalid NDArray file format (name count)")
    return arrays, names


def _load_legacy_interim(r: _Reader, n: int):
    names, arrays = [], []
    for _ in range(n):
        name = r.read(r.u32()).decode()
        npdt = onp.dtype(r.read(r.u32()).decode())
        ndim = r.u32()
        shape = struct.unpack(f"<{ndim}q", r.read(8 * ndim)) if ndim else ()
        nb = r.u64()
        data = onp.frombuffer(r.read(nb), dtype=npdt).reshape(shape).copy()
        names.append(name)
        arrays.append(torch.from_numpy(data))
    return arrays, names if any(names) else []


Saved = Union[torch.Tensor, Sequence[torch.Tensor], Dict[str, torch.Tensor]]


def save(fname: str, data: Saved) -> None:
    """Write a tensor, a list of tensors or a ``{name: tensor}`` dict to
    ``fname`` in MXNet's format (``mx.nd.save``)."""
    if isinstance(data, torch.Tensor):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = [""] * len(data)
        arrays = list(data)
    with open(fname, "wb") as f:
        f.write(save_bytes(arrays, names))


def load_frombuffer(buf: bytes, device="cuda"):
    """What :func:`load` gives, from the file's bytes."""
    dev = resolve_device(device)
    arrays, names = load_buffer(buf)
    arrays = [None if a is None else a.to(dev) for a in arrays]
    if names:
        return dict(zip(names, arrays))
    return arrays


def load(fname: str, device="cuda"):
    """The tensors of a file in MXNet's format, on ``device``: a
    ``{name: tensor}`` dict where the file names them, else a list
    (``mx.nd.load``)."""
    with open(fname, "rb") as f:
        return load_frombuffer(f.read(), device)
