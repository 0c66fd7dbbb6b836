"""Gluon utilities: ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1`` and ``download``.

Counterpart of ``mxnet_tpu/gluon/utils.py``. ``split_and_load`` slices a
batch along ``batch_axis`` and copies each slice to its context (a plain
copy in the calling process, so nothing initializes CUDA anywhere else);
``clip_global_norm`` scales the arrays in place with one host read of
the norm. The port has no network path: ``download`` returns a file that
is already at ``path`` (with a matching hash where given) and raises
otherwise.
"""
from __future__ import annotations

import hashlib
import math
import os
import warnings

import torch

from ..base import MXNetError
from ..context import as_device
from ..ndarray.ndarray import NDArray, _wrap, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last one
    takes the remainder unless ``even_split``, which raises instead)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}.")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        end = size if i == num_slice - 1 else (i + 1) * step
        idx = [slice(None)] * len(data.shape)
        idx[batch_axis] = slice(i * step, end)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` (an NDArray or an array) split along ``batch_axis``, one
    slice on each context of ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [_wrap(s._data.to(as_device(ctx)))
            for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float)."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    tensors = [getattr(a, "_data", a) for a in arrays]
    total = math.sqrt(float(sum(
        torch.sum(torch.square(t.detach().to(torch.float32))).to(
            tensors[0].device) for t in tensors)))
    if check_isfinite and not math.isfinite(total):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for t in tensors:
                t.mul_(scale)
    return total


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The local file ``url`` would be saved as, where it is already there
    (and matches ``sha1_hash`` where given); the port has no network path,
    so anything else raises."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(f"download({url!r}): the port has no network path; "
                     f"place the file at {fname!r} first")
