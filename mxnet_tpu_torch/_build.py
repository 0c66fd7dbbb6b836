"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and
loaded with :mod:`ctypes`. A library is built at first use into
``_build/`` beside this file, named by a hash of its source, the shared
headers and the flags, so an edited source rebuilds and an unchanged one
loads at once. Nothing is
built when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

from .base import MXNetError

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "load", "LaunchCounter"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("flash_fwd", "flash_fwd_tc", "flash_fwd_tc32", "flash_bwd",
           "flash_bwd_tc", "flash_bwd_tc32", "mp_sgd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the port's CUDA kernels are built from csrc/ at first "
                     "use")


def _target(name: str) -> str:
    """Path of the library, named by a hash of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Build every kernel source that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: {"path", "seconds",
    "log"}}`` (``seconds`` 0 and ``log`` empty where the library was
    already built)."""
    report: Dict[str, dict] = {}
    with _LOCK:
        t0 = time.perf_counter()
        running = []
        for name in names or SOURCES:
            out = _target(name)
            if os.path.exists(out):
                report[name] = {"path": out, "seconds": 0.0, "log": ""}
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            running.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for name, out, tmp, proc in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise MXNetError(f"nvcc failed for csrc/{name}.cu (exit "
                                 f"{proc.returncode}):\n{log}")
            os.replace(tmp, out)  # atomic: a reader never sees a partial .so
            report[name] = {"path": out, "log": log,
                            "seconds": time.perf_counter() - t0}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]["path"]
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(path)
                lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
                lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        msg = lib.mx_cuda_error_string(err).decode()
        raise MXNetError(f"{what}: CUDA error {err} ({msg})")


class LaunchCounter:
    """Count of one kernel's launches. A wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its
    path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
