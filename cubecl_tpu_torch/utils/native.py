"""Builds and loads the port's CUDA kernels (``cubecl_tpu_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The library
lands in ``cubecl_tpu_torch/build/`` under a name that hashes the sources and
flags, so an edited kernel is rebuilt and an unchanged one is loaded as is.

Counterpart of ``cubecl_tpu/utils/native.py``, without its silent fallbacks:
a missing ``nvcc``, a compile error or a library that does not load raises
:class:`KernelBuildError` with the compiler's output. Nothing is built at
import time; :func:`kernels` builds on first use.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "cubecl_flash_fwd": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
                         _F, _I, _VP],
    "cubecl_paged_decode": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F, _VP],
}


class KernelBuildError(RuntimeError):
    """The kernels could not be compiled or loaded."""


@dataclasses.dataclass(frozen=True)
class Build:
    """The kernel library; ``seconds`` and ``log`` (nvcc's output with
    ptxas' register/spill report) are 0.0 and "" when an earlier build of
    the same sources was reused."""
    path: str
    seconds: float
    log: str


_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD: Optional[Build] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``nvcc``
    on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked for {cand} and on PATH); the CUDA "
            "kernels of cubecl_tpu_torch need the CUDA toolkit")
    return found


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    deps = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    return srcs, deps


def build() -> Build:
    """Compile ``csrc/*.cu`` into one library, or reuse the library of an
    earlier build of the same sources and flags."""
    global _BUILD
    with _LOCK:
        if _BUILD is not None:
            return _BUILD
        srcs, deps = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in srcs + deps:
            with open(f, "rb") as fh:
                h.update(os.path.basename(f).encode() + fh.read())
        so = os.path.join(BUILD_DIR,
                          f"cubecl_kernels_{h.hexdigest()[:16]}.so")
        if os.path.exists(so):
            _BUILD = Build(so, 0.0, "")
            return _BUILD
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *srcs]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = r.stdout + r.stderr
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise KernelBuildError(
                f"nvcc failed (exit {r.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or none
        _BUILD = Build(so, seconds, log)
        return _BUILD


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    b = build()
    with _LOCK:
        if _LIB is None:
            try:
                lib = ctypes.CDLL(b.path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {b.path}: {e}") from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cubecl_error_string.argtypes = [ctypes.c_int]
            lib.cubecl_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check_aligned(*tensors) -> None:
    """The kernels read rows with 16-byte vector loads."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"tensor {tuple(t.shape)} at {t.data_ptr():#x} "
                             "is not 16-byte aligned")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.cubecl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
