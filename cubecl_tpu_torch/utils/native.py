"""Builds and loads the port's CUDA kernels (``cubecl_tpu_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``cubecl_tpu_torch/build/`` under a name that hashes the sources and flags,
so an edited kernel is rebuilt and an unchanged one is loaded as is.

Counterpart of ``cubecl_tpu/utils/native.py``, without its silent fallbacks:
a missing ``nvcc``, a compile error or a library that does not load raises
:class:`KernelBuildError` with the compiler's output. Nothing is built at
import time; :func:`kernels` builds on first use. The host page pool
(``csrc/page_pool.cc``, not a ``.cu`` file) is built apart by g++ in
:func:`page_pool`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3, torch.float8_e5m2: 4, torch.int32: 5,
               torch.float16: 6}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "cubecl_reduce_sum": [_VP, _VP, _VP, _I64, _I64, _I, _I, _VP],
    "cubecl_flash_fwd": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                         _I, _F, _I, _VP],
    "cubecl_flash_bwd_dkv": [_VP] * 8 + [_I] * 7 + [_F, _F, _I, _VP],
    "cubecl_flash_bwd_dq": [_VP] * 7 + [_I] * 7 + [_F, _F, _I, _VP],
    "cubecl_paged_decode": [_VP] * 10 + [_I] * 12 + [_F, _VP],
    "cubecl_paged_decode_plan": [_I] * 11 + [_VP],
    "cubecl_paged_chunked": [_VP] * 10 + [_I] * 11 + [_F, _VP],
    "cubecl_paged_chunked_plan": [_I] * 9 + [_VP],
    "cubecl_matmul": [_VP] * 6 + [_I] * 10 + [_F, _VP],
    "cubecl_matmul8": [_VP] * 6 + [_I] * 10 + [_F, _VP],
    "cubecl_expert_matmul": [_VP] * 4 + [_I] * 8 + [_VP],
    "cubecl_selective_scan": [_VP] * 3 + [_I] * 3 + [_I64, _VP],
    "cubecl_selective_scan_bwd": [_VP] * 5 + [_I] * 3 + [_I64, _VP],
    "cubecl_flash_bsp_fwd": [_VP] * 7 + [_I] * 9 + [_F, _I, _VP],
    "cubecl_flash_bsp_dq": [_VP] * 9 + [_I] * 9 + [_F, _F, _I, _VP],
    "cubecl_flash_bsp_dkv": [_VP] * 10 + [_I] + [_VP] * 2 + [_I] * 9
    + [_F, _F, _I, _VP],
    "cubecl_flash_masked_fwd": [_VP] * 8 + [_I] * 7 + [_F] + [_I] * 4
    + [_VP],
    "cubecl_flash_masked_dkv": [_VP] * 11 + [_I] * 7 + [_F, _F] + [_I] * 4
    + [_VP],
    "cubecl_flash_masked_dq": [_VP] * 10 + [_I] * 7 + [_F, _F] + [_I] * 4
    + [_VP],
    "cubecl_conv3x3": [_VP] * 4 + [_I] * 5 + [_VP],
    "cubecl_conv3x3_plan": [_I] * 4 + [_VP],
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
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            objs = [os.path.join(objdir, os.path.basename(f) + ".o")
                    for f in srcs]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, f]
                    for f, o in zip(srcs, objs)]
            cmds.append([nvcc, "-shared", "-o", tmp, *objs])
            log = ""
            # one nvcc per source, all at once; then the link
            for batch in (cmds[:-1], cmds[-1:]):
                procs = [(c, subprocess.Popen(
                    c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)) for c in batch]
                for cmd, p in procs:
                    out = p.communicate()[0]
                    log += out
                    if p.returncode != 0:
                        for _, other in procs:
                            if other.returncode is None:  # drain its pipe
                                other.communicate()
                        if os.path.exists(tmp):
                            os.remove(tmp)
                        raise KernelBuildError(
                            f"nvcc failed (exit {p.returncode}): "
                            f"{' '.join(cmd)}\n{out}")
        seconds = time.perf_counter() - t0
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


PAGE_POOL_SRC = os.path.join(CSRC_DIR, "page_pool.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_I32 = ctypes.c_int32
_POOL_SIGNATURES = {
    "page_pool_create": ([_I32], _I64),
    "page_pool_destroy": ([_I64], _I32),
    "page_pool_num_free": ([_I64], _I32),
    "page_pool_seq_pages": ([_I64, _I64], _I32),
    "page_pool_alloc_seq": ([_I64, _I64, _I32], _I32),
    "page_pool_append": ([_I64, _I64], _I32),
    "page_pool_fork": ([_I64, _I64, _I64], _I32),
    "page_pool_free_seq": ([_I64, _I64], _I32),
    "page_pool_fill_table": ([_I64, _VP, _I32, _VP, _I32], _I32),
    "page_pool_unshare_last": ([_I64, _I64], _I64),
    "page_pool_register_prefix": ([_I64, _I64, _VP, _I32], _I32),
    "page_pool_admit_cached": ([_I64, _I64, _VP, _I32], _I32),
    "page_pool_refcount": ([_I64, _I32], _I32),
}
_POOL_LIB: Optional[ctypes.CDLL] = None


def page_pool() -> ctypes.CDLL:
    """The host page pool of ``csrc/page_pool.cc`` (the block manager of
    ``runtime/pages.py``): plain C++ built by ``$CXX`` (default ``g++``)
    into ``build/`` at first use, under a name that hashes the source and
    flags, and loaded with ctypes. Raises :class:`KernelBuildError` when it
    cannot be compiled or loaded."""
    global _POOL_LIB
    with _LOCK:
        if _POOL_LIB is not None:
            return _POOL_LIB
        with open(PAGE_POOL_SRC, "rb") as fh:
            h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + fh.read())
        so = os.path.join(BUILD_DIR, f"page_pool_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            cxx = os.environ.get("CXX") or "g++"
            if shutil.which(cxx) is None:
                raise KernelBuildError(f"{cxx} not found: the page pool of "
                                       "cubecl_tpu_torch needs a C++ compiler")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            p = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, PAGE_POOL_SRC],
                               capture_output=True, text=True)
            if p.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise KernelBuildError(f"{cxx} failed (exit {p.returncode}) "
                                       f"on {PAGE_POOL_SRC}:\n{p.stderr}")
            os.replace(tmp, so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise KernelBuildError(f"cannot load {so}: {e}") from e
        for name, (argtypes, restype) in _POOL_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _POOL_LIB = lib
        return lib


def check_aligned(*tensors) -> None:
    """The kernels read rows with 16-byte vector loads."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"tensor {tuple(t.shape)} at {t.data_ptr():#x} "
                             "is not 16-byte aligned")


def refuse_grad(kernel: str, alternative: str, *tensors) -> None:
    """A hand kernel writes its output through ``data_ptr()`` and has no
    backward: under grad mode with an input that requires grad it would cut
    the autograd graph silently, so it raises, naming ``alternative``, the
    differentiable route. Checked on every device, before the device
    branch, so that the CPU holds the same contract as the card."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward (nor has the JAX kernel); under "
            f"autograd use {alternative}")


# cudaError_t codes that leave the context unusable: an illegal address
# (700), a launch timeout (702), a device assert (710), a hardware stack
# error, an illegal instruction, a misaligned address, an invalid address
# space or pc (714-718), a launch failure (719); every later call fails too.
# 701 (too many resources requested for a launch) is not among them.
STICKY_CUDA_ERRORS = frozenset({700, 702, 710, 714, 715, 716, 717, 718, 719})


class CudaError(RuntimeError):
    """A kernel launch returned a CUDA error. ``sticky`` is true for the
    errors that poison the context; the others (a launch refused for its
    resources, ``cudaErrorInvalidValue`` for a type or tile the library
    was not built for) leave it usable."""

    def __init__(self, what: str, code: int, msg: str):
        super().__init__(f"{what}: CUDA error {code} ({msg})")
        self.code = code

    @property
    def sticky(self) -> bool:
        return self.code in STICKY_CUDA_ERRORS


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise :class:`CudaError` if a kernel entry point returned a CUDA
    error."""
    if code != 0:
        raise CudaError(what, code, lib.cubecl_error_string(code).decode())
