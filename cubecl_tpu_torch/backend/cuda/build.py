"""Builds the kernels the CUDA printer writes, and launches them.

The route of slice 1's ``utils/native.py``: each printed source is written
to ``cubecl_tpu_torch/build/k0/<kernel>_<hash>.cu`` (the directory is
gitignored) and compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. The name hashes the
source and the flags, so an unchanged kernel is loaded as is.

:func:`start` runs ``nvcc`` in the background and returns at once; the
:class:`Launcher` of a kernel waits for its build at its first launch. So
a caller can compile many kernels before it launches one, and their
compilers run together. A failed build raises :class:`KernelBuildError`
with nvcc's output and the path of the source. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

import torch

from ...utils.native import BUILD_DIR as _NATIVE_BUILD_DIR
from ...utils.native import CudaError, KernelBuildError, find_nvcc

BUILD_DIR = os.path.join(_NATIVE_BUILD_DIR, "k0")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


class Build:
    """One kernel's library: nvcc's wall seconds (0.0 when an earlier
    build was reused) and its output, with ptxas' register, stack and
    spill report."""

    def __init__(self, path: str, source_path: str):
        self.path = path
        self.source_path = source_path
        self.seconds = 0.0
        self.log = ""
        self._proc: Optional[subprocess.Popen] = None
        self._t0 = 0.0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def wait(self) -> ctypes.CDLL:
        """The loaded library; waits for nvcc if it still runs."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._proc is not None:
                out, _ = self._proc.communicate()
                self.seconds = time.perf_counter() - self._t0
                self.log = out
                code = self._proc.returncode
                self._proc = None
                tmp = f"{self.path}.{os.getpid()}.tmp"
                if code != 0:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    raise KernelBuildError(
                        f"nvcc failed (exit {code}) on {self.source_path}:"
                        f"\n{out}")
                os.replace(tmp, self.path)
            try:
                lib = ctypes.CDLL(self.path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {self.path}: {e}") from e
            lib.cubecl_launch.argtypes = [ctypes.c_uint, ctypes.c_uint,
                                          ctypes.c_uint, ctypes.c_void_p,
                                          ctypes.c_void_p]
            lib.cubecl_launch.restype = ctypes.c_int
            lib.cubecl_error_string.argtypes = [ctypes.c_int]
            lib.cubecl_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib


def start(source: str, symbol: str) -> Build:
    """Write ``source`` and start nvcc on it (or reuse an earlier build of
    the same source and flags)."""
    h = digest(" ".join(NVCC_FLAGS) + "\n" + source)
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.join(BUILD_DIR, f"{symbol}_{h}")
    b = Build(stem + ".so", stem + ".cu")
    if os.path.exists(b.path):
        return b
    with open(b.source_path, "w") as f:
        f.write(source)
    tmp = f"{b.path}.{os.getpid()}.tmp"
    b._t0 = time.perf_counter()
    b._proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, b.source_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return b


_SCALAR_CTYPES = {
    "f64": ctypes.c_double, "f32": ctypes.c_float, "flex32": ctypes.c_float,
    "i64": ctypes.c_int64, "i32": ctypes.c_int32, "i16": ctypes.c_int16,
    "i8": ctypes.c_int8, "u64": ctypes.c_uint64, "u32": ctypes.c_uint32,
    "u16": ctypes.c_uint16, "u8": ctypes.c_uint8, "bool": ctypes.c_bool,
}


def _scalar_arg(value, elem):
    """A ctypes object holding a scalar argument as the kernel takes it
    (a 16-bit float is passed as its bits)."""
    if elem.name in ("bf16", "f16"):
        bits = torch.tensor(float(value), dtype=elem.torch_dtype())
        return ctypes.c_uint16(int(bits.view(torch.int16)) & 0xFFFF)
    ct = _SCALAR_CTYPES.get(elem.name)
    if ct is None:
        raise TypeError(f"no kernel argument type for a {elem.name} scalar")
    return ct(value)


class Launcher:
    """Launches one printed kernel on torch tensors (parameter order) on
    the current CUDA stream."""

    def __init__(self, build: Build, defn):
        self.build = build
        self.grid = defn.cube_count
        st = defn.state
        self.buffers = list(st.buffers)
        self.scalar_elems = [sp.ty.elem for sp in st.scalars]
        self.name = defn.options.name

    def __call__(self, tensors, scalars=()) -> None:
        lib = self.build.wait()
        objs = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
        objs += [ctypes.c_int64(bp.length) for bp in self.buffers]
        objs += [_scalar_arg(v, e) for v, e in zip(scalars,
                                                   self.scalar_elems)]
        args = (ctypes.c_void_p * len(objs))(
            *[ctypes.addressof(o) for o in objs])
        stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
        gx, gy, gz = self.grid
        code = lib.cubecl_launch(gx, gy, gz, stream, args)
        if code != 0:
            raise CudaError(self.name, code,
                            lib.cubecl_error_string(code).decode())
