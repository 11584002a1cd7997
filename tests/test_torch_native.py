"""cubecl_tpu_torch's import boundary and kernel build errors (no JAX)."""

import os
import subprocess
import sys

import pytest

from cubecl_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax_or_the_jax_package():
    """Every module of the port imports on a host without JAX, CUDA or
    nvcc, and none pulls in jax or cubecl_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cubecl_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'cubecl_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'cubecl_tpu_torch.models.llama' in mods, mods\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cubecl_tpu')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """No cached library and no earlier build in this process."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_BUILD", None)
    monkeypatch.setattr(native, "_LIB", None)
    return tmp_path


def test_missing_nvcc_raises(fresh_build, monkeypatch):
    empty = fresh_build / "empty"
    empty.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(empty))
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(native.KernelBuildError, match="nvcc not found"):
        native.kernels()


def test_compile_error_raises_with_compiler_output(fresh_build, monkeypatch):
    bindir = fresh_build / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'flash_attention.cu(7): error: "
                    "expected a \";\"' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "cuda"))
    with pytest.raises(native.KernelBuildError,
                       match=r"(?s)exit 2.*expected a"):
        native.build()
    assert not os.listdir(fresh_build / "build")  # no partial library left


def test_page_pool_without_a_compiler_raises(monkeypatch, tmp_path):
    """PageAllocator takes the C++ pool or raises: there is no fallback."""
    from cubecl_tpu_torch.runtime.pages import PageAllocator

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_POOL_LIB", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.KernelBuildError, match="not found"):
        PageAllocator(4, 16)
