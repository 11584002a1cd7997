"""Model families of the port: ``llama`` (serving and training, dense or
mixture-of-experts FFNs), ``transformer`` (training) and ``mamba`` (selective
SSM serving)."""

from . import llama, mamba, transformer

__all__ = ["llama", "mamba", "transformer"]
