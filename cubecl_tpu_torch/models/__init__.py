"""Model families of the port: ``llama`` (serving and training) and
``transformer`` (training)."""

from . import llama, transformer

__all__ = ["llama", "transformer"]
