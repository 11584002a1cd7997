"""The CUDA backend: ``printer`` (IR → CUDA C++) and ``build`` (nvcc,
ctypes, launch)."""
