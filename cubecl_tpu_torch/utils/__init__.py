"""Build and load support for the port's CUDA kernels."""
