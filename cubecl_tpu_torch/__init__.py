"""cubecl_tpu_torch: the PyTorch/CUDA port of ``cubecl_tpu`` for Hopper.

The serving path of the llama family runs here on one NVIDIA H100: the
model is plain PyTorch, and the attention of prefill and of paged decode
are hand-written CUDA kernels (``csrc/``), built by ``nvcc`` on first use.
Importing the package needs neither CUDA nor ``nvcc``, and it never imports
JAX or ``cubecl_tpu``.
"""

__version__ = "0.1.0"
