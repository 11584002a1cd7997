"""cubecl_tpu_torch: the PyTorch/CUDA port of ``cubecl_tpu`` for Hopper.

Three slices run on one NVIDIA H100:

- the ``@cube`` kernel language: ``frontend`` traces a Python kernel into
  the IR of ``ir``, ``opt`` optimizes it, and ``backend`` lowers it, by the
  CUDA C++ printer (built by ``nvcc`` at first launch) on a card, or by
  the torch evaluator on the CPU; ``runtime`` holds the clients
  (``CudaRuntime``, ``CpuRuntime``, ``default_client``);
- llama serving (``models.llama``), with hand-written CUDA kernels for
  attention (``csrc/``) and RMSNorm as a ``@cube`` kernel;
- training of llama and the transformer (``models.transformer``): flash
  attention's backward as two more CUDA kernels, and the ``@cube``
  backward kernels of ``ops.functional`` as autograd Functions.

Importing the package needs neither CUDA nor ``nvcc``, and it never
imports JAX or ``cubecl_tpu``.
"""

__version__ = "0.1.0"
