"""cubecl_tpu_torch.backend — backend compilers (counterpart of
``cubecl_tpu.backend``): the CUDA C++ printer built by nvcc
(``cuda.printer.CudaCompiler``, the port of K0) and the torch evaluator
(``torch_eval.TorchEvalCompiler``, its plain version and the CPU twin)."""

from .compiler import (CompiledKernel, Compiler, KernelDefinition,
                       KernelOptions, prepare_scope)
from .cuda.printer import CudaCompiler
from .torch_eval import TorchEvalCompiler
