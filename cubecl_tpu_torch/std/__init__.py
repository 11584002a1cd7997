"""cubecl_tpu_torch.std — the standard library of kernels (counterpart of
``cubecl_tpu.std``): so far the quantization schemes and their K0
kernels, which ``ops.matmul.matmul_quantized`` runs on."""
