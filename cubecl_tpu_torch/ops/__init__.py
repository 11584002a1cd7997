"""Kernels of the port, each beside its plain version:
``attention.flash_attention`` and ``attention.flash_attention_block_sparse``
(forward and backward), ``paged_attention.paged_attention``,
``matmul.matmul_pallas``, ``reduce.reduce_sum_native``,
``moe.expert_matmul``, ``ssm.scan_chunked_core`` and
``conv.conv2d_pairs_packed`` (hand-written CUDA), and the ``@cube``
kernels of ``gelu``, ``normalization`` and ``functional`` (K0: the CUDA
printer on a card, the torch evaluator on the CPU; ``functional``'s ops
are autograd Functions).

(Nothing is re-exported here: a function named like its module would hide
the module ``ops.paged_attention`` behind the function.)
"""
