"""Kernels of the port, each beside its plain version:
``attention.flash_attention`` (forward and backward) and
``paged_attention.paged_attention`` (hand-written CUDA), and the ``@cube``
kernels of ``gelu``, ``normalization`` and ``functional`` (K0: the CUDA
printer on a card, the torch evaluator on the CPU; ``functional``'s ops
are autograd Functions).

(Nothing is re-exported here: a function named like its module would hide
the module ``ops.paged_attention`` behind the function.)
"""
