"""Kernels of the port, each beside its plain PyTorch version:
``attention.flash_attention`` and ``paged_attention.paged_attention``.

(Nothing is re-exported here: a function named like its module would hide
the module ``ops.paged_attention`` behind the function.)
"""
