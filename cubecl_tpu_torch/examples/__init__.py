"""The port's twins of the JAX package's ``examples/`` scripts, as modules:
the same ``@cube`` kernels written against ``cubecl_tpu_torch`` (the
scripts import ``cubecl_tpu``), with their launch plans as functions that
the tests and ``chip_smoke.py`` call. Each runs on the card with
``python -m cubecl_tpu_torch.examples.<name>``."""
