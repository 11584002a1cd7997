"""Where the persistent store lives (counterpart of
``cubecl_tpu.runtime.config``'s ``cache_root``).

Reference: the environment root of cubecl-environment
(environment.rs:1-60). The store (the autotune cache) lives under
``$CUBECL_ENVIRONMENT_ROOT``, by default ``~/.cache/cubecl_tpu_torch``,
apart from the JAX package's ``~/.cache/cubecl_tpu`` so that the two
packages never share a sqlite store. The variable is read at each call.
"""

from __future__ import annotations

import os


def cache_root() -> str:
    """The persistent-store directory, created if missing."""
    path = os.environ.get("CUBECL_ENVIRONMENT_ROOT") or os.path.join(
        os.path.expanduser("~"), ".cache", "cubecl_tpu_torch")
    os.makedirs(path, exist_ok=True)
    return path
