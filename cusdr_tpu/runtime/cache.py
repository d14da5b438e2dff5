"""Persistent XLA compilation cache.

Nothing in the pipeline changes between runs of the CLI, the bench or
the smoke check, so an on-disk cache turns every compile after the first
into a reload.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets no directory; otherwise the cache lives at
the fixed path ``<checkout>/.cache/xla`` (the path is part of what a
later run must find again, so it never depends on the time, the process
or a temporary directory).

The reference has no compilation at all (interpreted MATLAB); this is
build infrastructure with no reference analog.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".cache" / "xla"


def enable_persistent_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    Returns the cache directory in use, or None for forced-CPU runs
    (tests and virtual-mesh rehearsals compile fast, and XLA:CPU
    artifacts are specific to the host's machine type).
    """
    import jax

    plats = os.environ.get("JAX_PLATFORMS", "")
    if "cpu" in plats.lower().split(","):
        return None
    # cache everything that takes noticeable time; the default 1 s floor
    # already skips trivial programs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    CHECKOUT_CACHE.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
