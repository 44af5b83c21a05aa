"""Shared JAX configuration for the device kernels: the compile cache.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the persistent cache lives at a fixed path
inside the checkout (``<repo>/.jax_cache``, git-ignored), so every run
from the same checkout finds the programs an earlier run compiled.
Imported for its side effect by every module that jits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=os.environ) -> Path | None:
    """The directory this module configures, or None when the env var
    already tells JAX where its cache is."""
    if environ.get(ENV_VAR):
        return None
    return REPO_CACHE_DIR


def configure(environ=os.environ) -> None:
    path = cache_dir(environ)
    if path is None:
        return
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


configure()
