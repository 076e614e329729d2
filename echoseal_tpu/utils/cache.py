"""Persistent JAX compilation cache location.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory: JAX
reads the variable itself and no other directory is set in code.
Otherwise the cache lives at the fixed path ``<repo>/.jax_cache`` (the
directory holding the ``echoseal_tpu`` package; listed in .gitignore).
The path is part of every cache key, so a directory that moves between
processes never hits.

XLA:CPU artifacts encode configuration-dependent target features: ones
compiled under the test harness's
``--xla_force_host_platform_device_count=8`` carry
``+prefer-no-scatter,+prefer-no-gather``, and loading them in a process
with other ``XLA_FLAGS`` (or vice versa) can mis-execute gather/scatter
ops -- observed once flipping a batch-verifier verdict mid-suite.  So a
process with a non-empty ``XLA_FLAGS`` gets its own deterministic
subdirectory, keyed by that string alone.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def persistent_cache_dir() -> str:
    """The directory ``enable_persistent_cache`` points JAX at."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    flags = os.environ.get("XLA_FLAGS", "").strip()
    if not flags:
        return str(REPO_CACHE)
    tag = hashlib.sha1(flags.encode()).hexdigest()[:10]
    return str(REPO_CACHE / f"flags-{tag}")


def enable_persistent_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    path = persistent_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return path
