"""Test harness configuration.

Tests run on CPU with a virtual 8-device mesh so multi-device sharding code
paths compile and execute without accelerator hardware.  A persistent JAX
compilation cache keeps the (one-time) SCL scan compilation out of every
test run.
"""
import os

# CPU unless the caller chose the platforms: the GPU-marked tests run on a
# card with JAX_PLATFORMS=cuda,cpu (they compare the GPU with the CPU)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The library's SCL default is chosen on the GPU (ops/scl.py); the CPU
# suite pins the compile-cheap lazy scan with its narrow deep tier
# (XLA:CPU does not fuse the wide tier's in-scan slice updates).
os.environ.setdefault("ECHOSEAL_SCL_IMPL", "lazy")
os.environ.setdefault("ECHOSEAL_SCL_DEEP_SEG", "1")

import jax  # noqa: E402

# the env var alone is too late if a plugin already set the platform list
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# per-XLA_FLAGS cache subdirectory: XLA:CPU artifacts depend on the
# device-count flag (utils/cache.py)
from echoseal_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def key32() -> bytes:
    return bytes.fromhex("aa" * 32)


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(0xE5EA1)
