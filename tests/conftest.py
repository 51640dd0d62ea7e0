"""Test configuration: run on a virtual 8-device CPU mesh by default.

Numerics and sharding are checked on the CPU backend with 8 virtual
devices, so the multi-device paths compile and execute as they would on a
mesh of cards. When JAX_PLATFORMS is set (e.g. ``JAX_PLATFORMS=cuda
python -m pytest -m gpu tests/``) the tests run on that platform instead.
Must run before jax creates its backends, hence the env mutation at
import time.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
