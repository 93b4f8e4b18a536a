"""Test configuration: run on a virtual 8-device CPU mesh.

Tests never need an accelerator: they run on JAX's CPU backend, and the
sharding tests use --xla_force_host_platform_device_count=8 for
multi-device validation without cards.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# pin the backend in JAX's config too, so that no plugin or later
# environment change can move the tests off the CPU
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: production-scale soak (minutes of CPU scan); "
                   "deselect with -m 'not slow'")
