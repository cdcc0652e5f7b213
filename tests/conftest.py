"""Test config: force a LOCAL CPU backend with 8 virtual devices so
multi-device sharding is exercised without accelerators.

XLA_FLAGS must be set before the CPU client is created to get the 8
virtual devices; the platform is pinned to "cpu" before any jax use, so
the suite runs the same on a machine that has a GPU.  Tests that need
the GPU carry the ``gpu`` marker and are deselected by default
(pyproject.toml).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
