"""Test configuration: run on a virtual 8-device CPU mesh.

Tests run on the CPU; sharding tests use XLA's host platform with 8 virtual
devices. JAX is pinned to the CPU through both the env var and the config
var, before it initializes a backend.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
