"""Test configuration: force JAX onto the CPU with 8 virtual devices, so
the multi-device sharding paths are exercised without GPUs (SURVEY.md §4
implication: mocked-mesh tests before real hardware).

``jax_platforms`` is set through ``jax.config`` before any backend is
initialized, so a GPU on the machine is never touched by the tests; code
that needs the card is exercised by ``chip_smoke.py`` instead.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
