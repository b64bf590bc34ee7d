"""Test configuration: run on the CPU backend with a virtual 8-device mesh,
so sharding and collective code paths are exercised without an
accelerator. Tests that need a GPU carry the ``gpu`` marker and run their
GPU work in a subprocess."""

import os

# Must be set before jax is imported anywhere. Forced, not defaulted: an
# in-process CLI test must not move later tests onto an accelerator.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
