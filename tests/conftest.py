"""Test configuration: run everything on a virtual 8-device CPU mesh in
float64, so numerical checks validate the math independent of the GPU's
float32 behaviour.  Sharding tests use the 8 virtual devices.

The platform is forced to the CPU via jax.config, so the suite runs on the
CPU even on a machine with a GPU; the GPU paths are checked by
``python chip_smoke.py`` on the card.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
