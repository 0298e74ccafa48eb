"""Test config: force JAX onto CPU with 8 virtual devices so sharded code
paths (dist/) run without accelerators. The env vars cover subprocesses;
jax.config covers this process even if jax was imported earlier (the
backend initializes lazily, on first device use).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def pytest_report_header(config):
    return f"jax devices: {jax.device_count()} x {jax.devices()[0].platform}"
