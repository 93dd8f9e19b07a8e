"""Test configuration.

By default every test runs on the CPU with an 8-device virtual mesh, set
before any backend init (SURVEY.md §4, "Multi-device tests without a
cluster").  Tests marked ``gpu`` need an NVIDIA GPU; run them on a GPU
host with

    FLUIDSIM_GPU_TESTS=1 python -m pytest tests/ -m gpu

which leaves JAX's platform choice alone.  Elsewhere they skip.
"""

import os

import pytest

if os.environ.get("FLUIDSIM_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402  (must import after env setup)

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpus():
    """JAX's GPU devices; skips the test when the default device is not a
    GPU (decided here, at run time, never at import)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is "
                    f"{devs[0].platform!r} (run with FLUIDSIM_GPU_TESTS=1 "
                    "on a GPU host)")
    return devs
