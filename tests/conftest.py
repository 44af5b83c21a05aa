"""Test configuration.

On the CPU (the default): ``python -m pytest tests/ -m 'not slow'``. JAX
is pinned to the CPU with an 8-device virtual mesh, so every device path
runs on XLA's CPU backend.

Tests marked ``gpu`` need a card: they skip elsewhere, and
``python chip_smoke.py`` runs them on the GPU in its own process
(``pytest.main(["-m", "gpu", ...])`` with ``TD_TESTS_ON_GPU=1``, which
leaves JAX on the GPU).
"""

import os

import pytest

if os.environ.get("TD_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (chip_smoke.py runs it)"
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU
    (decided here, at run time, never while a module is imported)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (chip_smoke.py runs the gpu-marked tests there)")
