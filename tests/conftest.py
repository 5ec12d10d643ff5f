"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests run on the CPU backend with 8 virtual devices so kernel correctness
and sharding are checked quickly without an accelerator (the substitution
SURVEY.md §4 calls out).  The Pallas scan kernel runs in Pallas'
interpreter here (``kernel_route``); tests that need the card are marked
``gpu`` and take the ``gpu`` fixture, which skips them on other devices.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if os.environ.get("RAPIDFUZZ_TPU_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture
def kernel_route(monkeypatch):
    """Route scans as on a GPU mesh, with the scan kernel in Pallas'
    interpreter: the scanner's kernel route (sorting, packing, grouping,
    sharding) runs on the CPU."""
    from rapidfuzz_tpu.ops import route, scan_kernel

    monkeypatch.setattr(route, "mesh_platform", lambda mesh: "gpu")
    monkeypatch.setattr(route, "default_platform", lambda: "gpu")
    monkeypatch.setattr(scan_kernel, "INTERPRET", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided when the test
    runs, never at import: every xdist worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
