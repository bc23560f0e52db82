"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's compose-on-one-box strategy for exercising the
distributed stack without a cluster (SURVEY.md §4.5): mesh/collective logic
runs on 8 virtual CPU devices via ``--xla_force_host_platform_device_count``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# An accelerator plugin may select itself via jax.config at import time;
# pin the test suite to the CPU either way.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_rgb(rng):
    """A small random RGB image in planar (3, H, W) u8 layout."""
    return rng.integers(0, 256, size=(3, 48, 160), dtype=np.uint8)


@pytest.fixture(scope="session")
def small_rgba(rng):
    return rng.integers(0, 256, size=(4, 40, 136), dtype=np.uint8)


@pytest.fixture(scope="session")
def small_gray(rng):
    return rng.integers(0, 256, size=(48, 160), dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Evict compiled executables after each test module.

    The full suite compiles ~300 distinct executables into one process;
    past roughly that count the XLA CPU JIT segfaults inside
    backend_compile (observed deterministically at ~83% of the r5 suite,
    reproducible with a clean process table, NOT memory- or
    stack-limited — 128 GB free, crash persists at 64 MB stack; either
    half of the suite alone passes). Executables are rarely shared
    across modules, so per-module eviction costs little and keeps the
    accumulated JIT state bounded.
    """
    yield
    jax.clear_caches()
