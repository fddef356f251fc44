"""Test harness: run everything on CPU with 8 virtual devices so the
multi-device sharding path is exercised without accelerators (the pattern
recommended in SURVEY.md §4)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

from pathlib import Path  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

from faid.utils.cache import enable_compilation_cache  # noqa: E402

# Persistent compilation cache: the full-code decoder graphs take ~1 min
# each to compile on CPU; cache them across pytest runs.
enable_compilation_cache(Path(__file__).parent / ".jax_cache")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from faid.code.qc_matrix import load_code  # noqa: E402


@pytest.fixture(scope="session")
def code():
    return load_code("50gpon")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
