"""Test configuration: the suite runs on the CPU backend with a virtual
8-device mesh, so sharding tests run on any host (SURVEY.md §4).  The GPU
path is exercised by `chip_smoke.py`, not by these tests.

jax_platforms is pinned through jax.config after import, before first
backend use, so the suite stays on the CPU even where JAX_PLATFORMS is unset
and an accelerator is present.
"""

import os
import sys
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# CPU test runs keep no persistent compile cache (an explicitly empty value
# opts out, vpcc_tpu/__init__.py): the suite's workers would otherwise
# share one on-disk cache and depend on what earlier runs left in it.
os.environ["JAX_COMPILATION_CACHE_DIR"] = ""

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", jax.default_backend()


import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound the suite's memory: XLA CPU keeps every compiled executable
    and its constants alive; on a small host the accumulated footprint
    can exhaust memory late in the suite.
    Dropping compiled programs between modules trades recompiles for a
    bounded high-water mark."""
    yield
    jax.clear_caches()
    gc.collect()
