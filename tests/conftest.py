"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The CPU suite is hermetic: JAX_PLATFORMS defaults to cpu here, with 8
virtual devices for the sharded paths. The card-marked tests
(tests/test_card.py) run on a GPU when JAX_PLATFORMS says so:

    JAX_PLATFORMS=cuda python -m pytest -m card tests/test_card.py
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_executables_between_modules():
    """Free compiled XLA executables after each test module.

    Every XLA-CPU compiled program holds tens of mmap'd regions; one
    full-suite process accumulates ~300 compiles and crosses the kernel
    default vm.max_map_count (65530) right around test ~305, at which
    point LLVM's JIT mmap fails and XLA SEGFAULTS (observed round 5:
    deterministic crash in backend_compile_and_load at the same test
    across fresh/warm persistent caches). Modules rarely share jit
    entries, so per-module clearing costs little wall time and keeps the
    map count bounded.
    """
    yield
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
