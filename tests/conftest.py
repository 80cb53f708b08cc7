"""Test config: run everything on the CPU, as a virtual 8-device mesh.

The tests need no accelerator: multi-device sharding runs on virtual CPU
devices (xla_force_host_platform_device_count) and the GPU kernels run in
Pallas interpret mode. ``python chip_smoke.py`` exercises the GPU itself
(``--multi-gpu`` on four cards).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Force the CPU backend before any backend initializes, whatever the
# environment (a machine with a GPU would otherwise pick it).
import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

import pytest

REFERENCE = Path("/root/reference")
# The 7 reference ISF test scenes are vendored into the repo (hermetic CI);
# fall back to the reference checkout if the vendored copy is ever pruned.
VENDORED_SCENES = Path(__file__).parent / "scenes"
SCENES = VENDORED_SCENES if (VENDORED_SCENES / "cube").exists() \
    else REFERENCE / "tests" / "scenes"


@pytest.fixture(scope="session")
def reference_scenes():
    if not SCENES.exists():
        pytest.skip("reference test scenes not available")
    return SCENES


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The full suite accumulates hundreds of XLA:CPU executables; run in
    one process, it once hit a deterministic segfault inside
    backend_compile late in the run (the same test passed standalone) —
    an XLA CPU compiler resource exhaustion, not a test bug.
    Clearing caches per module keeps the compiler's live state bounded."""
    yield
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
