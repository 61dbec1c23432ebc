"""Test configuration: run the suite on a virtual 8-device CPU mesh.

JAX_PLATFORMS may have been read before this file runs (an imported plugin
can import jax), so the platform is pinned through jax.config; the backend
itself initialises lazily, so XLA_FLAGS set here still applies. The 8
virtual CPU devices exercise the same multi-device sharding code paths that
run across GPUs. Tests that need a GPU carry the `gpu` marker and skip here
(see the `gpu_devices` fixture); chip_smoke.py runs their checks on the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compile cache keeps repeat test runs fast on the slow CPU
# backend (utils.device.enable_compile_cache: $JAX_COMPILATION_CACHE_DIR, or
# a CPU-feature-keyed directory under <checkout>/.jax_cache).
from droplet_visual_odometry_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache("cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def pytest_sessionstart(session):
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8, jax.devices()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run slow soak-class tests (25k-frame streaming runs)",
    )


import pytest  # noqa: E402


@pytest.fixture
def gpu_devices():
    """The GPU devices, or a skip. Decided here, at run time, never at import
    or collection, so every xdist worker collects the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU; on the card run `python chip_smoke.py`")
    return devices


_MODULES_SINCE_CLEAR = {"n": 0}


@pytest.fixture(autouse=True, scope="module")
def _unload_jax_executables_periodically():
    """Environment workaround: this image's XLA:CPU JIT segfaults when
    loading a NEW executable into a process that already holds ~200 live
    compiled programs (reproduced 7x: always the latest fresh compile or
    cache-deserialize in full-suite order — the same operation succeeds in a
    fresh or half-suite process, with and without the persistent cache, and
    moves to a different victim when test order changes). Dropping the jit
    caches every couple of test modules keeps the live-executable count far
    below the crash threshold (heaviest module ~40 programs vs ~200) while
    bounding the recompile cost; the persistent disk cache makes the
    cross-module recompiles cheap reloads.
    """
    yield
    _MODULES_SINCE_CLEAR["n"] += 1
    if _MODULES_SINCE_CLEAR["n"] >= 2:
        _MODULES_SINCE_CLEAR["n"] = 0
        jax.clear_caches()


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="soak test; opt in with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
