"""Device requirement and the persistent compile cache.

Measurement entry points (bench.py, chip_smoke.py) call `require_gpu`: a run
that finds no GPU fails instead of timing the CPU under a device metric's
name. `--platform cpu` on the CLIs stays the explicit way to rehearse on CPU.

`enable_compile_cache` is the one place the compile cache is placed: where
JAX_COMPILATION_CACHE_DIR is set, JAX reads it and code sets nothing; else
the cache lives at the fixed directory <checkout>/.jax_cache, so a later run
from the same checkout finds it again.
"""

from __future__ import annotations

import hashlib
import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(platform: str | None = None) -> str:
    """The compile-cache directory a run on `platform` uses.

    $JAX_COMPILATION_CACHE_DIR when set. Otherwise <checkout>/.jax_cache, and
    for the CPU platform a subdirectory keyed by the host's CPU feature flags:
    XLA:CPU entries embed machine code for the compiling host's vector
    extensions, and loading one compiled on a host with other extensions has
    crashed the test suite (the loader itself warns of SIGILL).
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    base = os.path.join(CHECKOUT, ".jax_cache")
    if (platform or jax.default_backend()) != "cpu":
        return base
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    except OSError:
        flags = ""
    return os.path.join(base, "cpu-" + hashlib.md5(flags.encode()).hexdigest()[:10])


def enable_compile_cache(platform: str | None = None) -> str:
    """Point JAX's persistent compile cache at compile_cache_dir(); returns it.

    Call before the first compilation. With the environment variable set,
    JAX has already read it and this only reports it.
    """
    path = compile_cache_dir(platform)
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> list:
    """JAX's devices, or RuntimeError unless the default device is a GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devices[0].platform!r} "
            f"({devices[0].device_kind}); this path measures the GPU only"
        )
    return devices
