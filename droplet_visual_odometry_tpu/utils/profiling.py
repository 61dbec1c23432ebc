"""Per-stage timing + jax.profiler integration.

The reference's only diagnostics are print statements and a frame counter
(SURVEY.md §5; visual_odometry_v3.py:125, 267-290). Here: a process-wide stage
timer registry (device-synchronised so wall times mean what they say under
async dispatch), a frames/s helper for the north-star metric, and a thin
wrapper over `jax.profiler.trace` for device timeline captures.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import jax


class StageTimes:
    """Accumulates wall-clock per named stage. Not thread-safe by design —
    one registry per pipeline run."""

    def __init__(self) -> None:
        self.total_s: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True) -> Iterator[None]:
        """Time a block. With sync=True (default) outstanding device work is
        drained first and after, so the block's time is attributable to it."""
        if sync:
            _block_on_all_devices()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _block_on_all_devices()
            self.total_s[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {"total_s": self.total_s[name], "calls": self.calls[name]}
            for name in sorted(self.total_s)
        }

    def pretty(self) -> str:
        rows = [
            f"  {name:<28s} {v['total_s']*1e3:10.2f} ms  /{v['calls']} calls"
            for name, v in self.report().items()
        ]
        return "stage timings:\n" + "\n".join(rows) if rows else "stage timings: (none)"


def _block_on_all_devices() -> None:
    # Cheap full-device sync: a tiny transfer per local device.
    for d in jax.local_devices():
        jax.device_put(0.0, d).block_until_ready()


TIMES = StageTimes()
stage = TIMES.stage


def frames_per_second(n_frames: int, seconds: float) -> float:
    """The north-star throughput metric (BASELINE.md: frames/s per chip)."""
    return n_frames / max(seconds, 1e-12)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture an XLA profiler trace viewable in TensorBoard/Perfetto."""
    with jax.profiler.trace(log_dir):
        yield


def timed(fn, *args, sync: bool = True, **kwargs):
    """Run fn(*args, **kwargs), return (result, seconds) with device sync."""
    if sync:
        _block_on_all_devices()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        out = jax.block_until_ready(out)
    return out, time.perf_counter() - t0
