"""Host-ingest benchmark: can the native store source frames fast enough?

Sustaining F fps at 1440x1080 from disk needs F x ~1.48 MB/frame of
host-side ingest. This tool measures that leg alone, the one the
device-resident stream bench substitutes out: `native/src/vostore.cpp`'s
mmap + background prefetch ring (data/native_store.py), host-only, with no
device involved (the role of the reference's rosbag C++ reader, get_valid_message_stream.py:
21-37).

Method: write an N-frame 1440x1080 store (default ~4 GB), drop its page
cache with posix_fadvise(DONTNEED), then time a full pass through
StoreReader.iter_chunks (the exact API the streaming pipeline consumes,
including the per-chunk copy-out the consumer receives). A second warm pass
bounds the page-cache ceiling. Prints ONE JSON line.

Usage: python tools/ingest_bench.py [--frames 2600] [--chunk 256] [--keep]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from droplet_visual_odometry_tpu.data import native_store  # noqa: E402


def drop_page_cache(path: str) -> bool:
    """Evict the file's pages so the timed pass reads from disk. Returns
    False when fadvise is unavailable (the run is then warm-cache only)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        return True
    except (AttributeError, OSError):
        return False


def timed_pass(path: str, chunk: int, copy: bool = True) -> tuple[float, int, int]:
    """One full iter_chunks pass. Returns (seconds, frames, touched_sum)."""
    t0 = time.perf_counter()
    n = 0
    touch = 0
    with native_store.StoreReader(path) as r:
        for _, frames in r.iter_chunks(chunk, copy=copy):
            n += len(frames)
            touch += int(frames[0, 0, 0]) + int(frames[-1, -1, -1])
    return time.perf_counter() - t0, n, touch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=2600)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1440)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--path", default="/tmp/dvo_ingest_bench.vostore")
    ap.add_argument("--keep", action="store_true", help="keep the store file")
    args = ap.parse_args(argv)

    frame_bytes = args.height * args.width
    print(
        f"writing {args.frames} x {args.height}x{args.width} store "
        f"({args.frames * frame_bytes / 1e9:.1f} GB)...",
        file=sys.stderr,
        flush=True,
    )
    rng = np.random.default_rng(0)
    # Per-frame-varied content (a byte-rolled random base) so the file is not
    # trivially compressible/dedupable by any storage layer underneath.
    base = rng.integers(0, 256, (args.height, args.width), dtype=np.uint8)
    frames = np.empty((args.frames, args.height, args.width), np.uint8)
    for i in range(args.frames):
        frames[i] = np.roll(base, i * 7, axis=1)
        frames[i, 0, 0] = i & 0xFF
    stamps = np.arange(args.frames, dtype=np.float64) / 20.0
    native_store.write_store(args.path, frames, stamps)
    del frames

    cold_ok = drop_page_cache(args.path)
    cold_s, n_cold, _ = timed_pass(args.path, args.chunk)
    warm_s, n_warm, _ = timed_pass(args.path, args.chunk)
    warm0_s, n_warm0, _ = timed_pass(args.path, args.chunk, copy=False)
    assert n_cold == n_warm == n_warm0 == args.frames

    if not args.keep:
        os.unlink(args.path)

    def rates(sec):
        return {
            "mb_per_s": round(args.frames * frame_bytes / sec / 1e6, 1),
            "fps_equivalent": round(args.frames / sec, 1),
            "seconds": round(sec, 2),
        }

    print(
        json.dumps(
            {
                "metric": "host_ingest_vostore_1440x1080",
                "unit": "MB/s",
                "value": rates(cold_s)["mb_per_s"],
                "cold_cache": rates(cold_s) | {"evicted": cold_ok},
                "warm_cache": rates(warm_s),
                "warm_cache_zero_copy": rates(warm0_s),
                "native_reader": native_store.native_available(),
                "chunk": args.chunk,
                "n_frames": args.frames,
                "target_fps_equivalent_for_520fps_pipeline": 520,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
