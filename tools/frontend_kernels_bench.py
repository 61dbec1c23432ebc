"""Frontend kernel decisions on the GPU, in one process.

    python tools/frontend_kernels_bench.py [--reps 5] [--sweep]

1. End to end: `run_sequence` at the bench shape (24 frames of 1440x1080,
   K=512, the 4-level x1.32 pyramid) with the Triton FAST kernel and with the
   XLA `fast_score`, compiled once each, timed in turns A/B/B/A with
   `block_until_ready`. The kernel stays only if it is faster end to end
   beyond the run-to-run spread printed here.
2. The FAST stage alone at each pyramid level shape, kernel vs XLA, and with
   --sweep the kernel's block shape and warp count.
3. Patch extraction in `describe_batch`: how the compiled HLO reads the
   N*K 37x37 patches (gathers vs a while loop), and its wall time against the
   N*K*37*37*4 bytes it moves.

Prints one JSON object per line; needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(**fields) -> None:
    print(json.dumps(fields, default=float), flush=True)


def _walls(fn, args, reps):
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def end_to_end(seq, reps: int) -> None:
    import jax
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu.estimation.vo import VOConfig, run_sequence
    from droplet_visual_odometry_tpu.frontend import fast

    args = (
        jax.random.PRNGKey(0),
        jnp.asarray(seq.frames, jnp.float32),
        jnp.nan_to_num(jnp.asarray(seq.marker_corners)),
        jnp.asarray(seq.marker_present),
        jnp.asarray(seq.marker_poses[0]),
        jnp.asarray(seq.camera.K, jnp.float32),
        seq.real_marker_length,
    )
    kernel_fn = fast.score_batch

    def xla_fn(imgs, threshold=20.0, arc_length=9):
        return jax.vmap(lambda f: fast.fast_score(f, threshold, arc_length))(imgs)

    exes, compile_s = {}, {}
    for name, fn in (("kernel", kernel_fn), ("xla", xla_fn)):
        fast.score_batch = fn
        jax.clear_caches()
        t0 = time.perf_counter()
        exes[name] = run_sequence.lower(*args, VOConfig()).compile()
        compile_s[name] = time.perf_counter() - t0
        fast.score_batch = kernel_fn
        jax.block_until_ready(exes[name](*args))
    walls = {"kernel": [], "xla": []}
    for name in ("kernel", "xla", "xla", "kernel"):
        walls[name] += _walls(exes[name], args, reps)
    n = len(seq)
    ref = jax.device_get(exes["xla"](*args))
    got = jax.device_get(exes["kernel"](*args))
    log(
        stage="run_sequence",
        frames=n,
        shape=list(seq.frames.shape[1:]),
        compile_s=compile_s,
        fps={k: n / float(np.median(v)) for k, v in walls.items()},
        fps_min_max={k: [n / max(v), n / min(v)] for k, v in walls.items()},
        walls_s=walls,
        max_abs_pose_diff=float(np.max(np.abs(np.asarray(got.abs_poses) - np.asarray(ref.abs_poses)))),
    )


def fast_levels(frames, reps: int, sweep: bool) -> None:
    import jax

    import chip_smoke
    from droplet_visual_odometry_tpu.frontend import fast
    from droplet_visual_odometry_tpu.ops import pallas_fast

    levels = chip_smoke.level_images(frames)
    xla = jax.jit(jax.vmap(fast.fast_score))
    configs = [(pallas_fast.BLOCK_H, pallas_fast.BLOCK_W, pallas_fast.NUM_WARPS, pallas_fast.NUM_STAGES)]
    if sweep:
        configs += [
            (4, 128, 4, 1), (8, 64, 4, 1), (8, 128, 4, 1), (8, 256, 8, 1),
            (16, 64, 4, 1), (16, 128, 8, 1), (32, 128, 4, 1),
        ]
    for lvl in levels:
        ref = np.asarray(xla(lvl))
        t_x = float(np.median(_walls(xla, (lvl,), reps)))
        for bh, bw, nw, ns in configs if lvl is levels[0] else configs[:1]:
            # The tiling is read from the module when the kernel is traced.
            pallas_fast.BLOCK_H, pallas_fast.BLOCK_W = bh, bw
            pallas_fast.NUM_WARPS, pallas_fast.NUM_STAGES = nw, ns
            k = jax.jit(lambda x: pallas_fast.fast_score_batch(x))
            got = np.asarray(k(lvl))
            same = bool(np.array_equal(got > 0, ref > 0))
            t_k = float(np.median(_walls(k, (lvl,), reps)))
            px = int(np.prod(lvl.shape))
            log(
                stage="fast_score",
                shape=list(lvl.shape),
                block=[bh, bw],
                num_warps=nw,
                num_stages=ns,
                same_corners=same,
                kernel_ms=t_k * 1e3,
                xla_ms=t_x * 1e3,
                kernel_gb_s=px * 4 * 2 / t_k / 1e9,
            )
    (pallas_fast.BLOCK_H, pallas_fast.BLOCK_W, pallas_fast.NUM_WARPS, pallas_fast.NUM_STAGES) = configs[0]


def patches(frames, reps: int) -> None:
    import jax
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu.frontend import orb

    n, h, w = frames.shape
    k = 512
    rng = np.random.default_rng(0)
    xy = jnp.asarray(rng.uniform([20, 20], [w - 20, h - 20], size=(n, k, 2)).astype(np.float32))
    extract = jax.jit(jax.vmap(orb.extract_patches))
    hlo = extract.lower(frames, xy).compile().as_text()
    describe = jax.jit(orb.describe_batch)
    dhlo = describe.lower(frames, xy).compile().as_text()
    ops = lambda text: {
        op: len(re.findall(rf"\b{op}\(", text)) for op in ("gather", "while", "dynamic-slice", "fusion")
    }
    t = float(np.median(_walls(extract, (frames, xy), reps)))
    td = float(np.median(_walls(describe, (frames, xy), reps)))
    nbytes = n * k * orb.PATCH * orb.PATCH * 4
    log(
        stage="extract_patches",
        frames=n,
        keypoints=k,
        hlo_ops=ops(hlo),
        describe_hlo_ops=ops(dhlo),
        ms=t * 1e3,
        describe_ms=td * 1e3,
        bytes=nbytes,
        gb_s=nbytes / t / 1e9,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    import bench
    from droplet_visual_odometry_tpu.utils.device import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache("gpu")
    seq = bench.build_sequence()
    end_to_end(seq, args.reps)
    frames = jnp.asarray(seq.frames, jnp.float32)
    fast_levels(frames, max(args.reps, 10), args.sweep)
    patches(frames, max(args.reps, 10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
