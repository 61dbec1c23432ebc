"""Headline benchmark: VO frames/s on one chip vs the reference pipeline.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N}

The reference publishes no numbers (BASELINE.md), so the baseline is measured
here, live, as the reference's own compute path: OpenCV ORB detect+describe on
both frames of each pair (the reference detects every frame twice,
visual_odometry_v3.py:387-392), BFMatcher(NORM_HAMMING, crossCheck),
findEssentialMat(RANSAC, prob=0.999, threshold=1.0), recoverPose, and
marker-corner triangulation — on the same synthetic frames at the reference's
1440x1080 resolution (camera_calibration.yaml:22-23). Ours is the compiled
sequence pipeline on the GPU; without a GPU the bench fails (rehearse the
pipeline on CPU through the CLIs' --platform cpu instead). When OpenCV is not
installed the reference baseline is reported as null: not measured.

Every JSON line names the platform, device kind and device count.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


N_FRAMES = 24
WIDTH, HEIGHT = 1440, 1080


def build_sequence():
    from droplet_visual_odometry_tpu.data import synthetic

    return synthetic.render_sequence(
        synthetic.SyntheticConfig(
            n_frames=N_FRAMES,
            width=WIDTH,
            height=HEIGHT,
            fx=1170.0,
            fy=1170.0,
            n_landmarks=900,
            landmark_size=0.07,
        )
    )


def device_fields() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind, "device_count": len(d)}


def bench_reference_cpu(seq) -> float | None:
    """The reference's per-pair OpenCV path: median frames/s of N_BASELINE_REPS
    full passes (first pass is warmup and discarded; one-shot timings swing
    with host load). None when OpenCV is not installed: not measured."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return None
    fps = [_reference_cpu_pass(seq) for _ in range(1 + N_BASELINE_REPS)]
    return float(np.median(fps[1:]))


N_BASELINE_REPS = 3


def _reference_cpu_pass(seq) -> float:
    import cv2

    K = np.asarray(seq.camera.K, np.float64)
    orb = cv2.ORB_create()  # 500 keypoints, the reference default (v3:96)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)  # v3:75

    frames = seq.frames
    corners = seq.marker_corners
    t0 = time.perf_counter()
    n_pairs = 0
    for i in range(1, len(frames)):
        prev, curr = frames[i - 1], frames[i]
        kp1, d1 = orb.detectAndCompute(prev, None)  # both frames per pair,
        kp2, d2 = orb.detectAndCompute(curr, None)  # as the reference does
        if d1 is None or d2 is None:
            continue
        matches = sorted(bf.match(d1, d2), key=lambda m: m.distance)
        if len(matches) < 8:
            continue
        p1 = np.float32([kp1[m.queryIdx].pt for m in matches])
        p2 = np.float32([kp2[m.trainIdx].pt for m in matches])
        E, _ = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC, prob=0.999, threshold=1.0)
        if E is None or E.shape != (3, 3):
            continue
        _, R, t, _ = cv2.recoverPose(E, p1, p2, K)
        P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
        P2 = K @ np.hstack([R, t])
        X = cv2.triangulatePoints(P1, P2, corners[i - 1].T.astype(np.float64), corners[i].T.astype(np.float64))
        X3 = X[:3] / X[3:]
        side = np.linalg.norm(X3[:, 0] - X3[:, 1])
        _ = seq.real_marker_length / max(side, 1e-12)
        n_pairs += 1
    dt = time.perf_counter() - t0
    return n_pairs / dt


def bench_ours(seq) -> float:
    import jax
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu.estimation.vo import VOConfig, run_sequence

    frames = jnp.asarray(seq.frames, jnp.float32)
    corners = jnp.nan_to_num(jnp.asarray(seq.marker_corners))
    present = jnp.asarray(seq.marker_present)
    K = jnp.asarray(seq.camera.K, jnp.float32)
    init = jnp.asarray(seq.marker_poses[0])
    cfg = VOConfig()
    key = jax.random.PRNGKey(0)

    def run():
        return run_sequence(
            key, frames, corners, present, init, K, seq.real_marker_length, cfg
        )

    jax.block_until_ready(run())  # compile + warmup
    n_rep = 5
    t0 = time.perf_counter()
    for _ in range(n_rep):
        traj = run()
    jax.block_until_ready(traj)
    dt = (time.perf_counter() - t0) / n_rep
    return (len(seq) - 1) / dt


def bench_stages(seq) -> None:
    """Per-stage attribution of the VO pipeline at bench shapes, printed to
    stderr (the stdout contract stays ONE JSON line). Each stage runs as its
    own jitted program with device-synchronised walls (utils.profiling)."""
    import jax
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig, ransac_pose
    from droplet_visual_odometry_tpu.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu.frontend import fast, filters, matcher, orb
    from droplet_visual_odometry_tpu.frontend.features import (
        detect_and_describe_batch,
        level_budgets,
        level_shapes,
    )
    from droplet_visual_odometry_tpu.utils.profiling import StageTimes

    cfg = VOConfig()
    frames = jnp.asarray(seq.frames, jnp.float32)
    n, h, w = frames.shape
    shapes = level_shapes(h, w, cfg.n_levels, cfg.scale_factor)
    budgets = level_budgets(cfg.n_keypoints, cfg.n_levels, cfg.scale_factor)
    times = StageTimes()
    reps = 5

    # Build per-level images once (resize timed separately).
    def run_resize(imgs):
        levels = [imgs]
        for l in range(1, cfg.n_levels):
            levels.append(filters.resize_bilinear(levels[-1], *shapes[l]))
        return levels

    jit_resize = jax.jit(run_resize)
    levels = jax.block_until_ready(jit_resize(frames))
    with times.stage("resize(pyramid)"):
        for _ in range(reps):
            levels = jit_resize(frames)
        jax.block_until_ready(levels)

    score_fn = jax.jit(
        lambda im: fast.score_batch(im, cfg.fast_threshold, cfg.fast_arc_length)
    )
    scores = [jax.block_until_ready(score_fn(li)) for li in levels]
    with times.stage("fast_score"):
        for _ in range(reps):
            scores = [score_fn(li) for li in levels]
        jax.block_until_ready(scores)

    topk_fns = [
        jax.jit(jax.vmap(lambda s, k=k: fast.select_topk_rows(fast.nms3x3(s), k)))
        for k in budgets
    ]
    kps = [jax.block_until_ready(f(s)) for f, s in zip(topk_fns, scores)]
    with times.stage("nms+topk"):
        for _ in range(reps):
            kps = [f(s) for f, s in zip(topk_fns, scores)]
        jax.block_until_ready(kps)

    blur_fn = jax.jit(
        lambda im: filters.gaussian_blur(
            im, sigma=2.0, radius=4, compute_dtype=jnp.bfloat16
        )
    )
    blurs = [jax.block_until_ready(blur_fn(li)) for li in levels]
    with times.stage("blur"):
        for _ in range(reps):
            blurs = [blur_fn(li) for li in levels]
        jax.block_until_ready(blurs)

    desc_fn = jax.jit(orb.describe_batch)
    descs = [jax.block_until_ready(desc_fn(b, kp.xy)) for b, kp in zip(blurs, kps)]
    with times.stage("describe(patch+mm+pack)"):
        for _ in range(reps):
            descs = [desc_fn(b, kp.xy) for b, kp in zip(blurs, kps)]
        jax.block_until_ready(descs)

    feats = jax.block_until_ready(detect_and_describe_batch(frames, k=cfg.n_keypoints))
    desc_a, desc_b = feats.desc[:-1], feats.desc[1:]
    va, vb = feats.valid[:-1], feats.valid[1:]
    match_fn = jax.jit(
        jax.vmap(lambda a, b, x, y: matcher.match(a, b, x, y, mode=cfg.match_mode))
    )
    m = jax.block_until_ready(match_fn(desc_a, desc_b, va, vb))
    with times.stage("match"):
        for _ in range(reps):
            m = match_fn(desc_a, desc_b, va, vb)
        jax.block_until_ready(m)

    pts_b = jnp.take_along_axis(feats.xy[1:], m.idx[..., None], axis=1)
    K = jnp.asarray(seq.camera.K, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), n - 1)
    rs_fn = jax.jit(
        jax.vmap(lambda k, pa, pb, v: ransac_pose(k, pa, pb, v, K, RansacConfig()))
    )
    rs = jax.block_until_ready(rs_fn(keys, feats.xy[:-1], pts_b, m.valid))
    with times.stage("ransac"):
        for _ in range(reps):
            rs = rs_fn(keys, feats.xy[:-1], pts_b, m.valid)
        jax.block_until_ready(rs)

    rep = times.report()
    per_frame = {k: v["total_s"] / reps / n * 1e3 for k, v in rep.items()}
    total = sum(per_frame.values())
    print("\n== per-stage breakdown (ms/frame, 1440x1080, K=512, pyramid 4x1.32) ==", file=sys.stderr)
    for k in sorted(per_frame, key=per_frame.get, reverse=True):
        print(f"  {k:<26s} {per_frame[k]:7.3f} ms  ({100*per_frame[k]/total:4.1f}%)", file=sys.stderr)
    print(f"  {'TOTAL (stages)':<26s} {total:7.3f} ms", file=sys.stderr)


class _TiledFrameIndices:
    """Lazy (N, H, W) frame source tiling a small base sequence by index —
    the stand-in for a 25k-frame 1440x1080 bag (~39 GB raw, which no host
    array should ever hold). Slicing yields the INDEX array for the chunk;
    the paired preprocess gathers from the device-resident base, so the
    host->device traffic per chunk is ~2 KB of indices and the measurement
    is the full-shape device pipeline at sequence scale. `--stream-store`
    measures the real host-streamed path instead."""

    def __init__(self, base_shape: tuple, idx: np.ndarray):
        self._idx = idx
        self.shape = (len(idx),) + base_shape[1:]

    def __getitem__(self, sl):
        return self._idx[sl]


def bench_stream(store: str | None = None, n_total: int = 25_075) -> None:
    """The reference's OWN workload at full shape: 25,075 frames
    (visual_odometry_v3.py:20) at 1440x1080 (camera_calibration.yaml:22-23)
    through the streaming engine. Prints ONE JSON line: fps + peak host RSS.

    store: path to a vostore file — frames are then written there once and
    STREAMED host->device through the native mmap+prefetch reader
    (data/native_store.py), i.e. the REAL ingest path instead of the
    device-resident tiling (_TiledFrameIndices); tools/ingest_bench.py
    measures the host-side leg in isolation."""
    import resource

    from droplet_visual_odometry_tpu.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu.utils.checkpoint import run_sequence_checkpointed

    N_TOTAL = n_total
    seq = build_sequence()
    n_base = len(seq.frames)
    period = 2 * (n_base - 1)
    t = np.arange(N_TOTAL) % period
    idx = np.minimum(t, period - t).astype(np.int64)  # pingpong: no teleports

    import jax
    import jax.numpy as jnp

    if store is not None:
        from droplet_visual_odometry_tpu.data import native_store

        if not os.path.exists(store):
            print(f"writing {N_TOTAL}-frame store to {store}...", file=sys.stderr)
            native_store.write_store(
                store, seq.frames[idx], np.arange(N_TOTAL, dtype=np.float64) / 20.0
            )
        reader = native_store.StoreReader(store)
        assert reader.n == N_TOTAL, (reader.n, N_TOTAL)
        frames = reader.frames()
        # Real host->device chunk transfer + on-device f32 cast.
        _cast = jax.jit(lambda c: c.astype(jnp.float32))
        preprocess = lambda chunk: _cast(jnp.asarray(np.asarray(chunk)))
    else:
        base_dev = jnp.asarray(seq.frames)  # 24 x 1440 x 1080 uint8, once
        frames = _TiledFrameIndices(seq.frames.shape, idx)
        preprocess = jax.jit(lambda i: base_dev[jnp.asarray(i)].astype(jnp.float32))
    corners = np.nan_to_num(seq.marker_corners)[idx]
    present = seq.marker_present[idx]
    cfg = VOConfig(scale_mode="hold")

    t_start = time.perf_counter()

    def progress(done: int, total: int) -> None:
        el = time.perf_counter() - t_start
        print(
            f"stream: {done}/{total} frames, {done/el:.0f} fps avg",
            file=sys.stderr,
            flush=True,
        )

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    traj = run_sequence_checkpointed(
        jax.random.PRNGKey(0),
        frames,
        corners,
        present,
        np.asarray(seq.marker_poses[0]),
        np.asarray(seq.camera.K, np.float32),
        seq.real_marker_length,
        cfg,
        path=None,
        chunk=256,
        preprocess=preprocess,
        progress=progress,
    )
    dt = time.perf_counter() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(
        json.dumps(
            {
                "metric": f"stream_vo_frames_per_second_{N_TOTAL}x1440x1080",
                "source": "vostore_host_stream" if store else "device_resident_tiles",
                "value": round((N_TOTAL - 1) / dt, 2),
                "unit": "frames/s",
                "wall_seconds": round(dt, 1),
                "ok_fraction": round(float(np.mean(traj.ok)), 4),
                "peak_rss_mb": round(rss1 / 1024, 1),
                "rss_growth_mb": round((rss1 - rss0) / 1024, 1),
                **device_fields(),
            }
        )
    )


def bench_online() -> None:
    """Per-push latency of the streaming engine (stream.OnlineVO) — the
    live-node replacement's own number (visual_odometry_v2.py:352-374's
    role). Prints ONE JSON line: median/p99 push latency + sustained fps at
    the reference's full 1440x1080 frame shape, markers on every push.

    Two regimes are measured: device-resident frames (the engine's compute
    latency) and host-numpy frames (ingest-inclusive: the ~1.5 MB/frame
    host->device copy rides each push)."""
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu.core import se3
    from droplet_visual_odometry_tpu.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu.groundtruth import (
        GroundTruthConfig,
        detections_from_arrays,
    )
    from droplet_visual_odometry_tpu.stream import OnlineVO

    seq = build_sequence()
    n = len(seq)

    def dets_for(i):
        cTm = jnp.asarray(seq.marker_poses[i], jnp.float32)
        t, q = se3.to_translation_quaternion(cTm)
        return detections_from_arrays(
            np.asarray([[0]], np.int32),
            np.asarray(t)[None, None],
            np.asarray(q)[None, None],
            np.asarray(seq.marker_corners[i])[None, None],
        )

    dets = [dets_for(i) for i in range(n)]
    vo = OnlineVO(
        K=np.asarray(seq.camera.K),
        real_marker_length=seq.real_marker_length,
        cfg=VOConfig(),
        gt_cfg=GroundTruthConfig(use_base_link=False),
    )
    order = list(range(n)) + list(range(n - 2, 0, -1))  # pingpong, no teleport
    frames_dev = jnp.asarray(seq.frames, jnp.float32)  # staged once

    # Warmup: arm + compile both the prime and pair-step programs.
    vo.push(0.0, frames_dev[0], dets[0])
    for k, i in enumerate(order):
        vo.push(float(k + 1), frames_dev[i], dets[i])

    def measure(frame_of):
        lats = []
        t_all0 = time.perf_counter()
        step = 0
        for _ in range(3):
            for i in order:
                step += 1
                t0 = time.perf_counter()
                r = vo.push(float(1000 + step), frame_of(i), dets[i])
                assert r.pose is not None  # push returns synced numpy
                lats.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_all0
        lats = np.asarray(lats)
        return {
            "median_ms": round(float(np.median(lats)) * 1e3, 2),
            "p99_ms": round(float(np.quantile(lats, 0.99)) * 1e3, 2),
            "fps": round(len(lats) / wall, 1),
        }

    dev = measure(lambda i: frames_dev[i])
    host = measure(lambda i: seq.frames[i])
    print(
        json.dumps(
            {
                "metric": "online_vo_push_latency_1440x1080",
                "unit": "ms/push",
                "value": dev["median_ms"],
                "device_resident": dev,
                "host_ingest": host,
                "n_pushes_each": 3 * len(order),
                **device_fields(),
            }
        )
    )


def main() -> int:
    from droplet_visual_odometry_tpu.utils.device import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache("gpu")
    if "--stream" in sys.argv:
        store = None
        n_total = 25_075
        if "--stream-store" in sys.argv:
            store = sys.argv[sys.argv.index("--stream-store") + 1]
        if "--stream-frames" in sys.argv:
            n_total = int(sys.argv[sys.argv.index("--stream-frames") + 1])
        bench_stream(store=store, n_total=n_total)
        return 0
    if "--online" in sys.argv:
        bench_online()
        return 0
    seq = build_sequence()
    if "--stages" in sys.argv:
        bench_stages(seq)
    ref_fps = bench_reference_cpu(seq)
    ours_fps = bench_ours(seq)
    print(
        json.dumps(
            {
                "metric": "vo_frames_per_second_1440x1080",
                "value": ours_fps,
                "unit": "frames/s",
                "vs_baseline": None if ref_fps is None else ours_fps / ref_fps,
                "baseline_reference_cpu_fps": ref_fps,
                **device_fields(),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
