"""Smoke run of the VO engine on an NVIDIA GPU, through its user entry points.

    python chip_smoke.py               # one card: all phases below
    python chip_smoke.py --four-cards  # four cards: the mesh phase only

One process owns the card(s). Phases, each of which fails the run (non-zero
exit, no result line) when a check does not hold:

  device   JAX's default device must be a GPU; prints its kind and count,
           `nvidia-smi` name and power limit, and the compile-cache directory.
  main     the reference's production camera (parity scenario distorted_1440:
           60 frames at 1440x1080 through the real plumb_bob lens) and the
           loop scenario (drift_loop: 200 frames at 640x480) through
           `cli.run_experiment.main` with the shipped defaults; the six TUM
           streams are parsed back and ATE must stay under the best reference
           row of PARITY.md for that scenario.
  stream   the chunked streaming engine (chunk=16) against the whole-sequence
           program, and 20 live `OnlineVO.push` calls.
  kernels  every hand-written kernel on the frontend path against the XLA
           version and a host numpy reference, at the pyramid level shapes of
           a 1440x1080 frame, plus its time beside the XLA version's.
  four-cards  (--four-cards) the shipped default's pose graph sharded over
           4 cards against the single-device solve, data-parallel pair VO at
           1440x1080 against one card, and distributed Schur BA against
           single-device BA.

The last stdout line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# PARITY.md's best reference ATE RMSE (m) per scenario: the shipped default
# must stay below it on the card as it does on the CPU.
ATE_BOUND_M = {"distorted_1440": 0.357, "drift_loop": 0.764}


def log(**fields) -> None:
    print(json.dumps(fields, default=float), flush=True)


class CompileCounter:
    """Programs compiled (or loaded from the persistent cache), the seconds
    spent on it, and persistent-cache hits, from JAX's monitoring events."""

    def __init__(self):
        import jax

        self.n, self.seconds, self.cache_hits = 0, 0.0, 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event: str, secs: float, **_) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.seconds += secs

    def _event(self, event: str, **_) -> None:
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def snapshot(self) -> dict:
        return {"compiles": self.n, "compile_s": self.seconds, "cache_hits": self.cache_hits}


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def device_summary() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}


def nvidia_smi() -> str:
    """Card name and power limit, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def ate_from_streams(out_dir: str, present: np.ndarray) -> float:
    """ATE RMSE (m) of the written trajectory against the written ground
    truth, both parsed back from the TUM streams: camera centres in the
    marker frame over the marker-present frames, no alignment (the metric of
    PARITY.md)."""
    from droplet_visual_odometry_tpu.eval import metrics, tum

    n = len(present)
    streams = {}
    for name in tum.STREAM_NAMES:
        stamps, poses = tum.read_tum(os.path.join(out_dir, name))
        want = n if name.endswith("absolute.txt") else n - 1
        if poses.shape != (want, 4, 4) or not np.all(np.isfinite(poses)):
            raise AssertionError(f"{name}: {poses.shape} poses, want {want} finite")
        streams[name] = poses
    gt = np.linalg.inv(streams["stamped_ground_truth_absolute.txt"][present])
    est = np.linalg.inv(streams["stamped_traj_estimate_absolute.txt"][present])
    return float(metrics.ate(gt, est, align="none").rmse)


def run_main_path(seq, name: str, work: str, bound: float, extra_args=()) -> dict:
    """The sequence through `cli.run_experiment.main` with the shipped
    defaults, twice: the first (cold) run includes compilation, the second
    gives the steady frames/s. ATE is recomputed from the streams."""
    from droplet_visual_odometry_tpu.cli import run_experiment
    from droplet_visual_odometry_tpu.data import sequence as seq_mod

    path = os.path.join(work, f"{name}.npz")
    seq_mod.save(path, seq)
    out_dir = os.path.join(work, name)
    argv = ["--sequence", path, "--out-dir", out_dir, *extra_args]
    walls, summary = [], None
    for _ in range(2):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_experiment.main(argv)
        walls.append(time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError(f"run_experiment exited {rc}")
        summary = json.loads(buf.getvalue())
    ate = ate_from_streams(out_dir, np.asarray(seq.marker_present))
    if not abs(ate - summary["ate_rmse_m"]) <= 1e-6 * max(1.0, ate) + 1e-6:
        raise AssertionError(f"stream ATE {ate} != CLI ATE {summary['ate_rmse_m']}")
    if not ate < bound:
        raise AssertionError(f"{name}: ATE {ate:.4f} m not below {bound} m")
    return {
        "scenario": name,
        "frames": len(seq),
        "shape": list(seq.frames.shape[1:]),
        "ate_rmse_m": ate,
        "ate_bound_m": bound,
        "ok_fraction": summary["ok_fraction"],
        "frames_per_second": len(seq) / walls[1],
        "cold_wall_s": walls[0],
        "warm_wall_s": walls[1],
        "cold_compile_s": walls[0] - walls[1],
    }


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------


def _camera_centres(abs_poses) -> np.ndarray:
    return np.linalg.inv(np.asarray(abs_poses, np.float64))[:, :3, 3]


def _centre_rms(a, b) -> float:
    d = _camera_centres(a) - _camera_centres(b)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def pair_differences(rel_a, rel_b) -> dict:
    """Per-pair differences of two relative-pose streams (P, 4, 4): largest
    element, rotation angle (deg) and translation distance (m)."""
    a, b = np.asarray(rel_a, np.float64), np.asarray(rel_b, np.float64)
    chord = np.linalg.norm(a[:, :3, :3] - b[:, :3, :3], axis=(1, 2)) / (2 * np.sqrt(2))
    return {
        "max_abs": np.abs(a - b).max(axis=(1, 2)),
        "rot_deg": np.degrees(2 * np.arcsin(np.clip(chord, 0.0, 1.0))),
        "trans_m": np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1),
    }


def cli_config():
    """The VOConfig that `cli.run_experiment` builds from its default flags,
    so phases that call the library directly reuse the main path's programs."""
    from droplet_visual_odometry_tpu.cli import run_experiment

    return run_experiment.vo_config(run_experiment.build_parser().parse_args(["--synthetic"]))


# Chunked vs whole, on one H100 at distorted_1440 with chunk=16 (PERF.md):
# 75% of pairs equal to 1e-4, the rest within 0.32 deg and 13 mm, camera
# centres 13.9 mm RMS apart. Two whole runs under different RANSAC keys:
# 0-5% of pairs equal, per pair up to 0.65 deg and 24 mm, 21-36 mm RMS.
STREAM_MIN_EQUAL_PAIRS = 0.25
STREAM_PAIR_ROT_DEG = 1.0
STREAM_PAIR_TRANS_M = 0.05
STREAM_CENTRE_RMS_M = 0.05


def run_stream_phase(
    seq, chunk: int = 16, n_push: int = 20, ate_bound: float = ATE_BOUND_M["distorted_1440"],
) -> dict:
    """Chunked streaming vs the whole-sequence program, then live pushes.

    Both runs see the same frames, per-pair RANSAC keys and held-scale carry.
    On the CPU they agree to rounding. On the H100 the features and matches
    agree bit for bit at any chunk size, and chunk = N-1 reproduces the whole
    run bit for bit; but RANSAC's batched products over 16 pairs round
    otherwise than over 59, which moves inlier counts at the threshold and
    with them some pairs' winning hypothesis. So every pair is held to a
    bound set from the measured spread (above): at least a quarter of the
    pairs equal to 1e-4 (a different RANSAC draw gives 0-5%), each within
    1 deg and 5 cm of the whole run, the camera centres within 5 cm RMS, all
    pairs ok, and ATE under the scenario's parity bound.
    """
    import jax
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu import pipeline
    from droplet_visual_odometry_tpu.core import se3
    from droplet_visual_odometry_tpu.estimation.vo import run_sequence
    from droplet_visual_odometry_tpu.groundtruth import (
        GroundTruthConfig,
        detections_from_arrays,
    )
    from droplet_visual_odometry_tpu.stream import OnlineVO
    from droplet_visual_odometry_tpu.utils.checkpoint import run_sequence_checkpointed

    cfg = cli_config()
    K = np.asarray(pipeline.effective_K(seq), np.float32)
    corners = pipeline.effective_marker_corners(seq, K)
    present = np.asarray(seq.marker_present)
    init = np.asarray(seq.marker_poses[0])

    frames = pipeline.preprocess_frames(seq)

    def whole(seed):
        return jax.device_get(
            run_sequence(
                jax.random.PRNGKey(seed), frames, jnp.asarray(np.nan_to_num(corners)),
                jnp.asarray(present), jnp.asarray(init), jnp.asarray(K),
                seq.real_marker_length, cfg,
            )
        )

    ref, reseeded = whole(0), whole(1)
    t0 = time.perf_counter()
    chunked = run_sequence_checkpointed(
        jax.random.PRNGKey(0), seq.frames, corners, present, init, K, seq.real_marker_length,
        cfg, path=None, chunk=chunk, preprocess=pipeline.make_preprocessor(seq),
    )
    chunk_wall = time.perf_counter() - t0
    if np.shape(chunked.abs_poses) != np.shape(ref.abs_poses):
        raise AssertionError(f"chunked run has {len(chunked.abs_poses)} poses, want {len(seq)}")
    d = pair_differences(chunked.rel_poses, ref.rel_poses)
    equal = float(np.mean(d["max_abs"] <= 1e-4))
    rms = _centre_rms(chunked.abs_poses, ref.abs_poses)
    gt = _camera_centres(seq.marker_poses)[present]
    ate = float(np.sqrt(np.mean(np.sum((_camera_centres(chunked.abs_poses)[present] - gt) ** 2, -1))))
    failed = [
        msg
        for bad, msg in (
            (not np.all(chunked.ok), f"ok fraction {np.mean(chunked.ok):.2f}"),
            (not ate < ate_bound, f"ATE {ate} m >= {ate_bound} m"),
            (not equal >= STREAM_MIN_EQUAL_PAIRS, f"{equal:.2f} of pairs equal to 1e-4"),
            (not d["rot_deg"].max() <= STREAM_PAIR_ROT_DEG, f"a pair {d['rot_deg'].max():.3f} deg off"),
            (not d["trans_m"].max() <= STREAM_PAIR_TRANS_M, f"a pair {d['trans_m'].max():.4f} m off"),
            (not rms < STREAM_CENTRE_RMS_M, f"camera centres {rms:.4f} m RMS off"),
        )
        if bad
    ]
    if failed:
        raise AssertionError("chunked vs whole run: " + "; ".join(failed))

    vo = OnlineVO(
        K=K, real_marker_length=seq.real_marker_length, cfg=cfg,
        gt_cfg=GroundTruthConfig(use_base_link=False),
    )
    lat = []
    for i in range(n_push):
        t, q = se3.to_translation_quaternion(jnp.asarray(seq.marker_poses[i], jnp.float32))
        dets = detections_from_arrays(
            np.asarray([[0]], np.int32), np.asarray(t)[None, None],
            np.asarray(q)[None, None], np.asarray(corners[i])[None, None],
        )
        t0 = time.perf_counter()
        r = vo.push(float(seq.timestamps[i]), frames[i], dets)
        lat.append(time.perf_counter() - t0)
        if not (r.ok and np.all(np.isfinite(r.pose))):
            raise AssertionError(f"push {i}: ok={r.ok} pose finite={np.all(np.isfinite(r.pose))}")
    return {
        "chunk": chunk,
        "pairs_equal_to_1e-4": equal,
        "pair_rot_deg_max": float(d["rot_deg"].max()),
        "pair_trans_m_max": float(d["trans_m"].max()),
        "chunked_vs_whole_centre_rms_m": rms,
        "reseeded_vs_whole_centre_rms_m": _centre_rms(reseeded.abs_poses, ref.abs_poses),
        "pairs_same_matches": float(np.mean(np.asarray(chunked.n_matches) == np.asarray(ref.n_matches))),
        "chunked_ate_rmse_m": ate,
        "chunked_wall_s": chunk_wall,
        "pushes": n_push,
        "push_median_ms_after_first": float(np.median(lat[2:]) * 1e3) if n_push > 3 else None,
    }


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_score_numpy(img: np.ndarray, threshold: float = 20.0, arc_length: int = 9) -> np.ndarray:
    """Host FAST-N response, written from the definition: a pixel at least 3
    px from every edge is a corner when `arc_length` contiguous circle pixels
    (cyclically) are all brighter than centre + t or all darker than
    centre - t; its score is the larger of the two polarities' summed
    |neighbour - centre| - t over the circle pixels of that polarity."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    c = img[3 : h - 3, 3 : w - 3]
    ring = np.stack([img[3 + dy : h - 3 + dy, 3 + dx : w - 3 + dx] for dy, dx in _CIRCLE])
    bright = ring > c + threshold
    dark = ring < c - threshold
    excess = np.abs(ring - c) - threshold

    def arc(mask):
        found = np.zeros(c.shape, bool)
        for start in range(16):
            run = np.ones(c.shape, bool)
            for i in range(arc_length):
                run &= mask[(start + i) % 16]
            found |= run
        return found

    corner = arc(bright) | arc(dark)
    score = np.maximum((excess * bright).sum(0), (excess * dark).sum(0))
    out = np.zeros((h, w), np.float32)
    out[3 : h - 3, 3 : w - 3] = np.where(corner, score, 0.0)
    return out


def _time_ab(fns: dict, arg, reps: int) -> dict:
    """Median wall (s) of each fn over `reps` calls, taken in turns A/B/B/A
    so that drift in clocks or power falls on both alike."""
    import jax

    for f in fns.values():
        jax.block_until_ready(f(arg))
    names = list(fns)
    order = names + names[::-1]
    times = {n: [] for n in names}
    for n in order:
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[n](arg))
            times[n].append(time.perf_counter() - t0)
    return {n: float(np.median(v)) for n, v in times.items()}


def level_images(frames, n_levels: int = 4, scale_factor: float = 1.32) -> list:
    """The frontend's pyramid of (N, H, W) frames, level by level."""
    from droplet_visual_odometry_tpu.frontend import filters
    from droplet_visual_odometry_tpu.frontend.features import level_shapes

    import jax
    import jax.numpy as jnp

    frames = jnp.asarray(frames, jnp.float32)
    shapes = level_shapes(frames.shape[1], frames.shape[2], n_levels, scale_factor)
    levels = [frames]
    for lh, lw in shapes[1:]:
        levels.append(jax.jit(filters.resize_bilinear, static_argnums=(1, 2))(levels[-1], lh, lw))
    return levels


def check_fast_kernel(frames, reps: int = 20, interpret: bool = False) -> list[dict]:
    """The FAST kernel against the XLA `fast_score` and the host numpy FAST,
    at every pyramid level shape of `frames` (N, H, W): identical corner
    sets, scores within atol=1e-3, rtol=1e-5 (summation order differs).
    Then kernel vs XLA device time over all N frames of each level."""
    import jax

    from droplet_visual_odometry_tpu.frontend import fast
    from droplet_visual_odometry_tpu.ops.pallas_fast import fast_score_batch

    kernel = jax.jit(lambda x: fast_score_batch(x, interpret=interpret))
    xla = jax.jit(jax.vmap(fast.fast_score))
    rows = []
    for lvl in level_images(frames):
        n, h, w = lvl.shape
        got = np.asarray(kernel(lvl))
        ref = np.asarray(xla(lvl))
        host = fast_score_numpy(np.asarray(lvl[0]))
        for name, want in (("xla", ref[0]), ("numpy", host)):
            if not np.array_equal(got[0] > 0, want > 0):
                raise AssertionError(f"FAST {h}x{w}: corner set differs from {name}")
            np.testing.assert_allclose(got[0], want, atol=1e-3, rtol=1e-5)
        if not np.array_equal(got > 0, ref > 0):
            raise AssertionError(f"FAST {h}x{w}: corner sets differ from xla over the batch")
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)
        row = {"shape": [n, h, w], "corners_frame0": int((got[0] > 0).sum())}
        if reps:
            t = _time_ab({"kernel": kernel, "xla": xla}, lvl, reps)
            row |= {"kernel_ms": t["kernel"] * 1e3, "xla_ms": t["xla"] * 1e3}
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def four_card_pose_graph(seq, n_devices: int) -> dict:
    """The shipped default through pipeline.run_experiment with n_devices
    visible: its pose-graph solve must shard over all of them and agree with
    the single-device solve of the same graph to atol=1e-4. The graph is
    solved only when loop edges were verified, so `seq` must revisit places
    (drift_loop does; distorted_1440 has no loop and skips the solve)."""
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu import pipeline
    from droplet_visual_odometry_tpu.backend.refine import pose_graph_trajectory

    cfg = cli_config()
    res = pipeline.run_experiment(seq, cfg, backend="pose_graph")
    info = res.backend_info
    if "pg_mesh_devices" not in info:
        raise AssertionError(f"no pose-graph solve: {info.get('n_loop_edges')} loop edges")
    if info["pg_mesh_devices"] != n_devices:
        raise AssertionError(f"pg_mesh_devices {info['pg_mesh_devices']} != {n_devices}")
    if not np.asarray(seq.marker_present)[0]:
        raise AssertionError("scenario must see the marker in frame 0")
    K = jnp.asarray(pipeline.effective_K(seq), jnp.float32)
    frames = pipeline.preprocess_frames(seq)
    single, _ = pose_graph_trajectory(
        lambda idx: frames[jnp.asarray(np.asarray(idx))],
        np.asarray(res.trajectory.abs_poses, np.float64),
        np.asarray(res.trajectory.n_inliers),
        pipeline.effective_marker_corners(seq, np.asarray(K)),
        np.asarray(seq.marker_present),
        K,
        seq.real_marker_length,
        cfg,
        pair_scale_ok=np.asarray(res.trajectory.scale_ok),
        mesh=None,
    )
    err = float(np.max(np.abs(res.vo_abs - single)))
    if not err <= 1e-4:
        raise AssertionError(f"sharded vs single pose graph: max |diff| {err} > 1e-4")
    return {
        "pg_mesh_devices": info["pg_mesh_devices"],
        "n_loop_edges": info["n_loop_edges"],
        "max_abs_diff": err,
        "ate_rmse_m": res.ate.rmse,
    }


def four_card_pair_vo(seq, n_devices: int, pairs_per_card: int = 4) -> dict:
    """sharding.shard_pair_vo over n_devices against the same pairs on one."""
    import jax
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu import pipeline
    from droplet_visual_odometry_tpu.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu.parallel import sharding

    n = n_devices * pairs_per_card
    frames = pipeline.preprocess_frames(seq)[: n + 1]
    K = np.asarray(pipeline.effective_K(seq), np.float32)
    corners = jnp.asarray(np.nan_to_num(pipeline.effective_marker_corners(seq, K)[: n + 1]))
    present = jnp.asarray(seq.marker_present[: n + 1])
    args = (
        jax.random.PRNGKey(0), frames[:-1], frames[1:], corners[:-1], corners[1:],
        present[:-1] & present[1:], jnp.asarray(K), seq.real_marker_length, VOConfig(),
    )
    multi = sharding.shard_pair_vo(sharding.make_mesh(n_devices), *args)
    one = sharding.shard_pair_vo(sharding.make_mesh(1), *args)
    multi, one = np.asarray(multi), np.asarray(one)
    if len(sharding.make_mesh(n_devices).devices.flat) != n_devices:
        raise AssertionError("mesh size")
    err = float(np.max(np.abs(multi - one)))
    if not (np.all(np.isfinite(multi)) and err <= 1e-3):
        raise AssertionError(f"sharded vs one-card pair VO: max |diff| {err} > 1e-3")
    return {"pairs": n, "shape": list(frames.shape[1:]), "max_abs_diff": err}


def make_ba_window(n_cams: int = 8, n_points: int = 2048, noise_px: float = 0.5, seed: int = 1):
    """A BA window with known truth: cameras on a short baseline looking at a
    point cloud 3-6 m ahead, observations with pixel noise, perturbed init."""
    import jax.numpy as jnp

    from droplet_visual_odometry_tpu.backend import ba
    from droplet_visual_odometry_tpu.core import se3

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0], size=(n_points, 3)).astype(np.float32)
    poses = np.stack([
        np.asarray(se3.make_se3(jnp.eye(3), jnp.asarray([0.15 * w, 0.02 * w, 0.0], jnp.float32)))
        for w in range(n_cams)
    ])
    K = jnp.asarray([[1170.0, 0, 720.0], [0, 1170.0, 540.0], [0, 0, 1]], jnp.float32)
    _, uv = ba._project(jnp.asarray(poses), jnp.asarray(pts), K)
    uv = uv + jnp.asarray(rng.normal(scale=noise_px, size=uv.shape).astype(np.float32))
    init_pts = pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32)
    return ba.BAWindow(
        poses=jnp.asarray(poses), points=jnp.asarray(init_pts), obs_uv=uv,
        obs_mask=jnp.ones((n_cams, n_points), bool), K=K,
    )


def four_card_ba(n_devices: int, n_points: int = 2048) -> dict:
    """distributed_ba.run_ba_distributed against single-device ba.run_ba:
    final cost within 1% and poses within 2e-3 (landmark sums are reduced
    in another order across cards, which perturbs f32 only)."""
    from droplet_visual_odometry_tpu.backend import ba
    from droplet_visual_odometry_tpu.parallel import distributed_ba, sharding

    window = make_ba_window(n_points=n_points)
    cfg = ba.BAConfig()
    single = ba.run_ba(window, cfg)
    multi = distributed_ba.run_ba_distributed(
        sharding.make_mesh(n_devices, axis_name="landmarks"), window, cfg
    )
    c1, cm = float(single.final_cost), float(multi.final_cost)
    if not (cm < float(multi.initial_cost) and abs(cm - c1) <= 0.01 * c1):
        raise AssertionError(f"BA cost: distributed {cm} vs single {c1}")
    err = float(np.max(np.abs(np.asarray(multi.poses) - np.asarray(single.poses))))
    if not err <= 2e-3:
        raise AssertionError(f"BA poses: max |diff| {err} > 2e-3")
    return {"landmarks": n_points, "cost_single": c1, "cost_distributed": cm, "pose_max_abs_diff": err}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true", help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)

    from droplet_visual_odometry_tpu.utils.device import enable_compile_cache, require_gpu

    require_gpu()
    want = 4 if args.four_cards else 1
    dev = device_summary()
    if dev["count"] < want:
        raise RuntimeError(f"{want} GPUs needed, {dev['count']} visible")
    log(phase="device", **dev, compile_cache=enable_compile_cache("gpu"))
    print(nvidia_smi(), flush=True)

    import parity

    t_all = time.perf_counter()
    counter = CompileCounter()

    def timed(phase, fn, *a, **kw):
        t0, c0 = time.perf_counter(), counter.snapshot()
        row = fn(*a, **kw)
        spent = {k: v - c0[k] for k, v in counter.snapshot().items()}
        log(phase=phase, **row, phase_wall_s=time.perf_counter() - t0, **spent,
            peak_bytes_in_use=peak_bytes())

    if args.four_cards:
        scen = parity.scenarios(names=["distorted_1440", "drift_loop"])
        timed("four_cards/pose_graph", four_card_pose_graph, scen["drift_loop"], dev["count"])
        timed("four_cards/pair_vo", four_card_pair_vo, scen["distorted_1440"], dev["count"])
        timed("four_cards/ba", four_card_ba, dev["count"])
    else:
        scen = parity.scenarios(names=list(ATE_BOUND_M))
        with tempfile.TemporaryDirectory() as work:
            for name, bound in ATE_BOUND_M.items():
                timed("main", run_main_path, scen[name], name, work, bound)
        seq = scen["distorted_1440"]
        timed("stream", run_stream_phase, seq)
        from droplet_visual_odometry_tpu import pipeline

        frames = pipeline.preprocess_frames(seq)[:24]
        t0 = time.perf_counter()
        for row in check_fast_kernel(frames):
            log(phase="kernels/fast_score", **row)
        log(phase="kernels", phase_wall_s=time.perf_counter() - t0)
    log(phase="total", wall_s=time.perf_counter() - t_all, **counter.snapshot(),
        peak_bytes_in_use=peak_bytes())
    print(json.dumps({"ok": True, "device": device_summary()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
