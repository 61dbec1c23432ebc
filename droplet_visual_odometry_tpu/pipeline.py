"""End-to-end experiment pipeline: the reference driver, on the accelerator.

Equivalent of UnitTestingExtractData (trajectory_evaluation_dual_process.py:31-91,
170-254): take a paired sequence, derive the marker ground-truth streams, run
VO seeded from the first marker pose, and emit the six TUM streams + metrics.
The per-frame Python loop of the reference becomes: one device preprocessing
batch (undistortion), one compiled lax.scan over the sequence, and host-side
file writes at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.core import camera as camera_mod
from droplet_visual_odometry_tpu.core import se3
from droplet_visual_odometry_tpu.data.sequence import VOSequence
from droplet_visual_odometry_tpu.estimation.vo import VOConfig, VOTrajectory, run_sequence
from droplet_visual_odometry_tpu.eval import metrics, tum


@dataclasses.dataclass
class ExperimentResult:
    timestamps: np.ndarray
    gt_abs: np.ndarray  # (N, 4, 4) cTm ground truth
    gt_rel: np.ndarray  # (N-1, 4, 4)
    vo_abs: np.ndarray  # (N, 4, 4)
    vo_rel: np.ndarray  # (N-1, 4, 4)
    trajectory: VOTrajectory
    ate: metrics.ATEResult
    rpe: metrics.RPEResult
    stream_paths: dict[str, str] | None = None
    backend_info: dict | None = None


def make_preprocessor(seq: VOSequence):
    """Chunk preprocessor: raw (C, H, W) uint8 host frames -> (C, H, W)
    float32 undistorted device frames (reference per-frame path v3:115-135,
    here a batched remap with a precomputed grid). Works on any chunk size,
    so both the whole-sequence and the streaming paths share it."""
    dist = np.asarray(seq.camera.dist)
    # Frames cross host->device in their RAW dtype (uint8 for camera data —
    # 4x fewer bytes than f32, which dominates streaming wall time on
    # bandwidth-limited links); the f32 cast happens ON DEVICE inside the
    # jitted preprocessor.
    if not np.any(dist):
        to_f32 = jax.jit(lambda raw: raw.astype(jnp.float32))
        return lambda chunk: to_f32(jnp.asarray(np.asarray(chunk)))
    new_K = camera_mod.optimal_new_camera_matrix(seq.camera, alpha=1.0)
    src_map = camera_mod.undistort_rectify_map(seq.camera, jnp.asarray(new_K))
    remap = jax.jit(
        jax.vmap(lambda f: camera_mod.remap_bilinear(f.astype(jnp.float32), src_map))
    )

    def preprocess(chunk) -> jnp.ndarray:
        return remap(jnp.asarray(np.asarray(chunk)))

    return preprocess


def preprocess_frames(seq: VOSequence) -> jnp.ndarray:
    """Whole-sequence device preprocessing (moderate sequences; the streaming
    path applies make_preprocessor per chunk instead)."""
    return make_preprocessor(seq)(seq.frames)


def effective_K(seq: VOSequence) -> np.ndarray:
    """Intrinsics valid for the (possibly undistorted) frames fed to VO."""
    dist = np.asarray(seq.camera.dist)
    if not np.any(dist):
        return np.asarray(seq.camera.K)
    return camera_mod.optimal_new_camera_matrix(seq.camera, alpha=1.0)


def effective_marker_corners(seq: VOSequence, new_K: np.ndarray) -> np.ndarray:
    """Marker corners in the SAME pixel space as the preprocessed frames.

    The sequence stores corners as detected on the raw (distorted) frames;
    once frames are undistorted under new_K (preprocess_frames), the corners
    must be undistorted too or scale triangulation (scale.py) runs on
    inconsistent geometry. NaN (marker-absent) entries stay NaN."""
    corners = np.asarray(seq.marker_corners, np.float32)
    if not np.any(np.asarray(seq.camera.dist)):
        return corners
    und = np.asarray(
        camera_mod.undistort_points(
            jnp.asarray(np.nan_to_num(corners)), seq.camera, new_K=jnp.asarray(new_K)
        ),
        np.float32,
    )
    return np.where(np.isnan(corners), np.nan, und)


def gt_streams(seq: VOSequence) -> tuple[np.ndarray, np.ndarray]:
    """Marker-derived ground truth: absolute cTm per frame and relative
    cTm_curr @ inv(cTm_prev) (dual_process:126-137)."""
    gt_abs = np.asarray(seq.marker_poses, np.float64)
    prev = jnp.asarray(gt_abs[:-1], jnp.float32)
    curr = jnp.asarray(gt_abs[1:], jnp.float32)
    gt_rel = np.asarray(se3.gt_relative(prev, curr))
    return gt_abs, gt_rel


def run_experiment(
    seq: VOSequence,
    cfg: VOConfig = VOConfig(),
    out_dir: str | None = None,
    seed: int = 0,
    backend: str = "none",  # 'none' (frame-to-frame) | 'ba' (windowed BA smoothing)
    refine_cfg=None,
    checkpoint_path: str | None = None,
    checkpoint_chunk: int = 256,
    stream: bool | None = None,
) -> ExperimentResult:
    """Full experiment on one sequence. Writes the six TUM streams when
    out_dir is given (file names per dual_process:296-309). backend='ba'
    additionally refines the trajectory with keyframe windowed bundle
    adjustment (BASELINE config #3).

    stream: process frames in host->device chunks of `checkpoint_chunk`
    (device memory bounded by the chunk, raw frames may be an np.memmap) —
    the reference's own 25k-frame bags (v3:20) require it. Defaults to ON
    when checkpoint_path is set or the sequence exceeds ~2 GB of f32 frames;
    both paths compute identical streams (same per-chunk programs).
    """
    preprocess = make_preprocessor(seq)
    K = jnp.asarray(effective_K(seq), jnp.float32)
    corners = effective_marker_corners(seq, np.asarray(K))
    if stream is None:
        frame_f32_bytes = 4 * int(np.prod(seq.frames.shape))
        stream = bool(checkpoint_path) or frame_f32_bytes > 2 << 30

    # Seed VO from the first marker pose (dual_process:102-117).
    first = int(np.argmax(seq.marker_present)) if seq.marker_present.any() else 0
    init_pose = jnp.asarray(seq.marker_poses[first])

    if stream:
        from droplet_visual_odometry_tpu.utils.checkpoint import run_sequence_checkpointed

        frames = None  # raw frames stay on host; chunks are device-resident
        traj = run_sequence_checkpointed(
            jax.random.PRNGKey(seed),
            seq.frames,
            corners,
            np.asarray(seq.marker_present),
            np.asarray(init_pose),
            np.asarray(K),
            seq.real_marker_length,
            cfg,
            path=checkpoint_path,
            chunk=checkpoint_chunk,
            preprocess=preprocess,
        )
    else:
        frames = preprocess(seq.frames)
        traj = run_sequence(
            jax.random.PRNGKey(seed),
            frames,
            jnp.asarray(corners),
            jnp.asarray(seq.marker_present),
            init_pose,
            K,
            seq.real_marker_length,
            cfg,
        )
        traj = jax.device_get(traj)

    gt_abs, gt_rel = gt_streams(seq)
    vo_abs = np.asarray(traj.abs_poses, np.float64)

    # Anchor at the first marker-bearing frame (dual_process:170-198 starts at
    # the first valid pair). run_sequence seeds index 0; with left-chaining
    # abs_i = C_i @ abs_0, re-anchoring so abs_first == init_pose is the
    # right-multiplication abs_i <- abs_i @ inv(abs_first) @ init_pose.
    if first > 0:
        corr = np.linalg.inv(vo_abs[first]) @ np.asarray(init_pose, np.float64)
        vo_abs = vo_abs @ corr

    # Backends fetch (undistorted, device-resident) frames by index — a
    # device gather for in-memory runs, a host gather + chunk preprocess for
    # streaming runs (keyframes only, so the transfer stays small).
    if frames is not None:
        fetch_frames = lambda idx: frames[jnp.asarray(np.asarray(idx))]
    else:
        fetch_frames = lambda idx: preprocess(seq.frames[np.asarray(idx)])

    backend_info: dict = {}
    if backend == "ba":
        from droplet_visual_odometry_tpu.backend.refine import RefineConfig, refine_trajectory

        vo_abs, backend_info = refine_trajectory(
            fetch_frames,
            vo_abs,
            np.asarray(traj.n_inliers),
            K,
            refine_cfg or RefineConfig(),
            marker_corners=corners,
            real_marker_length=seq.real_marker_length,
        )
    elif backend == "pose_graph":
        from droplet_visual_odometry_tpu.backend.refine import (
            PoseGraphRefineConfig,
            pose_graph_trajectory,
        )

        vo_abs, backend_info = pose_graph_trajectory(
            fetch_frames,
            vo_abs,
            np.asarray(traj.n_inliers),
            corners,
            np.asarray(seq.marker_present),
            K,
            seq.real_marker_length,
            cfg,
            refine_cfg or PoseGraphRefineConfig(),
            pair_scale_ok=np.asarray(traj.scale_ok),
        )
    elif backend != "none":
        raise ValueError(f"unknown backend: {backend}")

    vo_rel = np.asarray(
        se3.gt_relative(
            jnp.asarray(vo_abs[:-1], jnp.float32), jnp.asarray(vo_abs[1:], jnp.float32)
        ),
        np.float64,
    )

    # Metrics are computed on the CAMERA trajectory in the marker frame
    # (mTc = inv(cTm)): for marker-facing trajectories the cTm translation is
    # nearly constant (marker always ahead at viewing distance), which would
    # make a cTm-translation ATE trivially small. The TUM streams keep the
    # reference's cTm convention; inversion is a metric-side choice.
    present = seq.marker_present
    gt_cam = np.linalg.inv(gt_abs[present])
    vo_cam = np.linalg.inv(vo_abs[present])
    ate = metrics.ate(gt_cam, vo_cam, align="none")
    rpe = metrics.rpe(gt_cam, vo_cam, delta=1)

    paths = None
    if out_dir is not None:
        paths = tum.write_experiment_streams(
            out_dir, seq.timestamps, gt_abs, gt_rel, vo_abs, vo_rel
        )
    return ExperimentResult(
        timestamps=seq.timestamps,
        gt_abs=gt_abs,
        gt_rel=gt_rel,
        vo_abs=vo_abs,
        vo_rel=vo_rel,
        trajectory=traj,
        ate=ate,
        rpe=rpe,
        stream_paths=paths,
        backend_info=backend_info,
    )


def dump_match_images(
    seq: VOSequence,
    cfg: VOConfig,
    out_dir: str,
    n_pairs: int = 4,
    seed: int = 0,
    max_draw: int = 100,
) -> list[str]:
    """Write side-by-side matched-keypoint debug images for evenly spaced
    frame pairs — the reference's visualize_key_points_matching /
    drawKeypoints debug imagery (visual_odometry_v3.py:174-187, 370-379),
    with RANSAC inliers green and outliers red.

    Returns the written paths (match_XXXXX.png per pair, plus a keypoint
    overlay for the first frame of the first pair).
    """
    import os

    from droplet_visual_odometry_tpu.estimation.ransac import ransac_pose
    from droplet_visual_odometry_tpu.eval import plots
    from droplet_visual_odometry_tpu.frontend import matcher
    from droplet_visual_odometry_tpu.frontend.features import detect_and_describe_batch

    os.makedirs(out_dir, exist_ok=True)
    n = len(seq)
    if n < 2:
        return []
    pair_starts = sorted(
        {int(i) for i in np.linspace(0, n - 2, max(1, min(n_pairs, n - 1)))}
    )
    preprocess = make_preprocessor(seq)
    K = jnp.asarray(effective_K(seq), jnp.float32)

    paths: list[str] = []
    key = jax.random.PRNGKey(seed)
    for i in pair_starts:
        frames = preprocess(seq.frames[i : i + 2])
        feats = detect_and_describe_batch(
            frames,
            k=cfg.n_keypoints,
            threshold=cfg.fast_threshold,
            mode=cfg.frontend,
            dog_threshold=cfg.dog_threshold,
            n_levels=cfg.n_levels if cfg.frontend == "orb" else 1,
            scale_factor=cfg.scale_factor,
        )
        m = matcher.match(
            feats.desc[0], feats.desc[1], feats.valid[0], feats.valid[1],
            mode=cfg.match_mode, ratio=cfg.ratio,
        )
        p_prev, p_curr, valid = matcher.gather_correspondences(
            feats.xy[0], feats.xy[1], m
        )
        _, _, res = ransac_pose(
            jax.random.fold_in(key, i), p_prev, p_curr, valid, K, cfg.ransac
        )
        fa, fb = np.asarray(frames[0]), np.asarray(frames[1])
        path = os.path.join(out_dir, f"match_{i:05d}.png")
        plots.plot_matches(
            path,
            fa,
            fb,
            np.asarray(feats.xy[0]),
            np.asarray(feats.xy[1]),
            np.asarray(m.idx),
            np.asarray(m.valid),
            inliers=np.asarray(res.inliers),
            max_draw=max_draw,
            title=f"pair {i}->{i+1} ({cfg.frontend}/{cfg.match_mode})",
        )
        paths.append(path)
        if i == pair_starts[0]:
            kp_path = os.path.join(out_dir, f"keypoints_{i:05d}.png")
            plots.plot_keypoints(
                kp_path, fa, np.asarray(feats.xy[0]), np.asarray(feats.valid[0]),
                title=f"frame {i} ({cfg.frontend})",
            )
            paths.append(kp_path)
        if seq.marker_present[i] and seq.marker_present[i + 1]:
            mc_path = os.path.join(out_dir, f"marker_corners_{i:05d}.png")
            plots.plot_marker_corners(
                mc_path,
                np.asarray(seq.marker_corners[i]),
                np.asarray(seq.marker_corners[i + 1]),
                frame=fa,
                title=f"marker corners {i}->{i+1}",
            )
            paths.append(mc_path)
    return paths
