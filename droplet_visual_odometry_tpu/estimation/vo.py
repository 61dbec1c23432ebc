"""The visual-odometry core: two-frame relative pose + sequence chaining.

Batched equivalent of the reference's VisualOdometry.visual_odometry_calculations
(visual_odometry_v3.py:384-408) and the driver loop
(trajectory_evaluation_dual_process.py:170-254), with two structural upgrades:

  * Features are computed ONCE per frame and carried through the `lax.scan`
    (the reference re-detects every frame twice since pairs overlap,
    v3:387-392 — a 2x frontend cost we do not replicate).
  * The whole sequence loop is one compiled program: per-pair matching,
    batched RANSAC, pose recovery, marker-scale and pose chaining run on
    device with fixed shapes; no per-frame host round-trips.

Pose conventions (see data/synthetic.py):
  rel = curr_T_prev (cv.recoverPose convention), abs_curr = rel @ abs_prev.
  With abs_0 seeded from the first GT marker pose cTm_0 (the reference's
  initialisation, dual_process:102-117), abs_i estimates cTm_i.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.core import se3
from droplet_visual_odometry_tpu.estimation import scale as scale_mod
from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig, ransac_pose
from droplet_visual_odometry_tpu.frontend import matcher
from droplet_visual_odometry_tpu.frontend.features import (
    detect_and_describe,
    detect_and_describe_batch,
)
from droplet_visual_odometry_tpu.frontend.orb import Features


@dataclasses.dataclass(frozen=True)
class VOConfig:
    n_keypoints: int = 512
    frontend: str = "orb"  # 'orb'|'sift'|'surf' — v3:93-107 mode switch
    fast_threshold: float = 20.0
    fast_arc_length: int = 9
    dog_threshold: float = 1.0  # 'sift'/'surf' frontend blob threshold
    n_levels: int = 4  # pyramid levels ('orb'); 1 = single-scale
    scale_factor: float = 1.32  # pyramid level ratio (cv.ORB uses 1.2 x 8)
    match_mode: str = "crosscheck"  # 'crosscheck' (ref 'orb') | 'ratio' (ref SIFT modes)
    ratio: float = 0.75
    ransac: RansacConfig = RansacConfig()
    min_matches: int = 12
    scale_side: str = "mean"  # 'mean' | 'reference' (single-side parity)
    # 'gn': joint (marker pose, scale) Gauss-Newton on the known marker shape
    # — robust to corner noise, where per-pair corner triangulation at VO
    # baselines is several-fold biased (scale.py module docstring).
    # 'triangulation': the reference's method (v3:263-291).
    scale_estimator: str = "gn"
    # 'marker': per-pair marker scale, 1.0 fallback when absent (reference
    # behavior, v3:318-326). 'hold': forward-fill the last live marker scale
    # through marker-absent stretches (monocular scale cannot be re-derived
    # without the fiducial; holding it is the sane prior for smooth motion).
    scale_mode: str = "marker"


class VOStepResult(NamedTuple):
    rel: jax.Array  # (4, 4) scaled curr_T_prev (identity when degenerate)
    rel_unit: jax.Array  # (4, 4) same pose with UNIT-norm translation
    n_matches: jax.Array  # () int32
    n_inliers: jax.Array  # () int32
    scale: jax.Array  # () float32
    scale_ok: jax.Array  # () bool — scale came from a live marker triangulation
    ok: jax.Array  # () bool — enough matches/inliers to trust the step


def two_frame_vo(
    key: jax.Array,
    feats_prev: Features,
    feats_curr: Features,
    prev_marker_corners: jax.Array,
    curr_marker_corners: jax.Array,
    marker_valid: jax.Array,
    K: jax.Array,
    real_marker_length: float,
    cfg: VOConfig,
) -> VOStepResult:
    """One frame pair -> scaled relative pose. Fully jittable, fixed shapes.

    Mirrors get_matches_between_two_frames + previous_current_matching +
    get_transformation_between_two_frames (v3:191-239, 293-368) in one fused
    program. Degenerate pairs (too few matches/inliers — which crash the
    reference, SURVEY.md §7) yield rel=identity with ok=False.
    """
    m = matcher.match(
        feats_prev.desc,
        feats_curr.desc,
        feats_prev.valid,
        feats_curr.valid,
        mode=cfg.match_mode,
        ratio=cfg.ratio,
    )
    p_prev, p_curr, valid = matcher.gather_correspondences(feats_prev.xy, feats_curr.xy, m)
    n_matches = jnp.sum(valid).astype(jnp.int32)

    R, t_unit, res = ransac_pose(key, p_prev, p_curr, valid, K, cfg.ransac)

    s, s_ok = scale_mod.scale_factor_with_valid(
        K,
        R,
        t_unit,
        prev_marker_corners,
        curr_marker_corners,
        real_marker_length,
        marker_valid,
        side=cfg.scale_side,
        estimator=cfg.scale_estimator,
    )
    rel = se3.make_se3(R, t_unit * s)
    rel_unit = se3.make_se3(R, t_unit)

    ok = (n_matches >= cfg.min_matches) & (res.n_inliers >= cfg.ransac.sample_size)
    eye = jnp.eye(4, dtype=rel.dtype)
    rel = jnp.where(ok, rel, eye)
    rel_unit = jnp.where(ok, rel_unit, eye)
    return VOStepResult(
        rel=rel,
        rel_unit=rel_unit,
        n_matches=n_matches,
        n_inliers=res.n_inliers,
        scale=s,
        scale_ok=s_ok & ok,
        ok=ok,
    )


class VOTrajectory(NamedTuple):
    """Sequence result: absolute + relative pose streams and diagnostics."""

    abs_poses: jax.Array  # (N, 4, 4) — abs_0 = init_pose
    rel_poses: jax.Array  # (N-1, 4, 4)
    n_matches: jax.Array  # (N-1,)
    n_inliers: jax.Array  # (N-1,)
    scales: jax.Array  # (N-1,) applied scale (post-fill in 'hold' mode)
    scale_ok: jax.Array  # (N-1,) pair had a LIVE marker scale (pre-fill)
    ok: jax.Array  # (N-1,)


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_sequence(
    key: jax.Array,
    frames: jax.Array,  # (N, H, W) uint8/float grayscale, already undistorted
    marker_corners: jax.Array,  # (N, 4, 2) float32 (NaN/garbage where absent)
    marker_present: jax.Array,  # (N,) bool
    init_pose: jax.Array,  # (4, 4) — e.g. first GT marker pose (cTm_0)
    K: jax.Array,
    real_marker_length: float,
    cfg: VOConfig = VOConfig(),
    init_scale: jax.Array | float = 1.0,
    init_scale_seen: jax.Array | bool = False,
) -> VOTrajectory:
    """Frame-sequential VO over a whole sequence as one compiled program.

    key: one PRNG key, split into one RANSAC key per pair; see
    run_sequence_pair_keys for the rest.
    """
    pair_keys = jax.random.split(key, frames.shape[0] - 1)
    return run_sequence_pair_keys(
        pair_keys, frames, marker_corners, marker_present, init_pose, K,
        real_marker_length, cfg, init_scale, init_scale_seen,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_sequence_pair_keys(
    pair_keys: jax.Array,  # (N-1, 2) one RANSAC key per pair
    frames: jax.Array,
    marker_corners: jax.Array,
    marker_present: jax.Array,
    init_pose: jax.Array,
    K: jax.Array,
    real_marker_length: float,
    cfg: VOConfig = VOConfig(),
    init_scale: jax.Array | float = 1.0,
    init_scale_seen: jax.Array | bool = False,
) -> VOTrajectory:
    """run_sequence with the per-pair keys given, so that a chunked run
    (utils/checkpoint.py) draws the RANSAC samples the whole-sequence program
    would for the same pairs.

    init_scale/init_scale_seen: carry for scale_mode='hold' across chunked
    runs (utils/checkpoint.py) — the last held scale of the previous chunk
    and whether any live scale has been seen yet.

    Structure: the frontend runs ONCE for the whole batch of frames (large
    fused kernels / big matrix products); the per-pair stage (match + RANSAC + scale)
    is data-parallel across all N-1 pairs (one vmap, not a lax.scan — pairs
    are independent given precomputed features); only the pose chaining
    abs_i = rel_i @ ... @ rel_1 @ abs_0 is sequential, and that is a prefix
    product — one associative_scan of 4x4 matmuls, O(log N) depth.
    """
    all_feats = detect_and_describe_batch(
        frames,
        k=cfg.n_keypoints,
        threshold=cfg.fast_threshold,
        arc_length=cfg.fast_arc_length,
        mode=cfg.frontend,
        dog_threshold=cfg.dog_threshold,
        n_levels=cfg.n_levels if cfg.frontend == "orb" else 1,
        scale_factor=cfg.scale_factor,
    )
    feats_prev = jax.tree_util.tree_map(lambda a: a[:-1], all_feats)
    feats_curr = jax.tree_util.tree_map(lambda a: a[1:], all_feats)
    corners = jnp.nan_to_num(marker_corners)

    def pair(k, fp, fc, pc, cc, mv):
        return two_frame_vo(k, fp, fc, pc, cc, mv, K, real_marker_length, cfg)

    res = jax.vmap(pair)(
        pair_keys,
        feats_prev,
        feats_curr,
        corners[:-1],
        corners[1:],
        marker_present[:-1] & marker_present[1:],
    )

    if cfg.scale_mode == "hold":
        # Forward-fill the last LIVE marker scale (associative "last valid"
        # scan, seeded by the chunk carry; 1.0 until the first live scale),
        # then rebuild the scaled rels from the unit-translation poses.
        def last_valid(a, b):
            return (jnp.where(b[1], b[0], a[0]), a[1] | b[1])

        s_seed = jnp.concatenate(
            [jnp.asarray(init_scale, jnp.float32).reshape(1), res.scale]
        )
        v_seed = jnp.concatenate(
            [jnp.asarray(init_scale_seen, bool).reshape(1), res.scale_ok]
        )
        filled, _ = jax.lax.associative_scan(last_valid, (s_seed, v_seed))
        scales = filled[1:]
        rels = res.rel_unit.at[:, :3, 3].multiply(scales[:, None])
    elif cfg.scale_mode == "marker":
        scales = res.scale
        rels = res.rel
    else:
        raise ValueError(f"unknown scale_mode: {cfg.scale_mode}")

    init_pose = init_pose.astype(jnp.float32)
    chain = jnp.concatenate([init_pose[None], rels], axis=0)
    abs_poses = jax.lax.associative_scan(lambda a, b: b @ a, chain)
    n_matches, n_inliers, ok = (
        res.n_matches,
        res.n_inliers,
        res.ok,
    )
    return VOTrajectory(
        abs_poses=abs_poses,
        rel_poses=rels,
        n_matches=n_matches,
        n_inliers=n_inliers,
        scales=scales,
        scale_ok=res.scale_ok,
        ok=ok,
    )
