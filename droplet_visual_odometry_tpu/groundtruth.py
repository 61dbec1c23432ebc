"""Fiducial-marker ground truth — batched rebuild of reference layer L4.

The reference (`scripts/traj_eval_ground_truth.py`) converts STag marker
detections into camera_T_marker 4x4 poses one message at a time, with a fixed
camera<-base_link extrinsic calibration (traj_eval_ground_truth.py:22-23,
28-56), plus pixel-geometry helpers for the marker corners (reorder, side
length — :153-277). Here every operation is a pure jittable function over
fixed-shape arrays, batched over frames (and over the up-to-M detections per
frame) with vmap, so a whole sequence's ground truth is derived in one
compiled call instead of a per-message Python loop.

Conventions match the reference:
  * marker detector reports bTm — base(-link or camera)_T_marker — as a
    translation + xyzw quaternion (traj_eval_ground_truth.py:103-119);
  * with `use_base_link`, cTm = cTb @ bTm (traj_eval_ground_truth.py:135-149)
    where cTb is the fixed extrinsic (:122-132); otherwise the detection is
    already camera-frame and cTm = bTm (:147-149);
  * a frame's ground truth is the detection whose id equals `reference_id`
    (get_marker_position, :279-298); frames without it are flagged invalid
    (the reference returns None at :291-292 — here a mask, never a crash).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from droplet_visual_odometry_tpu.core import se3

# Fixed camera_T_baselink extrinsics of the BlueROV rig
# (traj_eval_ground_truth.py:22-23): translation [0, 0, -0.133] m,
# quaternion (xyzw) [0.5, -0.5, 0.5, 0.5].
DEFAULT_CAMERA_T_BASE_TRANSLATION = (0.0, 0.0, -0.133)
DEFAULT_CAMERA_T_BASE_QUAT_XYZW = (0.5, -0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class GroundTruthConfig:
    """Extrinsics + frame-convention switch (GroundTruth.__init__, gt:28-56)."""

    camera_t_base: tuple = DEFAULT_CAMERA_T_BASE_TRANSLATION
    camera_q_base_xyzw: tuple = DEFAULT_CAMERA_T_BASE_QUAT_XYZW
    use_base_link: bool = True

    def camera_T_base(self) -> jax.Array:
        return se3.from_translation_quaternion(
            jnp.asarray(self.camera_t_base, jnp.float32),
            jnp.asarray(self.camera_q_base_xyzw, jnp.float32),
        )


class MarkerDetections(NamedTuple):
    """Raw fixed-shape detection stream: up to M markers per frame — the array
    analog of a `/stag_markers` message list (get_valid_message_stream.py:29,
    traj_eval_ground_truth.py:279-287). Slots beyond `count` have id == -1."""

    ids: jax.Array  # (N, M) int32, -1 for empty slots
    translations: jax.Array  # (N, M, 3) float32 — bTm translation
    quaternions: jax.Array  # (N, M, 4) float32 xyzw — bTm rotation
    corners: jax.Array  # (N, M, 4, 2) float32 pixel corners


def marker_pose_to_cTm(
    t: jax.Array, q_xyzw: jax.Array, cfg: GroundTruthConfig = GroundTruthConfig()
) -> jax.Array:
    """One detection's (translation, xyzw quaternion) -> camera_T_marker 4x4.

    bTm assembly per traj_eval_ground_truth.py:103-119; composition
    cTm = cTb @ bTm per :135-145 (or identity cTb when the detector already
    reports camera-frame poses, :147-149). Batched over leading dims via vmap.
    """
    bTm = se3.from_translation_quaternion(t, q_xyzw)
    if not cfg.use_base_link:
        return bTm
    return se3.compose(cfg.camera_T_base(), bTm)


def select_marker(dets: MarkerDetections, reference_id: int) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per frame, pick the detection with `reference_id` (gt:279-298).

    Returns (t (N,3), q (N,4), corners (N,4,2), found (N,) bool). When the id
    is absent the outputs are the first slot's values with found=False — the
    masked analog of the reference's `return None` (gt:291-292).
    """
    hit = dets.ids == reference_id  # (N, M)
    found = jnp.any(hit, axis=1)
    # argmax picks the first matching slot; 0 when none match.
    slot = jnp.argmax(hit, axis=1)
    take = lambda x: jnp.take_along_axis(
        x, slot.reshape((-1,) + (1,) * (x.ndim - 1)), axis=1
    )[:, 0]
    return take(dets.translations), take(dets.quaternions), take(dets.corners), found


def marker_keypoints(corners: jax.Array) -> jax.Array:
    """Corner array -> (N*4, 2) flat keypoint list — get_stagmarker_keypoints
    parity (gt:303-311), trivially a reshape in the array layout."""
    return corners.reshape(-1, 2)


def reorder_corners(corners: jax.Array) -> jax.Array:
    """Sort 4 corners counter-clockwise by angle around their centroid
    (reference reorder_corners, gt:174-185; centroid at :165-171). Batched:
    corners (..., 4, 2) -> (..., 4, 2)."""
    centroid = jnp.mean(corners, axis=-2, keepdims=True)
    d = corners - centroid
    ang = jnp.arctan2(d[..., 1], d[..., 0])
    order = jnp.argsort(ang, axis=-1)
    return jnp.take_along_axis(corners, order[..., None], axis=-2)


def side_lengths(corners: jax.Array) -> jax.Array:
    """Consecutive-corner distances of the angle-ordered quad
    (calculate_side_length, gt:188-203): (..., 4, 2) -> (..., 4)."""
    ordered = reorder_corners(corners)
    nxt = jnp.roll(ordered, -1, axis=-2)
    return jnp.linalg.norm(nxt - ordered, axis=-1)


def marker_pixel_length(corners: jax.Array) -> jax.Array:
    """Mean side length in pixels — the reference's primary estimator
    (get_current_marker_pixel_length, gt:206-257; its greedy 4-corner grouping
    reduces to exactly this once corners arrive grouped per marker)."""
    return jnp.mean(side_lengths(corners), axis=-1)


def marker_pixel_length_extent(corners: jax.Array) -> jax.Array:
    """max-X - min-X extent estimate — the reference's variant #2
    (get_current_marker_pixel_length_2, gt:259-277). Biased for rotated
    markers, kept for behavioral parity."""
    return jnp.max(corners[..., 0], axis=-1) - jnp.min(corners[..., 0], axis=-1)


class GroundTruthStreams(NamedTuple):
    """Per-frame ground truth for a sequence."""

    cTm: jax.Array  # (N, 4, 4)
    corners: jax.Array  # (N, 4, 2)
    present: jax.Array  # (N,) bool
    pixel_length: jax.Array  # (N,) float32 mean side length


from functools import partial


@partial(jax.jit, static_argnames=("cfg",))
def derive_ground_truth(
    dets: MarkerDetections,
    reference_id: jax.Array,
    cfg: GroundTruthConfig = GroundTruthConfig(),
) -> GroundTruthStreams:
    """Whole-sequence GT in one compiled call: select the reference marker in
    every frame, convert its pose to cTm, and compute the pixel side length —
    the batched equivalent of calling get_marker_position +
    get_stagmarker_keypoints per message (gt:279-311)."""
    t, q, corners, found = select_marker(dets, reference_id)
    cTm = jax.vmap(lambda ti, qi: marker_pose_to_cTm(ti, qi, cfg))(t, q)
    return GroundTruthStreams(
        cTm=cTm,
        corners=corners,
        present=found,
        pixel_length=marker_pixel_length(corners),
    )


def relative_stream(cTm: jax.Array, present: jax.Array | None = None) -> jax.Array:
    """GT relative poses cTm_curr @ inv(cTm_prev) for consecutive frames
    (extract_and_compute_gt_transformation, dual_process:134-137)."""
    rel = se3.gt_relative(cTm[:-1], cTm[1:])
    if present is not None:
        ok = (present[:-1] & present[1:])[:, None, None]
        rel = jnp.where(ok, rel, jnp.eye(4, dtype=rel.dtype))
    return rel


def sequence_from_detections(
    frames: np.ndarray,
    timestamps: np.ndarray,
    dets: MarkerDetections,
    reference_id: int,
    camera,
    real_marker_length: float,
    cfg: GroundTruthConfig = GroundTruthConfig(),
):
    """Assemble a VOSequence directly from frames + raw marker detections —
    the full reference ingest path (bag messages -> paired stream -> GT poses,
    get_valid_message_stream.py:80-87 + traj_eval_ground_truth.py:279-298) in
    one call. Frames and detections must already be stamp-aligned; use
    data.sequence.pair_timestamps for the exact-stamp intersection first."""
    from droplet_visual_odometry_tpu.data.sequence import VOSequence

    streams = derive_ground_truth(dets, jnp.asarray(reference_id), cfg)
    present = np.asarray(streams.present)
    corners = np.asarray(streams.corners, np.float32)
    corners = np.where(present[:, None, None], corners, np.nan)
    ids = np.where(present, reference_id, -1).astype(np.int32)
    seq = VOSequence(
        frames=np.asarray(frames),
        timestamps=np.asarray(timestamps, np.float64),
        marker_corners=corners,
        marker_poses=np.asarray(streams.cTm, np.float32),
        marker_present=present,
        marker_ids=ids,
        camera=camera,
        real_marker_length=float(real_marker_length),
    )
    seq.validate()
    return seq


def detections_from_arrays(
    ids: np.ndarray, translations: np.ndarray, quaternions: np.ndarray, corners: np.ndarray
) -> MarkerDetections:
    """Host-side constructor from numpy arrays (e.g. a converted bag)."""
    return MarkerDetections(
        ids=jnp.asarray(ids, jnp.int32),
        translations=jnp.asarray(translations, jnp.float32),
        quaternions=jnp.asarray(quaternions, jnp.float32),
        corners=jnp.asarray(corners, jnp.float32),
    )
