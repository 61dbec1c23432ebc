"""Online (streaming) visual odometry — the live-node capability.

The reference's live variant is a ROS node (utilities_folder/visual_odometry_v2.py):
a marker callback arms the image callback across ROS threads
(v2:97-116, 352-374), each frame chains the pose in-place, and state lives in
mutable node attributes guarded by try/except (the implicit race documented in
SURVEY.md §5). Here the same capability is a synchronous engine object driven
by the host's ingest loop:

  * `push(timestamp, frame, markers)` is the analog of one
    image_callback + marker_callback pair — no threads, no race: the caller
    owns ordering (ROS-style concurrency buys nothing when the device step is
    the bottleneck and frames must be processed in order anyway).
  * marker gating matches v2: processing is armed by the first marker
    detection (v2:104-116); before that, frames only prime the
    previous-frame state.
  * the per-pair device step (features once per frame, carried forward;
    match + RANSAC + scale) is ONE compiled function reused every push —
    the streaming twin of the offline lax.scan (estimation/vo.py).

A lightweight TF-style broadcast hook covers the stag_visualizer capability
(stag_visualizer.py:13-22): `on_pose` callbacks receive (timestamp, pose).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.estimation.vo import VOConfig, two_frame_vo
from droplet_visual_odometry_tpu.frontend.features import detect_and_describe
from droplet_visual_odometry_tpu.groundtruth import (
    GroundTruthConfig,
    MarkerDetections,
    marker_pose_to_cTm,
)


@dataclasses.dataclass
class StreamResult:
    """One push()'s outcome."""

    timestamp: float
    pose: np.ndarray  # (4, 4) absolute pose estimate (cTm frame)
    rel: np.ndarray  # (4, 4) relative pose of this step (identity if primed/skipped)
    gt_pose: np.ndarray | None  # marker-derived cTm when a marker was seen
    n_inliers: int
    ok: bool
    armed: bool


class OnlineVO:
    """Marker-gated streaming VO engine.

    Frames must arrive in timestamp order. Shapes are fixed per engine: the
    first frame pins (H, W) and every later frame must match (the reference
    assumed a fixed camera too, v2:44-46).
    """

    def __init__(
        self,
        K: np.ndarray,
        real_marker_length: float,
        reference_id: int = 0,
        cfg: VOConfig = VOConfig(),
        gt_cfg: GroundTruthConfig = GroundTruthConfig(),
        seed: int = 0,
    ) -> None:
        self.cfg = cfg
        self.gt_cfg = gt_cfg
        self.reference_id = reference_id
        self.K = jnp.asarray(K, jnp.float32)
        self.real_marker_length = float(real_marker_length)
        self._key = jax.random.PRNGKey(seed)
        self._armed = False
        self._prev_feats = None
        self._prev_corners = None
        self._prev_valid = False
        self._pose = np.eye(4, dtype=np.float32)
        self._step = 0
        self.on_pose: list[Callable[[float, np.ndarray], None]] = []
        # Per-marker broadcast — the stag_visualizer analog
        # (stag_visualizer.py:13-22 publishes every detected marker as a TF
        # frame `marker_<id>`): callbacks get (timestamp, marker_id, cTm)
        # for EVERY detected marker in the frame, not just reference_id.
        self.on_marker: list[Callable[[float, int, np.ndarray], None]] = []

        def detect(img):
            return detect_and_describe(
                img,
                k=cfg.n_keypoints,
                threshold=cfg.fast_threshold,
                arc_length=cfg.fast_arc_length,
                mode=cfg.frontend,
                dog_threshold=cfg.dog_threshold,
            )

        self._detect = detect
        # ONE fused program per push: current-frame feature extraction +
        # match + RANSAC + scale run as a single dispatch, because each
        # dispatch and result fetch is a host<->device round trip.
        def push_step(key, step, frame, feats_prev, pc, cc, mv):
            feats_curr = self._detect(frame.astype(jnp.float32))
            res = two_frame_vo(
                jax.random.fold_in(key, step), feats_prev, feats_curr,
                pc, cc, mv, self.K, self.real_marker_length, cfg,
            )
            return feats_curr, res

        self._push_step = jax.jit(push_step)
        # Host-side copy of the fixed extrinsic for the per-push marker math
        # (device round-trips per marker would defeat the one-dispatch push).
        self._cTb_np = np.asarray(gt_cfg.camera_T_base(), np.float64)

    # -- marker handling ----------------------------------------------------
    def _marker_info(self, markers: MarkerDetections | None):
        """Per-frame marker extraction, HOST-side numpy.

        Mirrors groundtruth.select_marker + marker_pose_to_cTm (asserted
        equivalent in tests/test_stream.py) without a device dispatch: the
        per-push device budget is exactly one fused program (__init__)."""
        if markers is None:
            return None, np.zeros((4, 2), np.float32), False
        ids = np.asarray(markers.ids[0])
        hit = ids == self.reference_id
        if not hit.any():
            return None, np.zeros((4, 2), np.float32), False
        s = int(np.argmax(hit))
        t = np.asarray(markers.translations[0][s], np.float64)
        q = np.asarray(markers.quaternions[0][s], np.float64)  # xyzw
        q = q / max(np.linalg.norm(q), 1e-12)
        x, y, z, w = q
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        bTm = np.eye(4)
        bTm[:3, :3] = R
        bTm[:3, 3] = t
        cTm = (self._cTb_np @ bTm) if self.gt_cfg.use_base_link else bTm
        corners = np.asarray(markers.corners[0][s], np.float32)
        return cTm.astype(np.float32), corners, True

    # -- main entry ---------------------------------------------------------
    def push(
        self,
        timestamp: float,
        frame: np.ndarray,
        markers: MarkerDetections | None = None,
    ) -> StreamResult:
        """Process one frame (+ optional marker detections for the same stamp).

        Returns the chained pose estimate. Until the first marker arrives the
        engine stays un-armed (v2 gating): frames prime the previous-frame
        state but no pose is produced.
        """
        gt_pose, corners, mvalid = self._marker_info(markers)
        if markers is not None and self.on_marker:
            self._broadcast_markers(timestamp, markers)

        if not self._armed:
            if gt_pose is None:
                # Not armed, no marker: remember the frame (v2 keeps priming
                # previous_image until the marker appears, v2:352-360).
                self._prime(frame, corners, mvalid)
                return self._result(timestamp, np.eye(4, dtype=np.float32), None, 0, False)
            # First marker: arm, seed the pose from the marker
            # (dual_process:102-117 initialisation).
            self._armed = True
            self._pose = np.asarray(gt_pose, np.float32)
            self._prime(frame, corners, mvalid)
            return self._result(timestamp, np.eye(4, dtype=np.float32), gt_pose, 0, True)

        # ONE dispatch (key folding + transfers ride the call; host numpy
        # args are uploaded as part of the execute) and ONE result fetch:
        # every extra device round trip adds its latency to the push.
        self._step += 1
        feats_curr, res = self._push_step(
            self._key,
            np.uint32(self._step),
            frame,  # raw dtype over the wire; f32 cast on device
            self._prev_feats,
            self._prev_corners,
            np.asarray(corners, np.float32),
            np.bool_(bool(self._prev_valid) and bool(mvalid)),
        )
        rel, n_inliers, ok = jax.device_get((res.rel, res.n_inliers, res.ok))
        rel = np.asarray(rel)
        self._pose = rel @ self._pose
        self._prev_feats = feats_curr
        self._prev_corners = np.asarray(corners, np.float32)
        self._prev_valid = mvalid
        return self._result(timestamp, rel, gt_pose, int(n_inliers), bool(ok))

    # -- helpers ------------------------------------------------------------
    def _broadcast_markers(self, timestamp: float, markers: MarkerDetections) -> None:
        """Fire on_marker for every detected marker slot (id >= 0) in the
        frame's detections — per-marker TF-frame parity with
        stag_visualizer.stag_markers_callback (stag_visualizer.py:13-22)."""
        ids = np.asarray(markers.ids[0])
        if not (ids >= 0).any():
            return
        cTms = np.asarray(
            marker_pose_to_cTm(
                jnp.asarray(markers.translations[0]),
                jnp.asarray(markers.quaternions[0]),
                self.gt_cfg,
            )
        )
        for slot in np.flatnonzero(ids >= 0):
            for cb in self.on_marker:
                cb(float(timestamp), int(ids[slot]), cTms[slot])

    def _prime(self, frame, corners, mvalid):
        self._prev_feats = detect_and_describe(
            jnp.asarray(frame, jnp.float32),
            k=self.cfg.n_keypoints,
            threshold=self.cfg.fast_threshold,
            arc_length=self.cfg.fast_arc_length,
            mode=self.cfg.frontend,
            dog_threshold=self.cfg.dog_threshold,
        )
        self._prev_corners = np.asarray(corners, np.float32)
        self._prev_valid = mvalid

    def _result(self, timestamp, rel, gt_pose, n_inliers, ok) -> StreamResult:
        pose = np.asarray(self._pose, np.float32).copy()
        for cb in self.on_pose:
            cb(timestamp, pose)
        return StreamResult(
            timestamp=float(timestamp),
            pose=pose,
            rel=np.asarray(rel, np.float32),
            gt_pose=None if gt_pose is None else np.asarray(gt_pose, np.float32),
            n_inliers=n_inliers,
            ok=ok,
            armed=self._armed,
        )

    @property
    def pose(self) -> np.ndarray:
        return np.asarray(self._pose, np.float32).copy()

    @property
    def armed(self) -> bool:
        return self._armed
