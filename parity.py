"""Accuracy-parity harness: the reference pipeline vs this framework, end-to-end.

BASELINE.md target #1 is "ATE RMSE <= the reference pipeline's" — this file is
the measurement. It ports the reference's FULL chain faithfully to
OpenCV+numpy (the same libraries the reference calls), CHAINS poses exactly as
the reference does, runs both pipelines over identical synthetic sequences,
and writes `PARITY.md` with ATE/RPE for every configuration.

The reference chain ported here (file:line in /root/reference):

  seed    abs_0 = first GT marker pose cTm_0           dual_process:102-117, 193-198
  detect  ORB/SIFT detectAndCompute on BOTH frames     visual_odometry_v3.py:387-392
  match   BFMatcher crosscheck (orb) / KNN+ratio       v3:191-239
  E       findEssentialMat(p_prev, p_curr, K, RANSAC,
          prob=.999, thr=1.0) + recoverPose            v3:297-306
  scale   triangulatePoints(prev_P, K[R|t], corners),
          scale = L / dist(corner0, corner1)           v3:263-291, 309-326
  rel     Trans(t*scale) @ Rot(euler round-trip)       v3:328-345
  chain   abs = abs_prev @ rel                         v3:349-368

When the camera has a distortion model, the reference's undistortion leg
runs too (its production camera is 1440x1080 with strong plumb_bob
distortion — Parameters/camera_calibration.yaml:21-29):

  new_K  getOptimalNewCameraMatrix(K, dist, (w,h), alpha=1, (w,h))
                                                       v3:117-123 (recomputed
                                                       per frame; identical
                                                       every time, hoisted)
  rect   cv.undistort(gray, K, dist, newCameraMatrix=new_K)
                                                       v3:110-113, 127-133

`faithful=True` reproduces the reference's six implementation quirks
bug-for-bug (they are the pipeline's real behavior):
  1. marker corners read from the PREVIOUS valid set — the scale sees corner
     pairs (i-2, i-1) for image pair (i-1, i)          dual_process:214 vs :182
  2. triangulated corners used WITHOUT dividing by the homogeneous w row
                                                       v3:269-279
  3. the previous pair's K[R|t] carried as projMatr1 of the next pair's
     triangulation (geometrically unrelated cameras)   v3:309, 344
  4. relative rotation rebuilt via euler_from_matrix(axes='rxyz') then
     euler_matrix(axes='sxyz') — a convention-permuting round-trip
                                                       v3:334-339 vs :138-142
  5. chaining abs = abs_prev @ rel with rel = curr_T_prev (right-
     multiplication of a left-frame transform)         v3:367
  6. (distorted cameras) keypoints are detected on frames rectified under
     new_K, but findEssentialMat / recoverPose / the projection matrices
     all use the ORIGINAL K (v3:297-309 `self.intrinsic_coefficient_matrix`
     — never new_K), and the marker corners fed to the scale triangulation
     are the RAW detections from the distorted stream (the STag corners come
     from /stag_markers, detected on the raw camera feed —
     get_valid_message_stream.py:29; nothing undistorts them).

`faithful=False` ("reference-intent") fixes all six — corners (i-1, i),
dehomogenised triangulation at K[I|0]/K[R|t], the recovered R used directly,
abs = rel @ abs_prev, and (quirk 6) new_K used consistently for the
epipolar/projection geometry with marker corners undistorted into the same
new_K pixel frame (cv.undistortPoints(..., P=new_K)) — and is the STRONGER
baseline our ATE must also beat: parity against the as-is reference alone
would be won trivially on quirk #5.

Both reference variants consume the valid-message-stream semantics: only
marker-bearing frames enter the stream (get_valid_message_stream.py:21-37
drops empty marker messages), so marker-gap frames are simply absent for the
reference while our pipeline processes every frame. ATE/RPE are evaluated on
the marker-present frames both pipelines share, on camera-center trajectories
in the marker frame (inv(cTm)), align='none' — identical treatment for all.

Usage:
  python parity.py [--platform cpu] [--write-md] [--quick]
Prints one JSON line per scenario; --write-md regenerates PARITY.md.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


# ---------------------------------------------------------------------------
# The reference pipeline, ported (OpenCV + numpy, like the original).
# ---------------------------------------------------------------------------


def _euler_roundtrip_rotation(R_mat: np.ndarray) -> np.ndarray:
    """v3:334-339 -> :138-142: euler_from_matrix(R, 'rxyz') then
    euler_matrix(euler, 'sxyz'). tf 'rxyz' (rotating/intrinsic xyz) is
    scipy 'XYZ'; tf 'sxyz' (static/extrinsic xyz) is scipy 'xyz'. The
    mismatched conventions permute the composition order — reproduced, not
    fixed, in the faithful port."""
    from scipy.spatial.transform import Rotation

    euler = Rotation.from_matrix(R_mat).as_euler("XYZ")
    return Rotation.from_euler("xyz", euler).as_matrix()


class ReferenceVO:
    """Faithful port of VisualOdometry (visual_odometry_v3.py:29-408) +
    the dual_process driver loop (trajectory_evaluation_dual_process.py:170-254).

    mode='orb' is the reference's default-parameter path (cv.ORB_create() =
    500 keypoints, BFMatcher NORM_HAMMING crossCheck — v3:96, 75) with its
    match-indexing type bug (v3:233-238 indexes a flat DMatch list as nested)
    resolved to its evident intent; mode='knn_sift' is the mode the driver's
    folder naming says was actually run (*_knn_sift.bag — dual_process:296).
    """

    def __init__(
        self, K, real_marker_length, mode="orb", faithful=True,
        dist=None, size=None,
    ):
        import cv2

        self.cv2 = cv2
        self.K = np.asarray(K, np.float64)
        self.real_marker_length = float(real_marker_length)
        self.mode = mode
        self.faithful = faithful
        # Undistortion leg (v3:110-135): active only when the camera model
        # has distortion. new_K is hoisted out of the per-frame loop (the
        # reference recomputes an identical matrix every frame, v3:117-123).
        self.dist = None
        self.new_K = None
        if dist is not None and np.any(np.asarray(dist)):
            assert size is not None, "distorted camera needs (width, height)"
            self.dist = np.asarray(dist, np.float64).reshape(-1)
            w, h = int(size[0]), int(size[1])
            self.size = (w, h)
            self.new_K, _ = cv2.getOptimalNewCameraMatrix(
                self.K, self.dist, (w, h), 1, (w, h)
            )
        # Geometry matrix for E/recoverPose/projection: the reference keeps
        # using the ORIGINAL K after rectifying under new_K (quirk #6,
        # v3:297-309); the intent variant uses new_K consistently.
        self.geom_K = self.K
        if self.new_K is not None and not faithful:
            self.geom_K = np.asarray(self.new_K, np.float64)
        if mode == "orb":
            self.detector = cv2.ORB_create()
            self.bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        elif mode == "knn_sift":
            self.detector = cv2.SIFT_create()
            self.bf = cv2.BFMatcher(cv2.NORM_L1, crossCheck=False)
        else:
            raise ValueError(mode)
        # v3:164-166 (controlled branch — the uncontrolled branch leaves this
        # None and crashes on the first triangulation, so the working
        # configuration is ported).
        self.previous_projection_matrix = self.geom_K @ np.hstack(
            [np.eye(3), np.zeros((3, 1))]
        )
        self.n_failures = 0

    def _rectify(self, img):
        """cv.undistort leg (v3:110-113) — identity for distortion-free cams."""
        if self.dist is None:
            return img
        return self.cv2.undistort(
            img, self.K, self.dist, newCameraMatrix=self.new_K
        )

    def _corners_for_scale(self, corners):
        """Marker corners as the scale triangulation sees them. Faithful: the
        raw distorted-stream detections (quirk #6). Intent: undistorted into
        the new_K pixel frame the rectified keypoints live in."""
        if self.dist is None or self.faithful:
            return np.asarray(corners, np.float64)
        c = np.asarray(corners, np.float64).reshape(-1, 1, 2)
        und = self.cv2.undistortPoints(c, self.K, self.dist, P=self.new_K)
        return und.reshape(-1, 2)

    def _match(self, d1, k1, d2, k2):
        cv2 = self.cv2
        if self.mode == "orb":
            matches = sorted(self.bf.match(d1, d2), key=lambda m: m.distance)
        else:  # knn + Lowe ratio (v3:204, 225-230)
            knn = self.bf.knnMatch(d1, d2, k=2)
            matches = [m for m, n in knn if m.distance < 0.75 * n.distance]
        p1 = np.float32([k1[m.queryIdx].pt for m in matches])
        p2 = np.float32([k2[m.trainIdx].pt for m in matches])
        return p1, p2

    def step(self, prev_img, curr_img, prev_abs, prev_corners, curr_corners):
        """One visual_odometry_calculations pair (v3:384-408).

        Returns (abs, rel); on the degenerate cases where the reference would
        crash (too few matches, E estimation failure), counts the failure and
        holds the pose (rel = I) so the run can be scored at all.
        """
        cv2 = self.cv2
        prev_img = self._rectify(prev_img)
        curr_img = self._rectify(curr_img)
        k1, d1 = self.detector.detectAndCompute(prev_img, None)
        k2, d2 = self.detector.detectAndCompute(curr_img, None)
        if d1 is None or d2 is None:
            self.n_failures += 1
            return prev_abs @ np.eye(4), np.eye(4)
        p1, p2 = self._match(d1, k1, d2, k2)
        if len(p1) < 8:
            self.n_failures += 1
            return prev_abs @ np.eye(4), np.eye(4)

        E, _ = cv2.findEssentialMat(
            p1, p2, self.geom_K, method=cv2.RANSAC, prob=0.999, threshold=1.0
        )  # v3:297-300 (geom_K == original K when faithful, quirk #6)
        if E is None or E.shape != (3, 3):
            self.n_failures += 1
            return prev_abs @ np.eye(4), np.eye(4)
        _, R, t, _ = cv2.recoverPose(E, p1, p2, self.geom_K)  # v3:303-306

        current_P = self.geom_K @ np.hstack([R, t.reshape(3, 1)])  # v3:309
        prev_P = self.previous_projection_matrix if self.faithful else (
            self.geom_K @ np.hstack([np.eye(3), np.zeros((3, 1))])
        )
        X4 = cv2.triangulatePoints(
            prev_P,
            current_P,
            self._corners_for_scale(prev_corners).T,
            self._corners_for_scale(curr_corners).T,
        )  # v3:265
        if self.faithful:
            # v3:269-279: raw homogeneous rows, no division by w.
            c = X4[:3, :2]
        else:
            c = (X4[:3] / np.where(np.abs(X4[3:]) < 1e-12, 1e-12, X4[3:]))[:, :2]
        dist = float(np.linalg.norm(c[:, 0] - c[:, 1]))
        scale = self.real_marker_length / max(dist, 1e-12)  # v3:276-279

        t_scaled = t.T[0] * scale  # v3:321-326
        R_rel = _euler_roundtrip_rotation(R) if self.faithful else R
        rel = np.eye(4)
        rel[:3, :3] = R_rel
        rel[:3, 3] = t_scaled  # make_transform_mat: Trans @ Rot (v3:138-142)

        self.previous_projection_matrix = current_P  # v3:344
        if self.faithful:
            abs_pose = prev_abs @ rel  # v3:367
        else:
            abs_pose = rel @ prev_abs  # consistent curr_T_prev chaining
        return abs_pose, rel


def run_reference(seq, mode="orb", faithful=True):
    """Drive ReferenceVO over a VOSequence with the dual_process loop
    semantics. Returns (present_idx, est_abs (V, 4, 4), n_failures)."""
    present = np.flatnonzero(np.asarray(seq.marker_present))
    frames = np.asarray(seq.frames)
    corners = np.asarray(seq.marker_corners, np.float64)
    vo = ReferenceVO(
        np.asarray(seq.camera.K),
        seq.real_marker_length,
        mode=mode,
        faithful=faithful,
        dist=np.asarray(seq.camera.dist),
        size=(seq.camera.width, seq.camera.height),
    )
    est = np.empty((len(present), 4, 4))
    est[0] = np.asarray(seq.marker_poses[present[0]], np.float64)  # seed cTm_0
    # dual_process:182/214: the corner list gets frame i's corners on the
    # first iteration, then frame i-1's corners ever after (the copy-paste
    # bug) — so VO pair (i-1, i) sees corner pair (i-2, i-1).
    corner_log = [corners[present[0]]]
    for v in range(1, len(present)):
        i_prev, i_curr = present[v - 1], present[v]
        corner_log.append(corners[i_prev if faithful else i_curr])
        est[v], _ = vo.step(
            frames[i_prev],
            frames[i_curr],
            est[v - 1],
            corner_log[-2],
            corner_log[-1],
        )
    return present, est, vo.n_failures


# ---------------------------------------------------------------------------
# Scenarios + evaluation.
# ---------------------------------------------------------------------------


def _corner_jitter(seq, std_px: float, seed: int = 1):
    """Perturb the marker-corner observations (both pipelines see the same
    jitter): detector noise on the fiducial, the dominant real-world error
    source for marker-triangulated scale."""
    rng = np.random.default_rng(seed)
    noisy = np.asarray(seq.marker_corners).copy()
    mask = np.asarray(seq.marker_present)
    noisy[mask] += rng.normal(scale=std_px, size=noisy[mask].shape).astype(np.float32)
    return dataclasses.replace(seq, marker_corners=noisy)


def _marker_gap(seq, start: int, stop: int):
    """Hide the fiducial for frames [start, stop): these frames vanish from
    the reference's valid stream entirely; our pipeline keeps processing them
    (scale_mode='hold')."""
    present = np.asarray(seq.marker_present).copy()
    present[start:stop] = False
    corners = np.asarray(seq.marker_corners).copy()
    corners[start:stop] = np.nan
    return dataclasses.replace(seq, marker_present=present, marker_corners=corners)


def scenarios(quick: bool = False, names=None):
    """The parity scenarios by name; `names` renders only those listed."""
    from droplet_visual_odometry_tpu.data import synthetic

    n1 = 30 if quick else 60
    n2 = 60 if quick else 200
    base = synthetic.SyntheticConfig(n_frames=n1, width=640, height=480)
    build = {
        "clean": lambda: synthetic.render_sequence(base),
        "corner_noise_1px": lambda: _corner_jitter(
            synthetic.render_sequence(dataclasses.replace(base, seed=2)), 1.0
        ),
        # Multi-seed (see run_scenario): the reference's single wide-baseline
        # gap step has a seed-luck-sized error that can cancel its drift, so
        # one seed cannot decide this scenario; the verdict is the 3-seed
        # mean. Quick mode keeps one seed.
        "marker_gap": lambda: [
            _marker_gap(
                synthetic.render_sequence(dataclasses.replace(base, seed=sd)),
                n1 // 3,
                2 * n1 // 3,
            )
            for sd in ((3,) if quick else (3, 13, 23))
        ],
        "drift_loop": lambda: synthetic.render_sequence(
            dataclasses.replace(
                base, n_frames=n2, seed=4, loop=True, orbit_sweep=0.9, dolly=0.3
            )
        ),
        # The reference's PRODUCTION camera: 1440x1080 with its real plumb_bob
        # distortion (Parameters/camera_calibration.yaml:21-29). The frames
        # are rendered THROUGH the lens model and both pipelines run their
        # full undistortion legs (ReferenceVO._rectify == v3:110-135 /
        # pipeline.make_preprocessor) — the only scenario that exercises the
        # per-frame rectification path end-to-end on both sides.
        "distorted_1440": lambda: synthetic.render_sequence(
            dataclasses.replace(
                base,
                n_frames=n1,
                seed=5,
                width=1440,
                height=1080,
                fx=1173.854081,
                fy=1170.565083,
                cx=747.788206,
                cy=574.700374,
                distortion=np.array(
                    [-0.296079, 0.099771, 0.000222, 0.000109, 0.0]
                ),
                n_landmarks=700,
                landmark_size=0.07,
            )
        ),
    }
    return {name: make() for name, make in build.items() if names is None or name in names}


def evaluate(seq, present_idx, est_abs):
    """ATE/RPE on camera-center trajectories in the marker frame, over the
    given marker-present frames (identical treatment for every pipeline)."""
    from droplet_visual_odometry_tpu.eval import metrics

    gt = np.linalg.inv(np.asarray(seq.marker_poses, np.float64)[present_idx])
    es = np.linalg.inv(np.asarray(est_abs, np.float64))
    a = metrics.ate(gt, es, align="none")
    r = metrics.rpe(gt, es, delta=1)
    return {
        "ate_rmse_m": round(a.rmse, 6),
        "ate_max_m": round(a.max, 6),
        "rpe_trans_rmse_m": round(r.trans_rmse, 6),
        "rpe_rot_rmse_deg": round(r.rot_rmse_deg, 6),
    }


def run_ours(seq, backend="none", scale_mode="marker", seed=0, frontend="orb"):
    from droplet_visual_odometry_tpu import pipeline
    from droplet_visual_odometry_tpu.estimation.vo import VOConfig

    if frontend == "orb":
        cfg = VOConfig(scale_mode=scale_mode)
    else:  # float-descriptor modes pair with Lowe-ratio matching (v3:223-230)
        cfg = VOConfig(
            scale_mode=scale_mode,
            frontend=frontend,
            match_mode="ratio",
            dog_threshold=0.5,
        )
    res = pipeline.run_experiment(seq, cfg, seed=seed, backend=backend)
    present = np.flatnonzero(np.asarray(seq.marker_present))
    return present, res.vo_abs[present]


def run_scenario(name, seq, quick=False):
    """seq may be one VOSequence or a LIST of them (same scenario, different
    render seeds). Multi-seed exists because single-sequence margins on the
    hardest scenario are seed-luck-sized: on marker_gap the reference's one
    wide-baseline step lands with a random direction error that can happen
    to CANCEL its accumulated drift (measured across seeds 3/13/23/31: ref
    intent 0.078/0.538/0.134/0.174 vs ours default 0.093/0.056/0.089/0.084
    ATE - ours wins 3 of 4 and the mean by ~2x, but seed 3 alone flips the
    verdict). Rows flagged all_seeds are scored on every seed and reported
    as the MEAN; the remaining diagnostic rows run on the first seed only
    (the `seeds` field records each row's sample count)."""
    seqs = list(seq) if isinstance(seq, (list, tuple)) else [seq]

    ref_variants = [
        ("reference (faithful port)", dict(mode="orb", faithful=True), False),
        ("reference (intent, bugs fixed)", dict(mode="orb", faithful=False), True),
        ("reference knn_sift (intent)", dict(mode="knn_sift", faithful=False), True),
    ]

    sm = "hold" if name == "marker_gap" else "marker"
    ours = [("ours none", "none", sm, "orb", True)]
    if not quick:
        ours += [
            ("ours ba", "ba", sm, "orb", False),
            ("ours pose_graph", "pose_graph", sm, "orb", False),
            # ONE fixed config scored on EVERY scenario (r4 verdict weak #7:
            # per-scenario best-ours proved capability, but a user runs one
            # default). pose_graph + hold is the shipped CLI default:
            # 'hold' == 'marker' whenever a live marker scale exists, and
            # forward-fills through gaps; the pose graph only adds verified
            # loop/bridge edges. Gated below: this row ALONE must beat the
            # best reference variant in every scenario.
            ("ours default (pose_graph+hold)", "pose_graph", "hold", "orb", True),
        ]
        if name in ("clean", "corner_noise_1px"):
            # The reference's mode switch scored end-to-end (v3:93-107;
            # knn_sift is the mode its driver ran, dual_process:296): our
            # float-descriptor frontends on the frame-to-frame backend.
            ours += [
                ("ours sift", "none", sm, "sift", False),
                ("ours surf", "none", sm, "surf", False),
            ]

    per_label = {}
    for si, sq in enumerate(seqs):
        cache = {}  # identical (backend, scale_mode, frontend) rows run once
        for label, kwargs, all_seeds in ref_variants:
            if si > 0 and not all_seeds:
                continue
            pres, est, nf = run_reference(sq, **kwargs)
            per_label.setdefault(label, []).append(
                evaluate(sq, pres, est) | {"n_failures": nf}
            )
        for label, backend, scale_mode, frontend, all_seeds in ours:
            if si > 0 and not all_seeds:
                continue
            key = (backend, scale_mode, frontend)
            if key not in cache:
                pres, est = run_ours(
                    sq, backend=backend, scale_mode=scale_mode, frontend=frontend
                )
                cache[key] = evaluate(sq, pres, est)
            per_label.setdefault(label, []).append(dict(cache[key]))

    rows = {}
    for label, samples in per_label.items():
        keys = [k for k in samples[0] if isinstance(samples[0][k], (int, float))]
        rows[label] = {
            k: round(float(np.mean([s[k] for s in samples])), 6) for k in keys
        }
        if "n_failures" in samples[0]:  # total across seeds, not a mean
            rows[label]["n_failures"] = int(sum(s["n_failures"] for s in samples))
        rows[label]["seeds"] = len(samples)
    return rows


def format_md(results: dict) -> str:
    lines = [
        "# PARITY — accuracy of the reference pipeline vs this framework",
        "",
        "Generated by `python parity.py --write-md` (see its docstring for the",
        "port's provenance, faithful-quirk list, and evaluation protocol).",
        "ATE/RPE over shared marker-present frames, camera-center trajectories",
        "in the marker frame, align='none'. Lower is better.",
        "",
    ]
    for scen, rows in results.items():
        lines += [f"## {scen}", ""]
        n_seeds = max(m.get("seeds", 1) for m in rows.values())
        if n_seeds > 1:
            lines += [
                f"Mean over {n_seeds} render seeds for the gated rows "
                "(single-seed margins here are seed-luck-sized — see "
                "run_scenario's docstring); `seeds` column = sample count.",
                "",
            ]
        lines.append(
            "| pipeline | ATE RMSE (m) | ATE max (m) | RPE trans RMSE (m) | RPE rot RMSE (deg) | seeds |"
        )
        lines.append("|---|---|---|---|---|---|")
        for label, m in rows.items():
            fail = f" ({m['n_failures']} failures)" if m.get("n_failures") else ""
            lines.append(
                f"| {label}{fail} | {m['ate_rmse_m']:.4f} | {m['ate_max_m']:.4f} "
                f"| {m['rpe_trans_rmse_m']:.4f} | {m['rpe_rot_rmse_deg']:.4f} "
                f"| {m.get('seeds', 1)} |"
            )
        lines.append("")
        best_ref = min(
            v["ate_rmse_m"] for k, v in rows.items() if k.startswith("reference")
        )
        best_ours = min(
            v["ate_rmse_m"] for k, v in rows.items() if k.startswith("ours")
        )
        verdict = "PASS" if best_ours <= best_ref else "FAIL"
        lines.append(
            f"Best reference ATE {best_ref:.4f} m vs best ours {best_ours:.4f} m "
            f"-> **{verdict}**"
        )
        default = rows.get("ours default (pose_graph+hold)")
        if default is not None:
            dv = "PASS" if default["ate_rmse_m"] <= best_ref else "FAIL"
            lines.append(
                f"Single shipped default (pose_graph+hold) ATE "
                f"{default['ate_rmse_m']:.4f} m -> **{dv}**"
            )
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--platform", default="cpu",
                    help="jax platform for OUR pipeline (reference port is "
                    "always host OpenCV); default cpu for determinism")
    ap.add_argument("--write-md", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="small sequences, frame-to-frame backend only")
    ap.add_argument("--scenario", default=None, help="run a single scenario")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from droplet_visual_odometry_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    results = {}
    scen = scenarios(args.quick, names=[args.scenario] if args.scenario else None)
    for name, seq in scen.items():
        print(f"scenario {name}...", file=sys.stderr, flush=True)
        results[name] = run_scenario(name, seq, quick=args.quick)
        print(json.dumps({name: results[name]}))

    if args.write_md:
        with open("PARITY.md", "w") as f:
            f.write(format_md(results))
        print("wrote PARITY.md", file=sys.stderr)

    # Exit nonzero if any scenario's best-ours loses to the best reference.
    # Full mode only: --quick shrinks sequences AND skips the ba/pose_graph
    # backends, so its margins are not the committed claim (PARITY.md).
    if args.quick:
        print("quick mode: smoke only, exit gate skipped (see PARITY.md)", file=sys.stderr)
        return 0
    for name, rows in results.items():
        best_ref = min(v["ate_rmse_m"] for k, v in rows.items() if k.startswith("reference"))
        best_ours = min(v["ate_rmse_m"] for k, v in rows.items() if k.startswith("ours"))
        if best_ours > best_ref:
            print(f"PARITY FAIL: {name}: ours {best_ours} > reference {best_ref}", file=sys.stderr)
            return 1
        # The single shipped default must win on its own, not just some
        # per-scenario tuned row (r4 verdict weak #7).
        default = rows.get("ours default (pose_graph+hold)")
        if default is not None and default["ate_rmse_m"] > best_ref:
            print(
                f"PARITY FAIL: {name}: default config {default['ate_rmse_m']} "
                f"> reference {best_ref}",
                file=sys.stderr,
            )
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
