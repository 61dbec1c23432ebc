"""Tests for epipolar geometry, batched RANSAC, triangulation, marker scale."""

import cv2
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.estimation import epipolar, ransac, scale, triangulate

K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)


def synthetic_pair(n=100, outlier_frac=0.0, noise_px=0.0, seed=0):
    """Random 3D scene + two cameras; returns pixel correspondences and the
    true relative pose (R, t): p2 = R p1 + t."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 10], size=(n, 3))
    R = Rotation.from_rotvec(rng.normal(scale=0.08, size=3)).as_matrix()
    t = rng.normal(scale=0.3, size=3)
    # Fix the baseline magnitude: sub-decimetre baselines against 4-10 m depth
    # leave the translation direction unobservable at ~20 deg under 0.3 px
    # noise (cv2's RANSAC errs identically there) — not what these tests probe.
    t = t / np.linalg.norm(t) * 0.5
    X2 = X @ R.T + t

    def proj(P):
        return P[:, :2] / P[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    p1, p2 = proj(X), proj(X2)
    if noise_px:
        p1 += rng.normal(scale=noise_px, size=p1.shape)
        p2 += rng.normal(scale=noise_px, size=p2.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        p2[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    return (
        p1.astype(np.float32),
        p2.astype(np.float32),
        R.astype(np.float32),
        t.astype(np.float32),
        X.astype(np.float32),
    )


def rot_angle_deg(Ra, Rb):
    cosang = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(cosang, -1, 1)))


def t_angle_deg(ta, tb):
    c = abs(np.dot(ta, tb) / (np.linalg.norm(ta) * np.linalg.norm(tb) + 1e-12))
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


class TestEightPoint:
    def test_exact_correspondences(self):
        p1, p2, R, t, _ = synthetic_pair(64)
        x1 = epipolar.to_normalized(jnp.asarray(p1), jnp.asarray(K))
        x2 = epipolar.to_normalized(jnp.asarray(p2), jnp.asarray(K))
        E = epipolar.essential_8point(x1, x2, jnp.ones(64))
        err = np.asarray(epipolar.sampson_error(E, x1, x2))
        assert err.max() < 1e-8

    def test_matches_true_essential(self):
        p1, p2, R, t, _ = synthetic_pair(64)
        x1 = epipolar.to_normalized(jnp.asarray(p1), jnp.asarray(K))
        x2 = epipolar.to_normalized(jnp.asarray(p2), jnp.asarray(K))
        E = np.asarray(epipolar.essential_8point(x1, x2, jnp.ones(64)))
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E_true = tx @ R
        E_true /= np.linalg.norm(E_true)
        E_n = E / np.linalg.norm(E)
        if np.sum(E_n * E_true) < 0:
            E_n = -E_n
        np.testing.assert_allclose(E_n, E_true, atol=1e-4)

    def test_batched(self):
        p1, p2, *_ = synthetic_pair(64)
        x1 = epipolar.to_normalized(jnp.asarray(p1), jnp.asarray(K))
        x2 = epipolar.to_normalized(jnp.asarray(p2), jnp.asarray(K))
        xb1 = jnp.stack([x1, x1])
        xb2 = jnp.stack([x2, x2])
        E = epipolar.essential_8point(xb1, xb2, jnp.ones((2, 64)))
        assert E.shape == (2, 3, 3)
        err = np.asarray(epipolar.sampson_error(E, x1, x2))
        assert err.max() < 1e-6


class TestRecoverPose:
    def test_picks_correct_candidate(self):
        p1, p2, R, t, _ = synthetic_pair(80, seed=3)
        x1 = epipolar.to_normalized(jnp.asarray(p1), jnp.asarray(K))
        x2 = epipolar.to_normalized(jnp.asarray(p2), jnp.asarray(K))
        E = epipolar.essential_8point(x1, x2, jnp.ones(80))
        Rr, tr, front = epipolar.recover_pose(E, x1, x2, jnp.ones(80))
        assert rot_angle_deg(np.asarray(Rr), R) < 0.1
        assert t_angle_deg(np.asarray(tr), t) < 0.5
        assert np.asarray(front).mean() > 0.95

    def test_accuracy_parity_with_cv2(self):
        """Under the same 0.3px noise, our estimate must be as close to ground
        truth as OpenCV's RANSAC pipeline (both are noisy estimators, so we
        compare each to truth rather than to each other)."""
        p1, p2, R, t, _ = synthetic_pair(80, noise_px=0.3, seed=4)
        E_cv, _ = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC, prob=0.999, threshold=1.0)
        _, R_cv, t_cv, _ = cv2.recoverPose(E_cv, p1, p2, K)
        x1 = epipolar.to_normalized(jnp.asarray(p1), jnp.asarray(K))
        x2 = epipolar.to_normalized(jnp.asarray(p2), jnp.asarray(K))
        E = epipolar.essential_8point(x1, x2, jnp.ones(80))
        Rr, tr, _ = epipolar.recover_pose(E, x1, x2, jnp.ones(80))
        err_R_ours = rot_angle_deg(np.asarray(Rr), R)
        err_R_cv = rot_angle_deg(R_cv, R)
        err_t_ours = t_angle_deg(np.asarray(tr), t)
        err_t_cv = t_angle_deg(t_cv[:, 0], t)
        assert err_R_ours < max(2 * err_R_cv, 0.3), (err_R_ours, err_R_cv)
        assert err_t_ours < max(2 * err_t_cv, 2.0), (err_t_ours, err_t_cv)


class TestRansac:
    @pytest.mark.parametrize("outlier_frac", [0.0, 0.3, 0.5])
    def test_robust_to_outliers(self, outlier_frac):
        p1, p2, R, t, _ = synthetic_pair(200, outlier_frac=outlier_frac, noise_px=0.3, seed=5)
        key = jax.random.PRNGKey(0)
        # 8-point minimal samples at 50% outliers need breadth: P(clean) = 0.4%,
        # so use 4096 hypotheses (still one batched solve).
        cfg = ransac.RansacConfig(n_hypotheses=4096)
        Rr, tr, res = ransac.ransac_pose(
            key, jnp.asarray(p1), jnp.asarray(p2), jnp.ones(200, bool), jnp.asarray(K), cfg
        )
        rot_bound, t_bound = (1.5, 4.0) if outlier_frac >= 0.5 else (0.5, 3.0)
        assert rot_angle_deg(np.asarray(Rr), R) < rot_bound, outlier_frac
        assert t_angle_deg(np.asarray(tr), t) < t_bound, outlier_frac
        expected_inliers = 200 * (1 - outlier_frac)
        assert int(res.n_inliers) > 0.8 * expected_inliers

    def test_respects_valid_mask(self):
        p1, p2, R, t, _ = synthetic_pair(200, seed=6)
        # corrupt the masked-out half completely
        p2c = p2.copy()
        p2c[100:] = np.random.default_rng(0).uniform([0, 0], [640, 480], (100, 2))
        valid = np.zeros(200, bool)
        valid[:100] = True
        Rr, tr, res = ransac.ransac_pose(
            jax.random.PRNGKey(1), jnp.asarray(p1), jnp.asarray(p2c), jnp.asarray(valid), jnp.asarray(K)
        )
        assert rot_angle_deg(np.asarray(Rr), R) < 0.5
        inl = np.asarray(res.inliers)
        assert not inl[100:].any()

    def test_deterministic_given_key(self):
        p1, p2, *_ = synthetic_pair(100, outlier_frac=0.2, seed=7)
        args = (jnp.asarray(p1), jnp.asarray(p2), jnp.ones(100, bool), jnp.asarray(K))
        r1 = ransac.ransac_essential(jax.random.PRNGKey(3), *args)
        r2 = ransac.ransac_essential(jax.random.PRNGKey(3), *args)
        np.testing.assert_array_equal(np.asarray(r1.E), np.asarray(r2.E))


class TestTriangulate:
    def test_matches_cv2(self):
        p1, p2, R, t, X = synthetic_pair(50, seed=8)
        P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
        P2 = K @ np.hstack([R, t[:, None]])
        ref = cv2.triangulatePoints(P1, P2, p1.T, p2.T).T  # (N, 4)
        ref3 = ref[:, :3] / ref[:, 3:]
        ours = triangulate.dehomogenize(
            triangulate.triangulate_points(
                jnp.asarray(P1, jnp.float32), jnp.asarray(P2, jnp.float32),
                jnp.asarray(p1), jnp.asarray(p2),
            )
        )
        np.testing.assert_allclose(np.asarray(ours), ref3, atol=2e-2)
        np.testing.assert_allclose(np.asarray(ours), X, atol=2e-2)


class TestScale:
    def test_recovers_metric_scale(self):
        """Unit-|t| pose + triangulated marker -> scale; scaled translation must
        equal the true metric translation (v3:263-291 behavior, correct P1)."""
        rng = np.random.default_rng(9)
        marker_len = 0.2
        s = marker_len / 2
        Xm = np.array([[-s, -s, 6], [s, -s, 6], [s, s, 6], [-s, s, 6]], np.float32)
        R = Rotation.from_rotvec([0.02, -0.03, 0.01]).as_matrix().astype(np.float32)
        t = np.array([0.2, -0.1, 0.15], np.float32)
        X2 = Xm @ R.T + t

        def proj(P):
            return (P[:, :2] / P[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]).astype(np.float32)

        c1, c2 = proj(Xm), proj(X2)
        t_unit = t / np.linalg.norm(t)
        sf = scale.scale_factor(
            jnp.asarray(K), jnp.asarray(R), jnp.asarray(t_unit),
            jnp.asarray(c1), jnp.asarray(c2), marker_len, jnp.asarray(True),
        )
        t_scaled = np.asarray(t_unit) * float(sf)
        np.testing.assert_allclose(t_scaled, t, rtol=5e-3, atol=1e-4)

    def test_degenerate_returns_unit(self):
        c = jnp.zeros((4, 2))
        sf = scale.scale_factor(
            jnp.asarray(K), jnp.eye(3), jnp.asarray([0.0, 0, 1]), c, c, 0.2, jnp.asarray(False)
        )
        assert float(sf) == 1.0
