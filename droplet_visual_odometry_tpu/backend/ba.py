"""Windowed bundle adjustment: Levenberg-Marquardt with Schur complement.

NEW vs the reference (which chains per-pair poses with no optimization —
SURVEY.md §5 'no keyframing, no windowed BA'); required by the north star
(BASELINE.json configs 3-5).

Accelerator-first design — everything is fixed shape and masked:
  * A window holds W keyframe poses (cTw, world = first-keyframe/marker frame)
    and L landmarks, with a dense (W, L) observation grid + mask: the padded-
    sparsity strategy from SURVEY.md §7 hard-part #1. Real windows are small
    (W<=16), so the dense grid wastes little and every contraction is a clean
    batched einsum.
  * Analytic Jacobians; normal-equation blocks built by batched einsum.
  * Schur complement on the landmark blocks: Hll is (L, 3, 3) batched-inverted
    with the fixed-cost unrolled Cholesky (ops/linalg.py); the reduced camera
    system (6W x 6W) is solved densely.
  * LM damping with accept/reject implemented branchlessly (jnp.where), so the
    whole optimisation is one jittable fori_loop.
  * Gauge freedom: pose 0 is held fixed (its twist update is zeroed).

The (W, L)-grid contraction pattern is exactly what parallel/distributed_ba
shards over devices: landmarks are split across the mesh and the reduced
camera blocks are psum'd (SURVEY.md §7 stage 7).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.core import se3
from droplet_visual_odometry_tpu.ops import linalg as fast_linalg


@dataclasses.dataclass(frozen=True)
class BAConfig:
    iters: int = 10
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.3
    huber_px: float = 2.0  # robust kernel width in pixels
    min_depth: float = 1e-3
    # Poses held fixed at the head of the window. 1 fixes the rigid gauge;
    # 2 additionally pins the monocular scale gauge — use 2 when the first
    # two poses are trusted (e.g. marker-scaled VO smoothing, backend/refine.py).
    n_fixed: int = 1


class BAWindow(NamedTuple):
    """One fixed-shape BA problem."""

    poses: jax.Array  # (W, 4, 4) cTw keyframe poses
    points: jax.Array  # (L, 3) landmarks in world frame
    obs_uv: jax.Array  # (W, L, 2) pixel observations
    obs_mask: jax.Array  # (W, L) bool
    K: jax.Array  # (3, 3)


class BAResult(NamedTuple):
    poses: jax.Array  # (W, 4, 4) optimised
    points: jax.Array  # (L, 3) optimised
    initial_cost: jax.Array  # () mean squared reprojection error (px^2)
    final_cost: jax.Array
    rms_px: jax.Array  # () final RMS reprojection error over valid obs


def _project(poses: jax.Array, points: jax.Array, K: jax.Array):
    """(W,4,4) x (L,3) -> residual pieces. Returns p_cam (W,L,3), uv (W,L,2)."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    p = jnp.einsum("wij,lj->wli", R, points) + t[:, None, :]
    z = jnp.maximum(p[..., 2], 1e-6)
    u = K[0, 0] * p[..., 0] / z + K[0, 2]
    v = K[1, 1] * p[..., 1] / z + K[1, 2]
    return p, jnp.stack([u, v], axis=-1)


def reprojection_cost(w: BAWindow, poses, points, huber_px: float, min_depth: float):
    """(mean robust cost, per-obs residual (W,L,2), weights (W,L))."""
    p, uv = _project(poses, points, w.K)
    r = uv - w.obs_uv
    r2 = jnp.sum(r * r, axis=-1)
    valid = w.obs_mask & (p[..., 2] > min_depth)
    # Huber: weight = 1 for |r| <= delta, delta/|r| beyond.
    rn = jnp.sqrt(jnp.maximum(r2, 1e-12))
    wgt = jnp.where(rn <= huber_px, 1.0, huber_px / rn) * valid
    cost = jnp.sum(wgt * r2) / jnp.maximum(jnp.sum(valid), 1.0)
    return cost, r, wgt


def _build_normal_blocks(w: BAWindow, poses, points, huber_px, min_depth):
    """Jacobian blocks and gradient pieces for one GN step."""
    R = poses[:, :3, :3]
    p, uv = _project(poses, points, w.K)
    r = uv - w.obs_uv  # (W, L, 2)
    z = jnp.maximum(p[..., 2], 1e-6)
    valid = w.obs_mask & (p[..., 2] > min_depth)
    rn = jnp.linalg.norm(r, axis=-1)
    wgt = (jnp.where(rn <= huber_px, 1.0, huber_px / jnp.maximum(rn, 1e-12)) * valid)

    fx, fy = w.K[0, 0], w.K[1, 1]
    zero = jnp.zeros_like(z)
    # du/dp, dv/dp: (W, L, 2, 3)
    J_p = jnp.stack(
        [
            jnp.stack([fx / z, zero, -fx * p[..., 0] / (z * z)], axis=-1),
            jnp.stack([zero, fy / z, -fy * p[..., 1] / (z * z)], axis=-1),
        ],
        axis=-2,
    )
    # dp/dtwist = [I | -hat(p)] (left-multiplicative [v, w] twist)
    hat_p = se3._hat(p)  # (W, L, 3, 3)
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), hat_p.shape)
    dp_dxi = jnp.concatenate([I3, -hat_p], axis=-1)  # (W, L, 3, 6)
    J_pose = jnp.einsum("wlij,wljk->wlik", J_p, dp_dxi)  # (W, L, 2, 6)
    J_land = jnp.einsum("wlij,wjk->wlik", J_p, R)  # (W, L, 2, 3)

    # Weighted blocks.
    Wr = wgt[..., None] * r  # (W, L, 2)
    Hcc = jnp.einsum("wlik,wl,wlim->wkm", J_pose, wgt, J_pose)  # (W, 6, 6)
    Hll = jnp.einsum("wlik,wl,wlim->lkm", J_land, wgt, J_land)  # (L, 3, 3)
    Hcl = jnp.einsum("wlik,wl,wlim->wlkm", J_pose, wgt, J_land)  # (W, L, 6, 3)
    bc = -jnp.einsum("wlik,wli->wk", J_pose, Wr)  # (W, 6)
    bl = -jnp.einsum("wlik,wli->lk", J_land, Wr)  # (L, 3)
    return Hcc, Hll, Hcl, bc, bl


def schur_solve(Hcc, Hll, Hcl, bc, bl, lam, n_fixed: int = 1):
    """Solve the damped normal equations by Schur complement on landmarks.

    Returns (pose twists (W, 6), landmark deltas (L, 3)).
    """
    Wn, L = Hcl.shape[0], Hcl.shape[1]
    I3 = jnp.eye(3, dtype=Hll.dtype)
    I6 = jnp.eye(6, dtype=Hcc.dtype)
    # LM damping (additive, scale-aware via diagonal).
    Hll_d = Hll + lam * I3 * jnp.maximum(
        jnp.diagonal(Hll, axis1=-2, axis2=-1), 1e-6
    )[..., None] * I3
    Hcc_d = Hcc + lam * I6 * jnp.maximum(
        jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-6
    )[..., None] * I6

    # Hll^-1 via batched unrolled Cholesky solves against I.
    Lc = fast_linalg.cholesky_unrolled(Hll_d, eps=1e-9)
    cols = [fast_linalg.cholesky_solve(Lc, jnp.broadcast_to(I3[i], (L, 3))) for i in range(3)]
    Hll_inv = jnp.stack(cols, axis=-1)  # (L, 3, 3)

    # Reduced camera system: S[w1,w2] = delta*Hcc - sum_l Hcl Hll^-1 Hlc.
    HclHinv = jnp.einsum("wlkm,lmn->wlkn", Hcl, Hll_inv)  # (W, L, 6, 3)
    S_off = jnp.einsum("wlkn,vlmn->wvkm", HclHinv, Hcl)  # (W, W, 6, 6)
    S = -S_off
    S = S.at[jnp.arange(Wn), jnp.arange(Wn)].add(Hcc_d)
    rhs = bc - jnp.einsum("wlkn,ln->wk", HclHinv, bl)  # (W, 6)

    if n_fixed > 0:
        # Gauge fix: clamp the first n_fixed poses by zeroing their rows/cols
        # and placing identity diagonal blocks.
        mask = (jnp.arange(Wn) >= n_fixed).astype(S.dtype)
        S = S * mask[:, None, None, None] * mask[None, :, None, None]
        for i in range(n_fixed):
            S = S.at[i, i].set(jnp.eye(6, dtype=S.dtype))
        rhs = rhs * mask[:, None]

    S_dense = S.transpose(0, 2, 1, 3).reshape(Wn * 6, Wn * 6)
    dc = jnp.linalg.solve(
        S_dense + 1e-9 * jnp.eye(Wn * 6, dtype=S.dtype), rhs.reshape(-1)
    ).reshape(Wn, 6)

    # Back-substitute landmarks: dx = Hll^-1 (bl - Hlc dc).
    Hlc_dc = jnp.einsum("wlkm,wk->lm", Hcl, dc)  # (L, 3)
    dx = jnp.einsum("lmn,ln->lm", Hll_inv, bl - Hlc_dc)
    return dc, dx


def run_ba(window: BAWindow, cfg: BAConfig = BAConfig()) -> BAResult:
    """Levenberg-Marquardt windowed BA. Jittable; fixed iteration count with
    branchless accept/reject."""
    huber, min_depth = cfg.huber_px, cfg.min_depth

    cost0, _, _ = reprojection_cost(window, window.poses, window.points, huber, min_depth)

    def step(_, carry):
        poses, points, lam, cost = carry
        Hcc, Hll, Hcl, bc, bl = _build_normal_blocks(window, poses, points, huber, min_depth)
        dc, dx = schur_solve(Hcc, Hll, Hcl, bc, bl, lam, n_fixed=cfg.n_fixed)
        new_poses = se3.se3_exp(dc) @ poses
        new_points = points + dx
        new_cost, _, _ = reprojection_cost(window, new_poses, new_points, huber, min_depth)
        ok = (new_cost < cost) & jnp.isfinite(new_cost)
        poses = jnp.where(ok, new_poses, poses)
        points = jnp.where(ok, new_points, points)
        lam = jnp.where(ok, lam * cfg.lambda_down, lam * cfg.lambda_up)
        lam = jnp.clip(lam, 1e-9, 1e6)
        cost = jnp.where(ok, new_cost, cost)
        return poses, points, lam, cost

    poses, points, _, cost = jax.lax.fori_loop(
        0, cfg.iters, step, (window.poses, window.points, cfg.init_lambda, cost0)
    )
    _, r, wgt = reprojection_cost(window, poses, points, huber, min_depth)
    n = jnp.maximum(jnp.sum(wgt > 0), 1)
    rms = jnp.sqrt(jnp.sum(jnp.where(wgt > 0, jnp.sum(r * r, -1), 0.0)) / n)
    return BAResult(
        poses=poses,
        points=points,
        initial_cost=cost0,
        final_cost=cost,
        rms_px=rms,
    )
