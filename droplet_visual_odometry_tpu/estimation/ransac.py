"""Batched essential-matrix RANSAC: thousands of hypotheses as one tensor program.

Replaces cv.findEssentialMat(method=cv.RANSAC, prob=0.999, threshold=1.0)
(reference: visual_odometry_v3.py:297-300). OpenCV iterates hypotheses
sequentially with early exit; on an accelerator the design is breadth-first —
sample B 8-point minimal sets at once, solve B essential matrices with one
batched eigh, score all B x N Sampson errors with one einsum, argmax the
inlier count, then polish with one weighted 8-point fit on the winner's
inliers. Deterministic given the PRNG key, fixed shapes throughout.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.estimation import epipolar


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    # 384 breadth-first 8-point hypotheses + a 128-sample fused LO round: at
    # VO-frontend inlier ratios (~70% after crosscheck matching) an all-inlier
    # 8-point draw lands ~22 times in 384, and the MSAC winner + LO rescue
    # saturate accuracy (gate: the full five-scenario parity matrix —
    # every verdict unchanged vs 512/256).
    n_hypotheses: int = 384
    sample_size: int = 8
    # Inlier threshold in PIXELS (converted to normalized coords via focal
    # length like OpenCV's findEssentialMat does internally).
    threshold_px: float = 1.0
    # Two MSAC-accepted full-set polish iterations. Measured (r4): dropping
    # to 1 saved NOTHING end-to-end (the polish latency hides under the
    # fused pipeline) and cost 6-23% parity-scenario ATE — keep both.
    refine_iters: int = 2
    # Locally-optimised inner round (LO-RANSAC): hypotheses resampled from the
    # winning inlier set. Shakes off chance-consistent outliers that a pure
    # least-squares polish locks in. 0 disables.
    lo_hypotheses: int = 128
    # Larger-than-minimal LO samples average out noise (Chum's LO-RANSAC).
    lo_sample_size: int = 14
    # Inverse-iteration counts for the minimal-sample eigvec solves
    # (ops/linalg.smallest_eigvec). MEASURED (r5 bisect, corner-noise
    # scenario ATE): 3/3 = 0.012, 2/3 = 0.026, 1/3 = 0.057, 1/1 = 0.152 —
    # the noisy minimal-sample eigproblems genuinely need all three steps,
    # so the latency cut comes from the fused schedule + budget, not here.
    hyp_eig_iters: int = 3
    lo_eig_iters: int = 3
    # Fold LO round 2 + polish round 1 into ONE accept step: the LO candidates
    # and the full-set weighted polish (both functions of the round-1 inlier
    # set only) are scored together in one batched Sampson, then a single
    # final polish runs on the winner — 3 sequential solver chains instead of
    # 5 on a stage that is latency-bound on exactly those chains (PERF.md,
    # r4's twice-named lever). False restores the r4 sequential schedule.
    fused_lo_polish: bool = True


class RansacResult(NamedTuple):
    E: jax.Array  # (3, 3) best essential matrix
    inliers: jax.Array  # (N,) bool
    n_inliers: jax.Array  # () int32
    best_score: jax.Array  # () float32 (final MSAC cost — lower is better)


def _sample_indices(
    key: jax.Array, n_hyp: int, sample_size: int, n_pts: int, valid: jax.Array
) -> jax.Array:
    """(B, sample_size) indices drawn uniformly from valid points, with
    replacement. Implemented as a packed index table (cumsum scatter) plus
    uniform draws: `jax.random.choice(..., p=mask)` lowers to a
    searchsorted-per-draw program, while this is three cheap vector ops.

    Assumes n_valid < 2**24: (u * n_valid) is computed in float32, so beyond
    that the product quantizes and biases the draw (never out of bounds — the
    minimum clamp covers the u≈1 rounding edge). VO feature counts are ~1e3."""
    v = valid.astype(jnp.int32)
    pos = jnp.cumsum(v) - 1  # packed slot for each valid point
    n_valid = jnp.maximum(pos[-1] + 1, 1)
    slot = jnp.where(v > 0, pos, n_pts)  # invalid -> OOB, dropped by scatter
    table = jnp.zeros((n_pts,), jnp.int32).at[slot].set(
        jnp.arange(n_pts, dtype=jnp.int32), mode="drop"
    )
    u = jax.random.uniform(key, (n_hyp * sample_size,))
    draw = jnp.minimum((u * n_valid).astype(jnp.int32), n_valid - 1)
    return table[draw].reshape(n_hyp, sample_size)


def ransac_essential(
    key: jax.Array,
    pts1_px: jax.Array,
    pts2_px: jax.Array,
    valid: jax.Array,
    K: jax.Array,
    cfg: RansacConfig = RansacConfig(),
) -> RansacResult:
    """Robust E estimation from fixed-shape matched pixel coords.

    pts1_px/pts2_px: (N, 2) matched points (prev, curr). valid: (N,) mask.
    """
    x1 = epipolar.to_normalized(pts1_px, K)
    x2 = epipolar.to_normalized(pts2_px, K)
    n = x1.shape[0]
    f = 0.5 * (K[0, 0] + K[1, 1])
    thr2 = (cfg.threshold_px / f) ** 2

    # Global Hartley frame: ONE O(N) normalisation pass over the full matched
    # set conditions every minimal-sample solve (the fixed-cost inverse-
    # iteration eigensolver needs centred, unit-scale coords), instead of
    # per-sample stats inside each of the B solves. Each candidate E is mapped
    # back with two 3x3 matmuls so scoring stays in original units.
    vw = valid.astype(jnp.float32)
    x1g, T1 = epipolar._hartley_normalize(x1, vw)
    x2g, T2 = epipolar._hartley_normalize(x2, vw)

    def denorm(En):
        return T2.T @ En @ T1

    idx = _sample_indices(key, cfg.n_hypotheses, cfg.sample_size, n, valid)
    s1 = x1g[idx]  # (B, 8, 3)
    s2 = x2g[idx]
    w = jnp.ones(idx.shape, jnp.float32)
    # Hypotheses are scored UNPROJECTED (Sampson ranks raw null-space solutions
    # equally well); the essential-manifold projection runs once, on the winner.
    Es = denorm(
        epipolar.essential_8point(
            s1, s2, w, enforce_rank2=False, hartley=False,
            eig_iters=cfg.hyp_eig_iters,
        )
    )  # (B, 3, 3)

    def msac_cost(err):
        """Truncated (MSAC) cost — lower is better. Counting inliers alone
        cannot distinguish a sloppy hypothesis that grazes the threshold from
        a tight one, which matters for the polish acceptance below.
        NaN-proof: degenerate hypotheses (rank-deficient samples) charge the
        full truncation everywhere and can never win."""
        e = jnp.where(jnp.isfinite(err), err, thr2)
        return jnp.sum(jnp.where(valid, jnp.minimum(e, thr2), 0.0), axis=-1)

    err = epipolar.sampson_error(Es, x1, x2)  # (B, N)
    costs = msac_cost(err)
    best = jnp.argmin(costs)
    E = Es[best]
    inliers = (err[best] < thr2) & valid
    cost = costs[best]

    def accept_batch(Es_c, carry):
        """Score candidate Es against the full set in ONE batched Sampson and
        accept the best if it beats the carried cost."""
        E, inliers, cost = carry
        err_c = epipolar.sampson_error(Es_c, x1, x2)
        costs_c = msac_cost(err_c)
        best_c = jnp.argmin(costs_c)
        better = costs_c[best_c] <= cost
        E = jnp.where(better, Es_c[best_c], E)
        inliers = jnp.where(better, (err_c[best_c] < thr2) & valid, inliers)
        cost = jnp.where(better, costs_c[best_c], cost)
        return E, inliers, cost

    def lo_candidates(key_lo, inl, eig_iters):
        idx_lo = _sample_indices(
            key_lo, cfg.lo_hypotheses, cfg.lo_sample_size, n, inl
        )
        return denorm(
            epipolar.essential_8point(
                x1g[idx_lo], x2g[idx_lo], jnp.ones(idx_lo.shape, jnp.float32),
                enforce_rank2=False, hartley=False, eig_iters=eig_iters,
            )
        )

    def polish_candidate(inl):
        """Full-set weighted 8-point on an inlier set (the polish solve)."""
        return epipolar.essential_8point(
            x1, x2, inl.astype(jnp.float32), enforce_rank2=False
        )

    if cfg.fused_lo_polish and cfg.lo_hypotheses > 0:
        # Stage A — one accept step over {LO candidates, full-set polish}:
        # both depend only on the round-1 inlier set, so their solves overlap
        # and their Sampson scoring is one (B+1)-batched call.
        cands = jnp.concatenate(
            [
                lo_candidates(jax.random.fold_in(key, 1), inliers, cfg.lo_eig_iters),
                polish_candidate(inliers)[None],
            ],
            axis=0,
        )
        E, inliers, cost = accept_batch(cands, (E, inliers, cost))
        # Stage B — final full-set polish on the improved set, MSAC-accepted.
        E, inliers, cost = accept_batch(
            polish_candidate(inliers)[None], (E, inliers, cost)
        )
    else:
        if cfg.lo_hypotheses > 0:
            # LO-RANSAC inner rounds: larger-than-minimal samples drawn from
            # the current inlier set only; the second round resamples from
            # the (possibly improved) set.
            for lo_round in (1, 2):
                E, inliers, cost = accept_batch(
                    lo_candidates(jax.random.fold_in(key, lo_round), inliers, cfg.lo_eig_iters),
                    (E, inliers, cost),
                )
        # Polish: weighted 8-point on the current inlier set, MSAC-accepted.
        def polish(_, carry):
            return accept_batch(polish_candidate(carry[1])[None], carry)

        E, inliers, cost = jax.lax.fori_loop(
            0, cfg.refine_iters, polish, (E, inliers, cost)
        )
    E = epipolar.project_to_essential(E)
    return RansacResult(
        E=E,
        inliers=inliers,
        n_inliers=jnp.sum(inliers).astype(jnp.int32),
        best_score=cost.astype(jnp.float32),
    )


def ransac_pose(
    key: jax.Array,
    pts1_px: jax.Array,
    pts2_px: jax.Array,
    valid: jax.Array,
    K: jax.Array,
    cfg: RansacConfig = RansacConfig(),
) -> tuple[jax.Array, jax.Array, RansacResult]:
    """findEssentialMat + recoverPose in one call: returns (R, t_unit, result)
    with p_curr = R @ p_prev + t (curr_T_prev, |t| = 1)."""
    res = ransac_essential(key, pts1_px, pts2_px, valid, K, cfg)
    x1 = epipolar.to_normalized(pts1_px, K)
    x2 = epipolar.to_normalized(pts2_px, K)
    R, t, front = epipolar.recover_pose(res.E, x1, x2, res.inliers.astype(jnp.float32))
    return R, t, res._replace(inliers=res.inliers & front)
