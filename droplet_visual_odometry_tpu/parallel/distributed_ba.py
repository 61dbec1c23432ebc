"""Distributed windowed bundle adjustment over a device mesh.

BASELINE.json config #5: keyframes/map blocks sharded across devices,
Schur-complement reduction via collectives. Design (SURVEY.md §7 stage 7):

  * LANDMARKS are the sharded axis: each device owns L/D landmarks with their
    observation columns. Landmark blocks (Hll, bl, dx) never leave their chip.
  * Keyframe poses are replicated (a window is small). Each device computes its
    partial reduced-camera contributions Sum_l Hcl Hll^-1 Hlc and Sum_l ...,
    which are combined with one psum over the mesh axis (an all-reduce over
    NVLink between GPUs); the reduced (6W x 6W) solve is then replicated on every device.
  * The whole LM loop (cost evaluation via psum, accept/reject) lives inside
    ONE shard_map'ed jitted function: no host round-trips per iteration.

The per-shard math reuses backend/ba.py's block builder on the local slice,
so single-device and distributed BA share one implementation of the physics.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from droplet_visual_odometry_tpu.backend import ba
from droplet_visual_odometry_tpu.core import se3
from droplet_visual_odometry_tpu.ops import linalg as fast_linalg


def _pad_landmarks(window: ba.BAWindow, n_devices: int) -> ba.BAWindow:
    L = window.points.shape[0]
    pad = (-L) % n_devices
    if pad == 0:
        return window
    return ba.BAWindow(
        poses=window.poses,
        points=jnp.concatenate([window.points, jnp.zeros((pad, 3), window.points.dtype)]),
        obs_uv=jnp.concatenate(
            [window.obs_uv, jnp.zeros(window.obs_uv.shape[:1] + (pad, 2), window.obs_uv.dtype)],
            axis=1,
        ),
        obs_mask=jnp.concatenate(
            [window.obs_mask, jnp.zeros(window.obs_mask.shape[:1] + (pad,), bool)], axis=1
        ),
        K=window.K,
    )


def run_ba_distributed(
    mesh: Mesh, window: ba.BAWindow, cfg: ba.BAConfig = ba.BAConfig()
) -> ba.BAResult:
    """LM windowed BA with landmarks sharded over mesh axis 0."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    window = _pad_landmarks(window, n_dev)

    lm_sh = NamedSharding(mesh, P(axis))  # shard leading landmark axis
    obs_sh = NamedSharding(mesh, P(None, axis))  # (W, L, ...) shard L
    repl = NamedSharding(mesh, P())

    huber, min_depth = cfg.huber_px, cfg.min_depth

    def local_cost(poses, points, obs_uv, obs_mask, K):
        """Sum of robust costs + valid count over the LOCAL landmark shard."""
        w = ba.BAWindow(poses, points, obs_uv, obs_mask, K)
        p, uv = ba._project(poses, points, K)
        r = uv - obs_uv
        r2 = jnp.sum(r * r, axis=-1)
        valid = obs_mask & (p[..., 2] > min_depth)
        rn = jnp.sqrt(jnp.maximum(r2, 1e-12))
        wgt = jnp.where(rn <= huber, 1.0, huber / rn) * valid
        return jnp.sum(wgt * r2), jnp.sum(valid)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(None, axis), P(None, axis), P()),
        out_specs=(P(), P(axis), P(), P(), P()),
    )
    def optimize_shard(poses, points, obs_uv, obs_mask, K):
        def total_cost(poses, points):
            c, n = local_cost(poses, points, obs_uv, obs_mask, K)
            c = jax.lax.psum(c, axis)
            n = jax.lax.psum(n, axis)
            return c / jnp.maximum(n, 1.0)

        cost0 = total_cost(poses, points)

        def step(_, carry):
            poses, points, lam, cost = carry
            w = ba.BAWindow(poses, points, obs_uv, obs_mask, K)
            Hcc, Hll, Hcl, bc, bl = ba._build_normal_blocks(
                w, poses, points, huber, min_depth
            )
            # Partial camera-side quantities -> all-reduce over the mesh.
            Wn = poses.shape[0]
            I3 = jnp.eye(3, dtype=Hll.dtype)
            I6 = jnp.eye(6, dtype=Hcc.dtype)
            Hll_d = Hll + lam * jnp.maximum(
                jnp.diagonal(Hll, axis1=-2, axis2=-1), 1e-6
            )[..., None] * I3
            Lc = fast_linalg.cholesky_unrolled(Hll_d, eps=1e-9)
            cols = [
                fast_linalg.cholesky_solve(Lc, jnp.broadcast_to(I3[i], Hll.shape[:1] + (3,)))
                for i in range(3)
            ]
            Hll_inv = jnp.stack(cols, axis=-1)
            HclHinv = jnp.einsum("wlkm,lmn->wlkn", Hcl, Hll_inv)
            S_off_local = jnp.einsum("wlkn,vlmn->wvkm", HclHinv, Hcl)
            rhs_corr_local = jnp.einsum("wlkn,ln->wk", HclHinv, bl)

            Hcc = jax.lax.psum(Hcc, axis)
            bc = jax.lax.psum(bc, axis)
            S_off = jax.lax.psum(S_off_local, axis)
            rhs_corr = jax.lax.psum(rhs_corr_local, axis)

            Hcc_d = Hcc + lam * jnp.maximum(
                jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-6
            )[..., None] * I6
            S = -S_off
            S = S.at[jnp.arange(Wn), jnp.arange(Wn)].add(Hcc_d)
            rhs = bc - rhs_corr
            # Gauge fix (replicated solve).
            mask = (jnp.arange(Wn) >= cfg.n_fixed).astype(S.dtype)
            S = S * mask[:, None, None, None] * mask[None, :, None, None]
            for i in range(cfg.n_fixed):
                S = S.at[i, i].set(jnp.eye(6, dtype=S.dtype))
            rhs = rhs * mask[:, None]
            S_dense = S.transpose(0, 2, 1, 3).reshape(Wn * 6, Wn * 6)
            dc = jnp.linalg.solve(
                S_dense + 1e-9 * jnp.eye(Wn * 6, dtype=S.dtype), rhs.reshape(-1)
            ).reshape(Wn, 6)

            # Local landmark back-substitution.
            Hlc_dc = jnp.einsum("wlkm,wk->lm", Hcl, dc)
            dx = jnp.einsum("lmn,ln->lm", Hll_inv, bl - Hlc_dc)

            new_poses = se3.se3_exp(dc) @ poses
            new_points = points + dx
            new_cost = total_cost(new_poses, new_points)
            ok = (new_cost < cost) & jnp.isfinite(new_cost)
            poses = jnp.where(ok, new_poses, poses)
            points = jnp.where(ok, new_points, points)
            lam = jnp.clip(
                jnp.where(ok, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6
            )
            cost = jnp.where(ok, new_cost, cost)
            return poses, points, lam, cost

        poses, points, _, cost = jax.lax.fori_loop(
            0, cfg.iters, step, (poses, points, cfg.init_lambda, cost0)
        )

        # Final unweighted RMS inside the mesh (two psums) — in multi-process
        # runs the sharded landmark axis is not host-addressable, so the RMS
        # cannot be a host-side afterthought.
        p, uv = ba._project(poses, points, K)
        r = uv - obs_uv
        valid = obs_mask & (p[..., 2] > min_depth)
        sq = jax.lax.psum(jnp.sum(jnp.where(valid, jnp.sum(r * r, -1), 0.0)), axis)
        n = jax.lax.psum(jnp.sum(valid), axis)
        rms = jnp.sqrt(sq / jnp.maximum(n, 1))
        return poses, points, cost0, cost, rms

    jfn = jax.jit(
        optimize_shard,
        in_shardings=(repl, lm_sh, obs_sh, obs_sh, repl),
        out_shardings=(repl, lm_sh, repl, repl, repl),
    )
    if jax.process_count() > 1:
        from droplet_visual_odometry_tpu.parallel.sharding import global_array

        args = (
            global_array(mesh, P(), window.poses),
            global_array(mesh, P(axis), window.points),
            global_array(mesh, P(None, axis), window.obs_uv),
            global_array(mesh, P(None, axis), window.obs_mask),
            global_array(mesh, P(), window.K),
        )
    else:
        args = (window.poses, window.points, window.obs_uv, window.obs_mask, window.K)
    poses, points, cost0, cost, rms = jfn(*args)
    return ba.BAResult(
        poses=poses, points=points, initial_cost=cost0, final_cost=cost, rms_px=rms
    )
