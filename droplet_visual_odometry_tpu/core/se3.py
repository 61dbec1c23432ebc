"""Pure-JAX SO(3)/SE(3) library — quaternions, euler angles, 4x4 transforms.

Batched, jittable replacement for the reference's pose math layer
(reference: scripts/pose_estimation_module.py:15-77, the thrice-duplicated
rotation_matrix_to_quaternion at pose_estimation_module.py:31-57 /
traj_eval_ground_truth.py:62-89, and the `tf.transformations` euler helpers used at
visual_odometry_v3.py:138-142, 334).

Every function is pure, jittable, and batched: all ops broadcast over arbitrary
leading batch dimensions, so `jax.vmap` is never required (but always works).

Conventions:
  * Quaternions are **xyzw** (ROS/TUM order), matching the reference's TUM output
    lines "t tx ty tz qx qy qz qw" (pose_estimation_module.py:80-86).
  * `euler_*` functions implement the 'sxyz' and 'rxyz' axis conventions of ROS
    `tf.transformations` (the only two the reference uses:
    visual_odometry_v3.py:141 'sxyz', visual_odometry_v3.py:334 'rxyz'):
      - 'sxyz' (static/extrinsic xyz):  R = Rz(az) @ Ry(ay) @ Rx(ax)
      - 'rxyz' (rotating/intrinsic xyz): R = Rx(ax) @ Ry(ay) @ Rz(az)
  * SE(3) poses are 4x4 homogeneous matrices, float32 by default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Quaternions (xyzw)
# ---------------------------------------------------------------------------

def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """xyzw quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> xyzw quaternion (..., 4).

    Branch-free Shepperd method: compute all four candidate quaternions (one per
    choice of largest diagonal element / trace) and select the numerically best
    by maximum denominator — the jit-friendly equivalent of the reference's
    branch-on-trace code (pose_estimation_module.py:31-57).
    Returns the hemisphere with w >= 0.
    """
    m00 = R[..., 0, 0]
    m11 = R[..., 1, 1]
    m22 = R[..., 2, 2]
    m01, m02, m10 = R[..., 0, 1], R[..., 0, 2], R[..., 1, 0]
    m12, m20, m21 = R[..., 1, 2], R[..., 2, 0], R[..., 2, 1]

    tr = m00 + m11 + m22
    # Four squared denominators (all >= 0 up to rounding).
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    # Candidate quaternions, each scaled by its (unnormalised) denominator.
    # cand_w: s = 2*sqrt(qw2); q = [ (m21-m12)/s*..., ..., s/4 ] — we keep the
    # unnormalised vector [x, y, z, w]*s and normalise at the end.
    def _safe_sqrt(v):
        return jnp.sqrt(jnp.maximum(v, 1e-12))

    sw = _safe_sqrt(qw2)
    cw = jnp.stack([(m21 - m12), (m02 - m20), (m10 - m01), qw2], axis=-1) / sw[..., None]
    sx = _safe_sqrt(qx2)
    cx = jnp.stack([qx2, (m01 + m10), (m02 + m20), (m21 - m12)], axis=-1) / sx[..., None]
    sy = _safe_sqrt(qy2)
    cy = jnp.stack([(m01 + m10), qy2, (m12 + m21), (m02 - m20)], axis=-1) / sy[..., None]
    sz = _safe_sqrt(qz2)
    cz = jnp.stack([(m02 + m20), (m12 + m21), qz2, (m10 - m01)], axis=-1) / sz[..., None]

    cands = jnp.stack([cw, cx, cy, cz], axis=-2)  # (..., 4 candidates, 4)
    dens = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)  # (..., 4)
    idx = jnp.argmax(dens, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, axis=-1), axis=-2)
    q = q[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical hemisphere: w >= 0.
    return jnp.where(q[..., 3:4] < 0, -q, q)


def quat_multiply(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product of xyzw quaternions (rotation q1 then... q1*q2 applies q2's
    frame composition: R(q1*q2) = R(q1) @ R(q2))."""
    x1, y1, z1, w1 = jnp.moveaxis(q1, -1, 0)
    x2, y2, z2, w2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


# ---------------------------------------------------------------------------
# Euler angles (tf.transformations 'sxyz' / 'rxyz' conventions)
# ---------------------------------------------------------------------------

def _rx(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    m = jnp.stack([o, z, z, z, c, -s, z, s, c], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _ry(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    m = jnp.stack([c, z, s, z, o, z, -s, z, c], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _rz(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    m = jnp.stack([c, -s, z, s, c, z, z, z, o], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def euler_to_rotmat(euler: jax.Array, axes: str = "sxyz") -> jax.Array:
    """Euler angles (..., 3) -> rotation matrix (..., 3, 3).

    'sxyz': extrinsic x-y-z, R = Rz @ Ry @ Rx  (tf euler_matrix(..., 'sxyz')).
    'rxyz': intrinsic x-y-z, R = Rx @ Ry @ Rz  (tf euler_matrix(..., 'rxyz')).
    """
    ax, ay, az = euler[..., 0], euler[..., 1], euler[..., 2]
    if axes == "sxyz":
        return _rz(az) @ _ry(ay) @ _rx(ax)
    if axes == "rxyz":
        return _rx(ax) @ _ry(ay) @ _rz(az)
    raise ValueError(f"unsupported euler convention: {axes}")


def rotmat_to_euler(R: jax.Array, axes: str = "sxyz") -> jax.Array:
    """Rotation matrix (..., 3, 3) -> euler angles (..., 3) for 'sxyz'/'rxyz'.

    Gimbal-lock-safe (falls back to a consistent solution with the third/first
    angle zeroed when the middle angle is +-pi/2).
    """
    eps = 1e-7
    if axes == "rxyz":
        # R = Rx(a) Ry(b) Rz(c):
        #   R[0,2] = sb;  R[1,2] = -sa*cb;  R[2,2] = ca*cb
        #   R[0,1] = -cb*sc;  R[0,0] = cb*cc
        sb = jnp.clip(R[..., 0, 2], -1.0, 1.0)
        b = jnp.arcsin(sb)
        cb = jnp.cos(b)
        safe = jnp.abs(cb) > eps
        a = jnp.where(safe, jnp.arctan2(-R[..., 1, 2], R[..., 2, 2]), jnp.arctan2(R[..., 2, 1], R[..., 1, 1]))
        c = jnp.where(safe, jnp.arctan2(-R[..., 0, 1], R[..., 0, 0]), jnp.zeros_like(b))
        return jnp.stack([a, b, c], axis=-1)
    if axes == "sxyz":
        # R = Rz(c) Ry(b) Rx(a):
        #   R[2,0] = -sb;  R[2,1] = cb*sa;  R[2,2] = cb*ca
        #   R[1,0] = sc*cb;  R[0,0] = cc*cb
        sb = jnp.clip(-R[..., 2, 0], -1.0, 1.0)
        b = jnp.arcsin(sb)
        cb = jnp.cos(b)
        safe = jnp.abs(cb) > eps
        a = jnp.where(safe, jnp.arctan2(R[..., 2, 1], R[..., 2, 2]), jnp.zeros_like(b))
        c = jnp.where(safe, jnp.arctan2(R[..., 1, 0], R[..., 0, 0]), jnp.arctan2(-R[..., 0, 1], R[..., 1, 1]))
        return jnp.stack([a, b, c], axis=-1)
    raise ValueError(f"unsupported euler convention: {axes}")


# ---------------------------------------------------------------------------
# SE(3) 4x4 homogeneous transforms
# ---------------------------------------------------------------------------

def make_se3(R: jax.Array, t: jax.Array) -> jax.Array:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def from_translation_quaternion(t: jax.Array, q_xyzw: jax.Array) -> jax.Array:
    """TUM-style (t, q) -> 4x4 (reference: pose_estimation_module.py:15-23)."""
    return make_se3(quat_to_rotmat(q_xyzw), t)


def from_translation_euler(t: jax.Array, euler: jax.Array, axes: str = "sxyz") -> jax.Array:
    """Translation + euler -> 4x4 = T @ R (reference make_transform_mat,
    visual_odometry_v3.py:138-142: translation_matrix(t) @ euler_matrix(euler))."""
    return make_se3(euler_to_rotmat(euler, axes=axes), t)


def rotation(T: jax.Array) -> jax.Array:
    return T[..., :3, :3]


def translation(T: jax.Array) -> jax.Array:
    """(..., 4, 4) -> (..., 3) (reference: pose_estimation_module.py:26-28)."""
    return T[..., :3, 3]


def to_translation_quaternion(T: jax.Array) -> tuple[jax.Array, jax.Array]:
    """4x4 -> (t (...,3), q xyzw (...,4)) — the TUM line payload."""
    return translation(T), rotmat_to_quat(rotation(T))


def inverse(T: jax.Array) -> jax.Array:
    """Exact SE(3) inverse: [R t]^-1 = [R^T  -R^T t]."""
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make_se3(Rt, -(Rt @ t[..., None])[..., 0])


def adjoint(T: jax.Array) -> jax.Array:
    """SE(3) adjoint (..., 6, 6) for [v, w]-ordered twists:
    Adj(T) [v; w] = [R v + hat(t) R w; R w], i.e. [[R, hat(t)R], [0, R]].
    Satisfies T exp(xi) T^-1 = exp(Adj(T) xi)."""
    R = rotation(T)
    tx = _hat(translation(T))
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, tx @ R], axis=-1)
    bot = jnp.concatenate([zero, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def ad(xi: jax.Array) -> jax.Array:
    """se(3) small adjoint (..., 6, 6) for [v, w] twists:
    ad(xi) = [[hat(w), hat(v)], [0, hat(w)]]."""
    vx = _hat(xi[..., :3])
    wx = _hat(xi[..., 3:])
    zero = jnp.zeros_like(wx)
    top = jnp.concatenate([wx, vx], axis=-1)
    bot = jnp.concatenate([zero, wx], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def compose(*Ts: jax.Array) -> jax.Array:
    """Chain 4x4 transforms left-to-right: compose(A, B, C) = A @ B @ C."""
    out = Ts[0]
    for T in Ts[1:]:
        out = out @ T
    return out


def marker_to_marker(prev_cTm: jax.Array, curr_cTm: jax.Array) -> jax.Array:
    """inv(prev) @ curr (reference: pose_estimation_module.py:68-71)."""
    return inverse(prev_cTm) @ curr_cTm


def camera_to_camera(prev_cTm: jax.Array, curr_cTm: jax.Array) -> jax.Array:
    """prev @ inv(curr) (reference: pose_estimation_module.py:74-77)."""
    return prev_cTm @ inverse(curr_cTm)


def gt_relative(prev_cTm: jax.Array, curr_cTm: jax.Array) -> jax.Array:
    """curr @ inv(prev) — the GT cam-to-cam convention the current driver uses
    (reference: trajectory_evaluation_dual_process.py:134-137)."""
    return curr_cTm @ inverse(prev_cTm)


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = rotation(T)
    t = translation(T)
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def velocity_between_timestamps(
    prev_T: jax.Array, curr_T: jax.Array, prev_t: jax.Array, curr_t: jax.Array
) -> jax.Array:
    """Finite-difference 'velocity' 4x4 between two stamped poses.

    Behavioural parity with the reference (pose_estimation_module.py:94-111),
    which packs (t_curr - t_prev)/dt and the **element-wise** rotation-matrix
    difference quotient into a 4x4 — documented there as a quirk; we keep the
    translation part (a genuine linear velocity) and the same element-wise
    rotation rate so downstream TUM velocity streams match.
    """
    dt = jnp.maximum(curr_t - prev_t, 1e-9)
    dT = (translation(curr_T) - translation(prev_T)) / dt[..., None]
    dR = (rotation(curr_T) - rotation(prev_T)) / dt[..., None, None]
    return make_se3(dR, dT)


# ---------------------------------------------------------------------------
# se(3) exp/log — used by the BA / pose-graph backend (new vs reference)
# ---------------------------------------------------------------------------

def _hat(w: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    m = jnp.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _sinc(x: jax.Array) -> jax.Array:
    """sin(x)/x with a Taylor-guarded double-where (value- and JVP-safe)."""
    small = jnp.abs(x) < 1e-3
    x_safe = jnp.where(small, 1.0, x)
    return jnp.where(small, 1.0 - x * x / 6.0, jnp.sin(x_safe) / x_safe)


def _exp_coeff_A(theta):
    """sin(t)/t."""
    return _sinc(theta)


def _exp_coeff_B(theta):
    """(1-cos t)/t^2 = 0.5*sinc(t/2)^2 — cancellation-free in f32.

    The naive (1-cos)/t^2 form loses ~half the mantissa for moderate t, which
    is amplified badly in forward-mode JVPs (autodiff-built Gauss-Newton
    Jacobians came out 50% wrong in f32 before this rewrite).
    """
    s = _sinc(0.5 * theta)
    return 0.5 * s * s


def _exp_coeff_C(theta):
    """(1 - sinc t)/t^2: Taylor series below 1 rad (cancellation-free), exact
    trig beyond (where 1 - sinc is O(1) and safe)."""
    t2 = theta * theta
    series = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    theta_safe = jnp.where(theta < 1.0, 1.0, theta)
    exact = (1.0 - jnp.sin(theta_safe) / theta_safe) / (theta_safe * theta_safe)
    return jnp.where(theta < 1.0, series, exact)


def _log_coeff(theta):
    """(1 - (t/2) cot(t/2)) / t^2: series below 1 rad, half-angle exact form
    beyond. This is the 'coef' of V^-1 in se3_log."""
    t2 = theta * theta
    series = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    theta_safe = jnp.where(theta < 1.0, 2.0, theta)  # keep tan well-defined
    half = 0.5 * theta_safe
    exact = (1.0 - half * jnp.cos(half) / jnp.sin(half)) / (theta_safe * theta_safe)
    return jnp.where(theta < 1.0, series, exact)


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3). Taylor-safe."""
    theta = jnp.sqrt(jnp.maximum(jnp.sum(w * w, axis=-1), 1e-24))
    A = _exp_coeff_A(theta)
    B = _exp_coeff_B(theta)
    W = _hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation (..., 3, 3) -> axis-angle (..., 3). Safe near 0 and pi, and
    GRADIENT-safe: uniformly the quaternion route w = qv * 2*atan2(|qv|, qw)/|qv|
    with a Taylor-guarded double-where at |qv| -> 0. (The arccos(trace) form has
    an infinite derivative at theta = 0, which poisons autodiff-built
    Gauss-Newton systems — see backend/pose_graph.py.)"""
    q = rotmat_to_quat(R)  # canonical hemisphere, qw >= 0
    qv = q[..., :3]
    qw = jnp.maximum(q[..., 3], 1e-12)
    qn2 = jnp.sum(qv * qv, axis=-1)
    small = qn2 < 1e-10
    qn_safe = jnp.sqrt(jnp.where(small, 1.0, qn2))
    # factor = 2*atan2(qn, qw)/qn, Taylor 2/qw * (1 - qn^2/(3 qw^2)) near 0.
    factor = jnp.where(
        small,
        2.0 / qw * (1.0 - qn2 / (3.0 * qw * qw)),
        2.0 * jnp.arctan2(qn_safe, qw) / qn_safe,
    )
    return qv * factor[..., None]


def se3_exp(xi: jax.Array) -> jax.Array:
    """Twist (..., 6) [v, w] -> 4x4. v = translational, w = rotational part."""
    v, w = xi[..., :3], xi[..., 3:]
    theta = jnp.sqrt(jnp.maximum(jnp.sum(w * w, axis=-1), 1e-24))
    A = _exp_coeff_A(theta)
    B = _exp_coeff_B(theta)
    C = _exp_coeff_C(theta)
    W = _hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = I + A[..., None, None] * W + B[..., None, None] * (W @ W)
    V = I + B[..., None, None] * W + C[..., None, None] * (W @ W)
    return make_se3(R, (V @ v[..., None])[..., 0])


def se3_log(T: jax.Array) -> jax.Array:
    """4x4 -> twist (..., 6) [v, w]; inverse of se3_exp.

    V^-1 = I - W/2 + coef(theta) W^2 with the cancellation-free _log_coeff,
    so values AND f32 forward-mode JVPs are accurate (GN backends autodiff
    through this)."""
    R = rotation(T)
    t = translation(T)
    w = so3_log(R)
    theta = jnp.sqrt(jnp.maximum(jnp.sum(w * w, axis=-1), 1e-24))
    W = _hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    coef = _log_coeff(theta)
    Vinv = I - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)
