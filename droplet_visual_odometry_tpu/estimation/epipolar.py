"""Two-view epipolar geometry: batched 8-point essential matrices, Sampson
error, and E -> (R, t) recovery with cheirality voting.

Batched replacement for cv.findEssentialMat / cv.recoverPose
(reference: visual_odometry_v3.py:297-306). OpenCV runs a sequential 5-point
RANSAC in C++; here a *batch* of 8-point hypotheses is solved simultaneously —
the normal-matrix build is one einsum, the null-space extraction one batched
eigh, and inlier scoring one batched Sampson evaluation — so thousands of
hypotheses cost a few large dense ops (see ransac.py).

Conventions (OpenCV-compatible):
  * points are given in pixel coords of the prev (1) and curr (2) frames.
  * E satisfies x2^T E x1 = 0 in normalized camera coords.
  * recover_pose returns (R, t): p_curr = R @ p_prev + t, |t| = 1 —
    i.e. the curr_T_prev transform, matching cv.recoverPose.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.ops import linalg as fast_linalg


def to_normalized(pts_px: jax.Array, K: jax.Array) -> jax.Array:
    """Pixel (..., 2) -> normalized homogeneous camera coords (..., 3)."""
    x = (pts_px[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts_px[..., 1] - K[1, 2]) / K[1, 1]
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def _hartley_normalize(x: jax.Array, w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Weighted Hartley normalisation of homogeneous points (..., N, 3).

    Returns (x_normalised, T) with T (..., 3, 3) s.t. x_norm = x @ T^T.
    Weights w (..., N) mask invalid points.
    """
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mean = jnp.sum(x[..., :2] * w[..., None], axis=-2, keepdims=True) / wsum[..., None]
    centred = x[..., :2] - mean
    rms = jnp.sqrt(
        jnp.sum(jnp.sum(centred**2, axis=-1) * w, axis=-1, keepdims=True) / wsum / 2.0
    )
    s = 1.0 / jnp.maximum(rms, 1e-9)
    mx = mean[..., 0, 0]
    my = mean[..., 0, 1]
    sb = s[..., 0]
    zeros = jnp.zeros_like(sb)
    ones = jnp.ones_like(sb)
    T = jnp.stack(
        [sb, zeros, -sb * mx, zeros, sb, -sb * my, zeros, zeros, ones], axis=-1
    ).reshape(x.shape[:-2] + (3, 3))
    xn = jnp.concatenate([centred * s[..., None], x[..., 2:]], axis=-1)
    return xn, T


def essential_8point(
    x1: jax.Array,
    x2: jax.Array,
    w: jax.Array,
    enforce_rank2: bool = True,
    hartley: bool = True,
    eig_iters: int = 3,
) -> jax.Array:
    """Weighted 8-point algorithm, batched over leading dims.

    x1, x2: (..., N, 3) normalized homogeneous correspondences (N >= 8).
    w:      (..., N) weights/mask.
    Returns E (..., 3, 3); with enforce_rank2, singular values are projected
    to (1, 1, 0). Hypothesis *scoring* can skip the projection (Sampson error
    ranks raw solutions just as well) — RANSAC enforces on the winner only.

    hartley=False skips the per-sample Hartley normalisation. Callers that do
    so MUST pre-condition the inputs themselves: RANSAC normalises ONCE
    globally over the full matched set (O(N), not O(B*8)) and maps each
    candidate E back with two 3x3 matmuls — raw normalized-camera coords are
    NOT well-conditioned enough for the fixed-cost eigensolver below (the
    off-centre dolly sequence in test_frontend.py regressed 2x in ATE when
    the per-hypothesis solves ran unnormalised). The full-set polish keeps
    hartley=True.

    Uses fixed-cost inverse iteration + unrolled Cholesky instead of
    jnp.linalg.eigh, whose iterative solver hits worst-case iteration counts on
    exactly-rank-8 minimal-sample normal matrices (ops/linalg.py).

    eig_iters: inverse-iteration count. The RANSAC stage is LATENCY-bound on
    these unrolled solve chains (PERF.md); hypothesis solves pass 1 (each
    iteration contracts the eigvec error by ~(eps/lambda_2) ~ 1e-5, so one
    step never changes a Sampson ranking — accuracy gate: the full parity
    matrix, tests/test_parity.py), while polish solves keep the default 3.
    """
    if hartley:
        x1n, T1 = _hartley_normalize(x1, w)
        x2n, T2 = _hartley_normalize(x2, w)
    else:
        x1n, x2n = x1, x2

    # A rows: kron(x2, x1): [x2x*x1, x2y*x1, x1] -> (..., N, 9)
    A = (x2n[..., :, None] * x1n[..., None, :]).reshape(x1.shape[:-1] + (9,))
    Aw = A * w[..., None]
    AtA = jnp.einsum("...ni,...nj->...ij", Aw, A)
    e = fast_linalg.smallest_eigvec(AtA, iters=eig_iters)
    E = e.reshape(e.shape[:-1] + (3, 3))

    if hartley:
        # Undo normalisation: x2^T E x1 = x2n^T En x1n with xin = Ti xi.
        E = jnp.swapaxes(T2, -1, -2) @ E @ T1

    if enforce_rank2:
        E = project_to_essential(E)
    return E


def project_to_essential(E: jax.Array) -> jax.Array:
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, S, Vt = fast_linalg.svd3x3(E)
    d = jnp.ones_like(S).at[..., 2].set(0.0)
    return U @ (d[..., :, None] * Vt)


def sampson_error(E: jax.Array, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """First-order geometric (Sampson) error, batched.

    E: (..., 3, 3); x1, x2: strictly (N, 3) — batched/broadcast point arrays
    are NOT supported (the dot_general layout below assumes 2-D points).

    Structured as three clean 2-D dot_generals with (..., 3, N) / (..., N)
    outputs: the naive einsum formulation materialises (..., N, 3)
    intermediates whose layout transposes dominated the RANSAC stage —
    the epipolar dot x2^T E x1 is instead one (..., 9) x (9, N) matmul
    against the precomputable kron rows, and the two gradient-norm terms
    keep the (..., 3, N) layout.
    Accumulation dtype follows the input (>= f32), so f64 callers under
    jax_enable_x64 keep full precision (advisor r4).
    """
    nd = E.ndim
    acc = jnp.promote_types(E.dtype, jnp.float32)
    # x2^T E x1 for all (hypothesis, point): vec(E) . kron(x2, x1).
    Ef = E.reshape(E.shape[:-2] + (9,))
    A = (x2[:, :, None] * x1[:, None, :]).reshape(x1.shape[0], 9)  # (N, 9)
    num_s = jax.lax.dot_general(
        Ef, A, (((nd - 2,), (1,)), ((), ())), preferred_element_type=acc
    )  # (..., N)
    # (E x1)_i and (E^T x2)_j rows, kept as (..., 3, N) — no transposes.
    Ex1 = jax.lax.dot_general(
        E, x1, (((nd - 1,), (1,)), ((), ())), preferred_element_type=acc
    )
    Etx2 = jax.lax.dot_general(
        E, x2, (((nd - 2,), (1,)), ((), ())), preferred_element_type=acc
    )
    den = (
        Ex1[..., 0, :] ** 2
        + Ex1[..., 1, :] ** 2
        + Etx2[..., 0, :] ** 2
        + Etx2[..., 1, :] ** 2
    )
    return num_s**2 / jnp.maximum(den, 1e-12)


def decompose_essential(E: jax.Array) -> tuple[jax.Array, jax.Array]:
    """E -> four (R, t) candidates: (..., 4, 3, 3) and (..., 4, 3)."""
    U, _, Vt = fast_linalg.svd3x3(E)
    # Proper rotations: flip sign if det < 0.
    U = U * jnp.sign(jnp.linalg.det(U))[..., None, None]
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))[..., None, None]
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = jnp.stack([R1, R1, R2, R2], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return Rs, ts


def triangulate_two_view(
    R: jax.Array, t: jax.Array, x1: jax.Array, x2: jax.Array
) -> jax.Array:
    """Midpoint-free linear triangulation in normalized coords, batched.

    Camera 1 at [I|0], camera 2 at [R|t]. x1, x2: (..., N, 3) rays.
    Returns (..., N, 3) points in camera-1 coords. Uses the homogeneous DLT
    normal equations solved in closed form per point (4x4 eigh).
    """
    # Rows of P1 = [I|0], P2 = [R|t].
    # DLT matrix per point: [x1x*P1_3 - P1_1; x1y*P1_3 - P1_2; x2x*P2_3 - P2_1; ...]
    batch = jnp.broadcast_shapes(R.shape[:-2], x1.shape[:-2])
    N = x1.shape[-2]
    P2 = jnp.concatenate([R, t[..., :, None]], axis=-1)  # (..., 3, 4)
    I0 = jnp.concatenate(
        [jnp.eye(3, dtype=R.dtype), jnp.zeros((3, 1), R.dtype)], axis=-1
    )
    P1 = jnp.broadcast_to(I0, batch + (3, 4))
    P2 = jnp.broadcast_to(P2, batch + (3, 4))
    x1 = jnp.broadcast_to(x1, batch + (N, 3))
    x2 = jnp.broadcast_to(x2, batch + (N, 3))

    def rows(P, x):
        # (..., N, 2, 4)
        p0 = P[..., 0, :][..., None, :]  # (..., 1, 4)
        p1 = P[..., 1, :][..., None, :]
        p2 = P[..., 2, :][..., None, :]
        r1 = x[..., 0][..., None] * p2 - p0  # (..., N, 4)
        r2 = x[..., 1][..., None] * p2 - p1
        return jnp.stack([r1, r2], axis=-2)

    A = jnp.concatenate([rows(P1, x1), rows(P2, x2)], axis=-2)  # (..., N, 4, 4)
    # Inhomogeneous DLT (fix w = 1): solve the 3x3 normal equations with the
    # fixed-cost unrolled Cholesky. Valid for finite points, which is all the
    # cheirality vote needs; avoids eigh's data-dependent iteration count.
    M = A[..., :3]
    d = A[..., 3]
    MtM = jnp.einsum("...ki,...kj->...ij", M, M)
    Mtd = jnp.einsum("...ki,...k->...i", M, d)
    tr = (MtM[..., 0, 0] + MtM[..., 1, 1] + MtM[..., 2, 2])[..., None, None]
    reg = 1e-7 * tr * jnp.eye(3, dtype=A.dtype)
    return fast_linalg.solve_spd(MtM + reg, -Mtd)


def recover_pose(
    E: jax.Array, x1: jax.Array, x2: jax.Array, w: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Choose the (R, t) of the four E decompositions with the best cheirality
    vote (points in front of both cameras) — cv.recoverPose parity
    (reference call: visual_odometry_v3.py:303-306).

    Returns (R (3,3), t (3,), in_front (N,) bool for the winning pose).
    """
    Rs, ts = decompose_essential(E)  # (4, 3, 3), (4, 3)
    X1 = triangulate_two_view(Rs, ts, x1[None], x2[None])  # (4, N, 3)
    z1 = X1[..., 2]
    X2 = jnp.einsum("cij,cnj->cni", Rs, X1) + ts[:, None, :]
    z2 = X2[..., 2]
    front = (z1 > 0) & (z2 > 0)
    votes = jnp.sum(front * w[None], axis=-1)
    best = jnp.argmax(votes)
    return Rs[best], ts[best], front[best]
