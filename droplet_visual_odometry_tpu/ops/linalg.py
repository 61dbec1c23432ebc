"""Small-matrix batched linear algebra as fixed-cost elementwise programs.

XLA's jnp.linalg.{eigh, svd} are iterative (Jacobi or QR sweeps inside a
while_loop) with DATA-DEPENDENT cost: on the near-singular normal matrices
that robust estimation produces (an 8-point minimal sample has an exactly
rank-8 AtA) they run to worst-case iteration counts. These routines replace
them in hot paths with FIXED-cost, fully vectorised programs: unrolled
Cholesky factorisation (Python loops over the static 9x9 index space emit one
fused elementwise graph over the batch) and a few inverse-iteration steps,
with deterministic latency.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_unrolled(A: jax.Array, eps: float = 0.0) -> jax.Array:
    """Batched Cholesky of (..., n, n) SPD matrices, unrolled at trace time.

    n must be a static (small) dimension. Returns lower-triangular L with
    A + eps*I = L L^T. No pivoting; caller guarantees positive-definiteness
    (add eps for semi-definite input).
    """
    n = A.shape[-1]
    cols: list[list[jax.Array]] = [[None] * n for _ in range(n)]  # L[i][j]
    for j in range(n):
        s = A[..., j, j] + eps
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-30))
        cols[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - cols[i][k] * cols[j][k]
            cols[i][j] = s * inv_d
    rows = []
    zero = jnp.zeros_like(A[..., 0, 0])
    for i in range(n):
        rows.append(jnp.stack([cols[i][j] if j <= i else zero for j in range(n)], axis=-1))
    return jnp.stack(rows, axis=-2)


def cholesky_solve(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve (L L^T) x = b with unrolled forward/back substitution.

    L: (..., n, n) lower-triangular; b: (..., n). Static small n.
    """
    n = L.shape[-1]
    # Forward: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    # Backward: L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)


def solve_spd(A: jax.Array, b: jax.Array, eps: float = 0.0) -> jax.Array:
    """Solve SPD (..., n, n) @ x = (..., n) via unrolled Cholesky."""
    return cholesky_solve(cholesky_unrolled(A, eps=eps), b)


def smallest_eigvec(AtA: jax.Array, iters: int = 3) -> jax.Array:
    """Eigenvector of the smallest eigenvalue of SPSD (..., n, n), batched.

    Inverse iteration with a trace-relative Tikhonov shift: each step solves
    (AtA + eps*I) v = v_prev with the unrolled Cholesky. Convergence factor
    (lambda_min + eps) / (lambda_next + eps) is tiny for the near-rank-deficient
    matrices of minimal-sample estimation, so 2-3 iterations suffice.
    Fixed cost; replaces jnp.linalg.eigh(...)[1][..., 0] in hot paths.
    """
    n = AtA.shape[-1]
    tr = jnp.trace(AtA, axis1=-2, axis2=-1)
    # Shift large enough that f32 Cholesky of an exactly singular (or, for
    # degenerate repeated-point samples, rank-deficient) matrix stays positive
    # definite; inverse iteration still contracts by ~1e-5 per step.
    eps = (1e-5 * tr / n + 1e-30)[..., None, None] * jnp.eye(n, dtype=AtA.dtype)
    L = cholesky_unrolled(AtA + eps)
    v = jnp.ones(AtA.shape[:-1], AtA.dtype)
    for _ in range(iters):
        v = cholesky_solve(L, v)
        norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
        v = jnp.where(jnp.isfinite(norm) & (norm > 0), v / jnp.maximum(norm, 1e-30), jnp.ones_like(v) / (n**0.5))
    return v


def svd3x3(E: jax.Array, jacobi_sweeps: int = 6) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Fixed-cost batched SVD of (..., 3, 3) via one-sided Jacobi rotations.

    Returns (U, S, Vt) with S descending, like jnp.linalg.svd but with a
    static unrolled sweep count (no data-dependent while_loop).
    """
    V = jnp.broadcast_to(jnp.eye(3, dtype=E.dtype), E.shape)
    A = E
    # One-sided Jacobi: orthogonalise columns of A, accumulating V.
    for _ in range(jacobi_sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            ap = A[..., :, p]
            aq = A[..., :, q]
            app = jnp.sum(ap * ap, axis=-1)
            aqq = jnp.sum(aq * aq, axis=-1)
            apq = jnp.sum(ap * aq, axis=-1)
            # Jacobi rotation angle
            tau = (aqq - app) / (2.0 * jnp.where(jnp.abs(apq) < 1e-30, 1e-30, apq))
            t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
            t = jnp.where(jnp.abs(apq) < 1e-30, 0.0, t)
            c = 1.0 / jnp.sqrt(1.0 + t * t)
            s = c * t
            new_p = c[..., None] * ap - s[..., None] * aq
            new_q = s[..., None] * ap + c[..., None] * aq
            A = A.at[..., :, p].set(new_p).at[..., :, q].set(new_q)
            vp = V[..., :, p]
            vq = V[..., :, q]
            V = (
                V.at[..., :, p].set(c[..., None] * vp - s[..., None] * vq)
                .at[..., :, q].set(s[..., None] * vp + c[..., None] * vq)
            )
    S = jnp.linalg.norm(A, axis=-2)  # column norms
    # Sort descending.
    order = jnp.argsort(-S, axis=-1)
    S = jnp.take_along_axis(S, order, axis=-1)
    A = jnp.take_along_axis(A, order[..., None, :], axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    U0 = A[..., :, 0] / jnp.maximum(S[..., 0:1], 1e-30)
    U1 = A[..., :, 1] / jnp.maximum(S[..., 1:2], 1e-30)
    # Third left vector via cross product (robust when s3 ~ 0, the essential case).
    U2 = jnp.cross(U0, U1)
    U2 = U2 / jnp.maximum(jnp.linalg.norm(U2, axis=-1, keepdims=True), 1e-30)
    # The cross imposes a right-handed U. When the orthogonalised matrix's
    # actual third column points the OTHER way (a tie-breaking sort
    # permutation with near-equal singular values can leave det(A_sorted)
    # = -1 — hit in practice on rotation-matrix input, where all three
    # singular values tie at 1), V's third column must flip with it or
    # U S V^T reconstructs a reflection of the input. sign(dot)=0 (the
    # rank-deficient essential case, s3 ~ 0) keeps the old convention.
    s3 = jnp.sign(jnp.sum(A[..., :, 2] * U2, axis=-1))
    s3 = jnp.where(s3 == 0, 1.0, s3)
    V = V.at[..., :, 2].multiply(s3[..., None])
    U = jnp.stack([U0, U1, U2], axis=-1)
    return U, S, jnp.swapaxes(V, -1, -2)
