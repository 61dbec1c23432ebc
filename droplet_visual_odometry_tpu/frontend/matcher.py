"""Descriptor matching: Hamming distances as a matrix product + cross-check/ratio tests.

Replaces cv.BFMatcher(NORM_HAMMING, crossCheck)/FLANN knnMatch + Lowe ratio
(reference: visual_odometry_v3.py:75, 191-239). The O(K^2) distance matrix —
OpenCV's scalar XOR/popcount loop — becomes one 256-deep matmul of +-1-expanded
descriptors on the tensor cores: dot(a, b) = 256 - 2*hamming(a, b), exact in
bf16 x bf16 -> f32. Mutual-best cross-check and the Lowe ratio test are
fixed-shape argmin/top-k reductions.

All matchers return fixed-shape (K,) per-query results with a validity mask —
the fixed-shape analog of OpenCV's variable-length DMatch lists.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.frontend.orb import N_BITS, unpack_bits_pm1

BIG = jnp.float32(1e9)


def hamming_matrix(
    desc_a: jax.Array, desc_b: jax.Array, valid_a: jax.Array | None = None, valid_b: jax.Array | None = None
) -> jax.Array:
    """(Ka, 8) x (Kb, 8) packed descriptors -> (Ka, Kb) float32 Hamming distances.

    Invalid rows/cols are filled with BIG so downstream argmins never pick them.
    """
    a = unpack_bits_pm1(desc_a)
    b = unpack_bits_pm1(desc_b)
    dot = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    ham = 0.5 * (N_BITS - dot)
    if valid_a is not None:
        ham = jnp.where(valid_a[:, None], ham, BIG)
    if valid_b is not None:
        ham = jnp.where(valid_b[None, :], ham, BIG)
    return ham


def l2_matrix(
    desc_a: jax.Array, desc_b: jax.Array, valid_a: jax.Array | None = None, valid_b: jax.Array | None = None
) -> jax.Array:
    """(Ka, D) x (Kb, D) FLOAT descriptors -> (Ka, Kb) squared-L2 distances.

    |a-b|^2 = |a|^2 + |b|^2 - 2 a.b: one matrix product + rank-1 corrections —
    the float-mode twin of hamming_matrix for SIFT-style descriptors
    (the reference's SIFT/KNN modes, v3:100-104, 223-230).
    """
    dot = jax.lax.dot_general(
        desc_a, desc_b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    na = jnp.sum(desc_a.astype(jnp.float32) ** 2, axis=1)
    nb = jnp.sum(desc_b.astype(jnp.float32) ** 2, axis=1)
    d2 = jnp.maximum(na[:, None] + nb[None, :] - 2.0 * dot, 0.0)
    if valid_a is not None:
        d2 = jnp.where(valid_a[:, None], d2, BIG)
    if valid_b is not None:
        d2 = jnp.where(valid_b[None, :], d2, BIG)
    return d2


class Matches(NamedTuple):
    """Fixed-shape match set: for each query keypoint (in frame A), the matched
    train index (frame B), the Hamming distance, and validity."""

    idx: jax.Array  # (Ka,) int32 index into frame B keypoints
    distance: jax.Array  # (Ka,) float32
    valid: jax.Array  # (Ka,) bool


def match_crosscheck(dist: jax.Array, max_distance: float = 256.0) -> Matches:
    """Mutual-nearest-neighbour matching — cv.BFMatcher(crossCheck=True) parity
    (the reference's 'orb' mode, v3:75, 217-221)."""
    best_b = jnp.argmin(dist, axis=1)  # (Ka,)
    best_a = jnp.argmin(dist, axis=0)  # (Kb,)
    d = jnp.take_along_axis(dist, best_b[:, None], axis=1)[:, 0]
    ka = dist.shape[0]
    rows = jnp.arange(ka, dtype=best_b.dtype)
    mutual = best_a[best_b] == rows
    ok = mutual & (d <= max_distance) & (d < BIG)
    return Matches(idx=best_b.astype(jnp.int32), distance=d, valid=ok)


def match_ratio(dist: jax.Array, ratio: float = 0.75, max_distance: float = 256.0) -> Matches:
    """Lowe ratio-test matching — knnMatch(k=2) + 0.75 ratio parity
    (the reference's SIFT/KNN modes, v3:223-230)."""
    neg2, idx2 = jax.lax.top_k(-dist, 2)  # two smallest distances
    d1 = -neg2[:, 0]
    d2 = -neg2[:, 1]
    ok = (d1 < ratio * d2) & (d1 <= max_distance) & (d1 < BIG)
    return Matches(idx=idx2[:, 0].astype(jnp.int32), distance=d1, valid=ok)


def match(
    desc_a: jax.Array,
    desc_b: jax.Array,
    valid_a: jax.Array | None = None,
    valid_b: jax.Array | None = None,
    mode: str = "crosscheck",
    ratio: float = 0.75,
    max_distance: float = 256.0,
) -> Matches:
    """One-call matcher. mode: 'crosscheck' (reference 'orb') or 'ratio'
    (reference 'sift'/'knn_sift' Lowe test)."""
    if jnp.issubdtype(desc_a.dtype, jnp.floating):
        # Float (SIFT-mode) descriptors: squared-L2 distance matrix. Ratio
        # thresholds are specified on true distances, so square them here.
        dist = l2_matrix(desc_a, desc_b, valid_a, valid_b)
        if mode == "crosscheck":
            return match_crosscheck(dist, max_distance=BIG / 2)
        if mode == "ratio":
            return match_ratio(dist, ratio=ratio * ratio, max_distance=BIG / 2)
        raise ValueError(f"unknown match mode: {mode}")

    dist = hamming_matrix(desc_a, desc_b, valid_a, valid_b)
    if mode == "crosscheck":
        return match_crosscheck(dist, max_distance)
    if mode == "ratio":
        return match_ratio(dist, ratio, max_distance)
    raise ValueError(f"unknown match mode: {mode}")


def gather_correspondences(
    xy_a: jax.Array, xy_b: jax.Array, m: Matches
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Matched coordinate pairs (fixed shape): (Ka,2) prev pts, (Ka,2) curr pts,
    (Ka,) mask — the analog of the reference's matched keypoint extraction
    (v3:233-238: queryIdx -> previous, trainIdx -> current)."""
    pts_b = xy_b[m.idx]
    return xy_a, pts_b, m.valid
