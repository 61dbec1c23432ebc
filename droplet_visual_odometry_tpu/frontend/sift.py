"""Float-descriptor (SIFT-mode) frontend — scale-space blobs + gradient
histograms, fully batched.

The reference switches feature modes by string: 'orb' vs 'sift'/'knn_sift'
(cv.SIFT_create) and 'surf' (cv.SURF_create(400)) at
visual_odometry_v3.py:93-107, with Lowe-ratio KNN matching for the float
modes (v3:223-230). This module supplies the float-descriptor capability the
batched way — capability parity, not an OpenCV clone:

  * detector: difference-of-Gaussians blob response |DoG| at a mid scale,
    3x3 NMS + top-k (fixed K) — scale-space extrema as whole-image tensor
    ops instead of per-octave scalar scans;
  * descriptor: the standard SIFT shape — 4x4 spatial cells x 8 orientation
    bins = 128-d gradient histogram over a rotated patch, Gaussian-weighted,
    L2-normalised, 0.2-clipped, renormalised. Rotation reuses the
    discrete-angle-bin trick of the binary frontend (orb.py:56-74): the
    sample grid is pre-rotated into ANGLE_BINS orientations and the keypoint
    picks its bin;
  * histogram accumulation is two one-hot contractions (positions
    -> cells is a static matrix; positions -> orientation bins is computed
    per keypoint), instead of scatter-adds.

Matching uses matcher.match on float descriptors (L2-squared via one
matrix product). The reference pairs SIFT with NORM_L1 brute force (v3:101-104) — an
arbitrary metric choice there; L2 is the standard SIFT metric and maps to a
matrix product, so that is what we build.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.frontend import filters
from droplet_visual_odometry_tpu.frontend.fast import Keypoints, nms3x3, select_topk
from droplet_visual_odometry_tpu.frontend.orb import (
    ANGLE_BINS,
    HALF,
    PATCH,
    extract_patches,
    orientation,
)

N_CELLS = 4  # 4x4 spatial grid
N_ORI = 8  # orientation bins
N_DIM = N_CELLS * N_CELLS * N_ORI  # 128
GRID = 16  # 16x16 gradient samples per patch
SPACING = 2  # sample spacing in pixels (covers 32px, inside the 37px patch)


def dog_response(img: jax.Array, sigma: float = 1.6, k: float = 1.6) -> jax.Array:
    """|DoG| blob response within one octave: max over two adjacent DoG
    scales |G(k*s) - G(s)| for s in {sigma, k*sigma} — scale sampling inside
    the octave; octave coverage comes from the pyramid in detect_and_describe."""
    img = img.astype(jnp.float32)
    g1 = filters.gaussian_blur(img, sigma=sigma, radius=int(3 * sigma + 0.5))
    g2 = filters.gaussian_blur(img, sigma=sigma * k, radius=int(3 * sigma * k + 0.5))
    g3 = filters.gaussian_blur(
        img, sigma=sigma * k * k, radius=int(3 * sigma * k * k + 0.5)
    )
    return jnp.maximum(jnp.abs(g2 - g1), jnp.abs(g3 - g2))


def detect_blobs(img: jax.Array, k: int = 512, threshold: float = 1.0) -> Keypoints:
    """DoG blob detection: response -> NMS -> top-k (fixed shape)."""
    resp = dog_response(img)
    h, w = resp.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    # Exclude the descriptor-patch border up front.
    inside = (yy >= HALF) & (yy < h - HALF) & (xx >= HALF) & (xx < w - HALF)
    resp = jnp.where(inside & (resp > threshold), resp, 0.0)
    return select_topk(nms3x3(resp), k)


def _rotated_grid_indices() -> np.ndarray:
    """(ANGLE_BINS, GRID*GRID) patch indices of the rotated 16x16 sample grid.

    Same pre-rotation trick as orb._rotated_pattern_indices (orb.py:56-74).
    """
    # Grid offsets centred at 0: positions -15..15 step 2 (16 samples/axis).
    coords = (np.arange(GRID) - (GRID - 1) / 2.0) * SPACING
    dy, dx = np.meshgrid(coords, coords, indexing="ij")
    out = np.empty((ANGLE_BINS, GRID * GRID), np.int32)
    for b in range(ANGLE_BINS):
        a = 2.0 * np.pi * b / ANGLE_BINS
        c, s = np.cos(a), np.sin(a)
        ry = np.round(s * dx + c * dy).astype(np.int32)
        rx = np.round(c * dx - s * dy).astype(np.int32)
        ry = np.clip(ry, -HALF, HALF) + HALF
        rx = np.clip(rx, -HALF, HALF) + HALF
        out[b] = (ry * PATCH + rx).reshape(-1)
    return out


# Module-level constants stay NUMPY: this module is imported lazily, and the
# first import can happen INSIDE a jit trace (pipeline -> run_sequence with
# frontend='sift'), where a module-level jnp.asarray would capture the
# ambient trace and leak a tracer into the global (UnexpectedTracerError on
# the next trace). jnp ops lift numpy operands to constants per-trace.
_GRID_INDICES = _rotated_grid_indices()


def _cell_onehot() -> np.ndarray:
    """(GRID*GRID, 16) static position->cell assignment (4x4 cells of 4x4)."""
    onehot = np.zeros((GRID * GRID, N_CELLS * N_CELLS), np.float32)
    for gy in range(GRID):
        for gx in range(GRID):
            cell = (gy // 4) * N_CELLS + (gx // 4)
            onehot[gy * GRID + gx, cell] = 1.0
    return onehot


_CELL_ONEHOT = _cell_onehot()


def _spatial_weight() -> np.ndarray:
    """Gaussian weight over the 16x16 grid (sigma = half window)."""
    coords = (np.arange(GRID) - (GRID - 1) / 2.0) * SPACING
    dy, dx = np.meshgrid(coords, coords, indexing="ij")
    w = np.exp(-(dy * dy + dx * dx) / (2.0 * (GRID * SPACING / 2.0) ** 2))
    return w.reshape(-1).astype(np.float32)


_SPATIAL_W = _spatial_weight()


def describe(img_blur: jax.Array, kps: Keypoints) -> tuple[jax.Array, jax.Array]:
    """(K,) keypoints -> (K, 128) float descriptors + (K,) angles.

    img_blur: Gaussian-blurred frame (the same sigma~2 blur the binary
    descriptor uses — one blur serves both frontends).
    """
    patches = extract_patches(img_blur, kps.xy)  # (K, P, P)
    ang = orientation(patches)
    two_pi = 2.0 * jnp.pi
    bin_idx = jnp.mod(jnp.round(ang / two_pi * ANGLE_BINS), ANGLE_BINS).astype(jnp.int32)

    # Patch gradients (central differences), flattened.
    gy = jnp.gradient(patches, axis=1)
    gx = jnp.gradient(patches, axis=2)
    flat_gy = gy.reshape(gy.shape[0], -1)
    flat_gx = gx.reshape(gx.shape[0], -1)

    # Rotated sample positions per keypoint.
    sample_idx = jnp.asarray(_GRID_INDICES)[bin_idx]  # (K, 256)
    sgy = jnp.take_along_axis(flat_gy, sample_idx, axis=1)
    sgx = jnp.take_along_axis(flat_gx, sample_idx, axis=1)

    # Rotate gradient vectors into the keypoint frame.
    a = (two_pi * bin_idx.astype(jnp.float32) / ANGLE_BINS)[:, None]
    c, s = jnp.cos(a), jnp.sin(a)
    rgx = c * sgx + s * sgy
    rgy = -s * sgx + c * sgy

    mag = jnp.sqrt(rgx * rgx + rgy * rgy + 1e-12) * _SPATIAL_W[None, :]
    theta = jnp.arctan2(rgy, rgx)  # (-pi, pi]
    obin = jnp.mod(jnp.floor((theta + jnp.pi) / (two_pi / N_ORI)), N_ORI).astype(jnp.int32)
    ori_onehot = jax.nn.one_hot(obin, N_ORI, dtype=jnp.float32)  # (K, 256, 8)

    # positions->cells (static) x positions->orientations (dynamic): one product.
    desc = jnp.einsum(
        "kp,pc,kpo->kco", mag, _CELL_ONEHOT, ori_onehot, precision="highest"
    ).reshape(-1, N_DIM)

    # SIFT normalisation: L2 -> clip 0.2 -> L2.
    desc = desc / (jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-8)
    desc = jnp.minimum(desc, 0.2)
    desc = desc / (jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-8)
    return desc, ang


@functools.partial(jax.jit, static_argnames=("k", "threshold", "n_octaves"))
def detect_and_describe(
    img: jax.Array, k: int = 512, threshold: float = 1.0, n_octaves: int = 3
):
    """(H, W) frame -> float-descriptor Features (desc is (K, 128) f32).

    Real scale-space (the reference's SIFT is genuinely scale-invariant,
    v3:100): intra-octave DoG scale sampling (dog_response) x a power-of-two
    octave pyramid. Each octave detects + describes at its own resolution on
    a static per-octave keypoint budget (geometric split, summing to exactly
    k); coordinates map back to full-resolution pixels. n_octaves=1 is the
    round-1 single-scale behavior.
    """
    from droplet_visual_odometry_tpu.frontend.features import level_budgets
    from droplet_visual_odometry_tpu.frontend.orb import Features

    img = img.astype(jnp.float32)
    h0, w0 = img.shape
    # Keep every octave at least 64px/axis (descriptor patch is 37px).
    while n_octaves > 1 and min(h0, w0) // 2 ** (n_octaves - 1) < 64:
        n_octaves -= 1
    budgets = level_budgets(k, n_octaves, 2.0) if n_octaves > 1 else [k]

    parts = []
    oct_img = img
    for o in range(n_octaves):
        if o > 0:
            oct_img = filters.downsample2(oct_img)
        lh, lw = oct_img.shape
        kps = detect_blobs(oct_img, k=budgets[o], threshold=threshold)
        blur = filters.gaussian_blur(oct_img, sigma=2.0, radius=4)
        desc, ang = describe(blur, kps)
        x, y = kps.xy[:, 0], kps.xy[:, 1]
        interior = (x >= HALF) & (x < lw - HALF) & (y >= HALF) & (y < lh - HALF)
        scale = float(2**o)  # downsample2 decimates [::2]: level x -> 2^o * x
        parts.append(
            Features(
                xy=kps.xy * scale,
                score=kps.score,
                angle=ang,
                desc=desc,
                valid=kps.valid & interior,
            )
        )
    if n_octaves == 1:
        return parts[0]
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)
