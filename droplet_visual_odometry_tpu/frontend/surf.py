"""SURF-mode frontend: Hessian-determinant blobs + 64-d gradient descriptor.

Completes the reference's three-way feature-mode switch — 'orb' / 'sift' /
'surf' (cv.xfeatures2d.SURF_create(400) at visual_odometry_v3.py:102-107).
Capability parity the batched way, not an OpenCV clone:

  * detector: scale-normalised determinant-of-Hessian response
    det(H) = Lxx*Lyy - (0.9*Lxy)^2 (the 0.9 is Bay's box-filter correction
    constant, kept for response parity) evaluated at a geometric ladder of
    sigmas as whole-image tensor ops — the batched analog of SURF's
    box-filter octaves. The per-pixel response is the max over scales; NMS +
    fixed-K top-k follow, exactly like the FAST path.
  * descriptor: SURF's 64-d shape — 4x4 spatial cells x (sum dx, sum |dx|,
    sum dy, sum |dy|) of oriented gradient samples over a rotated 16x16 grid.
    Rotation reuses the discrete-angle-bin pre-rotated grid of the SIFT
    frontend (sift.py:75-95); the cell accumulation is the same static
    one-hot contraction. L2-normalised (SURF's contrast invariance).

Matching: float descriptors -> matcher.l2_matrix (one matrix product) with the
Lowe ratio test, the reference's float-mode matcher shape (v3:223-230).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.frontend import filters
from droplet_visual_odometry_tpu.frontend.fast import Keypoints, nms3x3, select_topk
from droplet_visual_odometry_tpu.frontend.orb import (
    ANGLE_BINS,
    HALF,
    extract_patches,
    orientation,
)
from droplet_visual_odometry_tpu.frontend.sift import (
    _CELL_ONEHOT,
    _GRID_INDICES,
    _SPATIAL_W,
)

N_CELLS = 4
N_DIM = N_CELLS * N_CELLS * 4  # 64

# Intra-octave geometric sigma ladder ~ SURF's 9/15/21 box sizes
# (sigma ≈ 1.2 * size/9); the octave pyramid in detect_and_describe extends
# the effective ladder 2x per octave (1.2..3.2 x {1,2,4} spans ~10x), and —
# unlike a flat ladder — descriptors are sampled at the DETECTING octave's
# resolution, so a blob found at sigma 6.4 gets a 2x-wider descriptor
# support than one found at 1.2 (scale-adapted, like the ORB/SIFT paths).
SIGMAS = (1.2, 2.0, 3.2)


def hessian_response(img: jax.Array, sigmas=SIGMAS) -> jax.Array:
    """Scale-normalised det-of-Hessian response, max over the sigma ladder.

    Second derivatives by central differences of the sigma-blurred image;
    sigma^4 normalisation makes responses comparable across scales (standard
    scale-space normalisation — det(H) is 4th-order in derivatives).
    """
    img = img.astype(jnp.float32)
    best = None
    for s in sigmas:
        g = filters.gaussian_blur(img, sigma=s, radius=int(3 * s + 0.5))
        # Central differences; jnp.gradient handles the borders.
        gy, gx = jnp.gradient(g)
        gxy, gxx = jnp.gradient(gx)
        gyy, _ = jnp.gradient(gy)
        det = (gxx * gyy - (0.9 * gxy) ** 2) * (s**4)
        best = det if best is None else jnp.maximum(best, det)
    return jnp.maximum(best, 0.0)  # SURF keeps positive-determinant blobs


def detect_blobs(img: jax.Array, k: int = 512, threshold: float = 1.0) -> Keypoints:
    """Hessian blob detection: response -> NMS -> top-k (fixed shape)."""
    resp = hessian_response(img)
    h, w = resp.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (yy >= HALF) & (yy < h - HALF) & (xx >= HALF) & (xx < w - HALF)
    resp = jnp.where(inside & (resp > threshold), resp, 0.0)
    return select_topk(nms3x3(resp), k)


def describe(img_blur: jax.Array, kps: Keypoints) -> tuple[jax.Array, jax.Array]:
    """(K,) keypoints -> (K, 64) SURF-shape descriptors + (K,) angles."""
    patches = extract_patches(img_blur, kps.xy)  # (K, P, P)
    ang = orientation(patches)
    two_pi = 2.0 * jnp.pi
    bin_idx = jnp.mod(jnp.round(ang / two_pi * ANGLE_BINS), ANGLE_BINS).astype(
        jnp.int32
    )

    gy = jnp.gradient(patches, axis=1)
    gx = jnp.gradient(patches, axis=2)
    flat_gy = gy.reshape(gy.shape[0], -1)
    flat_gx = gx.reshape(gx.shape[0], -1)

    sample_idx = jnp.asarray(_GRID_INDICES)[bin_idx]  # (K, 256) rotated grid positions
    sgy = jnp.take_along_axis(flat_gy, sample_idx, axis=1)
    sgx = jnp.take_along_axis(flat_gx, sample_idx, axis=1)

    # Rotate gradients into the keypoint frame (rotation invariance).
    a = (two_pi * bin_idx.astype(jnp.float32) / ANGLE_BINS)[:, None]
    c, s = jnp.cos(a), jnp.sin(a)
    rgx = (c * sgx + s * sgy) * _SPATIAL_W[None, :]
    rgy = (-s * sgx + c * sgy) * _SPATIAL_W[None, :]

    # Per-cell (sum dx, sum |dx|, sum dy, sum |dy|): one contraction per
    # channel against the static position->cell matrix.
    chans = jnp.stack([rgx, jnp.abs(rgx), rgy, jnp.abs(rgy)], axis=-1)  # (K,256,4)
    desc = jnp.einsum("kpc,pm->kmc", chans, _CELL_ONEHOT, precision="highest")
    desc = desc.reshape(-1, N_DIM)
    desc = desc / (jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-8)
    return desc, ang


@functools.partial(jax.jit, static_argnames=("k", "threshold", "n_octaves"))
def detect_and_describe(
    img: jax.Array, k: int = 512, threshold: float = 1.0, n_octaves: int = 3
):
    """(H, W) frame -> SURF Features (desc is (K, 64) f32).

    Octave pyramid (same structure as the SIFT frontend): each octave runs
    the intra-octave Hessian sigma ladder AND describes at its own
    resolution on a static per-octave budget summing to exactly k, with
    coordinates mapped back to full-resolution pixels. Describing on the
    detecting octave is what makes the descriptor scale-adapted — the fixed
    37-px patch covers 2^o times more image at octave o, so a blob detected
    at a coarse scale is described by its full support, not its centre
    texture. n_octaves=1 runs the single-resolution intra-octave ladder only
    (SIGMAS = 1.2/2.0/3.2 — the former flat ladder's sigma=5.0 rung now lives
    in octave 1 as 2.0 * 2^1 + downsampling, so single-octave callers do not
    get it).
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
