"""Per-frame feature extraction: multi-scale detect + orient + describe.

The analog of the reference's compute_current_image_elements
(visual_odometry_v3.py:370-379) — but batched, fixed-shape, and computed ONCE
per frame (the reference re-detects every frame twice per pair since pairs
overlap, v3:387-392; our sequence pipeline carries features forward instead).

Scale space: cv.ORB_create() detects over an 8-level 1.2x image pyramid
(v3:96). The fixed-shape equivalent here is a geometric pyramid with a
per-level keypoint budget: each level is an antialiased resize of the
previous one (two weight matmuls — filters.resize_bilinear), detection,
NMS, top-k, blur and description all run at the level's resolution with the
SAME fixed-shape kernels as level 0, and keypoint coordinates are mapped back
to level-0 pixels. Per-level budgets follow OpenCV's nfeatures-per-level
geometric split (factor 1/scale per level) but are STATIC, so the
concatenated output is exactly K keypoints — downstream shapes are unchanged
whatever n_levels is. Descriptors are computed on the level image, which is
what makes matching survive scale change (approach/dolly motion — the
BlueROV's dominant motion, frame_extraction_notes.txt).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.frontend import fast, filters
from droplet_visual_odometry_tpu.frontend.orb import (
    Features,
    HALF,
    describe_batch,
)

# Pyramid defaults, tuned on the synthetic dolly benchmark (correct matches
# under a 1.48x scale change, cv2.ORB_create()=30 on the same pair):
#   4 x 1.41: 21   5 x 1.41: 23   4 x 1.32: 34   4 x 1.2: 37
# Scale SAMPLING density matters more than range; 4 x 1.32 beats cv2 at a
# 2.1x level-0 pixel cost (vs 2.5x for 1.2 steps) and spans 2.3x scale.
N_LEVELS = 4
SCALE_FACTOR = 1.32


def level_shapes(
    h: int, w: int, n_levels: int, scale_factor: float
) -> list[tuple[int, int]]:
    """Static per-level (H_l, W_l). Levels never shrink below 64 px per axis
    (or the input size if smaller): the descriptor patch is 37 px, and patch
    origins must stay non-negative."""
    out = [(h, w)]
    for l in range(1, n_levels):
        s = scale_factor**l
        out.append(
            (
                max(int(round(h / s)), min(64, h)),
                max(int(round(w / s)), min(64, w)),
            )
        )
    return out


def level_budgets(k: int, n_levels: int, scale_factor: float) -> list[int]:
    """Static per-level keypoint counts summing exactly to k (OpenCV's
    geometric nfeatures split: level l gets ~k * scale^-l / norm)."""
    raw = [scale_factor ** (-l) for l in range(n_levels)]
    total = sum(raw)
    ks = [max(int(round(k * r / total)), 8) for r in raw]
    ks[0] += k - sum(ks)
    if ks[0] < 8:
        raise ValueError(f"keypoint budget {k} too small for {n_levels} levels")
    return ks


def _orb_level(
    level_imgs: jax.Array,  # (N, H_l, W_l) float32
    k_level: int,
    threshold: float,
    arc_length: int,
    h0: int,
    w0: int,
) -> Features:
    """Detect + describe one pyramid level; coords mapped to level-0 pixels."""
    n, lh, lw = level_imgs.shape
    score = fast.score_batch(level_imgs, threshold, arc_length)
    kps = jax.vmap(lambda s: fast.select_topk_rows(fast.nms3x3(s), k_level))(score)
    blur = filters.gaussian_blur(
        level_imgs, sigma=2.0, radius=4, compute_dtype=jnp.bfloat16
    )
    desc, ang = describe_batch(blur, kps.xy)

    # Border check in LEVEL pixels (the descriptor patch lives at this level).
    x, y = kps.xy[..., 0], kps.xy[..., 1]
    interior = (x >= HALF) & (x < lw - HALF) & (y >= HALF) & (y < lh - HALF)

    # Sub-pixel peak localisation on the RAW score map (the NMS'd map has
    # zeroed neighbourhoods); descriptors above intentionally sample at the
    # integer locations (the patch grid is integer anyway), only the
    # geometry-facing coords are refined.
    xy_ref = jax.vmap(fast.subpixel_refine)(score, kps.xy)
    xr, yr = xy_ref[..., 0], xy_ref[..., 1]

    # Level -> level-0 coords under resize's pixel-center convention:
    # output pixel i samples input at (i + 0.5) * scale - 0.5.
    sx, sy = w0 / lw, h0 / lh
    xy0 = jnp.stack([(xr + 0.5) * sx - 0.5, (yr + 0.5) * sy - 0.5], axis=-1)
    return Features(
        xy=xy0, score=kps.score, angle=ang, desc=desc, valid=kps.valid & interior
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k",
        "threshold",
        "arc_length",
        "mode",
        "dog_threshold",
        "n_levels",
        "scale_factor",
    ),
)
def detect_and_describe_batch(
    imgs: jax.Array,
    k: int = 512,
    threshold: float = 20.0,
    arc_length: int = 9,
    mode: str = "orb",
    dog_threshold: float = 1.0,
    n_levels: int = N_LEVELS,
    scale_factor: float = SCALE_FACTOR,
) -> Features:
    """(N, H, W) frames -> Features with leading N axis, K = k total keypoints
    across all pyramid levels (coordinates in level-0 pixels).

    mode selects the frontend family (the reference's mode switch, v3:93-107):
    'orb' — FAST + 256-bit binary descriptors (Hamming matching);
    'sift' — DoG blobs + 128-d float gradient histograms (L2, frontend/sift.py);
    'surf' — Hessian blobs + 64-d gradient descriptor (L2, frontend/surf.py).

    Natively batched: each level's corner response is ONE launch over all N
    frames (fast.score_batch), the blur is one batched shift-and-add, and
    only the small per-keypoint stages (top-k, patch gather, descriptor
    matmul) are per-level. n_levels=1 is the single-scale frontend.
    """
    if mode == "sift":
        from droplet_visual_odometry_tpu.frontend import sift

        return jax.vmap(
            functools.partial(sift.detect_and_describe, k=k, threshold=dog_threshold)
        )(imgs)
    if mode == "surf":
        from droplet_visual_odometry_tpu.frontend import surf

        return jax.vmap(
            functools.partial(surf.detect_and_describe, k=k, threshold=dog_threshold)
        )(imgs)
    if mode != "orb":
        raise ValueError(f"unknown frontend mode: {mode}")

    imgs = imgs.astype(jnp.float32)
    n, h0, w0 = imgs.shape
    shapes = level_shapes(h0, w0, n_levels, scale_factor)
    budgets = level_budgets(k, n_levels, scale_factor)

    parts = []
    level_imgs = imgs
    for l in range(n_levels):
        if l > 0:
            lh, lw = shapes[l]
            level_imgs = filters.resize_bilinear(level_imgs, lh, lw)
        parts.append(
            _orb_level(level_imgs, budgets[l], threshold, arc_length, h0, w0)
        )
    if n_levels == 1:
        return parts[0]
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=1), *parts)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k",
        "threshold",
        "arc_length",
        "mode",
        "dog_threshold",
        "n_levels",
        "scale_factor",
    ),
)
def detect_and_describe(
    img: jax.Array,
    k: int = 512,
    threshold: float = 20.0,
    arc_length: int = 9,
    mode: str = "orb",
    dog_threshold: float = 1.0,
    n_levels: int = N_LEVELS,
    scale_factor: float = SCALE_FACTOR,
) -> Features:
    """(H, W) frame -> fixed-K Features. Single-frame wrapper over the batch
    path (identical results; the batch kernels handle N=1)."""
    feats = detect_and_describe_batch(
        img[None],
        k=k,
        threshold=threshold,
        arc_length=arc_length,
        mode=mode,
        dog_threshold=dog_threshold,
        n_levels=n_levels,
        scale_factor=scale_factor,
    )
    return jax.tree_util.tree_map(lambda a: a[0], feats)
