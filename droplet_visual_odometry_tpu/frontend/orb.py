"""Rotation-aware binary (rBRIEF-style) descriptors, fully batched.

Replaces the descriptor half of cv.ORB_create().detectAndCompute
(reference: visual_odometry_v3.py:96, 370-379). Design:

  * Orientation by intensity centroid (the ORB method): patch moments m01/m10.
  * Descriptor: 256 pixel-pair comparisons on a sigma~2 blurred image. The
    sampling pattern is OUR OWN deterministic pattern (seeded Gaussian pairs as
    in the original BRIEF paper) — not OpenCV's learned table — since both
    sides of every match use the same pattern, the choice only needs to be
    spread-out and fixed.
  * Steering: the pattern is pre-rotated into ANGLE_BINS discrete orientations
    (OpenCV quantises to 12 degrees as well).

The whole per-keypoint stage is one patch gather plus ONE matrix product:
extract each keypoint's 37x37 patch once (a batched dynamic_slice), then
multiply by a constant steering matrix whose columns are [disc moment weights
wy, wx] ++ [for each angle bin, 256 columns of (+1 at rotated sample p2, -1
at rotated sample p1)]. Sampling 512 scattered pixels per keypoint by scalar
gathers is avoided; the product runs on the tensor cores in bf16 with f32
accumulation. The sign of column (b, j) is exactly the BRIEF test p1 < p2
under rotation bin b; the keypoint's bin (from the moment columns of the same
product) selects the 256 relevant columns with a one-hot contraction. Bits are
packed 256 -> 8 uint32 words by a log-tree of pairwise or/shift combines.

Everything is fixed-shape: K keypoints in, (K, 8) uint32 descriptors out, with
a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.frontend.fast import Keypoints

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH = 37  # patch side; supports rotated samples with radius <= 18
HALF = PATCH // 2
PATTERN_RADIUS = 13  # max sample offset magnitude before rotation
ANGLE_BINS = 30  # 12-degree quantisation


def _make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) int offsets (dy, dx) for the two test points of each bit.

    Gaussian-distributed offsets (BRIEF-II style), clipped to the pattern
    radius, deterministic. Module-level constant.
    """
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=PATTERN_RADIUS / 2.0, size=(N_BITS, 2, 2))
    return np.clip(np.round(pts), -PATTERN_RADIUS, PATTERN_RADIUS).astype(np.int32)


_PATTERN = _make_pattern()


def _build_steer_weights() -> np.ndarray:
    """(PATCH*PATCH, 2 + ANGLE_BINS*N_BITS) steering matrix (see module doc).

    Column 0/1: intensity-centroid moment weights wy/wx over the inscribed
    disc (m01 = patch . wy, m10 = patch . wx). Columns 2 + b*N_BITS + j:
    +1 at bin-b-rotated position of test point 2 of pair j, -1 at test point 1
    (positions clipped to the patch), so patch . column > 0  <=>  p1 < p2.
    """
    w = np.zeros((PATCH * PATCH, 2 + ANGLE_BINS * N_BITS), np.float32)

    d = np.arange(PATCH, dtype=np.float32) - HALF
    yy, xx = np.meshgrid(d, d, indexing="ij")
    disc = (yy * yy + xx * xx) <= (HALF * HALF)
    w[:, 0] = np.where(disc, yy, 0.0).reshape(-1)
    w[:, 1] = np.where(disc, xx, 0.0).reshape(-1)

    dy = _PATTERN[..., 0].astype(np.float32)  # (256, 2)
    dx = _PATTERN[..., 1].astype(np.float32)
    for b in range(ANGLE_BINS):
        a = 2.0 * np.pi * b / ANGLE_BINS
        c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
        ry = np.clip(np.round(s * dx + c * dy), -HALF, HALF).astype(np.int32) + HALF
        rx = np.clip(np.round(c * dx - s * dy), -HALF, HALF).astype(np.int32) + HALF
        pos = ry * PATCH + rx  # (256, 2) indices into the flat patch
        cols = 2 + b * N_BITS + np.arange(N_BITS)
        # += so coincident p1/p2 (possible after clipping) cancel to 0 -> bit 0,
        # matching the p1 < p2 comparison convention.
        np.add.at(w, (pos[:, 1], cols), 1.0)
        np.add.at(w, (pos[:, 0], cols), -1.0)
    return w


_STEER_W = _build_steer_weights().astype(jnp.bfloat16)  # numpy (ml_dtypes bf16): see sift.py tracer-leak note


def extract_patches(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Gather (K, PATCH, PATCH) patches centred on integer-rounded keypoints.

    Keypoints near the border are clamped so the patch stays in-bounds (their
    descriptors are still produced; callers should prefer masking borderline
    keypoints out with Features.valid for matching quality).
    """
    h, w = img.shape
    ij = jnp.stack([xy[:, 1], xy[:, 0]], axis=-1)  # (K, 2) row, col
    ij = jnp.round(ij).astype(jnp.int32) - HALF
    ij = jnp.clip(ij, 0, jnp.asarray([h - PATCH, w - PATCH]))

    def one(start):
        return jax.lax.dynamic_slice(img, (start[0], start[1]), (PATCH, PATCH))

    return jax.vmap(one)(ij)


def orientation(patches: jax.Array) -> jax.Array:
    """Intensity-centroid angle per patch: atan2(m01, m10) over a centred disc.

    Float32 reference implementation (describe_batch computes the same moments
    in bfloat16 inside its fused steering matmul).
    """
    dy = jnp.arange(PATCH, dtype=jnp.float32) - HALF
    dx = jnp.arange(PATCH, dtype=jnp.float32) - HALF
    yy, xx = jnp.meshgrid(dy, dx, indexing="ij")
    disc = (yy * yy + xx * xx) <= (HALF * HALF)
    wy = jnp.where(disc, yy, 0.0)
    wx = jnp.where(disc, xx, 0.0)
    m01 = jnp.einsum("khw,hw->k", patches, wy)
    m10 = jnp.einsum("khw,hw->k", patches, wx)
    return jnp.arctan2(m01, m10)


def describe_batch(
    imgs_blur: jax.Array, xy: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """(N, H, W) blurred frames + (N, K, 2) keypoints -> packed descriptors.

    Returns ((N, K, 8) uint32 descriptors, (N, K) angles). See the module
    docstring for why this is one patch-extraction pass + one matrix product.
    """
    n, h, w = imgs_blur.shape
    k = xy.shape[1]
    imgs_blur = imgs_blur.astype(jnp.float32)

    patches = jax.vmap(extract_patches)(imgs_blur, xy)  # (N, K, P, P)
    flat_p = patches.reshape(n * k, PATCH * PATCH)

    # Exact single bf16 matmul: quantise blurred pixels to integers first —
    # every integer in [0, 256] is exactly representable in bfloat16 (7+1
    # mantissa bits), and the steering weights are small integers, so products
    # are exact and accumulate in f32. A bf16 product on UNROUNDED pixels
    # flips ~10/256 near-tie bits, which would force a hi/lo two-product
    # split; rounding the patch once removes the ties deterministically (both
    # sides of every match see the same rounded image) at half the cost.
    q = jnp.round(flat_p).astype(jnp.bfloat16)
    feats = jnp.dot(q, _STEER_W, preferred_element_type=jnp.float32)
    # (NK, 2 + 30*256) f32
    m01 = feats[:, 0]
    m10 = feats[:, 1]
    ang = jnp.arctan2(m01, m10)  # (NK,)

    two_pi = 2.0 * jnp.pi
    bin_idx = jnp.mod(jnp.round(ang / two_pi * ANGLE_BINS), ANGLE_BINS).astype(jnp.int32)

    # Select each keypoint's bin with a one-hot contraction (exact: one term
    # per output), then threshold: bit j = (patch . D[bin, j]) > 0 = (p1 < p2).
    allbits = feats[:, 2:].reshape(n * k, ANGLE_BINS, N_BITS)
    onehot = (
        bin_idx[:, None] == jnp.arange(ANGLE_BINS, dtype=jnp.int32)[None, :]
    ).astype(jnp.float32)
    bits = jnp.einsum("kbs,kb->ks", allbits, onehot) > 0  # (NK, 256) bool

    # Pack 256 bits -> 8 uint32 words with a log-tree of pairwise combines.
    v = bits.astype(jnp.uint32)
    width = 1
    while v.shape[-1] > N_WORDS:
        v = v[..., 0::2] | (v[..., 1::2] << width)
        width *= 2
    # v[..., j] holds an interleaved subset of the pattern bits — a fixed
    # bijective bit permutation, identical on both sides of every match, so
    # Hamming distances are unchanged.
    return v.reshape(n, k, N_WORDS), ang.reshape(n, k)


def describe(
    img_blur: jax.Array, kps: Keypoints
) -> tuple[jax.Array, jax.Array]:
    """Compute (K, 8) uint32 packed descriptors + (K,) angle for keypoints.

    `img_blur` must already be Gaussian-blurred (sigma~2) — done once per frame
    by the caller so the blur amortises over all keypoints. Single-frame
    convenience wrapper over describe_batch.
    """
    desc, ang = describe_batch(img_blur[None], kps.xy[None])
    return desc[0], ang[0]


class Features(NamedTuple):
    """Per-frame fixed-K feature set — the unit the matcher consumes."""

    xy: jax.Array  # (K, 2) float32
    score: jax.Array  # (K,)
    angle: jax.Array  # (K,)
    desc: jax.Array  # (K, 8) uint32 packed 256-bit descriptors
    valid: jax.Array  # (K,) bool


def unpack_bits_pm1(desc: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """(K, 8) uint32 -> (K, 256) in {-1, +1}.

    The +-1 expansion turns Hamming distance into a matrix product:
    dot(a, b) = 256 - 2*hamming(a, b). Products of +-1 are exact in bf16 and
    accumulate in f32 on the tensor cores, so this path is bit-exact.
    """
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(desc.shape[:-1] + (N_BITS,))
    return (bits.astype(jnp.float32) * 2.0 - 1.0).astype(dtype)
