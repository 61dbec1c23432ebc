"""Image filtering primitives: separable Gaussian blur and image pyramid.

Separable 1-D passes keep the work low-rank (2*k taps instead of k^2).
Replaces the pyramid hidden inside cv.ORB_create's detectAndCompute
(reference: visual_odometry_v3.py:96, 373).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=32)
def _gaussian_taps(sigma: float, radius: int) -> tuple[float, ...]:
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def _pad_replicate(a: jax.Array, r: int, axis: int) -> jax.Array:
    first = jnp.take(a, jnp.asarray([0]), axis=axis)
    last = jnp.take(a, jnp.asarray([a.shape[axis] - 1]), axis=axis)
    return jnp.concatenate(
        [jnp.repeat(first, r, axis=axis), a, jnp.repeat(last, r, axis=axis)], axis=axis
    )


def gaussian_blur(
    img: jax.Array,
    sigma: float = 2.0,
    radius: int | None = None,
    compute_dtype: jnp.dtype | None = None,
) -> jax.Array:
    """Separable Gaussian blur of (..., H, W) float images (edge-replicated).

    Implemented as shift-and-add (2*(2r+1) scaled slice-adds), not as
    lax.conv: the shift form is pure elementwise work that XLA fuses into
    one pass per axis.

    compute_dtype=bfloat16 halves the HBM traffic of this bandwidth-bound
    stage (output cast back to the input dtype). Right for consumers that
    binarise smoothed intensities (ORB descriptor sampling: ~0.4% rounding on
    a [0, 255] surface); keep f32 where small DIFFERENCES matter (SIFT DoG).
    """
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    taps = _gaussian_taps(float(sigma), radius)
    in_dtype = img.dtype
    if compute_dtype is not None:
        img = img.astype(compute_dtype)

    h, w = img.shape[-2], img.shape[-1]
    x = _pad_replicate(img, radius, img.ndim - 2)
    acc = None
    for i, t in enumerate(taps):
        sl = jax.lax.slice_in_dim(x, i, i + h, axis=img.ndim - 2) * t
        acc = sl if acc is None else acc + sl
    x = _pad_replicate(acc, radius, img.ndim - 1)
    acc = None
    for i, t in enumerate(taps):
        sl = jax.lax.slice_in_dim(x, i, i + w, axis=img.ndim - 1) * t
        acc = sl if acc is None else acc + sl
    if compute_dtype is not None and acc.dtype != in_dtype:
        acc = acc.astype(in_dtype)
    return acc


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int):
    """(n_in, n_out) antialiased triangle-kernel weights, columns sum to 1.

    Output pixel i samples input at c = (i + 0.5) * scale - 0.5 with a
    triangle of half-width max(scale, 1) — the same pixel-center convention
    and antialias rule as jax.image.resize(method='linear', antialias=True).
    """
    import numpy as np

    scale = n_in / n_out
    support = max(scale, 1.0)
    c = (np.arange(n_out) + 0.5) * scale - 0.5
    j = np.arange(n_in)
    w = np.maximum(0.0, 1.0 - np.abs(j[:, None] - c[None, :]) / support)
    w /= w.sum(axis=0, keepdims=True)
    return w.astype(np.float32)


def resize_bilinear(img: jax.Array, new_h: int, new_w: int) -> jax.Array:
    """Antialiased linear resize of (..., H, W) to (..., new_h, new_w).

    Two separable weight matmuls (one per spatial axis) rather than gathers,
    for the pyramid's non-integer scale steps. Runs in bfloat16 with f32
    accumulation (not exact): half the memory traffic of f32, and pixel
    values 0..255 round to <=0.5 intensity (far below the FAST threshold of
    20), so detection/description downstream are unaffected.
    """
    h, w = img.shape[-2], img.shape[-1]
    Wh = jnp.asarray(_resize_weights(h, new_h), jnp.bfloat16)
    Ww = jnp.asarray(_resize_weights(w, new_w), jnp.bfloat16)
    t = jnp.einsum(
        "...hw,hk->...kw", img.astype(jnp.bfloat16), Wh,
        preferred_element_type=jnp.float32,
    )
    return jnp.einsum(
        "...kw,wl->...kl", t.astype(jnp.bfloat16), Ww,
        preferred_element_type=jnp.float32,
    )


def downsample2(img: jax.Array) -> jax.Array:
    """Blur + 2x decimate one pyramid step for (..., H, W)."""
    b = gaussian_blur(img, sigma=1.0, radius=2)
    return b[..., ::2, ::2]


def build_pyramid(img: jax.Array, n_levels: int) -> list[jax.Array]:
    """Power-of-two Gaussian pyramid: [level0 (full res), level1 (H/2), ...]."""
    out = [img]
    for _ in range(n_levels - 1):
        out.append(downsample2(out[-1]))
    return out
