"""Pallas kernel (Triton route): fused FAST-N corner response.

The XLA implementation (frontend/fast.py:fast_score) expresses the response
as a (16, H, W) stack of shifted images plus brighter/darker masks and a
31-step run-length scan; whether that stack reaches device memory is up to
XLA's fusion. This kernel computes the response per output tile directly:
each of the 16 Bresenham-circle neighbours is one masked `load` at a static
offset from the tile origin in a 3-px zero-padded frame (L1/L2 absorb the
halo reuse between neighbouring tiles), the polarity tests are packed into
one 16-bit integer ring per polarity, the contiguous-arc test is a log-step
AND-doubling on that ring, and the score is written once.

Grid: (frame, row block, column block). Blocks are powers of two; the tile
overhang at the far edges of non-multiple level shapes (1091x826, ...) is
masked on load and on store.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from droplet_visual_odometry_tpu.frontend.fast import BORDER, CIRCLE_OFFSETS

# From a sweep on an H100 at 24x1080x1440 (PERF.md): 8x128 tiles ran in
# 0.93 ms, and tiles of 4096+ pixels with 4 warps in 14-19 ms (too many live
# values per thread for the registers).
BLOCK_H = 8
BLOCK_W = 128
NUM_WARPS = 8
NUM_STAGES = 1


def _rot16(v: jax.Array, k: int) -> jax.Array:
    """Cyclic rotate of the 16-bit ring: bit j of the result = bit j+k of v."""
    return ((v >> k) | (v << (16 - k))) & 0xFFFF


def has_arc(v: jax.Array, arc_length: int) -> jax.Array:
    """True where the packed 16-bit ring holds a cyclic run of >= arc_length
    set bits.

    Log-step AND-doubling: r &= rot(r, k) doubles the run length each step,
    then arc_length is composed from its binary digits — ~20 integer ops
    instead of a 32-step sequential run-length scan. Equivalent to
    max_circular_run >= L for any L <= 16.
    """
    pows = {1: v}
    k = 1
    while k * 2 <= arc_length:
        pows[k * 2] = pows[k] & _rot16(pows[k], k)
        k *= 2
    run = None
    off = 0
    for bit in (16, 8, 4, 2, 1):
        if arc_length & bit:
            term = _rot16(pows[bit], off) if off else pows[bit]
            run = term if run is None else run & term
            off += bit
    return run != 0


def _kernel(img_ref, out_ref, *, h, w, block_h, block_w, threshold, arc_length):
    # img_ref: this frame's (h + 6, w + 6) zero-padded image; out_ref: (h, w).
    r0 = pl.program_id(1) * block_h
    c0 = pl.program_id(2) * block_w
    rows = r0 + jax.lax.broadcasted_iota(jnp.int32, (block_h, block_w), 0)
    cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (block_h, block_w), 1)
    in_tile = (rows < h) & (cols < w)

    def load(dy, dx):
        # Output pixel (y, x) sits at (y + 3, x + 3) in the padded frame, so
        # every neighbour offset is non-negative; only the overhang is masked.
        return plgpu.load(
            img_ref.at[
                pl.ds(r0 + BORDER + dy, block_h), pl.ds(c0 + BORDER + dx, block_w)
            ],
            mask=in_tile,
            other=0.0,
        )

    center = load(0, 0)
    score_b = jnp.zeros((block_h, block_w), jnp.float32)
    score_d = jnp.zeros((block_h, block_w), jnp.float32)
    pack_b = jnp.zeros((block_h, block_w), jnp.int32)
    pack_d = jnp.zeros((block_h, block_w), jnp.int32)
    for j, (dy, dx) in enumerate(CIRCLE_OFFSETS):
        nbr = load(dy, dx)
        bj = nbr > center + threshold
        dj = nbr < center - threshold
        excess = jnp.abs(nbr - center) - threshold
        score_b = score_b + jnp.where(bj, excess, 0.0)
        score_d = score_d + jnp.where(dj, excess, 0.0)
        pack_b = pack_b | jnp.where(bj, 1 << j, 0)
        pack_d = pack_d | jnp.where(dj, 1 << j, 0)

    is_corner = has_arc(pack_b, arc_length) | has_arc(pack_d, arc_length)
    interior = (
        (rows >= BORDER) & (rows < h - BORDER) & (cols >= BORDER) & (cols < w - BORDER)
    )
    score = jnp.where(is_corner & interior, jnp.maximum(score_b, score_d), 0.0)
    plgpu.store(
        out_ref.at[pl.ds(r0, block_h), pl.ds(c0, block_w)], score, mask=in_tile
    )


def _fast_score_impl(imgs, threshold, arc_length, block_h, block_w, num_warps, num_stages, interpret):
    n, h, w = imgs.shape
    padded = jnp.pad(imgs, ((0, 0), (BORDER, BORDER), (BORDER, BORDER)))
    grid = (n, pl.cdiv(h, block_h), pl.cdiv(w, block_w))
    return pl.pallas_call(
        functools.partial(
            _kernel,
            h=h,
            w=w,
            block_h=block_h,
            block_w=block_w,
            threshold=threshold,
            arc_length=arc_length,
        ),
        out_shape=jax.ShapeDtypeStruct((n, h, w), jnp.float32),
        grid=grid,
        in_specs=[pl.BlockSpec((None, h + 2 * BORDER, w + 2 * BORDER), lambda f, i, j: (f, 0, 0))],
        out_specs=pl.BlockSpec((None, h, w), lambda f, i, j: (f, 0, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=num_stages),
        interpret=interpret,
        name="fast_score_triton",
    )(padded)


@functools.lru_cache(maxsize=None)
def _batch_fn(threshold, arc_length, block_h, block_w, num_warps, num_stages, interpret):
    """(N, H, W) kernel wrapper with a custom vmap rule: the batch axis is the
    kernel's leading grid dimension already, so a vmap folds its axis into N
    (nested vmaps fold one at a time) instead of adding a grid dimension."""

    @jax.custom_batching.custom_vmap
    def run(imgs):
        return _fast_score_impl(
            imgs, threshold, arc_length, block_h, block_w, num_warps, num_stages, interpret
        )

    @run.def_vmap
    def _rule(axis_size, in_batched, imgs):  # noqa: ANN001
        if not in_batched[0]:
            return run(imgs), False
        b, n, h, w = imgs.shape
        return run(imgs.reshape(b * n, h, w)).reshape(b, n, h, w), True

    return run


def fast_score_batch(
    imgs: jax.Array, threshold: float = 20.0, arc_length: int = 9, *, interpret: bool = False
) -> jax.Array:
    """(N, H, W) float -> (N, H, W) float32 corner response, matching
    frontend.fast.fast_score frame by frame (0 for non-corners). The tiling
    is the module's BLOCK_H/BLOCK_W/NUM_WARPS/NUM_STAGES, read at trace time."""
    fn = _batch_fn(
        float(threshold), int(arc_length), BLOCK_H, BLOCK_W, NUM_WARPS, NUM_STAGES, bool(interpret)
    )
    return fn(imgs.astype(jnp.float32))
