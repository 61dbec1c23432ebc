"""Camera model: pinhole intrinsics + plumb_bob distortion, on-device undistortion.

Replaces the reference's OpenCV camera frontend (visual_odometry_v3.py:110-135
`cv.undistort` + `cv.getOptimalNewCameraMatrix`, and parse_camera_intrinsics at
visual_odometry_v3.py:145-167 with its two YAML schemas selected by the
`controlled` flag).

Design: undistortion is a *precomputed remap grid* (computed once per camera,
host- or device-side) plus a batched bilinear gather — the gather is vmappable
over frames and fuses into the frontend pipeline, instead of OpenCV's per-frame
CPU remap.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with plumb_bob (Brown-Conrady k1 k2 p1 p2 k3) distortion."""

    K: jax.Array  # (3, 3) intrinsic matrix
    dist: jax.Array  # (5,) [k1, k2, p1, p2, k3]
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]


def make_camera(fx, fy, cx, cy, dist=None, width=1440, height=1080) -> Camera:
    K = jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=jnp.float32)
    d = jnp.zeros((5,), jnp.float32) if dist is None else jnp.asarray(dist, jnp.float32)
    return Camera(K=K, dist=d, width=int(width), height=int(height))


def load_calibration(path: str, controlled: bool = False) -> Camera:
    """Parse the two calibration YAML schemas the reference supports.

    `controlled=False`: robot schema — `distortion_coeffs`/`intrinsic_coeffs`
    nested single-row lists (reference: visual_odometry_v3.py:149-152;
    Parameters/camera_calibration.yaml:21-29).
    `controlled=True`: lab schema — `camera_matrix: {data: [...]}` /
    `distortion_coefficients: {data: [...]}` (visual_odometry_v3.py:155-167).
    """
    import yaml

    with open(path) as f:
        data: dict[str, Any] = yaml.safe_load(f)
    if not controlled:
        K = np.asarray(data["intrinsic_coeffs"][0], dtype=np.float32).reshape(3, 3)
        dist = np.asarray(data["distortion_coeffs"][0], dtype=np.float32).reshape(-1)
        width = int(data.get("image_width", 1440))
        height = int(data.get("image_height", 1080))
    else:
        K = np.asarray(data["camera_matrix"]["data"], dtype=np.float32).reshape(3, 3)
        dist = np.asarray(
            data["distortion_coefficients"]["data"], dtype=np.float32
        ).reshape(-1)
        width = int(data.get("image_width", 640))
        height = int(data.get("image_height", 480))
    dist5 = np.zeros(5, np.float32)
    dist5[: min(5, dist.size)] = dist[:5]
    return Camera(K=jnp.asarray(K), dist=jnp.asarray(dist5), width=width, height=height)


# ---------------------------------------------------------------------------
# Distortion model
# ---------------------------------------------------------------------------

def distort_normalized(pts: jax.Array, dist: jax.Array) -> jax.Array:
    """Apply plumb_bob distortion to normalized image coords (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return jnp.stack([xd, yd], axis=-1)


def undistort_points(pts_px: jax.Array, cam: Camera, new_K: jax.Array | None = None, iters: int = 8) -> jax.Array:
    """Undistort pixel coords (..., 2) by fixed-point iteration (cv.undistortPoints
    equivalent). Returns pixels under `new_K` (defaults to cam.K)."""
    K = cam.K
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xd = (pts_px[..., 0] - cx) / fx
    yd = (pts_px[..., 1] - cy) / fy
    d = jnp.stack([xd, yd], axis=-1)

    k1, k2, p1, p2, k3 = cam.dist[0], cam.dist[1], cam.dist[2], cam.dist[3], cam.dist[4]

    def body(_, p):
        x, y = p[..., 0], p[..., 1]
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return jnp.stack([(d[..., 0] - dx) * icdist, (d[..., 1] - dy) * icdist], axis=-1)

    x = jax.lax.fori_loop(0, iters, body, d)
    out_K = K if new_K is None else new_K
    u = x[..., 0] * out_K[0, 0] + out_K[0, 2]
    v = x[..., 1] * out_K[1, 1] + out_K[1, 2]
    return jnp.stack([u, v], axis=-1)


def optimal_new_camera_matrix(cam: Camera, alpha: float = 1.0) -> np.ndarray:
    """Host-side equivalent of cv.getOptimalNewCameraMatrix(alpha) for same-size
    output (reference call: visual_odometry_v3.py:117-123 with alpha=1).

    alpha=1 keeps all source pixels (outer rectangle); alpha=0 crops to valid
    pixels (inner rectangle). Computed from the undistorted positions of a
    boundary point grid, matching OpenCV's icvGetRectangles sampling (N=9 grid).
    """
    w, h = cam.width, cam.height
    n = 9
    us = np.linspace(0, w - 1, n, dtype=np.float64)
    vs = np.linspace(0, h - 1, n, dtype=np.float64)
    grid = np.stack(np.meshgrid(us, vs), axis=-1).reshape(-1, 2).astype(np.float32)
    # Undistort to *normalized* coords (new_K = identity)
    I3 = jnp.eye(3, dtype=jnp.float32)
    und = np.asarray(undistort_points(jnp.asarray(grid), cam, new_K=I3, iters=12))
    und = und.reshape(n, n, 2)

    # Outer rectangle: bounding box of all points.
    x0o, y0o = und[..., 0].min(), und[..., 1].min()
    x1o, y1o = und[..., 0].max(), und[..., 1].max()
    # Inner rectangle: per OpenCV — max of row/col mins along the border rows.
    x0i = und[:, :, 0].min(axis=1).max()  # max over rows of leftmost point
    x1i = und[:, :, 0].max(axis=1).min()
    y0i = und[:, :, 1].min(axis=0).max()
    y1i = und[:, :, 1].max(axis=0).min()

    def k_from_rect(x0, y0, x1, y1):
        fx = (w - 1) / max(x1 - x0, 1e-9)
        fy = (h - 1) / max(y1 - y0, 1e-9)
        cx = -fx * x0
        cy = -fy * y0
        return fx, fy, cx, cy

    fo = k_from_rect(x0o, y0o, x1o, y1o)
    fi = k_from_rect(x0i, y0i, x1i, y1i)
    a = float(np.clip(alpha, 0.0, 1.0))
    fx = fi[0] * (1 - a) + fo[0] * a
    fy = fi[1] * (1 - a) + fo[1] * a
    cx = fi[2] * (1 - a) + fo[2] * a
    cy = fi[3] * (1 - a) + fo[3] * a
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)


def undistort_rectify_map(cam: Camera, new_K: jax.Array) -> jax.Array:
    """Precompute the (H, W, 2) source-pixel map for undistortion under new_K
    (cv.initUndistortRectifyMap equivalent). For each destination pixel, the
    distorted source location in the original image."""
    h, w = cam.height, cam.width
    u = jnp.arange(w, dtype=jnp.float32)
    v = jnp.arange(h, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    x = (uu - new_K[0, 2]) / new_K[0, 0]
    y = (vv - new_K[1, 2]) / new_K[1, 1]
    pn = jnp.stack([x, y], axis=-1)
    pd = distort_normalized(pn, cam.dist)
    su = pd[..., 0] * cam.K[0, 0] + cam.K[0, 2]
    sv = pd[..., 1] * cam.K[1, 1] + cam.K[1, 2]
    return jnp.stack([su, sv], axis=-1)


def remap_bilinear(img: jax.Array, src_map: jax.Array) -> jax.Array:
    """Bilinear sample img (H, W) at src_map (H', W', 2) -> (H', W') float32.

    Out-of-bounds samples clamp to the border (cv.BORDER_REPLICATE-like, which
    only differs from OpenCV's constant border in the dead fringe).
    Jit-friendly: one fused gather; vmap over a leading frame axis for batches.
    """
    H, W = img.shape[-2], img.shape[-1]
    img = img.astype(jnp.float32)
    su = jnp.clip(src_map[..., 0], 0.0, W - 1.0)
    sv = jnp.clip(src_map[..., 1], 0.0, H - 1.0)
    u0 = jnp.floor(su).astype(jnp.int32)
    v0 = jnp.floor(sv).astype(jnp.int32)
    u1 = jnp.minimum(u0 + 1, W - 1)
    v1 = jnp.minimum(v0 + 1, H - 1)
    du = su - u0.astype(jnp.float32)
    dv = sv - v0.astype(jnp.float32)
    flat = img.reshape(img.shape[:-2] + (H * W,))

    def take(vi, ui):
        return jnp.take(flat, (vi * W + ui).reshape(-1), axis=-1).reshape(
            img.shape[:-2] + vi.shape
        )

    p00 = take(v0, u0)
    p01 = take(v0, u1)
    p10 = take(v1, u0)
    p11 = take(v1, u1)
    top = p00 * (1 - du) + p01 * du
    bot = p10 * (1 - du) + p11 * du
    return top * (1 - dv) + bot * dv


def undistort_image(img: jax.Array, cam: Camera, new_K: jax.Array, src_map: jax.Array | None = None) -> jax.Array:
    """Undistort one grayscale frame (H, W) (cv.undistort equivalent,
    reference: visual_odometry_v3.py:110-113)."""
    if src_map is None:
        src_map = undistort_rectify_map(cam, new_K)
    return remap_bilinear(img, src_map)


def projection_matrix(K: jax.Array, R: jax.Array | None = None, t: jax.Array | None = None) -> jax.Array:
    """P = K [R | t] (reference: visual_odometry_v3.py:165-167, 309)."""
    if R is None:
        R = jnp.eye(3, dtype=K.dtype)
    if t is None:
        t = jnp.zeros((3,), K.dtype)
    return K @ jnp.concatenate([R, t[..., :, None]], axis=-1)
