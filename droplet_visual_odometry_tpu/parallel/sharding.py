"""Multi-device sharding: mesh construction + data-parallel VO.

The reference has no parallelism of any kind (SURVEY.md §2: single-process,
frame-sequential; the only concurrency is ROS callback scheduling). The
scaling model here is jax.sharding over a device mesh:

  * `frames` axis — embarrassingly data-parallel work (frontend feature
    extraction, pair-wise matching + RANSAC over many frame pairs at once,
    e.g. offline mapping / multi-sequence evaluation).
  * `hyp` axis — RANSAC hypothesis parallelism within a pair (vmapped
    hypotheses are already one batched op per chip; sharding the batch spreads
    it across chips when a single pair must be solved fastest).
  * backend/ BA shards landmarks across devices and reduces Schur complement
    blocks with psum — see backend/distributed_ba.py.

All entry points take an explicit Mesh so tests can run them on the 8-device
virtual CPU mesh (tests/conftest.py) while production uses the host's GPUs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from droplet_visual_odometry_tpu.estimation.vo import VOConfig, two_frame_vo
from droplet_visual_odometry_tpu.frontend.features import detect_and_describe


def make_mesh(n_devices: int | None = None, axis_name: str = "frames") -> Mesh:
    """1-D device mesh over the first n_devices available devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.asarray(devs[:n_devices]), (axis_name,))


def global_array(mesh: Mesh, spec: P, arr) -> jax.Array:
    """Build a global device array under (mesh, spec) from a FULL host copy.

    Single-process: a plain device_put. Multi-process (jax.distributed): each
    process serves the shards it addresses from its own full copy via
    make_array_from_callback — the standard way to materialise inputs on a
    global mesh when every host computes/loads the same logical array (our
    synthetic batches and replicated scalars). Data-parallel production
    ingest would pass per-host slices instead; the callback form covers both.
    """
    sh = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sh)
    host = np.asarray(arr)
    return jax.make_array_from_callback(host.shape, sh, lambda idx: host[idx])


def pair_vo_batched(
    key: jax.Array,
    frames_prev: jax.Array,  # (B, H, W)
    frames_curr: jax.Array,  # (B, H, W)
    corners_prev: jax.Array,  # (B, 4, 2)
    corners_curr: jax.Array,  # (B, 4, 2)
    marker_valid: jax.Array,  # (B,)
    K: jax.Array,
    real_marker_length: float,
    cfg: VOConfig,
) -> jax.Array:
    """vmapped two-frame VO over a batch of pairs -> (B, 4, 4) relative poses.

    Pure function of its inputs; shard the B axis over a mesh with
    `shard_pair_vo` for multi-chip data parallelism.
    """

    def one(k, fp, fc, cp, cc, mv):
        feats_p = detect_and_describe(
            fp, k=cfg.n_keypoints, threshold=cfg.fast_threshold, arc_length=cfg.fast_arc_length
        )
        feats_c = detect_and_describe(
            fc, k=cfg.n_keypoints, threshold=cfg.fast_threshold, arc_length=cfg.fast_arc_length
        )
        res = two_frame_vo(k, feats_p, feats_c, cp, cc, mv, K, real_marker_length, cfg)
        return res.rel

    keys = jax.random.split(key, frames_prev.shape[0])
    return jax.vmap(one)(
        keys, frames_prev, frames_curr, corners_prev, corners_curr, marker_valid
    )


def shard_pair_vo(
    mesh: Mesh,
    key: jax.Array,
    frames_prev: jax.Array,
    frames_curr: jax.Array,
    corners_prev: jax.Array,
    corners_curr: jax.Array,
    marker_valid: jax.Array,
    K: jax.Array,
    real_marker_length: float,
    cfg: VOConfig,
) -> jax.Array:
    """Data-parallel pair VO: batch axis sharded over the mesh's first axis.

    Uses jit with explicit NamedShardings (XLA SPMD partitioning); per-pair
    work is independent so no collectives are inserted — frames ride HBM of
    their home chip only.
    """
    axis = mesh.axis_names[0]
    data_sh = NamedSharding(mesh, P(axis))
    repl_sh = NamedSharding(mesh, P())

    def fn(key, fp, fc, cp, cc, mv, K):
        return pair_vo_batched(key, fp, fc, cp, cc, mv, K, real_marker_length, cfg)

    jfn = jax.jit(
        fn,
        in_shardings=(repl_sh, data_sh, data_sh, data_sh, data_sh, data_sh, repl_sh),
        out_shardings=data_sh,
    )
    if jax.process_count() > 1:
        # Host-local arrays cannot be auto-placed onto non-addressable
        # devices; build true global arrays first (DCN path, launch.py).
        key = global_array(mesh, P(), key)
        frames_prev = global_array(mesh, P(axis), frames_prev)
        frames_curr = global_array(mesh, P(axis), frames_curr)
        corners_prev = global_array(mesh, P(axis), corners_prev)
        corners_curr = global_array(mesh, P(axis), corners_curr)
        marker_valid = global_array(mesh, P(axis), marker_valid)
        K = global_array(mesh, P(), K)
    return jfn(key, frames_prev, frames_curr, corners_prev, corners_curr, marker_valid, K)
