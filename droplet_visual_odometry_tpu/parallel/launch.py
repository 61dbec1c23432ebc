"""Multi-host launch scaffolding + scaling-efficiency measurement.

The reference is a single-process pipeline with ROS pub/sub as its only IPC
(SURVEY.md §5 'distributed communication backend: absent'). The scaling
model here is jax.distributed: one process per host, devices discovered
globally, meshes spanning all hosts' GPUs, collectives over NVLink within a
host (NCCL) and the network across hosts. This module owns:

  * `initialize()` — process bring-up: jax.distributed.initialize from
    explicit args or the standard env vars (COORDINATOR_ADDRESS etc.);
    idempotent and a no-op for single-process runs, so the same entry point
    serves a laptop, one GPU host, and a multi-host cluster.
  * `global_mesh()` — host-count-aware mesh over ALL addressable devices
    (hosts x local chips flattened to the requested axes).
  * `measure_scaling()` — the north-star harness (BASELINE.md: >=80%
    scaling efficiency at 2+ hosts): weak-scaling throughput of the
    data-parallel pair-VO stage and of distributed Schur-complement BA over
    1..N devices, reporting frames/s and efficiency vs the 1-device run.
    Runs identically on the 8-device virtual CPU mesh (tests/CI) and on real
    slices.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

# NOTE: no package imports at module level beyond the (config-only) package
# root — `initialize()` must run before anything touches the XLA backend,
# and several compute modules create small device constants at import time.
# The sharding/measurement imports below are deferred into the functions.


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Bring up jax.distributed for a multi-host run. Returns True if
    multi-process mode was initialized, False for single-process.

    Args default from the conventional env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). Without a cluster manager to detect,
    all three must be given. Safe to call twice (second call is a no-op).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single-process: nothing to initialize

    # Multi-process on the CPU backend (virtual-mesh testing / CI) needs an
    # explicit cross-process collectives implementation; GPUs use NCCL and
    # ignore this.
    platforms = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    if str(platforms).startswith("cpu"):
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
    return True


def global_mesh(axis_name: str = "frames") -> jax.sharding.Mesh:
    """1-D mesh over every addressable device across all hosts."""
    return jax.sharding.Mesh(np.asarray(jax.devices()), (axis_name,))


def is_coordinator() -> bool:
    return jax.process_index() == 0


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    seconds: float
    throughput: float  # work units / s (frames/s for pair VO)
    efficiency: float  # throughput / (n_devices * throughput_1dev)


def _time_reps(fn, reps: int = 3) -> float:
    out = fn()  # compile + warmup
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def measure_scaling_pair_vo(
    device_counts: list[int] | None = None,
    pairs_per_device: int = 2,
    height: int = 96,
    width: int = 128,
    n_keypoints: int = 64,
    reps: int = 3,
) -> list[ScalePoint]:
    """Weak-scaling pair-VO throughput: each device owns `pairs_per_device`
    pairs; ideal scaling is throughput proportional to device count."""
    from droplet_visual_odometry_tpu.data import synthetic
    from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig
    from droplet_visual_odometry_tpu.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu.parallel import sharding

    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= len(devs)]
    if jax.process_count() > 1:
        # Multi-controller: every process must participate in every
        # computation, so sub-meshes that exclude a process's devices are
        # not measurable — scale over the full global mesh only.
        device_counts = [n for n in device_counts if n == len(devs)] or [len(devs)]

    max_pairs = max(device_counts) * pairs_per_device
    seq = synthetic.render_sequence(
        synthetic.SyntheticConfig(
            n_frames=max_pairs + 1, width=width, height=height, n_landmarks=60
        )
    )
    frames = jnp.asarray(seq.frames, jnp.float32)
    corners = jnp.nan_to_num(jnp.asarray(seq.marker_corners))
    mvalid = jnp.asarray(seq.marker_present)
    K = jnp.asarray(seq.camera.K, jnp.float32)
    cfg = VOConfig(
        n_keypoints=n_keypoints,
        ransac=RansacConfig(n_hypotheses=128, lo_hypotheses=32),
    )

    points: list[ScalePoint] = []
    base = None
    for n in device_counts:
        mesh = sharding.make_mesh(n)
        b = n * pairs_per_device

        def run():
            return sharding.shard_pair_vo(
                mesh,
                jax.random.PRNGKey(0),
                frames[:b],
                frames[1 : b + 1],
                corners[:b],
                corners[1 : b + 1],
                mvalid[:b] & mvalid[1 : b + 1],
                K,
                seq.real_marker_length,
                cfg,
            )

        dt = _time_reps(run, reps)
        tput = b / dt
        if base is None:
            base = tput
        points.append(
            ScalePoint(
                n_devices=n,
                seconds=dt,
                throughput=tput,
                efficiency=tput / (n * base),
            )
        )
    return points


def measure_scaling_ba(
    device_counts: list[int] | None = None,
    landmarks_per_device: int = 256,
    n_poses: int = 6,
    iters: int = 5,
    reps: int = 3,
) -> list[ScalePoint]:
    """Weak-scaling distributed Schur BA: each device owns a fixed landmark
    shard; throughput unit is landmarks/s through the LM loop."""
    from droplet_visual_odometry_tpu.backend import ba
    from droplet_visual_odometry_tpu.core import se3
    from droplet_visual_odometry_tpu.parallel import distributed_ba, sharding

    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= len(devs)]
    if jax.process_count() > 1:
        device_counts = [n for n in device_counts if n == len(devs)] or [len(devs)]

    rng = np.random.default_rng(0)
    K = jnp.asarray([[200.0, 0, 64], [0, 200.0, 48], [0, 0, 1]], jnp.float32)
    poses = np.stack(
        [
            np.asarray(
                se3.make_se3(jnp.eye(3), jnp.asarray([0.2 * w, 0.0, 0.0], jnp.float32))
            )
            for w in range(n_poses)
        ]
    )

    points_out: list[ScalePoint] = []
    base = None
    for n in device_counts:
        L = n * landmarks_per_device
        pts = rng.uniform([-1, -1, 3], [1, 1, 6], size=(L, 3)).astype(np.float32)
        _, uv = ba._project(jnp.asarray(poses), jnp.asarray(pts), K)
        window = ba.BAWindow(
            poses=jnp.asarray(poses),
            points=jnp.asarray(
                pts + rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
            ),
            obs_uv=uv,
            obs_mask=jnp.ones((n_poses, L), bool),
            K=K,
        )
        mesh = sharding.make_mesh(n, axis_name="landmarks")
        cfg = ba.BAConfig(iters=iters)

        def run():
            return distributed_ba.run_ba_distributed(mesh, window, cfg).poses

        dt = _time_reps(run, reps)
        tput = L / dt
        if base is None:
            base = tput
        points_out.append(
            ScalePoint(
                n_devices=n,
                seconds=dt,
                throughput=tput,
                efficiency=tput / (n * base),
            )
        )
    return points_out


def format_report(name: str, points: list[ScalePoint]) -> str:
    rows = [f"scaling: {name} (weak scaling — ideal efficiency = 1.0)"]
    for p in points:
        rows.append(
            f"  {p.n_devices:3d} dev  {p.seconds*1e3:9.2f} ms"
            f"  {p.throughput:10.1f} units/s  eff={p.efficiency:.2f}"
        )
    return "\n".join(rows)
