"""Experiment configuration: typed dataclasses + YAML round-trip.

Replaces the reference's positional-argv CLI (experiment_sample, matching_mode,
controlled, marker_id, real_marker_length — trajectory_evaluation_dual_process.py:
329-338) and its hard-coded absolute paths (dual_process:296-309, v3:184) with
a single serializable config object. Nested configs (VO, RANSAC) map to nested
YAML tables; unknown keys fail loudly instead of being silently dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu.estimation.vo import VOConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Everything needed to reproduce one experiment run."""

    sequence: str = ""  # VOSequence .npz path ('' -> synthetic)
    out_dir: str = ""  # where the six stamped_*.txt streams go
    marker_id: int = 0  # reference fiducial id (dual_process argv 4)
    real_marker_length: float = 0.2  # metres (dual_process argv 5)
    calibration: str = ""  # camera yaml ('' -> sequence-embedded intrinsics)
    controlled: bool = False  # calibration schema switch (v3:145-167)
    # 'none' (reference behavior) | 'ba' | 'pose_graph' (default: together
    # with scale_mode='hold' below it is the single config that beats the
    # best reference variant on every PARITY.md scenario).
    backend: str = "pose_graph"
    seed: int = 0
    checkpoint_path: str = ""  # '' disables checkpointing
    checkpoint_every: int = 0  # frames between checkpoints (0 = chunk only)
    # Experiment-level default is scale_mode='hold' (identical to the
    # reference-faithful 'marker' while a live marker scale exists; forward-
    # fills through marker gaps instead of the reference's 1.0 fallback).
    # The library-level VOConfig default stays 'marker' for reference parity.
    vo: VOConfig = VOConfig(scale_mode="hold")


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def _from_dict(cls, d: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise KeyError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    kwargs = {}
    for name, value in d.items():
        ftype = fields[name].type
        target = {"vo": VOConfig, "ransac": RansacConfig}.get(name)
        if target is not None and isinstance(value, dict):
            kwargs[name] = _from_dict(target, value)
        else:
            del ftype
            kwargs[name] = value
    return cls(**kwargs)


def to_yaml(cfg: ExperimentConfig) -> str:
    import yaml

    return yaml.safe_dump(_to_dict(cfg), sort_keys=False)


def from_yaml(text: str) -> ExperimentConfig:
    import yaml

    data = yaml.safe_load(text) or {}
    return _from_dict(ExperimentConfig, data)


def save(path: str, cfg: ExperimentConfig) -> None:
    with open(path, "w") as f:
        f.write(to_yaml(cfg))


def load(path: str) -> ExperimentConfig:
    with open(path) as f:
        return from_yaml(f.read())
