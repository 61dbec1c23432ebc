"""droplet_visual_odometry_tpu — monocular visual-odometry / SfM engine in JAX.

A JAX/XLA implementation of the capabilities of the reference
ROS1/OpenCV pipeline (theivyzhang/droplet_visual_odometry): feature detection and
matching, essential-matrix RANSAC pose recovery, fiducial-marker metric scale,
AR-tag ground-truth extraction and TUM-format trajectory evaluation — plus a
keyframe/windowed-BA/pose-graph backend and multi-device sharding the reference
lacks.

Layer map (mirrors SURVEY.md §7):
  core/        SE(3)/SO(3) math, camera model            (ref L0/L2)
  data/        sequence ingestion + synthetic renderer    (ref L1)
  frontend/    FAST/ORB features + Hamming matching       (ref L2/L3 frontend)
  estimation/  batched RANSAC two-view geometry + scale   (ref L3 core)
  backend/     keyframes, windowed BA, pose graph         (new)
  eval/        TUM writers, ATE/RPE, stats, plots         (ref L5/L6)
  parallel/    mesh sharding, distributed Schur BA        (new)
  ops/         hand-written kernels (FAST via Pallas/Triton) + small-matrix linalg
  utils/       config, profiling, checkpointing
  cli/         experiment drivers
"""

import jax as _jax

# Geometry correctness first: pose chains, essential matrices and BA normal
# equations are numerically fragile — on a GPU an f32 matmul may otherwise run
# in TF32 (about three decimal digits); "highest" keeps full f32. The
# throughput-critical products opt into bf16 explicitly where it is safe:
# descriptor steering (exact on integers, orb.py) and Hamming matching (exact
# on +-1, orb.unpack_bits_pm1), and the pyramid resize (filters.py, f32
# accumulation, not exact; the parity bounds cover it).
_jax.config.update("jax_default_matmul_precision", "highest")

# Source paths in MLIR locations relative to the checkout. The FAST kernel's
# Triton IR carries its locations into the persistent compile cache's key, so
# with absolute paths every checkout of the same commit would compile anew.
if _jax.config.jax_hlo_source_file_canonicalization_regex is None:
    import os as _os
    import re as _re

    _jax.config.update(
        "jax_hlo_source_file_canonicalization_regex",
        "^" + _re.escape(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))) + _os.sep),
    )

__version__ = "0.1.0"
