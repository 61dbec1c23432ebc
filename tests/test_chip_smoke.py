"""chip_smoke.py's phases at a tiny size on the CPU, and the device and
compile-cache helpers it stands on. On the card the same functions run at
full size (`python chip_smoke.py`)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from droplet_visual_odometry_tpu import pipeline
from droplet_visual_odometry_tpu.data import synthetic
from droplet_visual_odometry_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import parity  # noqa: E402

_LENS = np.array([-0.296079, 0.099771, 0.000222, 0.000109, 0.0])


@pytest.fixture(scope="module")
def tiny_seq():
    """A 13-frame 192x144 render through the production lens model."""
    return synthetic.render_sequence(
        synthetic.SyntheticConfig(
            n_frames=13, width=192, height=144, n_landmarks=160, seed=5, distortion=_LENS
        )
    )


# -- device and cache helpers --------------------------------------------------


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(device.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.compile_cache_dir("gpu") == str(tmp_path)
    assert device.enable_compile_cache("cpu") == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # code set nothing


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    base = os.path.join(REPO, ".jax_cache")
    assert device.compile_cache_dir("gpu") == base
    cpu = device.compile_cache_dir("cpu")
    assert os.path.dirname(cpu) == base and os.path.basename(cpu).startswith("cpu-")
    assert device.compile_cache_dir("cpu") == cpu  # fixed: a later run finds it


def test_require_gpu_raises_without_card():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_pipeline_imports_without_yaml():
    code = (
        "import sys; sys.modules['yaml'] = None; "
        "import droplet_visual_odometry_tpu.pipeline, droplet_visual_odometry_tpu.cli.run_experiment; "
        "print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_chip_smoke_fails_without_gpu():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


# -- the phases, tiny ----------------------------------------------------------


def test_fast_score_numpy_agrees_with_definition():
    """A hand-built corner: 9 contiguous bright circle pixels fire, 8 do not."""
    img = np.zeros((16, 16), np.float32)
    for dy, dx in chip_smoke._CIRCLE[:9]:
        img[8 + dy, 8 + dx] = 100.0
    s = chip_smoke.fast_score_numpy(img)
    assert s[8, 8] == pytest.approx(9 * (100.0 - 20.0))
    img[8 + chip_smoke._CIRCLE[8][0], 8 + chip_smoke._CIRCLE[8][1]] = 0.0
    assert chip_smoke.fast_score_numpy(img)[8, 8] == 0.0


def test_main_path_phase(tiny_seq, tmp_path):
    """The shipped CLI defaults end to end (a 144-px frame is far too small
    for the parity bounds, so the bound here only exercises the check)."""
    row = chip_smoke.run_main_path(
        tiny_seq, "tiny", str(tmp_path), bound=100.0, extra_args=("--platform", "cpu")
    )
    assert row["frames"] == 13 and row["shape"] == [144, 192]
    assert np.isfinite(row["ate_rmse_m"]) and row["ok_fraction"] > 0.5
    # The streams parse back to the CLI's own ATE.
    assert chip_smoke.ate_from_streams(
        str(tmp_path / "tiny"), np.asarray(tiny_seq.marker_present)
    ) == pytest.approx(row["ate_rmse_m"], abs=1e-6)
    with pytest.raises(AssertionError, match="not below"):
        chip_smoke.run_main_path(
            tiny_seq, "tiny", str(tmp_path), bound=1e-9, extra_args=("--platform", "cpu")
        )


def test_stream_phase_chunked_equals_whole(tiny_seq):
    """On the CPU the chunked run reproduces the whole program to rounding
    (same keys, features and scale carry)."""
    row = chip_smoke.run_stream_phase(tiny_seq, chunk=4, n_push=5, ate_bound=100.0)
    assert row["chunked_vs_whole_centre_rms_m"] < 1e-4
    assert row["pairs_equal_to_1e-4"] == 1.0 and row["pairs_same_matches"] == 1.0
    assert row["pushes"] == 5


def test_pair_differences_measures_rotation_and_translation():
    from droplet_visual_odometry_tpu.core import se3

    import jax.numpy as jnp

    a = np.stack([np.eye(4, dtype=np.float32)] * 3)
    b = a.copy()
    b[1] = np.asarray(se3.make_se3(se3.so3_exp(jnp.asarray([0.0, 0.0, np.radians(0.5)])), jnp.zeros(3)))
    b[2, :3, 3] = [0.03, 0.0, 0.04]
    d = chip_smoke.pair_differences(a, b)
    np.testing.assert_allclose(d["rot_deg"], [0.0, 0.5, 0.0], atol=1e-4)
    np.testing.assert_allclose(d["trans_m"], [0.0, 0.0, 0.05], atol=1e-7)
    assert d["max_abs"][0] == 0.0 and d["max_abs"][2] == pytest.approx(0.04)


def test_kernel_phase_interpreted(tiny_seq):
    frames = pipeline.preprocess_frames(tiny_seq)[:2]
    rows = chip_smoke.check_fast_kernel(frames, reps=0, interpret=True)
    assert [r["shape"][1:] for r in rows] == [[144, 192], [109, 145], [83, 110], [64, 83]]


def test_four_card_phases_on_virtual_devices(tiny_seq):
    """The mesh phase's three comparisons; the shipped default's pose graph
    shards over every visible device (8 virtual ones here)."""
    n = len(jax.devices())
    loop = parity.scenarios(quick=True, names=["drift_loop"])["drift_loop"]
    pg = chip_smoke.four_card_pose_graph(loop, n)
    pv = chip_smoke.four_card_pair_vo(tiny_seq, 4, pairs_per_card=1)
    ba = chip_smoke.four_card_ba(4, n_points=256)
    assert pg["pg_mesh_devices"] == n and pg["n_loop_edges"] > 0
    assert pv["pairs"] == 4 and pv["max_abs_diff"] <= 1e-3
    assert ba["pose_max_abs_diff"] <= 2e-3
