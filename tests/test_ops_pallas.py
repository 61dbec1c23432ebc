"""The FAST kernel (Pallas, Triton route) against the XLA `fast_score` and a
host numpy FAST, plus plain-reference checks of the other frontend ops.

On the CPU the kernel runs in Pallas' interpreter (`interpret=True`); the
`gpu`-marked test compiles it for the card and skips elsewhere.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from droplet_visual_odometry_tpu.frontend import fast, matcher, orb
from droplet_visual_odometry_tpu.ops import pallas_fast

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (repo-root smoke script: host references)


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    # Smooth-ish image with injected corners so FAST fires.
    img = rng.uniform(0, 60, size=(h, w)).astype(np.float32)
    for y, x in rng.integers(10, [h - 10, w - 10], size=(25, 2)):
        img[y : y + 4, x : x + 4] += 150.0
    return img


def _kernel(imgs, threshold=20.0, arc_length=9):
    return np.asarray(
        pallas_fast.fast_score_batch(jnp.asarray(imgs), threshold, arc_length, interpret=True)
    )


# -- the kernel (interpreted) ------------------------------------------------


@pytest.mark.parametrize("shape", [(96, 128), (100, 130), (70, 45)])
def test_fast_kernel_matches_xla(shape, monkeypatch):
    """Tile overhang at both far edges (100x130, and a frame smaller than one
    block) is masked on load and store."""
    monkeypatch.setattr(pallas_fast, "BLOCK_H", 32)
    monkeypatch.setattr(pallas_fast, "BLOCK_W", 64)
    img = _image(*shape)
    ref = np.asarray(fast.fast_score(jnp.asarray(img), 20.0, 9))
    out = _kernel(img[None])[0]
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-5)


def test_fast_kernel_arc_and_threshold_params():
    img = _image(64, 128, seed=3)
    for thr, arc in [(10.0, 12), (35.0, 9), (20.0, 16)]:
        ref = np.asarray(fast.fast_score(jnp.asarray(img), thr, arc))
        out = _kernel(img[None], thr, arc)[0]
        np.testing.assert_array_equal(out > 0, ref > 0)
        np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-5)


def test_fast_kernel_batch_and_vmap_fold():
    imgs = np.stack([_image(96, 128, seed=s) for s in range(4)])
    batch = _kernel(imgs)
    for i in range(4):
        single = np.asarray(fast.fast_score(jnp.asarray(imgs[i])))
        np.testing.assert_array_equal(batch[i] > 0, single > 0)
        np.testing.assert_allclose(batch[i], single, atol=1e-3, rtol=1e-5)
    # A vmap over a (2, 2, H, W) stack folds into the kernel's frame axis.
    folded = jax.vmap(
        lambda x: pallas_fast.fast_score_batch(x, interpret=True)
    )(jnp.asarray(imgs).reshape(2, 2, 96, 128))
    np.testing.assert_array_equal(np.asarray(folded).reshape(4, 96, 128), batch)


def _as_gpu(monkeypatch) -> list:
    """Make score_batch take its GPU branch, with the kernel interpreted;
    returns the list of frame batches the kernel was called on."""
    calls = []
    real = pallas_fast.fast_score_batch

    def interpreted(imgs, t=20.0, a=9):
        calls.append(imgs.shape)
        return real(imgs, t, a, interpret=True)

    monkeypatch.setattr(fast.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pallas_fast, "fast_score_batch", interpreted)
    return calls


def test_score_batch_picks_kernel_only_on_gpu(monkeypatch):
    imgs = jnp.asarray(np.stack([_image(48, 64, seed=s) for s in range(2)]))
    cpu = np.asarray(fast.score_batch(imgs))
    calls = _as_gpu(monkeypatch)
    assert calls == []  # the CPU ran the XLA fast_score
    gpu = np.asarray(fast.score_batch(imgs))
    assert calls == [(2, 48, 64)]
    np.testing.assert_allclose(gpu, cpu, atol=1e-3, rtol=1e-5)


def test_detect_kernel_path_equals_xla(monkeypatch):
    img = jnp.asarray(_image(96, 128, seed=5))
    ref = fast.detect(img, k=64)
    _as_gpu(monkeypatch)
    out = fast.detect(img, k=64)
    sel = np.asarray(ref.valid)
    np.testing.assert_array_equal(np.asarray(out.valid), sel)
    np.testing.assert_allclose(np.asarray(out.xy)[sel], np.asarray(ref.xy)[sel])


@pytest.mark.gpu
def test_fast_kernel_on_card_at_level_shapes(gpu_devices):
    """Compiled for the card: the chip_smoke kernel check at the pyramid of
    two 1440x1080 frames (identical corners, scores to 1e-3)."""
    frames = np.stack([_image(1080, 1440, seed=s) for s in range(2)])
    rows = chip_smoke.check_fast_kernel(frames, reps=0)
    assert [r["shape"][1:] for r in rows] == [[1080, 1440], [818, 1091], [620, 826], [470, 626]]


# -- plain references of what XLA runs ----------------------------------------


@pytest.mark.parametrize(
    "shape,threshold,arc",
    [
        ((96, 128), 20.0, 9),
        ((100, 130), 20.0, 9),
        ((57, 83), 20.0, 9),
        ((64, 96), 10.0, 12),
        ((64, 96), 35.0, 9),
    ],
)
def test_fast_score_matches_numpy(shape, threshold, arc):
    img = _image(*shape, seed=shape[0])
    ref = chip_smoke.fast_score_numpy(img, threshold, arc)
    out = np.asarray(fast.fast_score(jnp.asarray(img), threshold, arc))
    assert (ref > 0).sum() > 10
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("k", [23, 64])
def test_extract_patches_matches_numpy(k):
    """Patches centred on rounded keypoints; keypoints near an edge are
    clamped so the 37x37 patch stays inside the frame."""
    rng = np.random.default_rng(k)
    h, w = 96, 160
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    xy = rng.uniform(0, [w, h], size=(k, 2)).astype(np.float32)
    xy[:4] = [[0.0, 0.0], [w - 1.0, h - 1.0], [2.0, h - 3.0], [w - 5.0, 1.0]]
    out = np.asarray(orb.extract_patches(jnp.asarray(img), jnp.asarray(xy)))
    p = orb.PATCH
    for i, (x, y) in enumerate(xy):
        r0 = min(max(int(np.round(y)) - orb.HALF, 0), h - p)
        c0 = min(max(int(np.round(x)) - orb.HALF, 0), w - p)
        np.testing.assert_array_equal(out[i], img[r0 : r0 + p, c0 : c0 + p])


@pytest.mark.parametrize("mode", ["crosscheck", "ratio"])
def test_match_matches_bruteforce_hamming(mode):
    rng = np.random.default_rng(7)
    ka, kb = 96, 80
    da = rng.integers(0, 2**32, size=(ka, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(kb, 8), dtype=np.uint32)
    db[:40] = da[:40] ^ (1 << rng.integers(0, 32, size=(40, 8))).astype(np.uint32)  # near copies
    va = rng.uniform(size=ka) > 0.1
    vb = rng.uniform(size=kb) > 0.1

    bits = lambda d: np.unpackbits(d.view(np.uint8), axis=1).astype(np.int32)
    dist = (bits(da)[:, None, :] != bits(db)[None, :, :]).sum(-1).astype(np.float64)
    dist[~va, :] = np.inf
    dist[:, ~vb] = np.inf
    best = dist.argmin(1)
    d1 = dist[np.arange(ka), best]
    if mode == "crosscheck":
        ok = (dist.argmin(0)[best] == np.arange(ka)) & np.isfinite(d1)
    else:
        d2 = np.sort(dist, axis=1)[:, 1]
        ok = (d1 < 0.75 * d2) & np.isfinite(d1)

    m = matcher.match(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(va), jnp.asarray(vb), mode=mode
    )
    np.testing.assert_array_equal(np.asarray(m.valid), ok)
    np.testing.assert_array_equal(np.asarray(m.idx)[ok], best[ok])
    np.testing.assert_array_equal(np.asarray(m.distance)[ok], d1[ok])
    assert ok.sum() >= 20
