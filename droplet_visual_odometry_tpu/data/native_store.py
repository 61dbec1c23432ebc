"""ctypes bindings for the native sequence store (native/src/vostore.cpp).

The native library is the ingest hot path: mmap'd frame store, background
prefetch ring (overlaps disk readahead with device compute), exact-stamp
pairing and BT.601 grayscale conversion — the capabilities the reference gets
from rosbag's C++ reader and OpenCV's cvtColor (get_valid_message_stream.py:
21-37, visual_odometry_v3.py:127-132).

The library is built on demand with `make` (g++ only). Every entry point has
a pure-numpy fallback with identical semantics, so the package works without
a compiler; `native_available()` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libvostore.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _try_load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        # Always ask make: it does nothing when the library is newer than
        # native/src, and rebuilds a stale one (e.g. copied in with the tree)
        # so the committed source is what runs.
        if not os.path.isdir(_NATIVE_DIR) or shutil.which("make") is None:
            _build_failed = True
            return None
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (subprocess.SubprocessError, OSError):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.vostore_write.restype = ctypes.c_int
        lib.vostore_open.restype = ctypes.c_void_p
        lib.vostore_read.restype = ctypes.c_int
        lib.vostore_prefetch_start.restype = ctypes.c_int
        lib.vostore_prefetch_next.restype = ctypes.c_int64
        lib.vostore_prefetch_acquire.restype = ctypes.c_int64
        lib.vostore_pair_stamps.restype = ctypes.c_int64
        _lib = lib
        return _lib


def native_available() -> bool:
    return _try_load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# ---------------------------------------------------------------------------
# store write/read
# ---------------------------------------------------------------------------

_MAGIC = b"VOSTORE1"
_HEADER = 32


def write_store(path: str, frames: np.ndarray, timestamps: np.ndarray) -> None:
    """Write (N, H, W) uint8 frames + (N,) float64 stamps as a VOSTORE1 file."""
    frames = np.ascontiguousarray(frames, np.uint8)
    stamps = np.ascontiguousarray(timestamps, np.float64)
    n, h, w = frames.shape
    assert stamps.shape == (n,)
    lib = _try_load()
    if lib is not None:
        rc = lib.vostore_write(
            path.encode(), ctypes.c_uint64(n), ctypes.c_uint32(h),
            ctypes.c_uint32(w), _u8(frames), _f64(stamps),
        )
        if rc != 0:
            raise OSError(f"vostore_write failed: {path}")
        return
    with open(path, "wb") as f:  # numpy fallback, identical layout
        f.write(_MAGIC)
        f.write(np.asarray([n], np.uint64).tobytes())
        f.write(np.asarray([h, w, 0, 0], np.uint32).tobytes())
        f.write(stamps.tobytes())
        f.write(frames.tobytes())


class StoreReader:
    """Reader over a VOSTORE1 file; uses the native mmap reader when built."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _try_load()
        self._handle = None
        if self._lib is not None:
            h = self._lib.vostore_open(path.encode())
            if not h:
                raise OSError(f"vostore_open failed: {path}")
            self._handle = ctypes.c_void_p(h)
            n = ctypes.c_uint64()
            hh = ctypes.c_uint32()
            ww = ctypes.c_uint32()
            self._lib.vostore_info(self._handle, ctypes.byref(n), ctypes.byref(hh), ctypes.byref(ww))
            self.n, self.h, self.w = int(n.value), int(hh.value), int(ww.value)
        else:
            with open(path, "rb") as f:
                if f.read(8) != _MAGIC:
                    raise OSError(f"bad magic: {path}")
                self.n = int(np.frombuffer(f.read(8), np.uint64)[0])
                hw = np.frombuffer(f.read(16), np.uint32)
                self.h, self.w = int(hw[0]), int(hw[1])
            self._mm = np.memmap(path, np.uint8, "r")

    def timestamps(self) -> np.ndarray:
        if self._handle is not None:
            out = np.empty(self.n, np.float64)
            self._lib.vostore_timestamps(self._handle, _f64(out))
            return out
        raw = self._mm[_HEADER : _HEADER + 8 * self.n]
        return np.frombuffer(raw.tobytes(), np.float64).copy()

    def read(self, start: int, count: int) -> np.ndarray:
        if start < 0 or start + count > self.n:
            raise IndexError((start, count, self.n))
        if self._handle is not None:
            out = np.empty((count, self.h, self.w), np.uint8)
            rc = self._lib.vostore_read(
                self._handle, ctypes.c_uint64(start), ctypes.c_uint64(count), _u8(out)
            )
            if rc != 0:
                raise OSError("vostore_read failed")
            return out
        base = _HEADER + 8 * self.n
        fsz = self.h * self.w
        raw = self._mm[base + start * fsz : base + (start + count) * fsz]
        return np.asarray(raw).reshape(count, self.h, self.w).copy()

    def iter_chunks(self, chunk: int, nslots: int = 3, copy: bool = True):
        """Yield (start, frames) chunks. Native: background prefetch thread
        ring; fallback: plain sequential reads.

        copy=False yields ZERO-COPY views (into the prefetch slot buffer on
        the native path, into the file mmap on the fallback) valid only until
        the next iteration — right for consumers that immediately forward the
        bytes (e.g. a host->device transfer), removing the copy-out memcpy
        that otherwise bounds warm-path throughput (tools/ingest_bench.py)."""
        if self._handle is not None and not copy:
            rc = self._lib.vostore_prefetch_start(
                self._handle, ctypes.c_uint64(chunk), ctypes.c_uint64(nslots)
            )
            if rc != 0:
                raise OSError("vostore_prefetch_start failed")
            try:
                ptr = ctypes.POINTER(ctypes.c_uint8)()
                start = ctypes.c_uint64()
                while True:
                    got = self._lib.vostore_prefetch_acquire(
                        self._handle, ctypes.byref(ptr), ctypes.byref(start)
                    )
                    if got < 0:
                        raise OSError("vostore_prefetch_acquire failed")
                    if got == 0:
                        return
                    view = np.ctypeslib.as_array(
                        ptr, shape=(int(got), self.h, self.w)
                    )
                    view.flags.writeable = False
                    yield int(start.value), view
                    self._lib.vostore_prefetch_release(self._handle)
            finally:
                self._lib.vostore_prefetch_stop(self._handle)
            return
        if self._handle is not None:
            rc = self._lib.vostore_prefetch_start(
                self._handle, ctypes.c_uint64(chunk), ctypes.c_uint64(nslots)
            )
            if rc != 0:
                raise OSError("vostore_prefetch_start failed")
            try:
                buf = np.empty((chunk, self.h, self.w), np.uint8)
                start = ctypes.c_uint64()
                while True:
                    got = self._lib.vostore_prefetch_next(
                        self._handle, _u8(buf), ctypes.byref(start)
                    )
                    if got < 0:
                        raise OSError("vostore_prefetch_next failed")
                    if got == 0:
                        return
                    yield int(start.value), buf[: int(got)].copy()
            finally:
                self._lib.vostore_prefetch_stop(self._handle)
        else:
            base = _HEADER + 8 * self.n
            fsz = self.h * self.w
            for s in range(0, self.n, chunk):
                c = min(chunk, self.n - s)
                if copy:
                    yield s, self.read(s, c)
                else:  # zero-copy view straight into the file mmap
                    raw = self._mm[base + s * fsz : base + (s + c) * fsz]
                    yield s, np.asarray(raw).reshape(c, self.h, self.w)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.vostore_close(self._handle)
            self._handle = None

    def frames(self) -> "StoreFrames":
        """Array-like (N, H, W) uint8 view — reads on demand, nothing resident.
        Feed this straight to the streaming VO loop
        (utils.checkpoint.run_sequence_checkpointed / pipeline stream=True)."""
        return StoreFrames(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StoreFrames:
    """Minimal ndarray-like facade over a StoreReader: `.shape`, `.dtype`,
    slice and fancy-index reads. Only the requested frames are materialised,
    so a 25k-frame store streams through the chunked VO loop with O(chunk)
    host memory."""

    def __init__(self, reader: StoreReader):
        self._r = reader
        self.shape = (reader.n, reader.h, reader.w)
        self.dtype = np.uint8

    def __len__(self) -> int:
        return self._r.n

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, slice):
            start, stop, step = key.indices(self._r.n)
            if step != 1:
                raise IndexError("StoreFrames supports step-1 slices only")
            return self._r.read(start, max(stop - start, 0))
        idx = np.atleast_1d(np.asarray(key))
        if idx.ndim != 1:
            raise IndexError("StoreFrames supports 1-D fancy indexing only")
        out = np.empty((len(idx), self._r.h, self._r.w), np.uint8)
        for k, i in enumerate(idx):
            out[k] = self._r.read(int(i), 1)[0]
        return out


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------


def pair_stamps(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact-stamp pairing of two SORTED stamp arrays -> (idx_a, idx_b)
    (get_valid_message_stream.py:39-53 semantics, merge-join in C++)."""
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    lib = _try_load()
    if lib is not None:
        ia = np.empty(min(len(a), len(b)), np.int64)
        ib = np.empty_like(ia)
        k = lib.vostore_pair_stamps(
            _f64(a), ctypes.c_int64(len(a)), _f64(b), ctypes.c_int64(len(b)),
            ia.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ib.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return ia[:k].copy(), ib[:k].copy()
    common, ia, ib = np.intersect1d(a, b, return_indices=True)
    del common
    order = np.argsort(ia)
    return ia[order].astype(np.int64), ib[order].astype(np.int64)


def rgb_to_gray(img: np.ndarray, order: str = "rgb") -> np.ndarray:
    """(..., 3) uint8 -> (...) uint8 BT.601 luma (cvtColor parity)."""
    img = np.ascontiguousarray(img, np.uint8)
    assert img.shape[-1] == 3
    lib = _try_load()
    n_px = int(np.prod(img.shape[:-1]))
    if lib is not None:
        out = np.empty(img.shape[:-1], np.uint8)
        lib.vostore_rgb_to_gray(
            _u8(img), _u8(out), ctypes.c_int64(n_px),
            ctypes.c_int(0 if order == "rgb" else 1),
        )
        return out
    x = img.astype(np.uint32)
    r, g, b = (x[..., 0], x[..., 1], x[..., 2]) if order == "rgb" else (x[..., 2], x[..., 1], x[..., 0])
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).astype(np.uint8)
