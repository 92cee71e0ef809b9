"""ctypes binding for the native C++ stereo loader (native/loader.cpp).

Port of `stereo_dso_g2o_tpu/runtime/native_loader.py`. The reference's data
path is native C++ (util/DatasetReader.h getImage :200-226, IOWrapper
OpenCV PNG read, Undistort remap); this module builds and binds its
equivalent: a worker-threaded PNG/JPEG decoder with geometric remap +
photometric correction and a bounded in-order prefetch queue, so host image
I/O overlaps the device pipeline. Frames come out as host numpy arrays.

The shared library compiles with g++ on first use into the package's
`_build/` (one file per version of the source). PNG needs zlib only; JPEG
support is compiled in when libjpeg is there (`jpeg_error()` says why it is
not). `available()` reports whether a library was built, `build_error()` why
not; `io/dataset.StereoDataset.prefetch` falls back to `StereoDataset.get`
when there is none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "loader.cpp"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_err: Optional[str] = None
_jpeg_err: Optional[str] = None


def _compile(lib: Path, jpeg: bool) -> Optional[str]:
    """g++ `SOURCE` into `lib`; the compiler's error text on failure."""
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(SOURCE), "-o", str(tmp)]
    cmd += ["-DSDSO_WITH_JPEG", "-ljpeg"] if jpeg else []
    cmd += ["-lz", "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:  # g++ missing, timeout
        return str(e)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return r.stderr[-2000:]
    os.replace(tmp, lib)
    return None


def _library() -> Optional[Path]:
    """The built library, with JPEG if libjpeg is there, else without."""
    global _build_err, _jpeg_err
    version = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    with_jpeg = BUILD_DIR / f"libsdso_loader_{version}.so"
    png_only = BUILD_DIR / f"libsdso_loader_{version}_nojpeg.so"
    if with_jpeg.exists():
        return with_jpeg
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _jpeg_err = _compile(with_jpeg, jpeg=True)
    if _jpeg_err is None:
        return with_jpeg
    if png_only.exists():
        return png_only
    _build_err = _compile(png_only, jpeg=False)
    return None if _build_err is not None else png_only


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_err
    with _lock:
        if _lib is not None or _build_err is not None:
            return _lib
        path = _library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:  # built against a library this machine lacks
            _build_err = f"{path.name} does not load: {e}"
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        lib.sdso_decode_gray.restype = ctypes.c_int
        lib.sdso_decode_gray.argtypes = [
            ctypes.c_char_p, fp, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.sdso_loader_open.restype = ctypes.c_void_p
        lib.sdso_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, fp, fp, fp, fp,
        ]
        lib.sdso_loader_next.restype = ctypes.c_int
        lib.sdso_loader_next.argtypes = [ctypes.c_void_p, fp, fp]
        lib.sdso_loader_close.restype = None
        lib.sdso_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why no library could be built (None when one was)."""
    _load()
    return _build_err


def jpeg_error() -> Optional[str]:
    """Why the library was built without JPEG support (None when it has
    it)."""
    _load()
    return _jpeg_err


def _need_lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_err}")
    return lib


def decode_gray(path: str, max_pixels: int = 1 << 26) -> np.ndarray:
    """One-shot native decode to float32 grayscale (H, W)."""
    lib = _need_lib()
    buf = np.empty(max_pixels, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.sdso_decode_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_pixels, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def _fptr(a: Optional[np.ndarray]):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeStereoLoader:
    """Prefetching stereo frame stream, in frame order.

    remap_x/remap_y: (H, W) float32 source coordinates per output pixel with
    invalid pixels < 0 (callers encode the reference's remap_ok mask as -1).
    gamma: (256,) inverse-response LUT; vignette_inv: (H, W) 1/V factor.
    """

    def __init__(
        self,
        left_paths: Sequence[str],
        right_paths: Sequence[str],
        out_w: int,
        out_h: int,
        remap_x: Optional[np.ndarray] = None,
        remap_y: Optional[np.ndarray] = None,
        gamma: Optional[np.ndarray] = None,
        vignette_inv: Optional[np.ndarray] = None,
        n_workers: int = 3,
        capacity: int = 8,
    ):
        lib = _need_lib()
        if len(left_paths) != len(right_paths):
            raise ValueError("left and right path lists differ in length")

        def table(a, size):
            if a is None:
                return None
            a = np.ascontiguousarray(a, np.float32)
            if a.size != size:
                raise ValueError(f"a calibration table has {a.size} values, expected {size}")
            return a

        self._lib = lib
        self.n = len(left_paths)
        self.w, self.h = out_w, out_h
        # keep the encoded path buffers alive for the loader's lifetime
        self._lbytes = [p.encode() for p in left_paths]
        self._rbytes = [p.encode() for p in right_paths]
        larr = (ctypes.c_char_p * self.n)(*self._lbytes)
        rarr = (ctypes.c_char_p * self.n)(*self._rbytes)
        # keep the calibration arrays alive until open() copies them
        px = out_w * out_h
        rx, ry = table(remap_x, px), table(remap_y, px)
        gm, vi = table(gamma, 256), table(vignette_inv, px)
        self._h = lib.sdso_loader_open(
            larr, rarr, self.n, n_workers, capacity, out_w, out_h,
            _fptr(rx), _fptr(ry), _fptr(gm), _fptr(vi),
        )
        if not self._h:
            raise RuntimeError("loader_open failed")
        self._taken = 0

    def __len__(self):
        return self.n

    def next(self):
        """Blocking: (frame_idx, left, right) or None at end of stream."""
        if self._taken >= self.n:
            return None
        left = np.empty((self.h, self.w), np.float32)
        right = np.empty((self.h, self.w), np.float32)
        idx = self._lib.sdso_loader_next(
            self._h,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        self._taken += 1
        if idx == -1:
            return None
        if idx == -2:
            raise IOError(f"native decode failed at frame {self._taken - 1}")
        return idx, left, right

    def __iter__(self):
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def close(self):
        if getattr(self, "_h", None):
            self._lib.sdso_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
