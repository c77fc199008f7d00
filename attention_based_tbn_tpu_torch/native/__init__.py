"""ctypes binding of the port's native IO library (``tbn_io.cpp``).

JPEG decode (BGR, as ``cv2.imread``), bilinear resize, PCM WAV reading
with linear resampling, and a pthread decode + rescale + crop of a batch
of frames, outside the GIL. The names are the JAX package's
(``attention_based_tbn_tpu/native``); the library is the port's own copy.
It decodes JPEG through the port's own baseline decoder
(``jpeg_codec.cpp``) on every host, bit-equal to libjpeg's default decode,
so it needs no libjpeg; a progressive, arithmetic-coded or multi-scan file
raises ``IOError`` naming its type.

The library builds with ``g++`` at first use into ``native/_build/``
(git-ignored), keyed by a digest of its sources and flags, through a
temporary file and a rename, so an edited source is rebuilt and parallel
builds never load a half-written file.

Unlike the JAX binding, which degrades quietly when its library is
missing, a library that cannot build or load raises
:class:`NativeBuildError`, naming the missing compiler:
``tpu.native_io=true`` (the default) never quietly decodes with cv2.
``tpu.native_io=false`` selects the Python / cv2 readers instead.
Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

import numpy as np

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(NATIVE_DIR, "_build")
SOURCES = ("tbn_io.cpp", "jpeg_codec.cpp")
HEADERS = ("jpeg_codec.h",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-lpthread",)
COMPILER = "g++"

_library: Optional["Library"] = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native IO library cannot be built or loaded on this host."""


def compiler() -> str:
    found = shutil.which(COMPILER)
    if found is None:
        raise NativeBuildError(
            f"the native IO library needs the C++ compiler {COMPILER!r}, which is not on "
            "PATH; install it, or set tpu.native_io=false to use the Python / cv2 readers")
    return found


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for name in sorted(SOURCES + HEADERS):
        digest.update(name.encode())
        with open(os.path.join(NATIVE_DIR, name), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtbn_io-{digest.hexdigest()[:16]}.so")


def build() -> float:
    """Compile the library unless it exists; returns the seconds the build
    took (0 when it was there)."""
    out = library_path()
    if os.path.exists(out):
        return 0.0
    cxx = compiler()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    sources = [os.path.join(NATIVE_DIR, s) for s in SOURCES]
    start = time.perf_counter()
    result = subprocess.run([cxx, *CXX_FLAGS, *sources, "-o", tmp, *LIBS],
                            capture_output=True, text=True)
    if result.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeBuildError(f"building the native IO library failed: {COMPILER} said:\n"
                               f"{result.stderr[-2000:]}")
    os.replace(tmp, out)
    return time.perf_counter() - start


def load() -> "Library":
    """The loaded library, built first if needed."""
    global _library
    with _lock:
        if _library is None:
            build()
            _library = Library(library_path())
        return _library


def ensure_built() -> "Library":
    """The library, built and loaded; raises NativeBuildError."""
    return load()


def available() -> bool:
    """Whether the library builds and loads (never raises)."""
    try:
        load()
    except NativeBuildError:
        return False
    return True


def _u8(img: np.ndarray, name: str) -> np.ndarray:
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8:
        raise ValueError(f"{name} takes a uint8 numpy array")
    return np.ascontiguousarray(img)


class Library:
    """One loaded build of ``tbn_io.cpp``."""

    def __init__(self, path: str):
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            raise NativeBuildError(f"loading the native IO library {path} failed: {exc}") from exc
        self.path = path
        c_int, c_i64, c_void_p = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        lib.tbn_last_error.restype = ctypes.c_char_p
        lib.tbn_last_error.argtypes = []
        lib.tbn_jpeg_info.restype = c_int
        lib.tbn_jpeg_info.argtypes = [ctypes.c_char_p, c_i64, ctypes.POINTER(c_int),
                                      ctypes.POINTER(c_int)]
        lib.tbn_decode_jpeg.restype = c_int
        lib.tbn_decode_jpeg.argtypes = [ctypes.c_char_p, c_i64, c_void_p, c_int]
        lib.tbn_resize_bilinear.restype = None
        lib.tbn_resize_bilinear.argtypes = [c_void_p, c_int, c_int, c_int, c_void_p, c_int,
                                            c_int]
        lib.tbn_read_wav.restype = c_int
        lib.tbn_read_wav.argtypes = [ctypes.c_char_p, c_int,
                                     ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                     ctypes.POINTER(c_i64)]
        lib.tbn_free.restype = None
        lib.tbn_free.argtypes = [c_void_p]
        lib.tbn_decode_batch.restype = c_int
        lib.tbn_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int,
                                         c_int, c_void_p, c_int]
        self._lib = lib

    def _error(self) -> str:
        return self._lib.tbn_last_error().decode(errors="replace")

    def decode_jpeg(self, data: bytes, grayscale: bool = False) -> np.ndarray:
        """JPEG bytes -> (H, W, 3) BGR or (H, W) grayscale uint8."""
        h, w = ctypes.c_int(), ctypes.c_int()
        if self._lib.tbn_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
            raise IOError(f"invalid JPEG data: {self._error()}")
        channels = 1 if grayscale else 3
        out = np.empty((h.value, w.value, channels), dtype=np.uint8)
        if self._lib.tbn_decode_jpeg(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                                     channels) != 0:
            raise IOError(f"JPEG decode failed: {self._error()}")
        return out[..., 0] if grayscale else out

    def decode_jpeg_file(self, path: str, grayscale: bool = False) -> np.ndarray:
        with open(path, "rb") as handle:
            data = handle.read()
        try:
            return self.decode_jpeg(data, grayscale)
        except IOError as exc:
            raise IOError(f"{path}: {exc}") from exc

    def resize_bilinear(self, img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
        img = _u8(img, "resize_bilinear")
        squeeze = img.ndim == 2
        if squeeze:
            img = img[..., None]
        h, w, c = img.shape
        out = np.empty((new_h, new_w, c), dtype=np.uint8)
        self._lib.tbn_resize_bilinear(img.ctypes.data_as(ctypes.c_void_p), h, w, c,
                                      out.ctypes.data_as(ctypes.c_void_p), new_h, new_w)
        return out[..., 0] if squeeze else out

    def read_wav(self, path: str, target_sr: int = 24000) -> np.ndarray:
        """A PCM WAV file as mono float32, linearly resampled to target_sr."""
        ptr, length = ctypes.POINTER(ctypes.c_float)(), ctypes.c_int64()
        rc = self._lib.tbn_read_wav(path.encode(), target_sr, ctypes.byref(ptr),
                                    ctypes.byref(length))
        if rc != 0:
            raise IOError(f"WAV read failed ({rc}): {path}")
        try:
            return np.ctypeslib.as_array(ptr, shape=(length.value,)).copy()
        finally:
            self._lib.tbn_free(ptr)

    def decode_batch(self, paths: List[str], scale_size: int, crop_size: int,
                     grayscale: bool = False, num_threads: int = 8) -> np.ndarray:
        """Decode + shorter-side rescale + centre crop of a frame batch on
        ``num_threads`` native threads: (N, crop, crop, C) uint8, C = 3
        (BGR) or 1."""
        n = len(paths)
        channels = 1 if grayscale else 3
        out = np.empty((n, crop_size, crop_size, channels), dtype=np.uint8)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        failures = self._lib.tbn_decode_batch(arr, n, channels, scale_size, crop_size,
                                              out.ctypes.data_as(ctypes.c_void_p), num_threads)
        if failures:
            raise IOError(f"{failures}/{n} frames failed to decode")
        return out


def decode_jpeg(data: bytes, grayscale: bool = False) -> np.ndarray:
    return load().decode_jpeg(data, grayscale)


def decode_jpeg_file(path: str, grayscale: bool = False) -> np.ndarray:
    return load().decode_jpeg_file(path, grayscale)


def resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    return load().resize_bilinear(img, new_h, new_w)


def read_wav(path: str, target_sr: int = 24000) -> np.ndarray:
    return load().read_wav(path, target_sr)


def decode_batch(paths: List[str], scale_size: int, crop_size: int, grayscale: bool = False,
                 num_threads: int = 8) -> np.ndarray:
    return load().decode_batch(paths, scale_size, crop_size, grayscale, num_threads)
