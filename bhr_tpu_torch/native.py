"""The native PNG encoder and H.264 writer (C++, loaded via ctypes).

The port's own copy of ``bhr_tpu/native``. ``bhr_tpu_torch/_build.py``
compiles each source with ``g++`` at first use into the git-ignored
``bhr_tpu_torch/_build/``, keyed by a hash of the source:

- ``csrc/fastpng.cpp`` encodes the PNG of every still and video frame
  (``utils/io.save_image``): a None/Sub/Up filter per row and deflate at
  level 2, through libdeflate where the host has it, else zlib. Its
  bytes equal ``bhr_tpu.native.encode_png_rgb8``'s for the same image,
  level and backend. Where it does not build, ``png_available()`` is
  False and says why once, and ``save_image`` writes through the
  standard library's ``zlib``.
- ``csrc/fastvideo.cpp`` writes H.264 in an MP4, MKV or MOV container
  through libavformat / libavcodec / libswscale, for hosts that ship the
  ffmpeg shared libraries and headers but neither the Python bindings
  nor an ffmpeg CLI. Where ``g++``, the libraries or their headers are
  missing, ``video_available()`` is False and says why once; the video
  mode then goes down its documented chain (native, ffmpeg CLI, MJPEG
  AVI, frames kept), and the PNG frames and ``progress.json`` stay the
  product.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import _build

_LINK_FLAGS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
# The PNG encoder's link attempts, in order: libdeflate (~3x zlib's
# deflate throughput), then zlib.
_PNG_LINK_ATTEMPTS = (("-DUSE_LIBDEFLATE", "-ldeflate"), ("-lz",))

_lock = threading.Lock()
_loaded = False
_lib: Optional[ctypes.CDLL] = None
_png_loaded = False
_png_lib: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> None:
    c_i32, c_vp = ctypes.c_int32, ctypes.c_void_p
    lib.fastvideo_available.argtypes = []
    lib.fastvideo_available.restype = ctypes.c_int
    lib.fastvideo_open.argtypes = [ctypes.c_char_p, c_i32, c_i32, c_i32, c_i32]
    lib.fastvideo_open.restype = c_vp
    lib.fastvideo_write_frame.argtypes = [c_vp, c_vp]
    lib.fastvideo_write_frame.restype = ctypes.c_int
    lib.fastvideo_close.argtypes = [c_vp]
    lib.fastvideo_close.restype = ctypes.c_int
    lib.fastvideo_abort.argtypes = [c_vp]
    lib.fastvideo_abort.restype = None
    lib.fastvideo_probe.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(c_i32)] * 3
    lib.fastvideo_probe.restype = ctypes.c_int
    lib.fastvideo_read_frame0.argtypes = [ctypes.c_char_p, c_vp, c_i32, c_i32]
    lib.fastvideo_read_frame0.restype = ctypes.c_int


def _declare_png(lib: ctypes.CDLL) -> None:
    c_i32, c_vp = ctypes.c_int32, ctypes.c_void_p
    lib.fastpng_backend.argtypes = []
    lib.fastpng_backend.restype = ctypes.c_int
    lib.fastpng_write_rgb8.argtypes = [c_vp, c_i32, c_i32, c_i32,
                                       ctypes.c_char_p]
    lib.fastpng_write_rgb8.restype = ctypes.c_int
    lib.fastpng_encode_rgb8.argtypes = [
        c_vp, c_i32, c_i32, c_i32,
        ctypes.POINTER(c_vp), ctypes.POINTER(ctypes.c_size_t)]
    lib.fastpng_encode_rgb8.restype = ctypes.c_int
    lib.fastpng_free.argtypes = [c_vp]
    lib.fastpng_free.restype = None


def _load(name, link_attempts, declare, what) -> Optional[ctypes.CDLL]:
    """Build and load ``csrc/<name>.cpp``; None, with one line saying
    why, when it cannot be built or loaded on this host."""
    try:
        lib = _build.build_host(name, *link_attempts).lib
        declare(lib)
        return lib
    except (RuntimeError, OSError) as exc:
        # The headline, and the compiler's first error line.
        lines = str(exc).strip().splitlines() or [repr(exc)]
        errors = [ln.strip() for ln in lines[1:] if "error" in ln]
        print(f"{what} unavailable: " + lines[0]
              + (f" {errors[0]}" if errors else ""))
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    """The H.264 writer's library, built at the first call; None (with
    one line saying why) when it cannot be built or loaded on this host."""
    global _loaded, _lib
    if not _loaded:
        with _lock:  # one compile, whichever thread asks first
            if not _loaded:
                _lib = _load("fastvideo", (_LINK_FLAGS,), _declare,
                             "native H.264 writer")
                _loaded = True
    return _lib


def _get_png_lib() -> Optional[ctypes.CDLL]:
    """The PNG encoder's library, as ``_get_lib``."""
    global _png_loaded, _png_lib
    if not _png_loaded:
        with _lock:
            if not _png_loaded:
                _png_lib = _load("fastpng", _PNG_LINK_ATTEMPTS, _declare_png,
                                 "native PNG encoder")
                _png_loaded = True
    return _png_lib


def _require_png_lib() -> ctypes.CDLL:
    lib = _get_png_lib()
    if lib is None:
        raise RuntimeError("native fastpng unavailable")
    return lib


def _require_lib() -> ctypes.CDLL:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native fastvideo unavailable")
    return lib


def _check_rgb8(image: np.ndarray) -> np.ndarray:
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(
            f"expected (H, W, 3) uint8, got {image.dtype} {image.shape}")
    return np.ascontiguousarray(image)


def png_available() -> bool:
    """True when the native PNG encoder built and loaded on this host."""
    return _get_png_lib() is not None


def png_backend() -> str:
    """The deflate library the PNG encoder links: "libdeflate" or "zlib"."""
    return "libdeflate" if _require_png_lib().fastpng_backend() else "zlib"


def save_png_rgb8(image: np.ndarray, path: str, level: int = 2) -> None:
    """Write an (H, W, 3) uint8 array as a PNG file through the native
    encoder (any strides; a copy is made where it is not contiguous).
    Raises RuntimeError when the encoder is unavailable or fails."""
    lib = _require_png_lib()
    img = _check_rgb8(image)
    h, w = img.shape[:2]
    rc = lib.fastpng_write_rgb8(img.ctypes.data_as(ctypes.c_void_p), w, h,
                                int(level), path.encode())
    if rc != 0:
        raise RuntimeError(f"fastpng_write_rgb8 failed with code {rc}")


def encode_png_rgb8(image: np.ndarray, level: int = 2) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 array through the native encoder."""
    lib = _require_png_lib()
    img = _check_rgb8(image)
    h, w = img.shape[:2]
    out, out_len = ctypes.c_void_p(), ctypes.c_size_t()
    rc = lib.fastpng_encode_rgb8(img.ctypes.data_as(ctypes.c_void_p), w, h,
                                 int(level), ctypes.byref(out),
                                 ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"fastpng_encode_rgb8 failed with code {rc}")
    try:
        return ctypes.string_at(out.value, out_len.value)
    finally:
        lib.fastpng_free(out)


def video_available() -> bool:
    """True when the native H.264 writer built and has an encoder."""
    lib = _get_lib()
    return lib is not None and bool(lib.fastvideo_available())


class H264Writer:
    """Streaming H.264 writer over the native fastvideo library: open
    once, ``write`` (H, W, 3) uint8 frames in order, ``close`` to flush
    the encoder and finalize the container. A context manager; ``close``
    is idempotent. Width and height must be even (yuv420p).
    """

    def __init__(self, path: str, width: int, height: int, fps: int,
                 crf: int = 18):
        lib = _require_lib()
        if not lib.fastvideo_available():
            raise RuntimeError("this libavcodec has no H.264 encoder")
        if width % 2 or height % 2:
            raise ValueError(
                f"H.264 yuv420p needs even dimensions, got {width}x{height}")
        self._lib = lib
        self._width, self._height = int(width), int(height)
        self._handle = lib.fastvideo_open(
            path.encode(), int(width), int(height), int(fps), int(crf))
        if not self._handle:
            raise RuntimeError(f"fastvideo_open failed for {path!r}")

    def write(self, frame: np.ndarray) -> None:
        if self._handle is None:
            raise RuntimeError("writer is closed")
        img = _check_rgb8(frame)
        if img.shape[:2] != (self._height, self._width):
            raise ValueError(
                f"frame is {img.shape[1]}x{img.shape[0]}, "
                f"writer is {self._width}x{self._height}")
        rc = self._lib.fastvideo_write_frame(
            self._handle, img.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"fastvideo_write_frame failed with code {rc}")

    def close(self) -> None:
        if self._handle is not None:
            handle, self._handle = self._handle, None
            rc = self._lib.fastvideo_close(handle)
            if rc != 0:
                raise RuntimeError(f"fastvideo_close failed with code {rc}")

    def abort(self) -> None:
        """Free the handle without finalizing the container: the file is
        left without its moov box (unplayable), so an interrupted write
        can never pass for a finished video."""
        if self._handle is not None:
            handle, self._handle = self._handle, None
            self._lib.fastvideo_abort(handle)

    def __enter__(self) -> "H264Writer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Finalize on success; on any in-flight exception (an interrupt
        # too) abort, so no trailer is written.
        if exc_type is None:
            self.close()
        else:
            self.abort()


def probe_video(path: str):
    """(n_frames, width, height) of a video file, via libavformat."""
    lib = _require_lib()
    n, w, h = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.fastvideo_probe(path.encode(), ctypes.byref(n), ctypes.byref(w),
                             ctypes.byref(h))
    if rc != 0:
        raise RuntimeError(f"fastvideo_probe failed with code {rc}")
    return int(n.value), int(w.value), int(h.value)


def read_first_frame(path: str, width: int, height: int) -> np.ndarray:
    """Decode the first video frame to (H, W, 3) uint8 (for tests and for
    looking at a result without a Python codec)."""
    lib = _require_lib()
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.fastvideo_read_frame0(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p),
        int(width), int(height))
    if rc != 0:
        raise RuntimeError(f"fastvideo_read_frame0 failed with code {rc}")
    return out
