"""Image and video IO: PNG save and load, the asynchronous frame writer,
the MJPEG AVI writer, the inline video assembler, disk texture loading.

The port of ``bhr_tpu/utils/io.py``. ``save_image`` writes PNGs through
the native encoder (``native.save_png_rgb8``, level 2) where it built,
as ``bhr_tpu`` does, and otherwise through the standard library's
``zlib``. The reader needs nothing beyond the standard library
(``zlib`` and ``struct``) and NumPy, so a host with neither Pillow nor
imageio can save video frames and read them back (the assembler's
catch-up on resume and the post-pass do). Pillow is imported only where
it is needed: to read an explicit ``--disk_texture`` file and to
JPEG-encode the frames of the MJPEG AVI.
"""

from __future__ import annotations

import os
import shutil
import struct
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from .. import native
from .profiling import span

# Deflate levels of the PNGs: the native encoder's (bhr_tpu's) and the
# standard-library path's. PNG is lossless, so a level changes a file's
# size and the time to write it, never a pixel.
NATIVE_PNG_LEVEL = 2
PNG_LEVEL = 6
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def compute_edge_alpha(height: int, inner_soft: float = 0.1, outer_soft: float = 0.3) -> np.ndarray:
    """Radial edge-softening alpha for an (n_r,) texture column.

    Cubic ramp over the inner `inner_soft` fraction, quadratic falloff over
    the outer `outer_soft` fraction.
    """
    v = np.linspace(0.0, 1.0, height).astype(np.float32)
    alpha = np.ones_like(v)
    inner = v < inner_soft
    outer = v > (1.0 - outer_soft)
    alpha[inner] = (v[inner] / inner_soft) ** 3.0
    alpha[outer] = ((1.0 - v[outer]) / outer_soft) ** 2.0
    return alpha


def load_disk_texture(path: Optional[str]) -> Optional[np.ndarray]:
    """Load an external disk texture -> (h, w, 4) RGBA with edge softening."""
    if path and os.path.isfile(path):
        from PIL import Image

        img = Image.open(path).convert("RGB")
        rgb = np.asarray(img, dtype=np.float32) / 255.0
        h, w = rgb.shape[:2]
        alpha = np.broadcast_to(compute_edge_alpha(h)[:, None], (h, w)).copy()
        return np.concatenate([rgb, alpha[:, :, None]], axis=2)
    return None


def write_json_atomic(path: str, obj) -> None:
    """Write JSON via a temporary file and ``os.replace``, so a kill in
    mid-write never leaves truncated JSON (the video resume protocol
    reads this file back)."""
    import json

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def quantize_frame(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) float [0,1] or uint8 -> uint8 (round, not truncate —
    the same quantizer as the JAX package)."""
    if image.dtype == np.uint8:
        return image
    return np.round(np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def encode_png_rgb8(img_uint8: np.ndarray, level: int = PNG_LEVEL) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 image: 8-bit RGB, filter 0 on
    every scanline, one zlib stream at ``level``."""
    if img_uint8.dtype != np.uint8 or img_uint8.ndim != 3 or img_uint8.shape[2] != 3:
        raise ValueError(
            f"expected (H, W, 3) uint8, got {img_uint8.shape} {img_uint8.dtype}")
    h, w = img_uint8.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: filter type 0
    raw[:, 1:] = img_uint8.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_MAGIC + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The PNG Paeth predictor of int16 (left, up, upper-left) bytes."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png_rgb8(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, for 8-bit RGB, non-interlaced files
    with any of the five scanline filters: the frames this package
    writes (filter 0) and those ``bhr_tpu``'s encoders write. Anything
    else (palette, alpha, 16-bit, interlaced, a bad CRC) raises
    ValueError.

    None, Sub and Up rows are undone with whole-row NumPy operations;
    Average and Paeth rows depend on the pixel to their left and are
    undone pixel by pixel."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or struct.unpack(">I", crc)[0] != (
                zlib.crc32(tag + body) & 0xFFFFFFFF):
            raise ValueError(f"PNG chunk {tag!r} is truncated or fails its CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(
            f"only 8-bit RGB non-interlaced PNGs are read, got depth {depth} "
            f"color type {color} interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + 3 * w):
        raise ValueError(f"PNG data has {raw.size} bytes, expected {h * (1 + 3 * w)}")
    raw = raw.reshape(h, 1 + 3 * w)
    out = np.empty((h, w, 3), np.uint8)
    prev = np.zeros((w, 3), np.uint8)
    for y in range(h):
        kind = int(raw[y, 0])
        row = raw[y, 1:].reshape(w, 3)
        if kind == 0:
            cur = row
        elif kind == 1:  # Sub: running sum along the row, mod 256
            cur = np.cumsum(row, axis=0, dtype=np.uint8)
        elif kind == 2:  # Up
            cur = row + prev
        elif kind in (3, 4):  # Average, Paeth
            cur = np.empty((w, 3), np.int16)
            up = prev.astype(np.int16)
            diff = row.astype(np.int16)
            left = np.zeros(3, np.int16)
            up_left = np.zeros(3, np.int16)
            for x in range(w):
                pred = ((left + up[x]) >> 1 if kind == 3
                        else _paeth(left, up[x], up_left))
                left = (diff[x] + pred) & 0xFF
                up_left = up[x]
                cur[x] = left
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"PNG scanline {y} has unknown filter {kind}")
        out[y] = cur
        prev = out[y]
    return out


def load_png_rgb8(path: str) -> np.ndarray:
    """Read an 8-bit RGB PNG file -> (H, W, 3) uint8 (``decode_png_rgb8``)."""
    with open(path, "rb") as f:
        return decode_png_rgb8(f.read())


def save_image(image: np.ndarray, path: str) -> None:
    """Save an (H, W, 3) image (float in [0, 1] or uint8) as PNG: through
    the native encoder where it built, else ``encode_png_rgb8``. Every
    writer of a run (threads, a resume, a fleet's processes) goes through
    here on one host, so they all write the same bytes for a frame."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"save_image writes PNG only, got {path!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img = quantize_frame(np.asarray(image))
    if native.png_available():
        native.save_png_rgb8(img, path, level=NATIVE_PNG_LEVEL)
        return
    data = encode_png_rgb8(img)
    with open(path, "wb") as f:
        f.write(data)


class AsyncPNGWriter:
    """Bounded-queue asynchronous PNG writer: frames are encoded and
    written by a thread pool while the caller goes on rendering.

    ``submit(image, path, ready=None)``: ``ready``, if given, is waited
    on (``ready.synchronize()``, a CUDA event) in the worker before it
    reads ``image``, so a frame still on its way from the device can be
    queued at once. It returns the write's future, for a caller that
    waits for some frames and not for all. ``drain()`` returns once
    every queued frame is on disk and raises the first failure. Each
    frame's encode and write is the span ``writers.png``
    (``utils.profiling.SPANS``).
    """

    def __init__(self, max_workers: int = 2, max_pending: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._pending: List[Future] = []
        self._max_pending = max_pending

    def _write(self, image, path: str, ready) -> None:
        if ready is not None:
            ready.synchronize()
        with span("writers.png"):
            save_image(np.asarray(image), path)

    def submit(self, image, path: str, ready=None) -> Future:
        if len(self._pending) >= self._max_pending:
            self._pending.pop(0).result()
        future = self._pool.submit(self._write, image, path, ready)
        self._pending.append(future)
        return future

    def drain(self) -> None:
        # Every future is waited for before the first failure is raised,
        # so no write is still running when the caller handles it.
        pending, self._pending = self._pending, []
        errors = [f.exception() for f in pending]
        for exc in errors:
            if exc is not None:
                raise exc

    def close(self) -> None:
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)


def _chunk_header(fourcc: bytes, size: int) -> bytes:
    return fourcc + struct.pack("<I", size)


class MJPEGAVIWriter:
    """Streaming MJPEG AVI writer, with ``native.H264Writer``'s interface:
    open on the frame size, ``write`` (H, W, 3) uint8 frames in order,
    ``close`` to write the index and finish the headers, ``abort`` to
    stop without them. A context manager: closes on success, aborts on
    any in-flight exception.

    The headers are written with placeholder sizes, each frame is
    appended as one ``00dc`` chunk (peak memory is one frame), and
    ``close`` writes the ``idx1`` index and patches the RIFF, movi, avih
    and strh fields in place. The result is playable by ffplay, VLC and
    browsers and re-muxable to MP4 later (``ffmpeg -i x.avi -c copy
    x.mp4``).

    Each frame is JPEG-encoded by Pillow straight into the open file:
    into a real file Pillow's encoder holds no GIL for the whole encode
    (into a ``BytesIO`` it takes the GIL back for every 64 KiB block), so
    an encoder thread leaves the render loop's thread its speed. A file
    ``abort`` left behind has no index and zero sizes in its headers.
    """

    def __init__(self, path: str, width: int, height: int, fps: int,
                 quality: int = 92):
        from PIL import Image  # before the file is touched

        self._image = Image
        self._width, self._height = int(width), int(height)
        self._fps, self._quality = int(fps), quality
        self._index = []  # (offset in the movi list, size) of each frame
        self._offset = 4  # relative to the start of the 'movi' fourcc
        self._max_size = 0
        strf = struct.pack(
            "<IiiHH4sIiiII",
            40, self._width, self._height, 1, 24, b"MJPG",
            self._width * self._height * 3, 0, 0, 0, 0,
        )
        hdrl_payload = (
            b"hdrl"
            + _chunk_header(b"avih", 56) + self._avih()
            + _chunk_header(b"LIST", 4 + 8 + 56 + 8 + len(strf))
            + b"strl"
            + _chunk_header(b"strh", 56) + self._strh()
            + _chunk_header(b"strf", len(strf)) + strf
        )
        self._fh = open(path, "wb")
        self._fh.write(_chunk_header(b"RIFF", 0) + b"AVI ")
        self._hdrl_at = self._fh.tell()
        self._fh.write(_chunk_header(b"LIST", len(hdrl_payload)) + hdrl_payload)
        self._movi_at = self._fh.tell()
        self._fh.write(_chunk_header(b"LIST", 0) + b"movi")

    def _avih(self) -> bytes:
        fps = self._fps
        return struct.pack(
            "<14I",
            int(1_000_000 / max(fps, 1)),  # microseconds per frame
            self._max_size * fps,          # max bytes per second (bound)
            0,                             # padding granularity
            0x10,                          # AVIF_HASINDEX
            len(self._index), 0, 1, self._max_size, self._width,
            self._height, 0, 0, 0, 0,
        )

    def _strh(self) -> bytes:
        # dwQuality = -1 (the codec's default), dwSampleSize = 0 (required
        # for 'vids' streams: frames are variable-size).
        return struct.pack(
            "<4s4sIHHIIIIIIiI4H",
            b"vids", b"MJPG", 0, 0, 0, 0,
            1, max(self._fps, 1),          # scale / rate -> fps
            0, len(self._index), self._max_size, -1, 0,
            0, 0, self._width, self._height,
        )

    def write(self, frame: np.ndarray) -> None:
        if self._fh is None:
            raise RuntimeError("writer is closed")
        if (frame.dtype != np.uint8
                or frame.shape != (self._height, self._width, 3)):
            raise ValueError(
                f"expected ({self._height}, {self._width}, 3) uint8, got "
                f"{frame.shape} {frame.dtype}")
        fh = self._fh
        at = fh.tell()
        fh.write(_chunk_header(b"00dc", 0))
        self._image.fromarray(np.ascontiguousarray(frame)).save(
            fh, "JPEG", quality=self._quality)
        end = fh.tell()
        size = end - at - 8
        fh.seek(at + 4)
        fh.write(struct.pack("<I", size))
        fh.seek(end)
        # RIFF: ckSize excludes the odd-length pad byte, which is written
        # after the declared payload (a padded-in ckSize makes strict
        # re-muxers carry a trailing 0x00 into the JPEG stream).
        if size % 2:
            fh.write(b"\x00")
        self._index.append((self._offset, size))
        self._offset += 8 + size + size % 2
        self._max_size = max(self._max_size, size)

    def close(self) -> None:
        if self._fh is None:
            return
        fh, self._fh = self._fh, None
        with fh:
            fh.write(_chunk_header(b"idx1", 16 * len(self._index)))
            fh.write(b"".join(struct.pack("<4sIII", b"00dc", 0x10, off, size)
                              for off, size in self._index))
            riff_size = fh.tell() - 8
            fh.seek(4)
            fh.write(struct.pack("<I", riff_size))
            # The offsets grew by 8 + payload + pad a chunk from 4 (the
            # 'movi' fourcc): exactly the movi list's payload size.
            fh.seek(self._movi_at + 4)
            fh.write(struct.pack("<I", self._offset))
            # hdrl layout: LIST(8) 'hdrl'(4) 'avih'+size(8) <avih 56>
            #              LIST(8) 'strl'(4) 'strh'+size(8) <strh 56> ...
            fh.seek(self._hdrl_at + 20)
            fh.write(self._avih())
            fh.seek(self._hdrl_at + 20 + 56 + 8 + 4 + 8)
            fh.write(self._strh())

    def abort(self) -> None:
        """Close the file without its index or sizes."""
        if self._fh is not None:
            fh, self._fh = self._fh, None
            fh.close()

    def __enter__(self) -> "MJPEGAVIWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


def mjpeg_avi_path(output_path: str) -> str:
    """Where the MJPEG AVI of a video lands: ``output_path`` itself if it
    is an ``.avi``, else the same name with ``.avi``."""
    base, ext = os.path.splitext(output_path)
    return output_path if ext.lower() == ".avi" else base + ".avi"


def write_mjpeg_avi(
    frame_paths: List[str], output_path: str, fps: int,
    quality: int = 92,
) -> None:
    """Assemble PNG frames into an MJPEG AVI with no external encoder
    (``MJPEGAVIWriter``): the post-pass's last resort, for hosts without
    the native H.264 writer or an ffmpeg CLI."""
    if not frame_paths:
        raise ValueError("no frames to assemble")
    first = load_png_rgb8(frame_paths[0])
    height, width = first.shape[:2]
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with MJPEGAVIWriter(output_path, width, height, fps,
                        quality=quality) as writer:
        writer.write(first)
        for path in frame_paths[1:]:
            writer.write(load_png_rgb8(path))


# Containers the native H.264 writer handles; shared by the inline
# assembler and the post-pass native path so they can never disagree.
H264_CONTAINER_EXTS = (".mp4", ".mkv", ".mov")


class InlineVideoAssembler:
    """Encode the orbit video while frames render, from host memory.

    Each rendered frame is already in host memory when its PNG is
    queued, so it is fed straight into a streaming writer; on an
    uninterrupted run the video is finished the moment the last frame
    renders, and the post-pass (which would decode every PNG again)
    never runs. The writer is chosen once, at birth, from what the host
    has, in the post-pass chain's order (``modes._assemble_video``):

    - ``kind == "native"``: the native H.264 writer
      (``bhr_tpu_torch.native.H264Writer``) at ``output_path``, where it
      works and the output is an H.264 container;
    - ``kind == "mjpeg"``: else, on a host with no ffmpeg CLI, the MJPEG
      AVI writer (``MJPEGAVIWriter``) at ``mjpeg_avi_path(output_path)``,
      the file the post-pass would write;
    - ``kind is None``: else inert, and the post-pass runs ffmpeg.

    ``path`` is the file it writes. Each ``submit`` is one span,
    ``writers.h264`` or ``writers.mjpeg`` (``utils.profiling.SPANS``).

    The PNG frames stay the durability anchor, untouched:

    - resume: frames completed by an earlier run exist only on
      disk; ``submit`` catches up by decoding the gap frames (in index
      order) before encoding the fresh one.
    - interruption or any encode error: the writer is aborted (no
      trailer or index) and the partial file removed; ``finalize`` then
      reports False and the caller falls back to the post-pass chain.
    - unavailability (neither writer, odd dimensions for H.264, no
      Pillow for MJPEG): the assembler is inert and ``finalize`` returns
      False.

    Frames are quantized with the same ``quantize_frame`` as the PNG
    writer, so the inline video holds the pixels a post-pass one would.

    Use as a context manager around the whole render-and-finalize
    region: ``__exit__`` discards on any in-flight exception (those
    raised after the frame loop too, e.g. a failed PNG drain), so no
    partial file survives at the advertised path.
    """

    def __init__(self, output_path: str, n_frames: int, fps: int,
                 temp_dir: str, crf: int = 18):
        self._n = n_frames
        self._fps = fps
        self._crf = crf
        self._dir = temp_dir
        self._writer = None
        self._next = 0
        # True once this run touched the file at self.path: discard()
        # must never delete a video this run did not open (e.g. an inert
        # assembler and Ctrl-C).
        self._opened = False
        ext = os.path.splitext(output_path)[1].lower()
        if ext in H264_CONTAINER_EXTS and native.video_available():
            self.kind, self.path = "native", output_path
        elif shutil.which("ffmpeg") is None:
            self.kind, self.path = "mjpeg", mjpeg_avi_path(output_path)
        else:
            self.kind, self.path = None, output_path
        self._dead = self.kind is None

    def _open(self, width: int, height: int):
        # What makes a writer refuse the frames is checked before the
        # filesystem is touched: a condition that makes the assembler
        # inert must not mark the output file as this run's.
        if self.kind == "native" and ((height % 2) or (width % 2)):
            raise ValueError(f"odd dimensions {width}x{height} for yuv420p")
        if self.kind == "mjpeg":
            import PIL.Image  # noqa: F401  (the writer's one dependency)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # From here the open may create or truncate the file.
        self._opened = True
        if self.kind == "native":
            return native.H264Writer(self.path, width, height, self._fps,
                                     crf=self._crf)
        return MJPEGAVIWriter(self.path, width, height, self._fps)

    def _encode(self, rgb: np.ndarray) -> None:
        if self._writer is None:
            self._writer = self._open(rgb.shape[1], rgb.shape[0])
        self._writer.write(rgb)
        self._next += 1

    def _catch_up(self, upto: int) -> None:
        while self._next < upto:
            self._encode(load_png_rgb8(
                os.path.join(self._dir, f"frame_{self._next:04d}.png")))

    def submit(self, frame_idx: int, image: np.ndarray) -> None:
        """Feed frame ``frame_idx`` (a fresh render, float [0,1] or uint8).

        Must be called in increasing frame order; earlier frames that
        were never submitted in this run are read from their PNGs.
        Never raises on an encode problem: the assembler goes inert and
        the post-pass fallback takes over at ``finalize``."""
        if self._dead or frame_idx >= self._n:
            return
        try:
            with span("writers.h264" if self.kind == "native"
                      else "writers.mjpeg"):
                self._catch_up(frame_idx)
                self._encode(quantize_frame(np.asarray(image)))
        except Exception as exc:
            self._report_fallback(exc)
            self.discard()

    def finalize(self) -> bool:
        """Close the container. True = the video is complete at
        ``path``; False = the caller must run the post-pass chain."""
        if self._dead:
            return False
        try:
            self._catch_up(self._n)
            if self._writer is None:  # zero frames
                raise RuntimeError("no frames were encoded")
            writer, self._writer = self._writer, None
            writer.close()
            self._dead = True
            return True
        except Exception as exc:
            self._report_fallback(exc)
            self.discard()
            return False

    def _report_fallback(self, exc: Exception) -> None:
        """One line when inline assembly dies: without it the post-pass
        fallback would take over in silence."""
        if not self._dead:
            what = "H.264" if self.kind == "native" else "MJPEG AVI"
            print(f"inline {what} assembly failed at frame {self._next} "
                  f"({exc!r}); the post-pass assembler will run instead")

    def discard(self) -> None:
        """Abort without a trailer or index and, if this run wrote to
        ``path``, remove the partial file (a video this run did not open
        is never deleted). Idempotent; the PNG frames are untouched."""
        if self._writer is not None:
            writer, self._writer = self._writer, None
            writer.abort()
        self._dead = True
        if self._opened:
            self._opened = False
            try:
                os.remove(self.path)
            except OSError:
                pass

    def __enter__(self) -> "InlineVideoAssembler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.discard()
