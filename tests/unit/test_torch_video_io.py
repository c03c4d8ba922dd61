"""The port's video writers: PNG codec, the asynchronous frame writer,
the inline video assembler, the native libavcodec writer and the MJPEG
AVI writer.

* ``decode_png_rgb8`` against Pillow on files written with each of the
  five PNG scanline filters (and a mix), on a Pillow-written file and on
  the port's own: equal pixels. Files it does not read raise ValueError.
* ``write_mjpeg_avi`` and the fallback chain: the conditions of
  ``tests/unit/test_video_assembly.py`` (RIFF structure, decodable JPEG
  frames, an AVI beside the MP4 when no H.264 writer exists); through
  the shared ``MJPEGAVIWriter`` it writes ``bhr_tpu``'s bytes, for JPEGs
  of even and of odd sizes.
* ``InlineVideoAssembler`` with a stub in place of the native
  writer: native H.264, the MJPEG AVI or inert, in the post-pass chain's
  order; catch-up from PNGs in index order, a failed encode goes inert
  and removes only a file this run opened.
* ``H264Writer`` round trip (where the host has libavcodec with an
  H.264 encoder, else skipped): frame count and size from
  ``probe_video``, the first frame back within H.264's loss.

Tests that need Pillow skip where it is missing.
"""

import io
import json
import os
import struct
import threading
import zlib

import numpy as np
import pytest

from bhr_tpu_torch import native
from bhr_tpu_torch.modes import _assemble_video
from bhr_tpu_torch.utils import io as tio
from bhr_tpu_torch.utils.profiling import SPANS
from bhr_tpu_torch.utils.io import (
    AsyncPNGWriter,
    InlineVideoAssembler,
    decode_png_rgb8,
    encode_png_rgb8,
    load_png_rgb8,
    save_image,
    write_json_atomic,
    write_mjpeg_avi,
)


def _image(h=13, w=17, seed=0):
    """A smooth ramp plus seeded noise: every filter has work to do."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 9 + y, y * 11 + 40, (x + y) * 5], -1)
    return ((base + rng.integers(0, 30, (h, w, 3))) % 256).astype(np.uint8)


def _filter_row(kind, cur, prev):
    """PNG filter ``kind`` of one scanline (bytes as int arrays, bpp 3)."""
    cur, prev = cur.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
    up_left = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - up_left
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, up_left))
    return ((cur - pred) % 256).astype(np.uint8)


def _png_with_filters(img, kinds, idat_parts=1):
    """PNG bytes of ``img`` whose row y uses filter kinds[y % len(kinds)]."""
    h, w = img.shape[:2]
    rows, prev = [], np.zeros(3 * w, np.uint8)
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = img[y].reshape(-1)
        rows.append(bytes([kind]) + _filter_row(kind, cur, prev).tobytes())
        prev = cur
    data = zlib.compress(b"".join(rows), 6)
    step = -(-len(data) // idat_parts)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + b"".join(chunk(b"IDAT", data[i:i + step])
                       for i in range(0, len(data), step))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 1, 3, 0, 2)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_decode_png_matches_pillow_on_every_filter(kinds):
    Image = pytest.importorskip("PIL.Image")
    img = _image()
    data = _png_with_filters(img, kinds, idat_parts=3)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(ref, img)  # the test's own filters are right
    np.testing.assert_array_equal(decode_png_rgb8(data), ref)


def test_decode_png_reads_pillow_and_own_files(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = _image(36, 64, seed=1)
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, "PNG")  # Pillow's adaptive filters
    np.testing.assert_array_equal(decode_png_rgb8(buf.getvalue()), img)
    path = str(tmp_path / "sub" / "frame.png")
    save_image(img.astype(np.float32) / 255.0, path)
    np.testing.assert_array_equal(load_png_rgb8(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("level", [1, 2, 6, 9])
def test_png_level_changes_bytes_not_pixels(level):
    img = _image(36, 64, seed=2)
    np.testing.assert_array_equal(
        decode_png_rgb8(encode_png_rgb8(img, level=level)), img)
    assert encode_png_rgb8(img) == encode_png_rgb8(img, level=tio.PNG_LEVEL)


def _rgba_png():
    body = struct.pack(">IIBBBBB", 1, 1, 8, 6, 0, 0, 0)
    raw = zlib.compress(b"\x00\x01\x02\x03\x04")
    parts = b"\x89PNG\r\n\x1a\n"
    for tag, data in ((b"IHDR", body), (b"IDAT", raw), (b"IEND", b"")):
        parts += struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    return parts


@pytest.mark.parametrize("data,match", [
    (b"GIF89a" + b"\x00" * 20, "not a PNG"),
    (_rgba_png(), "only 8-bit RGB"),
    (bytearray(encode_png_rgb8(_image())), "CRC"),
    (_png_with_filters(_image(), (7,)), "unknown filter"),
], ids=["magic", "rgba", "crc", "filter"])
def test_decode_png_refuses_what_it_cannot_read(data, match):
    if isinstance(data, bytearray):
        data[45] ^= 0xFF  # a flipped byte inside the IDAT data
        data = bytes(data)
    with pytest.raises(ValueError, match=match):
        decode_png_rgb8(data)


def test_write_json_atomic_replaces_whole_file(tmp_path):
    path = str(tmp_path / "progress.json")
    write_json_atomic(path, {"completed": [0, 1]})
    write_json_atomic(path, {"completed": [0, 1, 2]})
    with open(path) as f:
        assert json.load(f) == {"completed": [0, 1, 2]}
    assert os.listdir(tmp_path) == ["progress.json"]  # no .tmp left


# -- AsyncPNGWriter ---------------------------------------------------------


class _Gate:
    """Stands in for a CUDA event: ``synchronize`` blocks until opened."""

    def __init__(self):
        self._event = threading.Event()
        self.waited = False

    def synchronize(self):
        self.waited = self._event.wait(timeout=30)

    def open(self):
        self._event.set()


def test_async_writer_waits_for_the_frame_before_reading_it(tmp_path):
    mark = SPANS.mark()
    writer = AsyncPNGWriter(max_workers=2, max_pending=4)
    frame = np.zeros((8, 8, 3), np.uint8)
    gate = _Gate()
    path = str(tmp_path / "frame_0000.png")
    writer.submit(frame, path, ready=gate)
    frame[:] = 200  # the copy "lands" only now
    gate.open()
    writer.close()
    assert gate.waited
    assert (load_png_rgb8(path) == 200).all()
    assert SPANS.count("writers.png", mark) == 1
    assert SPANS.samples("writers.png", mark)[0] > 0


def test_async_writer_drain_raises_a_failed_write(tmp_path, monkeypatch):
    real = tio.save_image

    def flaky(img, path):
        if "0001" in path:
            raise OSError("simulated disk-full")
        return real(img, path)

    monkeypatch.setattr(tio, "save_image", flaky)
    writer = AsyncPNGWriter(max_workers=2, max_pending=8)
    for f in range(3):
        writer.submit(np.zeros((4, 4, 3), np.uint8),
                      str(tmp_path / f"frame_{f:04d}.png"))
    with pytest.raises(OSError, match="disk-full"):
        writer.drain()
    writer.close()  # nothing left to raise, the pool stops
    assert sorted(os.listdir(tmp_path)) == ["frame_0000.png", "frame_0002.png"]


# -- MJPEG AVI (the conditions of test_video_assembly.py) --------------------


def _make_frames(tmp_path, n=4, w=64, h=32):
    paths = []
    for i in range(n):
        img = np.zeros((h, w, 3), np.float32)
        img[:, : (i + 1) * 8, i % 3] = 1.0
        p = os.path.join(tmp_path, f"frame_{i:04d}.png")
        save_image(img, p)
        paths.append(p)
    return paths


def test_mjpeg_avi_structure_and_frames(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    paths = _make_frames(str(tmp_path))
    out = os.path.join(str(tmp_path), "out.avi")
    write_mjpeg_avi(paths, out, fps=2)

    with open(out, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8

    avih_at = data.find(b"avih")
    fields = struct.unpack("<14I", data[avih_at + 8: avih_at + 8 + 56])
    assert fields[4] == 4 and fields[8] == 64 and fields[9] == 32
    assert data.find(b"idx1") > 0

    strh_at = data.find(b"strh")
    s_fields = struct.unpack(
        "<4s4sIHHIIIIIIiI4H", data[strh_at + 8: strh_at + 8 + 56])
    assert s_fields[0] == b"vids" and s_fields[1] == b"MJPG"
    assert s_fields[6] == 1 and s_fields[7] == 2  # scale=1, rate=fps
    assert s_fields[9] == 4  # dwLength = n frames
    assert s_fields[12] == 0  # dwSampleSize == 0 (variable-size frames)

    # Walk the movi LIST chunk by chunk: every 00dc chunk decodes as a
    # JPEG of the right size, with the RIFF pad byte outside its size.
    movi_at = data.find(b"LIST", 12)
    while data[movi_at + 8: movi_at + 12] != b"movi":
        movi_at = data.find(
            b"LIST", movi_at + 8 + struct.unpack(
                "<I", data[movi_at + 4: movi_at + 8])[0])
    movi_size = struct.unpack("<I", data[movi_at + 4: movi_at + 8])[0]
    pos, end, count = movi_at + 12, movi_at + 8 + movi_size, 0
    while pos < end:
        assert data[pos: pos + 4] == b"00dc"
        size = struct.unpack("<I", data[pos + 4: pos + 8])[0]
        jpg = data[pos + 8: pos + 8 + size]
        assert jpg[-2:] == b"\xff\xd9", "ckSize must end at the JPEG EOI"
        assert Image.open(io.BytesIO(jpg)).size == (64, 32)
        count += 1
        pos += 8 + size + (size % 2)
    assert count == 4
    with pytest.raises(ValueError, match="no frames"):
        write_mjpeg_avi([], out, fps=2)


def _jpeg_size(img, quality=92):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return len(buf.getvalue())


@pytest.mark.parametrize("parity", [0, 1], ids=["even", "odd"])
def test_mjpeg_avi_is_bhr_tpus_bytes(tmp_path, parity):
    """The shared writer, through ``write_mjpeg_avi``, writes the file
    ``bhr_tpu``'s writer does; frames whose JPEGs are all of one parity
    (odd ones carry the RIFF pad byte)."""
    pytest.importorskip("PIL.Image")
    from bhr_tpu.utils.io import write_mjpeg_avi as bhr_tpu_write_mjpeg_avi

    frames = [img for img in (_image(h=18, w=32, seed=s) for s in range(40))
              if _jpeg_size(img) % 2 == parity][:3]
    assert len(frames) == 3
    paths = []
    for i, img in enumerate(frames):
        paths.append(str(tmp_path / f"frame_{i:04d}.png"))
        save_image(img, paths[-1])
    ours, theirs = str(tmp_path / "ours.avi"), str(tmp_path / "theirs.avi")
    write_mjpeg_avi(paths, ours, fps=5)
    bhr_tpu_write_mjpeg_avi(paths, theirs, fps=5)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_mjpeg_writer_refuses_a_wrong_frame_and_abort_stops(tmp_path):
    pytest.importorskip("PIL.Image")
    path = str(tmp_path / "v.avi")
    writer = tio.MJPEGAVIWriter(path, 6, 4, fps=2)
    with pytest.raises(ValueError, match=r"expected \(4, 6, 3\) uint8"):
        writer.write(np.zeros((4, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        writer.write(np.zeros((4, 6, 3), np.float32))
    writer.write(_value_frame(7))
    writer.abort()
    with pytest.raises(RuntimeError, match="closed"):
        writer.write(_value_frame(7))
    writer.close()  # after abort: nothing to finish
    with open(path, "rb") as f:
        data = f.read()
    assert data.find(b"idx1") < 0 and struct.unpack("<I", data[4:8])[0] == 0


def test_assemble_video_falls_back_to_avi(tmp_path, monkeypatch, capsys):
    pytest.importorskip("PIL.Image")
    import bhr_tpu_torch.modes as modes

    _make_frames(str(tmp_path))
    out = os.path.join(str(tmp_path), "vid.mp4")
    # A host with neither the native writer nor an ffmpeg CLI.
    monkeypatch.setattr(native, "video_available", lambda: False)
    monkeypatch.setattr(modes.shutil, "which", lambda name: None)
    assert _assemble_video(str(tmp_path), out, 4, 2) == "mjpeg"
    assert not os.path.exists(out)
    assert os.path.getsize(os.path.join(str(tmp_path), "vid.avi")) > 0
    assert "MJPEG AVI fallback" in capsys.readouterr().out


def test_assemble_video_keeps_frames_when_every_assembler_fails(
        tmp_path, monkeypatch, capsys):
    import bhr_tpu_torch.modes as modes

    paths = _make_frames(str(tmp_path))
    monkeypatch.setattr(native, "video_available", lambda: False)
    monkeypatch.setattr(modes.shutil, "which", lambda name: None)

    def no_pillow(*args, **kwargs):
        raise ImportError("No module named 'PIL'")

    monkeypatch.setattr(modes, "write_mjpeg_avi", no_pillow)
    out = os.path.join(str(tmp_path), "vid.mp4")
    assert _assemble_video(str(tmp_path), out, 4, 2) == "none"
    assert f"frames kept in {tmp_path}" in capsys.readouterr().out
    assert all(os.path.exists(p) for p in paths)


# -- InlineVideoAssembler with a stub writer ---------------------------------


class _StubWriter:
    """Records what the assembler feeds it; creates the file like the
    native open does."""

    instances = []

    def __init__(self, path, width, height, fps, crf=18):
        self.path, self.size, self.fps, self.crf = path, (width, height), fps, crf
        self.frames, self.state = [], "open"
        with open(path, "wb") as f:
            f.write(b"partial")
        _StubWriter.instances.append(self)

    def write(self, rgb):
        if self.fail_at is not None and len(self.frames) == self.fail_at:
            raise RuntimeError("simulated encode failure")
        assert rgb.dtype == np.uint8
        self.frames.append(int(rgb[0, 0, 0]))

    fail_at = None

    def close(self):
        self.state = "closed"

    def abort(self):
        self.state = "aborted"


@pytest.fixture()
def stub_native(monkeypatch):
    _StubWriter.instances = []
    monkeypatch.setattr(_StubWriter, "fail_at", None)
    monkeypatch.setattr(native, "video_available", lambda: True)
    monkeypatch.setattr(native, "H264Writer", _StubWriter)
    return _StubWriter


def _value_frame(v, h=4, w=6):
    return np.full((h, w, 3), v, np.uint8)


def test_assembler_catches_up_from_pngs_in_index_order(tmp_path, stub_native):
    for f in (0, 1, 3):  # frames an earlier run left on disk
        save_image(_value_frame(10 * f), str(tmp_path / f"frame_{f:04d}.png"))
    out = str(tmp_path / "out" / "v.mp4")
    mark = SPANS.mark()
    with InlineVideoAssembler(out, 5, 24, str(tmp_path), crf=20) as asm:
        asm.submit(2, _value_frame(20).astype(np.float32) / 255.0)
        asm.submit(4, _value_frame(40))
        asm.submit(5, _value_frame(50))  # beyond n_frames: ignored
        assert asm.finalize() is True
        assert asm.finalize() is False  # closed: nothing more to do
    (writer,) = stub_native.instances
    assert writer.frames == [0, 10, 20, 30, 40]
    assert (writer.size, writer.fps, writer.crf) == ((6, 4), 24, 20)
    assert writer.state == "closed" and os.path.exists(out)
    assert SPANS.count("writers.h264", mark) == 2


def test_assembler_finalize_reads_trailing_frames(tmp_path, stub_native):
    for f in (1, 2):
        save_image(_value_frame(10 * f), str(tmp_path / f"frame_{f:04d}.png"))
    asm = InlineVideoAssembler(str(tmp_path / "v.mkv"), 3, 24, str(tmp_path))
    asm.submit(0, _value_frame(0))
    assert asm.finalize() is True
    assert stub_native.instances[0].frames == [0, 10, 20]


@pytest.mark.parametrize("ext, codec, ffmpeg, kind, path", [
    (".mp4", True, False, "native", "v.mp4"),
    (".mkv", True, True, "native", "v.mkv"),
    (".mp4", False, False, "mjpeg", "v.avi"),
    (".avi", True, False, "mjpeg", "v.avi"),
    (".mp4", False, True, None, "v.mp4"),
    (".avi", True, True, None, "v.avi"),
])
def test_assembler_picks_its_writer_in_the_chains_order(
        tmp_path, stub_native, monkeypatch, ext, codec, ffmpeg, kind, path):
    """Native H.264 where it can write the container, else the MJPEG AVI
    where no ffmpeg CLI would come before it, else inert (the post-pass
    runs ffmpeg): the post-pass chain's order, chosen at birth."""
    monkeypatch.setattr(native, "video_available", lambda: codec)
    monkeypatch.setattr(tio.shutil, "which",
                        lambda name: "/usr/bin/ffmpeg" if ffmpeg else None)
    asm = InlineVideoAssembler(str(tmp_path / ("v" + ext)), 2, 24, str(tmp_path))
    assert (asm.kind, asm.path) == (kind, str(tmp_path / path))
    asm.submit(0, _value_frame(0))
    asm.submit(1, _value_frame(1))
    assert asm.finalize() is (kind is not None)
    assert len(stub_native.instances) == (kind == "native")
    assert os.path.exists(asm.path) is (kind is not None)
    if kind == "mjpeg":
        with open(asm.path, "rb") as f:
            data = f.read()
        assert data[:4] == b"RIFF" and data.count(b"00dc") == 2 + 2  # idx1 too


@pytest.mark.parametrize("why", ["avi", "no_codec", "odd"])
def test_assembler_inert_never_touches_an_existing_video(tmp_path, stub_native,
                                                         monkeypatch, why):
    # With no H.264 writer for the output, only a host with an ffmpeg CLI
    # leaves the assembler inert (without one it writes the MJPEG AVI).
    monkeypatch.setattr(tio.shutil, "which", lambda name: "/usr/bin/" + name)
    if why == "no_codec":
        monkeypatch.setattr(native, "video_available", lambda: False)
    out = str(tmp_path / ("v.avi" if why == "avi" else "v.mp4"))
    with open(out, "wb") as f:
        f.write(b"an earlier run's finished video")
    asm = InlineVideoAssembler(out, 2, 24, str(tmp_path))
    frame = _value_frame(1, h=5) if why == "odd" else _value_frame(1)
    asm.submit(0, frame)
    asm.submit(1, frame)
    assert asm.finalize() is False
    asm.discard()
    assert stub_native.instances == []  # no writer was ever opened
    with open(out, "rb") as f:
        assert f.read() == b"an earlier run's finished video"


def test_assembler_failed_encode_removes_its_own_partial_file(
        tmp_path, stub_native, monkeypatch, capsys):
    monkeypatch.setattr(_StubWriter, "fail_at", 1)
    out = str(tmp_path / "v.mp4")
    asm = InlineVideoAssembler(out, 3, 24, str(tmp_path))
    asm.submit(0, _value_frame(0))
    assert os.path.exists(out)
    asm.submit(1, _value_frame(1))  # fails: goes inert, never raises
    assert "post-pass assembler will run instead" in capsys.readouterr().out
    assert stub_native.instances[0].state == "aborted"
    assert not os.path.exists(out)
    asm.submit(2, _value_frame(2))
    assert asm.finalize() is False


def test_assembler_discards_on_exception_in_its_block(tmp_path, stub_native):
    out = str(tmp_path / "v.mp4")
    with pytest.raises(KeyboardInterrupt):
        with InlineVideoAssembler(out, 3, 24, str(tmp_path)) as asm:
            asm.submit(0, _value_frame(0))
            raise KeyboardInterrupt
    assert stub_native.instances[0].state == "aborted"
    assert not os.path.exists(out)


# -- the native writer -------------------------------------------------------


def test_native_unavailable_says_why_once(monkeypatch, capsys):
    from bhr_tpu_torch import _build

    def no_libav(name, link_flags=()):
        raise RuntimeError("g++ failed to build fastvideo.cpp (exit 1):\n"
                           "fatal error: libavcodec/avcodec.h: No such file")

    monkeypatch.setattr(native, "_loaded", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_libav)
    assert native.video_available() is False
    assert native.video_available() is False
    out = capsys.readouterr().out
    assert out.count("native H.264 writer unavailable") == 1
    assert "avcodec.h" in out
    with pytest.raises(RuntimeError, match="unavailable"):
        native.probe_video("x.mp4")


def test_h264_writer_round_trip(tmp_path):
    if not native.video_available():
        pytest.skip("no g++ / libavcodec with an H.264 encoder on this host")
    h, w, n = 36, 64, 5
    y, x = np.mgrid[0:h, 0:w]
    frames = [np.stack([(x * 3 + 10 * i) % 256, y * 5 % 256,
                        np.full((h, w), 90)], -1).astype(np.uint8)
              for i in range(n)]
    path = str(tmp_path / "clip.mp4")
    with native.H264Writer(path, w, h, fps=12, crf=10) as writer:
        for frame in frames:
            writer.write(frame)
        with pytest.raises(ValueError, match="writer is 64x36"):
            writer.write(np.zeros((h, w + 2, 3), np.uint8))
    assert native.probe_video(path) == (n, w, h)
    first = native.read_first_frame(path, w, h)
    assert first.shape == (h, w, 3)
    assert np.abs(first.astype(np.int32) - frames[0]).mean() < 8  # lossy codec
    # The same frames give the same bytes: the encode is a pure function.
    again = str(tmp_path / "again.mp4")
    with native.H264Writer(again, w, h, fps=12, crf=10) as writer:
        for frame in frames:
            writer.write(frame)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="even dimensions"):
        native.H264Writer(str(tmp_path / "odd.mp4"), 63, 36, 12)
    # An aborted write leaves no playable file behind.
    aborted = str(tmp_path / "aborted.mp4")
    with pytest.raises(RuntimeError, match="boom"):
        with native.H264Writer(aborted, w, h, fps=12) as writer:
            writer.write(frames[0])
            raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match="probe failed"):
        native.probe_video(aborted)
