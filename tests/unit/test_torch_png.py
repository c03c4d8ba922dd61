"""The port's native PNG encoder (``csrc/fastpng.cpp``) vs bhr_tpu's.

``test_native_fastpng.py``'s conditions for ``bhr_tpu_torch.native``:
round trips of random and gradient images, every level and the
extremes, a file equal to the encoded bytes, bad inputs, non-contiguous
input, the same pixels through the native and the standard-library
paths of ``save_image``. Beyond them: the bytes equal
``bhr_tpu.native.encode_png_rgb8``'s for the same array, level and
deflate backend; every file decodes through the port's
``decode_png_rgb8`` and through Pillow; ``AsyncPNGWriter`` writes the
native bytes; the link attempts fall through to zlib and keep the failed
attempt's output; an encoder that does not build says why once.
``bhr_tpu``'s switch ``BHR_TPU_NATIVE`` has no counterpart: the port has
no switch.
"""

import ctypes
import io
import os
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from bhr_tpu import native as jnative

from bhr_tpu_torch import _build, native
from bhr_tpu_torch.utils import io as tio

LEVELS = (0, 1, 2, 6, 9)


@pytest.fixture
def encoder():
    if not native.png_available():
        pytest.skip("the native PNG encoder did not build on this host")
    return native


def _random(shape, seed=42):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def _gradient(h=90, w=160):
    # Smooth gradients on black make rows pick Sub and Up (a random
    # image always picks None).
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = np.exp(-((x - 80) ** 2 + (y - 45) ** 2) / 400.0)
    img[..., 1] = x / w
    img[..., 2] = y / h
    return (img * 255).astype(np.uint8)


def _extremes():
    arr = np.zeros((16, 16, 3), np.uint8)
    arr[8:, 8:] = 255
    return arr


def _decoded(data):
    """The image by the port's decoder, after checking Pillow agrees."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    ours = tio.decode_png_rgb8(data)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), ours)
    return ours


def _filters(data):
    """The filter byte of every scanline of an 8-bit RGB PNG."""
    w = int.from_bytes(data[16:20], "big")
    idat, pos = b"", 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(-1, 1 + 3 * w)[:, 0].tolist())


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 7, 3), (5, 1, 3), (2, 2, 3),
                                   (33, 61, 3), (128, 256, 3)])
def test_roundtrip_random_images(encoder, shape):
    arr = _random(shape)
    np.testing.assert_array_equal(_decoded(encoder.encode_png_rgb8(arr)), arr)


def test_roundtrip_gradient_frame_uses_sub_and_up(encoder):
    arr = _gradient()
    data = encoder.encode_png_rgb8(arr)
    np.testing.assert_array_equal(_decoded(data), arr)
    assert {1, 2} <= _filters(data)


@pytest.mark.parametrize("level", LEVELS)
def test_roundtrip_levels_and_extremes(encoder, level):
    for arr in (_extremes(), _gradient(), _random((24, 40, 3), seed=level)):
        np.testing.assert_array_equal(
            _decoded(encoder.encode_png_rgb8(arr, level=level)), arr)


@pytest.mark.parametrize("level", LEVELS)
def test_bytes_equal_bhr_tpu(encoder, level):
    if not jnative.available():
        pytest.skip("bhr_tpu's native PNG encoder did not build on this host")
    # Both builds prefer libdeflate, so on one host they link the same.
    ours = "libdeflate" if jnative._get_lib("fastpng").fastpng_backend() else "zlib"
    assert encoder.png_backend() == ours
    for arr in (_extremes(), _gradient(), _random((33, 61, 3)),
                _random((128, 256, 3), seed=level)):
        assert encoder.encode_png_rgb8(arr, level=level) == \
            jnative.encode_png_rgb8(arr, level=level)


def test_write_to_file_matches_encode(encoder, tmp_path):
    arr = _random((24, 40, 3), seed=7)
    path = str(tmp_path / "frame.png")
    encoder.save_png_rgb8(arr, path)
    with open(path, "rb") as f:
        data = f.read()
    assert data == encoder.encode_png_rgb8(arr)
    np.testing.assert_array_equal(_decoded(data), arr)


def test_rejects_bad_inputs(encoder, tmp_path):
    path = str(tmp_path / "x.png")
    with pytest.raises(ValueError):
        encoder.save_png_rgb8(np.zeros((4, 4, 4), np.uint8), path)
    with pytest.raises(ValueError):
        encoder.save_png_rgb8(np.zeros((4, 4, 3), np.float32), path)
    with pytest.raises(ValueError):
        encoder.encode_png_rgb8(np.zeros((4, 4), np.uint8))
    with pytest.raises(RuntimeError, match="code 5"):
        # A directory that does not exist: fopen fails.
        encoder.save_png_rgb8(np.zeros((4, 4, 3), np.uint8),
                              str(tmp_path / "missing" / "x.png"))


def test_non_contiguous_input(encoder):
    view = _random((20, 20, 3), seed=3)[::2, ::2]
    assert not view.flags.c_contiguous
    np.testing.assert_array_equal(_decoded(encoder.encode_png_rgb8(view)), view)
    assert encoder.encode_png_rgb8(view) == encoder.encode_png_rgb8(
        np.ascontiguousarray(view))


def test_save_image_writes_native_bytes(encoder, tmp_path):
    arr = _gradient(36, 64)
    path = str(tmp_path / "sub" / "u8.png")
    tio.save_image(arr, path)
    with open(path, "rb") as f:
        data = f.read()
    assert data == encoder.encode_png_rgb8(arr, level=tio.NATIVE_PNG_LEVEL)
    np.testing.assert_array_equal(_decoded(data), arr)


def test_save_image_float_quantization_parity(encoder, tmp_path, monkeypatch):
    """The native and the standard-library paths of ``save_image`` store
    the same pixels for a float image."""
    img = np.random.default_rng(11).random((12, 18, 3)).astype(np.float32)
    p_native, p_zlib = str(tmp_path / "n.png"), str(tmp_path / "z.png")
    tio.save_image(img, p_native)
    monkeypatch.setattr(native, "png_available", lambda: False)
    tio.save_image(img, p_zlib)
    with open(p_native, "rb") as f:
        a = f.read()
    with open(p_zlib, "rb") as f:
        b = f.read()
    assert a == encoder.encode_png_rgb8(tio.quantize_frame(img), level=2)
    assert b == tio.encode_png_rgb8(tio.quantize_frame(img))
    np.testing.assert_array_equal(_decoded(a), _decoded(b))
    np.testing.assert_array_equal(_decoded(a), tio.quantize_frame(img))


def test_async_writer_writes_native_frames(encoder, tmp_path):
    frames = [_gradient(36, 64) // (i + 1) for i in range(5)]
    writer = tio.AsyncPNGWriter(max_workers=2, max_pending=2)
    paths = [str(tmp_path / f"frame_{i:04d}.png") for i in range(5)]
    for img, path in zip(frames, paths):
        writer.submit(img, path)
    writer.close()
    assert len(writer.encode_s) == 5
    for img, path in zip(frames, paths):
        with open(path, "rb") as f:
            data = f.read()
        assert data == encoder.encode_png_rgb8(img, level=tio.NATIVE_PNG_LEVEL)
        np.testing.assert_array_equal(tio.load_png_rgb8(path), img)


def _encode_with(lib, arr, level):
    """PNG bytes of ``arr`` through a loaded fastpng library."""
    native._declare_png(lib)
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    h, w = arr.shape[:2]
    assert lib.fastpng_encode_rgb8(arr.ctypes.data_as(ctypes.c_void_p), w, h,
                                   level, ctypes.byref(out), ctypes.byref(n)) == 0
    try:
        return ctypes.string_at(out.value, n.value)
    finally:
        lib.fastpng_free(out)


@pytest.fixture(scope="module")
def zlib_builds(tmp_path_factory):
    """(the port's encoder linked to zlib through its second link attempt,
    bhr_tpu's source built with zlib): the backend of a host without
    libdeflate, such as the GPU machine."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    ours = _build.build_host(
        "fastpng", ("-DUSE_LIBDEFLATE", "-lbhr_no_such_library"), ("-lz",))
    so = str(tmp_path_factory.mktemp("fastpng") / "libfastpng_zlib.so")
    src = os.path.join(os.path.dirname(jnative.__file__), "fastpng.cpp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", so, src,
                    "-lz"], check=True, capture_output=True, timeout=120)
    return ours, ctypes.CDLL(so)


def test_link_attempts_fall_through_to_zlib(zlib_builds):
    ours, _ = zlib_builds
    # The failed attempt's output is kept beside the one that built.
    assert "bhr_no_such_library" in ours.log and "-lz: exit 0" in ours.log
    native._declare_png(ours.lib)
    assert ours.lib.fastpng_backend() == 0
    arr = _gradient(24, 32)
    np.testing.assert_array_equal(_decoded(_encode_with(ours.lib, arr, 2)), arr)


@pytest.mark.parametrize("level", LEVELS)
def test_zlib_bytes_equal_bhr_tpu(zlib_builds, level):
    ours, theirs = zlib_builds
    for arr in (_extremes(), _gradient(), _random((128, 256, 3), seed=level)):
        assert _encode_with(ours.lib, arr, level) == _encode_with(theirs, arr, level)


def test_library_from_another_host_is_built_again():
    # A keyed library that does not load here (as one built on a host with
    # other shared libraries) is built again, not reported unavailable. In
    # fresh processes: this one may hold the file loaded already.
    code = ("from bhr_tpu_torch import _build\n"
            "b = _build.build_host('fastpng', ('-lz', '-lm'))\n"  # a key of its own
            "print(b.path, b.seconds > 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def build():
        proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        path, rebuilt = proc.stdout.split()[-2:]
        return path, rebuilt == "True"

    path, _ = build()
    with open(path, "wb") as f:
        f.write(b"not a shared library")
    assert build() == (path, True)
    assert build() == (path, False)


def test_unavailable_encoder_says_why_once(monkeypatch, capsys, tmp_path):
    def no_zlib(name, *attempts):
        raise RuntimeError("g++ failed to build fastpng.cpp (2 attempt(s)):\n"
                           "fatal error: zlib.h: No such file or directory")

    monkeypatch.setattr(native, "_png_loaded", False)
    monkeypatch.setattr(native, "_png_lib", None)
    monkeypatch.setattr(_build, "build_host", no_zlib)
    assert native.png_available() is False
    assert native.png_available() is False
    out = capsys.readouterr().out
    assert out.count("native PNG encoder unavailable") == 1
    assert "zlib.h" in out
    with pytest.raises(RuntimeError, match="unavailable"):
        native.encode_png_rgb8(np.zeros((2, 2, 3), np.uint8))
    arr = _random((9, 13, 3), seed=5)
    path = str(tmp_path / "fallback.png")
    tio.save_image(arr, path)  # the standard-library path
    with open(path, "rb") as f:
        assert f.read() == tio.encode_png_rgb8(arr)
