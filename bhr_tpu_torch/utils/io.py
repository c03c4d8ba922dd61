"""Image IO: PNG save, disk texture loading, edge alpha.

The port of the still-frame part of ``bhr_tpu/utils/io.py``. The PNG
writer needs nothing beyond the standard library (``zlib`` and
``struct``), so a host with neither Pillow nor imageio can save frames;
Pillow is imported only to read an explicit ``--disk_texture`` file.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


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


def encode_png_rgb8(img_uint8: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 image: 8-bit RGB, filter 0 on
    every scanline, one zlib stream."""
    if img_uint8.dtype != np.uint8 or img_uint8.ndim != 3 or img_uint8.shape[2] != 3:
        raise ValueError(
            f"expected (H, W, 3) uint8, got {img_uint8.shape} {img_uint8.dtype}")
    h, w = img_uint8.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: filter type 0
    raw[:, 1:] = img_uint8.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image(image: np.ndarray, path: str) -> None:
    """Save an (H, W, 3) image (float in [0, 1] or uint8) as PNG."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"save_image writes PNG only, got {path!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = encode_png_rgb8(quantize_frame(np.asarray(image)))
    with open(path, "wb") as f:
        f.write(data)
