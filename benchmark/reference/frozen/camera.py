"""Pinhole camera model.

The camera always looks at the origin (the black hole). A copy of
``bhr_tpu/camera.py`` (framework-free NumPy), so the port needs no JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Camera:
    """Camera basis + pixel footprint on the image plane (1 unit in front).

    Attributes:
        pos: camera position (3,) float32.
        right/up/forward: orthonormal basis (3,) each; forward points at
            the origin.
        pixel_width/pixel_height: image-plane extent of one pixel.
        width/height: image resolution in pixels.
    """

    pos: np.ndarray
    right: np.ndarray
    up: np.ndarray
    forward: np.ndarray
    pixel_width: float
    pixel_height: float
    width: int
    height: int


def build_camera(cam_pos: Sequence[float], fov_deg: float, width: int, height: int) -> Camera:
    """Build a pinhole camera looking from ``cam_pos`` at the origin.

    The image plane sits 1 unit in front of the camera; the vertical FOV is
    ``fov_deg``. World up is +z; when the camera is on the z-axis the right
    vector degenerates and falls back to +x.
    """
    pos = np.asarray(cam_pos, dtype=np.float64)
    forward = -pos / np.linalg.norm(pos)

    world_up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, world_up)
    rn = np.linalg.norm(right)
    if rn < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / rn
    up = np.cross(right, forward)
    up = up / np.linalg.norm(up)

    fov_rad = np.radians(fov_deg)
    aspect = width / height
    plane_h = 2.0 * np.tan(fov_rad / 2.0)
    plane_w = plane_h * aspect

    return Camera(
        pos=pos.astype(np.float32),
        right=right.astype(np.float32),
        up=up.astype(np.float32),
        forward=forward.astype(np.float32),
        pixel_width=float(plane_w / width),
        pixel_height=float(plane_h / height),
        width=int(width),
        height=int(height),
    )


def orbit_camera_position(frame: int, n_frames: int, orbit_degrees: float,
                          base_pos: Sequence[float]) -> Tuple[float, float, float]:
    """Camera position for orbit-video frame ``frame``.

    Rotates around the z-axis at constant radius and constant z, sweeping
    ``orbit_degrees`` (negative = reverse) over ``n_frames``.
    Parity: reference render.py:4440-4447.
    """
    base = np.asarray(base_pos, dtype=np.float64)
    radius = float(np.linalg.norm(base))
    angle = np.radians(frame * orbit_degrees / n_frames)
    return (radius * np.cos(angle), radius * np.sin(angle), float(base[2]))
