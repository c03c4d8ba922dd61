"""The scene helpers of the port's ``config.py`` that a frame needs,
taking plain values where the port takes its ``SceneConfig``."""

from __future__ import annotations

import math
from typing import Tuple


def torch_device(name):
    """The torch device of ``name`` (a string or a ``torch.device``)."""
    import torch

    return torch.device(name)


def _cam_distance(cam_pos) -> float:
    """Euclidean camera distance |cam_pos| (host float)."""
    return math.sqrt(sum(float(c) ** 2 for c in cam_pos))


def escape_radius(r_max: float, cam_pos) -> float:
    """Trace escape radius: ``max(r_max, 2 x camera distance)``."""
    return max(float(r_max), 2.0 * _cam_distance(cam_pos))


def orbit_escape_radius(r_max: float, pov) -> float:
    """The escape radius of every frame of an orbit video: each camera
    sits at distance ``sqrt(|pov|**2 + pov_z**2)``."""
    d = math.sqrt(_cam_distance(pov) ** 2 + float(pov[2]) ** 2)
    return max(float(r_max), 2.0 * d)


def compute_disk_texture_resolution(
    width: int,
    height: int,
    cam_pos: Tuple[float, float, float],
    fov: float,
    r_inner: float,
    r_outer: float,
) -> Tuple[int, int]:
    """Camera-dependent polar texture size (n_phi, n_r).

    ~1 phi sample per screen pixel of disk coverage, 0.5 radial samples;
    floors of 256/128, rounded up to multiples of 16.
    """
    cam_dist = math.sqrt(sum(c * c for c in cam_pos))
    ang_radius = math.atan(r_outer / cam_dist)
    ang_extent = 2.0 * ang_radius
    screen_fraction = fov * math.pi / 180.0

    n_phi = int(width * (ang_extent / screen_fraction))
    n_r = int(height * (ang_radius / screen_fraction) * 0.5)
    n_phi = max(256, n_phi)
    n_r = max(128, n_r)
    n_phi += (16 - n_phi % 16) % 16
    n_r += (16 - n_r % 16) % 16
    return n_phi, n_r
