"""Screen-space lens flare as one vectorized pass (plain torch).

Part of the frozen copy (see the package docstring): the port's
``ops/lens_flare.py: apply_lens_flare`` (reference
``TaichiRenderer._apply_lens_flare``, render.py:3925-4028): the
brightness centroid of the disk layer places the light; 8 ghost blobs
along the light -> center line, 3 colored diffraction rings, a
hexagonal aperture ring and 4 star streaks, all resolution-scaled, are
added and the result clamped. Angles use the exact ``torch.atan2``.

Image layout is (H, W, 3); x = column, y = row. The dark-disk guard is
a ``torch.where``, not a host branch.
"""

from __future__ import annotations

import math

import torch


def apply_lens_flare(final: torch.Tensor, disk: torch.Tensor) -> torch.Tensor:
    """Add the flare stack to ``final`` based on the disk layer's centroid.

    Args:
        final: (H, W, 3) composed image.
        disk: (H, W, 3) disk layer (light source for the flare).
    Returns:
        (H, W, 3) image with flare, clipped to [0, 1]; ``final`` unchanged
        where the disk is essentially dark (total brightness < 0.01).
    """
    h, w = final.shape[0], final.shape[1]
    dev = final.device
    f32 = torch.float32
    scale = min(w, h) / 360.0

    def color(*rgb):
        return torch.tensor(rgb, dtype=f32, device=dev)

    brightness = torch.amax(disk, dim=-1)  # (H, W)
    total = torch.sum(brightness)

    ys, xs = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    safe_total = torch.clamp(total, min=1e-6)
    light_x = torch.sum(xs * brightness) / safe_total
    light_y = torch.sum(ys * brightness) / safe_total
    cx, cy = w / 2.0, h / 2.0

    intensity = torch.clamp(total / (w * h * 0.3), max=1.0) * 1.5

    flare = torch.zeros_like(final)

    # -- ghost blobs along the light -> screen-center line ---------------
    ghost_col = color(1.0, 0.9, 0.7)
    for g in range(8):
        t = (g + 1) * 0.15
        gx = light_x + (cx - light_x) * t
        gy = light_y + (cy - light_y) * t
        gsize = (25.0 + g * 30.0) * scale
        dist = torch.sqrt((xs - gx) ** 2 + (ys - gy) ** 2)
        alpha = torch.where(
            dist < gsize,
            (1.0 - dist / gsize) ** 2 * (1.0 - g * 0.08) * intensity,
            0.0,
        )
        flare = flare + alpha[..., None] * ghost_col

    # -- diffraction rings with dispersion-tinted colors ------------------
    ring_colors = (color(0.3, 0.4, 1.0), color(0.5, 0.5, 0.9),
                   color(0.7, 0.5, 0.8))
    for i in range(3):
        ring_t = 0.35 + i * 0.15
        rx = light_x + (cx - light_x) * ring_t
        ry = light_y + (cy - light_y) * ring_t
        ring_r = (60.0 + i * 40.0) * scale
        ring_w = (6.0 + i * 3.0) * scale
        dist = torch.sqrt((xs - rx) ** 2 + (ys - ry) ** 2)
        alpha = (
            torch.clamp(1.0 - torch.abs(dist - ring_r) / ring_w, 0.0, 1.0) ** 2
            * 0.5
            * intensity
            * (1.0 - i * 0.25)
        )
        flare = flare + alpha[..., None] * ring_colors[i]

    # -- hexagonal aperture ring ------------------------------------------
    hx = light_x + (cx - light_x) * 0.5
    hy = light_y + (cy - light_y) * 0.5
    hex_r = 100.0 * scale
    dx = xs - hx
    dy = ys - hy
    angle = torch.atan2(dy, dx)
    dist = torch.sqrt(dx ** 2 + dy ** 2)
    hex_edge = torch.abs(torch.remainder(angle, math.pi / 3.0) - math.pi / 6.0)
    hex_factor = torch.clamp(1.0 - hex_edge / 0.2, 0.0, 1.0)
    alpha = (
        torch.clamp(1.0 - torch.abs(dist - hex_r) / (15.0 * scale), 0.0, 1.0) ** 2
        * hex_factor
        * 0.3
        * intensity
    )
    flare = flare + alpha[..., None] * color(0.6, 0.7, 1.0)

    # -- 4 star streaks -----------------------------------------------------
    streak_len = min(w, h) * 0.4
    dx = xs - light_x
    dy = ys - light_y
    dist = torch.sqrt(dx ** 2 + dy ** 2)
    angle = torch.atan2(dy, dx)
    falloff = torch.exp(-dist / streak_len)
    streak_col = color(1.0, 0.95, 0.9)
    for main_angle in (0.0, math.pi / 2, math.pi, 3 * math.pi / 2):
        diff = torch.abs(
            torch.remainder(angle - main_angle + math.pi, 2 * math.pi) - math.pi)
        streak = torch.where(diff < 0.05, falloff * intensity * 0.3, 0.0)
        flare = flare + streak[..., None] * streak_col

    out = torch.clamp(final + flare, 0.0, 1.0)
    # Disabled when the disk is essentially dark (reference guard).
    return torch.where(total < 0.01, final, out)
