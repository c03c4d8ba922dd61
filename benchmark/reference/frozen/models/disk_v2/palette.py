"""Disk V2 palette: temperature + intensity -> RGB.

The port of ``bhr_tpu/models/disk_v2/palette.py``. Two mappings:

  * scientific: blackbody chromaticity at a physical temperature scale,
    luminance directly proportional to integrated intensity.
  * cinematic: warm-shifted blackbody with soft Reinhard luminance
    roll-off, matching the main renderer's look (color clamped so white
    never drifts blue, like the V1 compose).
"""

from __future__ import annotations

import torch

from ...ops.shading import blackbody_rgb


def apply_palette(
    intensity: torch.Tensor,
    temperature: torch.Tensor,
    mode: str = "cinematic",
    *,
    t_min: float = 2000.0,
    t_max: float = 12000.0,
    exposure: float = 1.0,
) -> torch.Tensor:
    """Map (intensity, normalized temperature in [0, 1]) -> RGB.

    Args:
        intensity: (N,) nonnegative path-integrated intensities.
        temperature: (N,) normalized temperatures (0 = coolest visible).
        mode: "scientific" | "cinematic".
    Returns:
        (N, 3) RGB in [0, 1].
    """
    temp_n = torch.clamp(temperature, 0.0, 1.0)
    t_k = t_min + temp_n * (t_max - t_min)
    color = blackbody_rgb(t_k)

    if mode == "scientific":
        lum = torch.clamp(intensity * exposure, 0.0, 1.0)
    elif mode == "cinematic":
        # Warm shift: damp blue, never exceed red; Reinhard luminance.
        # A new tensor, never a write into blackbody_rgb's result.
        color = torch.stack(
            [color[..., 0], color[..., 1],
             torch.minimum(color[..., 2] * 0.85, color[..., 0])], dim=-1)
        x = intensity * exposure
        lum = x / (1.0 + x)
    else:
        raise ValueError(f"unknown palette mode: {mode}")
    return torch.clamp(color * lum[..., None], 0.0, 1.0)
