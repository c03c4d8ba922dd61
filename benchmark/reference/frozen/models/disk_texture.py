"""The disk texture's compose: the 13 lifecycle components mixed into a
polar (n_r, n_phi, RGBA) texture.

The part of the port's ``models/disk_texture.py`` (reference render.py:
795-2010) that the lifecycle disk composes through
(``models/dynamic_disk.py``):

  density = (0.15 + 0.10 spiral + 0.30 turbulence + 0.20 hotspot
             + 0.30 filaments + 0.20 rt) * disturb_mod * edge / P98
  temperature = max(temp_base clamped per-row, temp_struct / P95 * 0.8)
  RGB = blackbody(T_min + temp*(0.9+0.25 az) * (T_max-T_min)) * sqrt(T)
  alpha = density

The static texture's generators are not copied: no cell of the
benchmark renders a static texture.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.shading import blackbody_rgb

_TWO_PI = 2.0 * math.pi


# Compose: 13-component contract (reference render.py:3169-3259 /
# 1014-1021). Component pack order (reference upload_parametric_state,
# render.py:2328-2350): 0 temp_base 1 spiral 2 spiral_temp 3 turbulence
# 4 turb_temp 5 arcs 6 arcs_temp 7 rt_spikes 8 rt_temp 9 hotspot
# 10 hotspot_temp 11 az_hotspot 12 disturb_mod.


def density_from_comp(comp, edge, enable_rt: bool):
    """Weighted density mix of the 13-component pack — the density
    contract shared by compose and the normalization stats."""
    rt_w = 0.20 if enable_rt else 0.0
    return (
        0.15 + 0.10 * comp[1] + 0.30 * comp[3] + 0.20 * comp[9]
        + 0.30 * comp[5] + rt_w * comp[7]
    ) * comp[12] * edge[:, None]


def temp_struct_from_comp(comp):
    """Structural-temperature sum of the 13-component pack (reference
    render.py:3196)."""
    return (comp[2] + comp[4] + comp[6] + comp[8] + comp[10]) * comp[12]


def _normalize_and_colorize(
    temp_base, temp_struct, density, az_hotspot,
    density_p98, struct_scale, row_stats, color_temp,
):
    """Normalization + colorize chain given precomputed stats (reference
    GPU kernel math, render.py:3189-3238)."""
    density = torch.clamp(density / (density_p98 + 1e-6), 0.0, 1.0)
    ts_scaled = torch.clamp(temp_struct / (struct_scale + 1e-6) * 0.8, 0.0, 1.2)
    ceiling = torch.clamp(row_stats[:, 1], min=0.05)
    tb = torch.minimum(temp_base, ceiling[:, None])
    tb = torch.minimum(tb, row_stats[:, 0][:, None])
    temperature = torch.clamp(torch.maximum(tb, ts_scaled), 0.0, 1.0)
    return _colorize(temperature, az_hotspot, density, color_temp)


def _colorize(temperature, az_hotspot, density, color_temp):
    """Blackbody coloring: color_temp shifts the [T_min, T_max] mapping."""
    t_factor = (color_temp - 4500.0) / (6500.0 - 2700.0)
    t_min = 2000.0 + t_factor * 1000.0
    t_max = 9000.0 + t_factor * 3000.0

    temp_aniso = torch.clamp(temperature * (0.9 + 0.25 * az_hotspot), 0.0, 1.0)
    t_k = t_min + temp_aniso * (t_max - t_min)
    bb = blackbody_rgb(t_k)
    # White-hot must not drift blue: clamp B <= R.
    bb = torch.cat([bb[..., :2], torch.minimum(bb[..., 2:3], bb[..., 0:1])],
                   dim=-1)
    lum = torch.clamp(torch.sqrt(temp_aniso), 0.0, 1.0)
    rgb = torch.clamp(bb * lum[..., None], 0.0, 1.0)
    return torch.cat([rgb, torch.clamp(density, 0.0, 1.0)[..., None]], dim=-1)


def _roll_rows_by(field: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-row circular shift along phi by -shifts[r] pixels, of an
    (..., n_r, n_phi) stack of fields."""
    n_phi = field.shape[-1]
    cols = torch.arange(n_phi, device=field.device)[None, :]
    src = torch.remainder(cols + shifts.to(torch.int64)[:, None], n_phi)
    return torch.gather(field, -1, src.expand(field.shape))


def compose_from_components(
    comp: torch.Tensor,
    edge: torch.Tensor,
    density_p98: torch.Tensor,
    struct_scale: torch.Tensor,
    row_stats: torch.Tensor,
    enable_rt: bool,
    color_temp,
    t_offset=0.0,
    omega_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Compose the (n_r, n_phi, 4) RGBA texture from the (13, n_r, n_phi)
    components, rotated per row by ``t_offset * omega_rows`` (the
    reference GPU compose kernel's contract, render.py:3169-3259).

    A host-scalar ``t_offset`` of 0 (the lifecycle path: its rotation
    lives in the background's rotating coordinates and the entity phases)
    skips the roll. The roll moves the four mixed planes, not the 13
    components: every plane rolls by the same per-row shift and the mixes
    are per texel, so the two orders give the same texture.
    """
    temp_base = comp[0]
    temp_struct = temp_struct_from_comp(comp)
    density = density_from_comp(comp, edge, enable_rt)
    az = comp[11]
    if not (isinstance(t_offset, (int, float)) and float(t_offset) == 0.0):
        n_phi = comp.shape[2]
        t = torch.as_tensor(t_offset, dtype=torch.float32, device=comp.device)
        shift = (t * omega_rows / _TWO_PI * n_phi).to(torch.int32)
        temp_base, temp_struct, density, az = (
            _roll_rows_by(p, shift)
            for p in (temp_base, temp_struct, density, az))
    return _normalize_and_colorize(
        temp_base, temp_struct, density, az,
        density_p98, struct_scale, row_stats, color_temp,
    )
