"""Disk V2 preview renders.

The port of ``bhr_tpu/models/disk_v2/preview.py``: quick diagnostic
views of the V2 fields without ray tracing:
  * top view: face-on midplane emissivity map in cartesian coordinates;
  * cross-section: (r, z) slice of density / temperature.
"""

from __future__ import annotations

from typing import Optional

import torch

from .geometry import disk_half_thickness
from .integrator import emissivity_volume
from .palette import apply_palette
from .params import DiskV2Params, DiskV2StructureParams
from .physical_fields import density_field, midplane_temperature_field, temperature_field


def render_top_view(
    params: DiskV2Params,
    structure_params: Optional[DiskV2StructureParams] = None,
    size: int = 512,
    seed: int = 42,
    t: float = 0.0,
    palette: str = "cinematic",
    device="cpu",
) -> torch.Tensor:
    """(size, size, 3) face-on view of the midplane emission."""
    extent = params.r_out * 1.05
    xs = torch.linspace(-extent, extent, size, dtype=torch.float32,
                        device=device)
    x, y = torch.meshgrid(xs, -xs, indexing="xy")
    r = torch.sqrt(x**2 + y**2)
    phi = torch.atan2(y, x)

    j, _ = emissivity_volume(r, torch.zeros_like(r), phi, params,
                             structure_params, seed=seed, t=t)
    t_mid = midplane_temperature_field(r, params)
    t_norm = t_mid / (torch.max(t_mid) + 1e-9)
    rgb = apply_palette(
        j.reshape(-1) / (torch.max(j) + 1e-9) * 3.0,
        t_norm.reshape(-1),
        palette,
    )
    return rgb.reshape(size, size, 3)


def render_cross_section(
    params: DiskV2Params,
    size_r: int = 512,
    size_z: int = 128,
    field: str = "density",
    device="cpu",
) -> torch.Tensor:
    """(size_z, size_r) vertical slice of density or temperature."""
    f32 = dict(dtype=torch.float32, device=device)
    rs = torch.linspace(params.r_in * 0.8, params.r_out * 1.05, size_r, **f32)
    # Span the ACTUAL outer half-thickness H(r_out) = h0*r_out*
    # (r_out/r_in)^beta_h with headroom; a plain h0*r_out*2 clips the
    # flared surface when the flare exponent makes (r_out/r_in)^beta_h
    # exceed 2.
    z_max = 1.25 * float(disk_half_thickness(params.r_out, params))
    zs = torch.linspace(-z_max, z_max, size_z, **f32)
    r_g, z_g = torch.meshgrid(rs, zs, indexing="xy")
    if field == "density":
        vals = density_field(r_g, z_g, params)
    elif field == "temperature":
        vals = temperature_field(r_g, z_g, params)
    else:
        raise ValueError(f"unknown field: {field}")
    return vals / (torch.max(vals) + 1e-9)
