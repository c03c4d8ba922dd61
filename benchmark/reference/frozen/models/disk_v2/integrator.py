"""Disk V2 emission-absorption path integration.

The port of ``bhr_tpu/models/disk_v2/integrator.py``: finite-thickness
radiative transfer I = integral j * exp(-tau) ds through the disk slab,
with grazing-angle opacity gain, unified advection phi_adv =
phi - Omega(r) t, and structure modulation of the emissivity.

It fits the deferred-shading pipeline: each recorded disk-plane crossing
(hit position + ray direction from the geodesic tracer) becomes a short
straight segment through the slab (curvature over one slab thickness is
negligible), integrated with a fixed number of samples, vectorized over
hits. This replaces the texture lookup of the texture-model path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .geometry import disk_half_thickness
from .params import DiskV2Params, DiskV2StructureParams
from .physical_fields import density_temperature_fields
from .structure_modulations import structure_modulation


def integrate_emission(
    hit_pos: torch.Tensor,
    ray_dir: torch.Tensor,
    params: DiskV2Params,
    structure_params: Optional[DiskV2StructureParams] = None,
    *,
    n_samples: int = 8,
    opacity_scale: float = 1.5,
    emission_scale: float = 1.0,
    seed: int = 42,
    t: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integrate emission through the slab at each midplane crossing.

    Args:
        hit_pos: (N, 3) positions on the disk midplane (local disk frame:
            the disk lies in z = 0; apply any tilt rotation beforehand).
        ray_dir: (N, 3) unit ray directions at the crossings.
        n_samples: fixed sample count along each slab segment.
        opacity_scale: absorption coefficient scale (tau per unit rho*ds).
        emission_scale: emissivity scale.

    Returns:
        (intensity (N,), temperature_mean (N,), alpha (N,)):
        path-integrated I = sum j exp(-tau) ds, the emission-weighted
        mean temperature (for palette mapping), and 1 - exp(-tau_total).
        They live on ``hit_pos``'s device.

    Grazing-angle behavior: the segment length through the slab is
    2 H(r) / |dz_hat|, so shallow rays traverse more material; the
    opacity gain arises geometrically.
    """
    dev = hit_pos.device
    r_hit = torch.sqrt(hit_pos[:, 0] ** 2 + hit_pos[:, 1] ** 2)
    h = disk_half_thickness(r_hit, params)  # (N,)
    dz = ray_dir[:, 2]
    inv_dz = 1.0 / torch.clamp(torch.abs(dz), min=0.05)  # cap grazing gain
    half_len = h * inv_dz  # half segment length through the slab

    # Sample midpoints, symmetric about the crossing.
    u = (torch.arange(n_samples, dtype=torch.float32, device=dev) + 0.5) / n_samples
    s = (u[None, :] * 2.0 - 1.0) * half_len[:, None]  # (N, S)
    ds = (2.0 * half_len / n_samples)[:, None]  # (N, 1)

    pts = hit_pos[:, None, :] + s[..., None] * ray_dir[:, None, :]  # (N,S,3)
    r_s = torch.sqrt(pts[..., 0] ** 2 + pts[..., 1] ** 2)
    z_s = pts[..., 2]
    del pts

    # Thin-slab modulation: the structure modulation varies on disk
    # scales (m=1/2 modes, low-frequency shear texture, hotspot radii),
    # larger than the slab segment, so instead of evaluating the full
    # stack at every quadrature sample it is evaluated at the segment's
    # ENTRY and EXIT points only and linearly interpolated across
    # samples. The two-point lerp keeps first-order accuracy for grazing
    # rays, whose segment can sweep a large azimuth arc (half_len up to
    # 20 H at the inv_dz cap) where a single midpoint sample would
    # misplace hotspot edges.
    rho_s, temp_s = density_temperature_fields(r_s, z_s, params)
    del r_s, z_s
    ends = torch.cat(
        [
            hit_pos - half_len[:, None] * ray_dir,  # segment entry (u=0)
            hit_pos + half_len[:, None] * ray_dir,  # segment exit (u=1)
        ],
        dim=0,
    )  # (2N, 3)
    r_ends = torch.sqrt(ends[:, 0] ** 2 + ends[:, 1] ** 2)
    phi_ends = torch.atan2(ends[:, 1], ends[:, 0])
    mod_ends = structure_modulation(
        r_ends, phi_ends, params, structure_params, seed=seed, t=t
    )
    n = hit_pos.shape[0]
    mod = mod_ends[:n, None] * (1.0 - u)[None, :] + mod_ends[n:, None] * u[None, :]
    j = rho_s * temp_s * mod * emission_scale
    dtau = rho_s * opacity_scale * ds

    # Front-to-back transfer: tau before each sample is the cumulative
    # optical depth of preceding samples (exclusive prefix sum).
    tau_before = torch.cumsum(dtau, dim=1) - dtau
    weight = j * torch.exp(-tau_before) * ds
    intensity = torch.sum(weight, dim=1)
    tau_total = torch.sum(dtau, dim=1)
    alpha = 1.0 - torch.exp(-tau_total)

    temp_mean = torch.sum(temp_s * weight, dim=1) / torch.clamp(
        intensity, min=1e-12)
    return intensity, temp_mean, alpha
