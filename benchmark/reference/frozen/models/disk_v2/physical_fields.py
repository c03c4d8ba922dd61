"""Disk V2 base physical fields: Omega(r), rho(r, z), T(r, z).

The port of ``bhr_tpu/models/disk_v2/physical_fields.py`` (reference
disk_v2/physical_fields.py):
    Omega(r) = omega_scale * (r/r_in)^(-3/2)
    rho_mid(r) = (r/r_in)^(-rho_power) * W_r(r)
    T_mid(r) = temp_scale * (r/r_in)^(-3/4) * (1 - sqrt(r_in/r))^(1/4) * W_r
    rho(r,z) = rho_mid * exp(-z^2 / (2 H^2)) * W_z, zeroed outside the volume
    T(r,z)   = T_mid * clip(1 - 0.25 |z|/H, 0, 1) * W_z, zeroed outside

``density_temperature_fields`` computes rho and T of the same points
together: the slab integrator needs both, and H(r), W_r, W_z and the
volume mask are each computed once for the two (XLA merges the repeats
in ``bhr_tpu``'s compiled program; eager PyTorch would launch them
twice). The operations and their order are those of ``geometry``'s
functions, so the shared terms equal them bit for bit.
"""

from __future__ import annotations

import torch

from .geometry import (
    _EPS,
    as_tensors,
    disk_radial_mask,
    disk_radial_weight,
    smoothstep,
)
from .params import DiskV2Params


def angular_velocity_field(r, params: DiskV2Params) -> torch.Tensor:
    """Keplerian angular velocity scaling (always positive; no cutoff)."""
    (r,) = as_tensors(r)
    safe_r = torch.clamp(r, min=params.r_in)
    return params.omega_scale * torch.pow(safe_r / params.r_in, -1.5)


def density_temperature_fields(r, z, params: DiskV2Params):
    """(rho(r, z), T(r, z)) of the same points, over shared H(r), W_r,
    W_z and volume mask."""
    r, z = as_tensors(r, z)
    safe_r = torch.clamp(r, min=params.r_in)
    ratio = safe_r / params.r_in
    half = params.h0 * safe_r * torch.pow(ratio, params.beta_h)  # H(r)
    thickness = torch.clamp(half, min=_EPS)
    w_r = disk_radial_weight(r, params)
    in_radius = disk_radial_mask(r, params)
    abs_z = torch.abs(z)
    w_z = torch.where(in_radius,
                      1.0 - smoothstep(0.0, 1.0, abs_z / thickness), 0.0)
    in_volume = in_radius & (abs_z <= half)

    rho = (
        torch.pow(ratio, -params.rho_power) * w_r
        * torch.exp(-0.5 * torch.square(z / thickness))
        * w_z
    )
    inner = torch.clamp(1.0 - torch.sqrt(params.r_in / safe_r), min=0.0)
    t_mid = torch.where(
        r <= params.r_in, 0.0,
        params.temp_scale * torch.pow(ratio, -0.75) * torch.pow(inner, 0.25)
        * w_r)
    temp = (
        t_mid
        * torch.clamp(1.0 - 0.25 * abs_z / thickness, 0.0, 1.0)
        * w_z
    )
    return (torch.where(in_volume, rho, 0.0), torch.where(in_volume, temp, 0.0))
