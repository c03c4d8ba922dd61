"""Disk V2 geometry: boundaries, masks, smooth weights.

The port of ``bhr_tpu/models/disk_v2/geometry.py`` (reference
disk_v2/geometry.py). Invariant kept from the design
(design_ad_v2.md:180-193): hard masks use closed-interval membership
(boundary points count as inside) while smooth weights close to exactly
0 on those same boundaries, so base fields vanish smoothly at the
geometric surface.

Everything broadcasts over float32 tensors and runs on the device of
its tensor inputs; a Python number is taken as a 0-d float32 tensor on
that device (on the CPU when no input is a tensor), so scalar inputs
return 0-d tensors (use float() to unwrap).
"""

from __future__ import annotations

import torch

from .params import DiskV2Params

_EPS = 2.220446049250313e-16  # float64 machine epsilon, matching the
# reference's np.finfo guards even though the arithmetic is float32: it
# only keeps divisions from a zero denominator.


def as_tensors(*xs):
    """The inputs as float32 tensors on the device of the first tensor
    among them (the CPU when there is none)."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(
        x if isinstance(x, torch.Tensor)
        else torch.as_tensor(x, dtype=torch.float32, device=device)
        for x in xs)


def smoothstep(edge0: float, edge1: float, x) -> torch.Tensor:
    """Cubic smoothstep: 0 below edge0, 1 above edge1, C1-smooth between."""
    if edge1 <= edge0:
        raise ValueError("edge1 must be greater than edge0")
    (x,) = as_tensors(x)
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def disk_half_thickness(r, params: DiskV2Params) -> torch.Tensor:
    """H(r) = h0 * r * (r / r_in)^beta_h, with r clamped to >= r_in."""
    (r,) = as_tensors(r)
    safe_r = torch.clamp(r, min=params.r_in)
    return params.h0 * safe_r * torch.pow(safe_r / params.r_in, params.beta_h)


def disk_radial_mask(r, params: DiskV2Params) -> torch.Tensor:
    """Hard membership: r_in <= r <= r_out (closed interval)."""
    (r,) = as_tensors(r)
    return (r >= params.r_in) & (r <= params.r_out)


def disk_radial_weight(r, params: DiskV2Params) -> torch.Tensor:
    """Smooth radial window W_r(r) in [0, 1].

    W_r = smoothstep(r_in, r_in + dr, r) * (1 - smoothstep(r_out - dr,
    r_out, r)) with dr = edge_softness * (r_out - r_in); exactly 0 at
    and outside both boundaries.
    """
    (r,) = as_tensors(r)
    span = params.r_out - params.r_in
    soft = max(span * params.edge_softness, _EPS)
    inner = smoothstep(params.r_in, params.r_in + soft, r)
    outer = 1.0 - smoothstep(params.r_out - soft, params.r_out, r)
    w = inner * outer
    return torch.where((r <= params.r_in) | (r >= params.r_out), 0.0, w)


