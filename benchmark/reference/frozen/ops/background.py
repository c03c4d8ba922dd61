"""Time-evolving background components for the dynamic disk.

The port of ``bhr_tpu/ops/background.py`` (reference GPU background
kernel, render.py:3332-3453): the wide-r component slices [0 temp_base,
1-2 spiral (zeroed), 3-4 turbulence, 11 az_hotspot, 12 disturb_mod] of
the 13-component field, from 3D simplex/FBM noise in seamlessly
rotating coordinates (cos(phi_rot), sin(phi_rot), r) with
phi_rot = phi + omega(r) * t.
"""

from __future__ import annotations

import math

import torch

from .noise import fbm_3d, simplex_noise_3d
from .shading import keplerian_omega


def generate_background_components(
    n_r: int,
    n_phi: int,
    az_freq: float,
    az_shear: float,
    r_inner: float,
    r_outer: float,
    t,
    generation_scale: int = 1,
    device=None,
) -> torch.Tensor:
    """Return a (7, n_r, n_phi) stack for comp indices [0,1,2,3,4,11,12].

    Order in the output stack: [temp_base, spiral(0), spiral_temp(0),
    turbulence, turb_temp, az_hotspot, disturb_mod].

    ``t`` is one time, or a sequence of F times, and then the stacks of
    all F frames come back as (F, 7, n_r, n_phi) from one pass: every
    operation here works element by element, so frame i of that pass
    equals the call with ``t[i]`` alone bit for bit, and the pass
    launches the device operations of one frame, not of F (the noise is
    bound by their launches, not by their sizes).

    ``generation_scale`` > 1 evaluates the noise on an (n_r/s, n_phi/s)
    grid and repeats each value s x s times (reference render.py:78-87).
    """
    if n_r % generation_scale or n_phi % generation_scale:
        raise ValueError(
            f"texture size ({n_r}, {n_phi}) must be divisible by "
            f"generation_scale {generation_scale}"
        )
    f32 = torch.float32
    gr, gp = n_r // generation_scale, n_phi // generation_scale
    r = (torch.arange(gr, dtype=f32, device=device)[:, None]
         * generation_scale / n_r)
    phi = (
        torch.arange(gp, dtype=f32, device=device)[None, :]
        * generation_scale / n_phi * (2.0 * math.pi)
    )
    r = r.expand(gr, gp)
    phi = phi.expand(gr, gp)
    # The scalars arrive as float32 values in the JAX program; round
    # them the same way before they meet the float32 grids.
    az_freq, az_shear, r_inner, r_outer = (
        torch.tensor(v, dtype=f32, device=device)
        for v in (az_freq, az_shear, r_inner, r_outer)
    )
    t = torch.as_tensor(t, dtype=f32).to(device)
    if t.ndim not in (0, 1):
        raise ValueError(f"t must be one time or a sequence, got {t.shape}")
    if t.ndim == 1:
        t = t[:, None, None]  # a leading frame axis on all that moves

    r_phys = r_inner + (r_outer - r_inner) * r
    omega = keplerian_omega(r_phys)
    phi_rot = phi + omega * t
    cx = torch.cos(phi_rot)
    cy = torch.sin(phi_rot)

    def unit(v):
        return torch.clamp(0.5 + 0.5 * v, 0.0, 1.0)

    # temp_base: radial decay x slow FBM.
    decay = torch.pow(torch.clamp(1.0 - r, min=0.0), 1.3)
    tb_noise = unit(fbm_3d(cx * 8.0, cy * 8.0, r * 8.0 + t * 0.05, 4, 0.6, 2.0))
    temp_base = decay * (0.85 + 0.15 * tb_noise) * 0.25

    zeros = torch.zeros_like(temp_base)

    # turbulence: six time-evolving scales.
    t_coarse = unit(fbm_3d(cx * 8.0, cy * 8.0, r * 4.0 + t * 0.06, 3, 0.45, 2.0)) * 0.08
    t_mid = unit(fbm_3d(cx * 24.0, cy * 24.0, r * 12.0 + t * 0.08, 4, 0.45, 2.0)) * 0.15
    t_fine = unit(fbm_3d(cx * 80.0, cy * 80.0, r * 40.0 + t * 0.1, 5, 0.45, 2.0)) * 0.25
    t_extra = unit(fbm_3d(cx * 200.0, cy * 200.0, r * 100.0 + t * 0.12, 4, 0.4, 2.0)) * 0.22
    t_ultra = unit(fbm_3d(cx * 400.0, cy * 400.0, r * 200.0 + t * 0.15, 3, 0.35, 2.0)) * 0.18
    t_pixel = torch.clamp(
        simplex_noise_3d(cx * 800.0, cy * 800.0, r * 400.0 + t * 0.2), 0.0, 1.0
    ) * 0.12
    turb = torch.clamp(t_coarse + t_mid + t_fine + t_extra + t_ultra + t_pixel, 0.0, 1.0)

    # az_hotspot: sinusoidal azimuthal wave with radial shear x FBM.
    shear = torch.pow(r, 1.2) * az_shear
    az_wave = 0.5 + 0.5 * torch.sin((phi_rot + shear) * az_freq)
    az_n = unit(fbm_3d(cx * 3.0, cy * 3.0, r * 3.0 + t * 0.04, 3, 0.5, 2.0))
    az_hotspot = az_wave * az_n

    # disturb_mod: slow multi-scale modulation in [0.1, 1].
    d_coarse = unit(fbm_3d(cx * 8.0, cy * 8.0, r * 4.0 + t * 0.003, 3, 0.5, 2.0)) * 0.05
    d_mid = unit(fbm_3d(cx * 32.0, cy * 32.0, r * 16.0 + t * 0.005, 3, 0.5, 2.0)) * 0.15
    d_fine = unit(fbm_3d(cx * 100.0, cy * 100.0, r * 50.0 + t * 0.006, 4, 0.45, 2.0)) * 0.30
    d_extra = unit(fbm_3d(cx * 250.0, cy * 250.0, r * 125.0 + t * 0.008, 4, 0.4, 2.0)) * 0.30
    d_pixel = torch.clamp(
        simplex_noise_3d(cx * 500.0, cy * 500.0, r * 250.0 + t * 0.01), 0.0, 1.0
    ) * 0.20
    disturb = torch.clamp((d_coarse + d_mid + d_fine + d_extra + d_pixel) * 1.4, 0.05, 1.0)
    disturb = torch.clamp(disturb * (0.6 + 0.4 * r), 0.1, 1.0)

    stack = torch.stack(
        [temp_base, zeros, zeros, turb, 0.05 * turb, az_hotspot, disturb],
        dim=-3,
    )
    if generation_scale > 1:
        stack = stack.repeat_interleave(generation_scale, dim=-2)
        stack = stack.repeat_interleave(generation_scale, dim=-1)
    return stack
