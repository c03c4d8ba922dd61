"""Procedural accretion-disk texture: structure generators + compose.

The port of ``bhr_tpu/models/disk_texture.py`` (reference render.py:
795-2010): a polar (n_r, n_phi, RGBA) texture built from layered
structure fields,

  density = (0.15 + 0.10 spiral + 0.30 turbulence + 0.20 hotspot
             + 0.30 filaments + 0.20 rt) * disturb_mod * edge / P98
  temperature = max(temp_base clamped per-row, temp_struct / P95 * 0.8)
  RGB = blackbody(T_min + temp*(0.9+0.25 az) * (T_max-T_min)) * sqrt(T)
  alpha = density

Every generator draws from ``ops.random``, the port of ``jax.random``
(threefry-2x32, JAX's partitionable layout), so a seed gives the same
structures as ``bhr_tpu``: the same counts, positions and widths, and
fields that differ by float rounding only. A generator's small draws are
made in one hash (each still equal to its own ``jax.random`` call): on
the card a hash is ~170 element-wise launches. Structure instances are
batched (padded to a static maximum with zero intensity). Where an
instance is an azimuthal profile times a radial one (arcs, filaments, RT
fingers, hotspots), the sum over instances is a float32 matrix product
of the two profiles, where ``bhr_tpu`` broadcasts (instances, rows,
columns) in chunks of 75: the same sum in another order, with no large
temporaries. Low-resolution generation + nearest-neighbour upscale
(generation_scale in {1, 2, 4}) is kept.

The normalization stats are exact percentiles with numpy's linear rule,
computed from ``torch.sort`` (``torch.quantile`` refuses inputs over 2**24
elements). The lifecycle disk (``models/dynamic_disk.py``) composes
through :func:`compose_from_components` at t = 0 with its own histogram
stats.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import torch_device
from ..constants import (
    DISK_COLOR_TEMPERATURE,
    DISK_GENERATION_SCALE_CHOICES,
    ENABLE_DISK_SPIRAL_ARMS,
)
from ..ops.noise import (
    fbm_noise,
    linspace0,
    periodic_pixel_noise,
    polar_axes,
    tileable_noise_many,
)
from ..ops.random import (
    beta,
    fold_in,
    prng_key,
    randint,
    randint_from_bits,
    random_bits_many,
    split,
    uniform,
    uniform_from_bits,
)
from ..ops.shading import blackbody_rgb, keplerian_omega
from ..utils.io import compute_edge_alpha
from ..utils.nans import check_nans

_TWO_PI = 2.0 * math.pi


def _validate_scale(generation_scale: int, n_r: int = 0,
                    n_phi: int = 0) -> int:
    if generation_scale not in DISK_GENERATION_SCALE_CHOICES:
        raise ValueError(
            f"disk_generation_scale must be one of "
            f"{DISK_GENERATION_SCALE_CHOICES}, got {generation_scale}"
        )
    # Fail fast on indivisible sizes: _upscale would silently return an
    # undersized field.
    if (n_r % generation_scale) or (n_phi % generation_scale):
        raise ValueError(
            f"generation_scale={generation_scale} must divide the texture "
            f"size ({n_r} x {n_phi})"
        )
    return generation_scale


def _upscale(field: torch.Tensor, scale: int, n_r: int, n_phi: int) -> torch.Tensor:
    """Nearest-neighbour (kron) upscale back to full resolution."""
    if scale == 1:
        return field[:n_r, :n_phi]
    up = field.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)
    return up[:n_r, :n_phi]


def _polar_grids(n_r: int, n_phi: int, device):
    """(phi_g, r_g): ``jnp.meshgrid`` of [0, 2 pi) x [0, 1], full size."""
    phi, r = polar_axes(n_r, n_phi, device)
    return phi.expand(n_r, n_phi), r.expand(n_r, n_phi)


def _roll_rows_by(field: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-row circular shift along phi by -shifts[r] pixels, of an
    (..., n_r, n_phi) stack of fields."""
    n_phi = field.shape[-1]
    cols = torch.arange(n_phi, device=field.device)[None, :]
    src = torch.remainder(cols + shifts.to(torch.int64)[:, None], n_phi)
    return torch.gather(field, -1, src.expand(field.shape))


def _profile_sums(radial: torch.Tensor, weights: torch.Tensor,
                  azimuthal: torch.Tensor) -> torch.Tensor:
    """sum_i weights[k, i] * radial[i, r] * azimuthal[i, phi] over the
    structure instances i (any leading shape, flattened) for each weight
    row k -> (K, n_r, n_phi): one float32 matrix product per row instead
    of an (instances, n_r, n_phi) broadcast."""
    n_r, n_phi = radial.shape[-1], azimuthal.shape[-1]
    radial = radial.reshape(-1, n_r)
    weighted = radial[None] * weights.reshape(weights.shape[0], -1, 1)
    return weighted.transpose(1, 2) @ azimuthal.reshape(-1, n_phi)


# ---------------------------------------------------------------------------
# Structure generators. Each takes a key of ops.random and returns field(s)
# at full (n_r, n_phi) resolution on ``device``.
# "Low-res" generation uses n / scale grids.
# ---------------------------------------------------------------------------


def generate_temperature_base(key, n_r: int, n_phi: int, *, device) -> torch.Tensor:
    """Radially decaying temperature floor with FBM modulation, <= 0.25."""
    _, r = polar_axes(n_r, n_phi, device)
    k1, k2 = split(key)
    decay = torch.clamp(1.0 - r, 0.0, 1.0) ** 1.3
    coarse = fbm_noise(k1, (n_r, n_phi), octaves=4, persistence=0.6,
                       base_scale=8, wrap_u=True, device=device)
    fine = fbm_noise(k2, (n_r, n_phi), octaves=5, persistence=0.45,
                     base_scale=3, wrap_u=True, device=device)
    noise = 0.6 * coarse + 0.4 * fine
    return torch.clamp(decay * (0.85 + 0.15 * noise), 0.0, 1.0) * 0.25


def generate_spiral_arms(
    key, n_r: int, n_phi: int, generation_scale: int = 2,
    enabled: bool = ENABLE_DISK_SPIRAL_ARMS, *, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented logarithmic spiral arms (disabled by default, matching
    the reference kill-switch ENABLE_DISK_SPIRAL_ARMS=False).

    When enabled: 2-4 arms x 4-8 sub-arm segments along the radial span,
    von-Mises azimuthal profile around the spiral phase
    phi - base_angle + r * rotations * 2pi, noise-modulated width and
    intensity, hard radial segment masks with small edge fades.
    """
    if not enabled:
        zeros = torch.zeros((n_r, n_phi), device=device)
        return zeros, zeros

    scale = _validate_scale(generation_scale, n_r, n_phi)
    lr, lp = n_r // scale, n_phi // scale
    phi_g, r_g = _polar_grids(lr, lp, device)

    max_arms, max_subs = 4, 8
    keys = split(key, 12)
    n_arms = randint(keys[0], (), 2, 5, device=device)
    n_from_center = randint(keys[1], (), 2, 4, device=device)

    arm_idx = torch.arange(max_arms, device=device)
    r_start = torch.where(
        arm_idx < n_from_center, 0.0,
        uniform(keys[2], (max_arms,), 0.05, 0.5, device=device))
    base_angle = torch.where(
        arm_idx < n_from_center,
        arm_idx.to(torch.float32) * 2.0 * math.pi
        / torch.clamp(n_from_center, min=1).to(torch.float32),
        uniform(keys[3], (max_arms,), maxval=_TWO_PI, device=device))
    # Minimum-separation nudge (reference render.py:1228-1233): each arm
    # is pushed +0.5 rad off any EARLIER live arm within 0.4 rad, with the
    # reference's non-circular |a - b| comparison.
    angles = list(base_angle.unbind())
    for i in range(1, max_arms):
        ai = angles[i]
        for j in range(i):
            close = (torch.abs(ai - angles[j]) < 0.4) & (j < n_arms)
            ai = torch.where(close, torch.remainder(ai + 0.5, _TWO_PI), ai)
        angles[i] = ai
    base_angle = torch.stack(angles)
    rotations = uniform(keys[4], (max_arms,), 2.5, 5.0, device=device)
    base_width = uniform(keys[5], (max_arms,), 0.2, 0.4, device=device)
    arm_delta_t = uniform(keys[6], (max_arms,), 0.1, 0.3, device=device)
    arm_alive = (arm_idx < n_arms).to(torch.float32)

    r_length = torch.minimum(rotations / 6.0 * (1.0 - r_start), 1.0 - r_start)
    sub_fill = uniform(keys[7], (max_arms,), 0.4, 0.6, device=device)
    sub_len_raw = uniform(keys[8], (max_arms, max_subs), 0.08, 0.20, device=device)
    sub_count = randint(keys[9], (max_arms,), 4, 9, device=device)
    sub_alive = (torch.arange(max_subs, device=device)[None, :]
                 < sub_count[:, None]).to(torch.float32)
    sub_len_raw = sub_len_raw * sub_alive
    sub_lengths = (
        sub_len_raw
        / (torch.sum(sub_len_raw, dim=1, keepdim=True) + 1e-9)
        * (r_length * sub_fill)[:, None]
    )
    gaps = uniform(keys[10], (max_arms, max_subs), 0.08, 0.15, device=device)
    starts = torch.cumsum(
        torch.cat([torch.zeros((max_arms, 1), device=device),
                   sub_lengths[:, :-1] + gaps[:, :-1]], dim=1),
        dim=1,
    ) + r_start[:, None]

    sub_widths = torch.clamp(
        base_width[:, None]
        * uniform(keys[11], (max_arms, max_subs), 0.3, 2.5, device=device),
        0.06, 1.2,
    )
    sub_int = uniform(fold_in(key, 99), (max_arms, max_subs), 0.1, 0.7,
                      device=device) * sub_alive * arm_alive[:, None]

    # Fresh noise PER ARM (reference render.py:1260): a shared field would
    # make every arm fade and break at the same texels.
    arm_noise = tileable_noise_many(list(split(fold_in(key, 100), max_arms)),
                                    (lr, lp), device=device)  # (A, lr, lp)
    width_mod = torch.clamp(0.2 + 1.5 * arm_noise, 0.15, 3.0)
    intensity_mod = 0.1 + 0.9 * (arm_noise ** 0.15)

    arm_angle = (
        phi_g[None] - base_angle[:, None, None]
        + r_g[None] * rotations[:, None, None] * 2.0 * math.pi
    )  # (A, lr, lp)
    cos_angle = torch.cos(arm_angle)

    spiral = torch.zeros((lr, lp), device=device)
    temp = torch.zeros((lr, lp), device=device)
    fade_edge = 0.02
    for s in range(max_subs):
        sr = starts[:, s][:, None, None]
        sr_end = sr + sub_lengths[:, s][:, None, None]
        kappa = 1.5 / (sub_widths[:, s][:, None, None] ** 2)
        val = torch.exp(kappa * (cos_angle - 1.0) * width_mod)
        mask = (r_g[None] >= sr) & (r_g[None] <= sr_end)
        fade_in = torch.clamp((r_g[None] - sr) / fade_edge, 0.0, 1.0)
        fade_out = torch.clamp((sr_end - r_g[None]) / fade_edge, 0.0, 1.0)
        val = torch.where(mask, val, 0.0) * fade_in * fade_out
        val = val * sub_int[:, s][:, None, None] * intensity_mod
        spiral = spiral + torch.sum(val, dim=0)
        temp = temp + torch.sum(val * arm_delta_t[:, None, None], dim=0)

    spiral = torch.clamp(spiral / (torch.max(spiral) + 1e-6), 0.0, 1.0)
    return (_upscale(spiral, scale, n_r, n_phi),
            _upscale(temp, scale, n_r, n_phi))


def _shear_shifts(shear_strength, r: torch.Tensor, n_phi: int) -> torch.Tensor:
    """Keplerian shear roll in whole pixels per row (int32)."""
    kep = torch.minimum(torch.clamp(
        shear_strength * (1.0 / (r + 0.3) ** 1.5 - 0.8), min=0.0),
        shear_strength * 8.0)
    return torch.clamp((kep / _TWO_PI * n_phi).to(torch.int32),
                       -n_phi // 4, n_phi // 4)


def generate_turbulence(
    key, n_r: int, n_phi: int, generation_scale: int = 2, *, device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """5-layer cloudy turbulence with Keplerian shear roll + pixel grain.

    Returns (turbulence, kep_shift_pixels (n_r,) int32, temp_contribution).
    The shear roll offsets each radial row's phi by a Keplerian-profile
    pixel count (reference render.py:1309-1382).
    """
    scale = _validate_scale(generation_scale, n_r, n_phi)
    lr, lp = n_r // scale, n_phi // scale
    keys = split(key, 7)
    shear_strength = uniform(keys[0], (), 3.0, 6.0, device=device)
    shift_low = _shear_shifts(shear_strength, linspace0(1.0, lr, True, device), lp)

    layers = tileable_noise_many(list(keys[1:6]), (lr, lp), device=device)
    # Keplerian shear: roll each row by +shift (reference np.roll(+shift)).
    layers = _roll_rows_by(layers, -shift_low)
    pixel = periodic_pixel_noise(keys[6], (lr, lp), device=device)

    w = (0.08, 0.15, 0.25, 0.22, 0.18)
    turb_low = sum(wi * li for wi, li in zip(w, layers)) + 0.12 * torch.clamp(
        pixel, 0.0, 1.0)
    turbulence = _upscale(turb_low, scale, n_r, n_phi)
    temp = 0.05 * torch.clamp(turbulence, 0.0, 1.0)
    # Full-res shear pixel counts for the disturbance generator.
    shift_full = _shear_shifts(shear_strength, linspace0(1.0, n_r, True, device),
                               n_phi)
    return turbulence, shift_full, temp


def generate_filaments(
    key, n_r: int, n_phi: int, generation_scale: int = 2,
    max_count: int = 300, max_subs: int = 4, *, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """150-300 azimuthally elongated filaments with 2-4 sub-segments:
    thin radial Gaussians x wide von-Mises azimuthal profiles, the
    reference's dominant texture detail (render.py:1385-1491)."""
    scale = _validate_scale(generation_scale, n_r, n_phi)
    lr, lp = n_r // scale, n_phi // scale
    phi, r = polar_axes(lr, lp, device)

    keys = split(key, 12)
    c, cs = (max_count,), (max_count, max_subs)
    bits = random_bits_many(
        [*split(keys[0]), *keys[1:6], *split(keys[7]), *keys[8:12], fold_in(key, 77)],
        [(), (), c, c, c, c, c, c, c, c, cs, cs, cs, cs], device)
    count = randint_from_bits(bits[0], bits[1], 150, 301)
    alive = (torch.arange(max_count, device=device) < count).to(torch.float32)

    phi_start = uniform_from_bits(bits[2], maxval=_TWO_PI)
    r_pos = uniform_from_bits(bits[3], 0.05, 0.95)
    base_r = 0.05 + r_pos ** 0.6 * 0.9
    base_width = uniform_from_bits(bits[4], 0.002, 0.008)
    total_len = uniform_from_bits(bits[5], 0.5, 1.2)
    intensity = uniform_from_bits(bits[6], 0.7, 1.0)
    delta_t = 0.3 + 0.6 * beta(keys[6], 0.3, 1.0, c, device=device)

    sub_count = randint_from_bits(bits[7], bits[8], 2, 5)
    sub_alive = (torch.arange(max_subs, device=device)[None, :]
                 < sub_count[:, None]).to(torch.float32) * alive[:, None]
    sub_fill = uniform_from_bits(bits[9], 0.35, 0.55)
    sub_len_raw = uniform_from_bits(bits[10], 0.08, 0.20) * sub_alive
    sub_lengths = (
        sub_len_raw
        / (torch.sum(sub_len_raw, dim=1, keepdim=True) + 1e-9)
        * (total_len * sub_fill)[:, None]
    )
    gaps = uniform_from_bits(bits[11], 0.08, 0.20)
    sub_starts = phi_start[:, None] + torch.cumsum(
        torch.cat([torch.zeros((max_count, 1), device=device),
                   sub_lengths[:, :-1] + gaps[:, :-1]], dim=1),
        dim=1,
    )
    sub_widths = torch.clamp(
        base_width[:, None] * uniform_from_bits(bits[12], 0.3, 3.0), 0.001, 0.025)
    sub_int = intensity[:, None] * uniform_from_bits(bits[13], 0.15, 1.0) * sub_alive

    phi_range = sub_lengths / (base_r[:, None] + 0.01)
    phi_half = torch.clamp(phi_range * 0.7, min=0.2)
    kappa = 1.5 / (phi_half ** 2)  # (C, S)

    # Each segment is an azimuthal profile times a radial one: the sums
    # over segments are matrix products over (C * S).
    az = torch.exp(kappa[..., None] * (torch.cos(phi - sub_starts[..., None]) - 1.0))
    rp = torch.exp(-0.5 * ((r.T - base_r[:, None, None]) / sub_widths[..., None]) ** 2)
    weights = torch.stack([sub_int, sub_int * (delta_t * 0.7)[:, None]])  # (2, C, S)
    arcs, temp = _profile_sums(rp, weights, az)

    arcs_full = torch.clamp(_upscale(arcs, scale, n_r, n_phi), 0.0, 1.0)
    temp_full = torch.minimum(
        torch.clamp(_upscale(temp, scale, n_r, n_phi), min=0.0), arcs_full * 0.5)
    return arcs_full, temp_full


def rt_slot_count(disk_area: float) -> int:
    """Padded RT finger slots: the draw's upper bound 30 * disk_area * 0.8
    (reference render.py:1517), so wide disks get all their fingers."""
    return max(int(30.0 * disk_area * 0.8) + 1, 1)


def generate_rt_spikes(
    key, n_r: int, n_phi: int, disk_area: float, enable_rt: bool = True,
    generation_scale: int = 2, max_count: Optional[int] = None, *, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rayleigh-Taylor instability fingers, biased toward the inner disk."""
    if not enable_rt:
        zeros = torch.zeros((n_r, n_phi), device=device)
        return zeros, zeros

    scale = _validate_scale(generation_scale, n_r, n_phi)
    lr, lp = n_r // scale, n_phi // scale
    phi, r = polar_axes(lr, lp, device)

    if max_count is None:
        max_count = rt_slot_count(disk_area)
    m = (max_count,)
    bits = random_bits_many(list(split(key, 7)), [(), m, m, m, m, m, m], device)
    count_f = uniform_from_bits(bits[0], 15.0, 30.0)
    count = (count_f * disk_area * 0.8).to(torch.int32)
    alive = (torch.arange(max_count, device=device) < count).to(torch.float32)

    phis = uniform_from_bits(bits[1], maxval=_TWO_PI)
    r_bases = uniform_from_bits(bits[2], 0.01, 0.15) ** 1.5
    phi_widths = uniform_from_bits(bits[3], 0.08, 0.20)
    r_lengths = uniform_from_bits(bits[4], 0.08, 0.20)
    intensities = uniform_from_bits(bits[5], 0.8, 1.0)
    delta_ts = uniform_from_bits(bits[6], 0.5, 1.2)

    kappa = 1.5 / (phi_widths ** 2)
    az = torch.exp(kappa[:, None] * (torch.cos(phi - phis[:, None]) - 1.0))  # (M, lp)
    r_diff = r.T - r_bases[:, None]  # (M, lr)
    rl = r_lengths[:, None]
    fade_out = torch.clamp(rl * 2.0 - r_diff, 0.0, 1.0)
    fade_in = torch.clamp(r_diff / (rl * 0.3), 0.0, 1.0)
    r_prof = torch.exp(-0.5 * (r_diff / (rl * 0.4)) ** 2) * fade_out * fade_in
    weight = intensities * alive
    spikes, temp = _profile_sums(r_prof, torch.stack([weight, weight * delta_ts]), az)
    spikes = torch.clamp(spikes, 0.0, 1.0)
    return (_upscale(spikes, scale, n_r, n_phi),
            _upscale(temp, scale, n_r, n_phi))


def generate_hotspots(
    key, n_r: int, n_phi: int, max_count: int = 40, *, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """20-40 roughly circular bright patches (full resolution)."""
    phi, r = polar_axes(n_r, n_phi, device)
    m = (max_count,)
    bits = random_bits_many(list(split(key, 6)), [(), m, m, m, m, m], device)
    count_f = uniform_from_bits(bits[0], 20.0, 40.0)
    alive = (torch.arange(max_count, device=device)
             < count_f.to(torch.int32)).to(torch.float32)

    phis = uniform_from_bits(bits[1], maxval=_TWO_PI)
    rs = 0.1 + uniform_from_bits(bits[2]) ** 0.6 * 0.85
    phi_w = uniform_from_bits(bits[3], 0.08, 0.20)
    r_w = 0.02 + uniform_from_bits(bits[4], maxval=0.03)
    inten = 0.3 + (1.0 - rs) * 0.6 + uniform_from_bits(bits[5], maxval=0.1)

    kappa = 1.5 / (phi_w ** 2)
    az = torch.exp(kappa[:, None] * (torch.cos(phi - phis[:, None]) - 1.0))
    rp = torch.exp(-0.5 * ((r.T - rs[:, None]) / r_w[:, None]) ** 2)
    hotspot = torch.clamp(_profile_sums(rp, (inten * alive)[None], az)[0], 0.0, 1.0)
    # Temperature contribution is the 0.12 aggregate (the reference draws
    # per-instance delta_Ts but never uses them, render.py:1626, 1659).
    return hotspot, 0.12 * hotspot


def generate_azimuthal_hotspot(
    key, n_r: int, n_phi: int, generation_scale: int = 2, *, device,
) -> torch.Tensor:
    """Low-frequency sinusoidal azimuthal wave x FBM (sheared by radius)."""
    scale = _validate_scale(generation_scale, n_r, n_phi)
    lr, lp = n_r // scale, n_phi // scale
    phi, r = polar_axes(lr, lp, device)
    k1, k2, k3 = split(key, 3)
    bits = random_bits_many([*split(k1), k2], [(), (), ()], device)
    az_freq = randint_from_bits(bits[0], bits[1], 2, 5)
    shear = r ** 1.2 * uniform_from_bits(bits[2], 2.0, 4.0)
    wave = 0.5 + 0.5 * torch.sin((phi + shear) * az_freq)
    noise = fbm_noise(k3, (lr, lp), octaves=3, persistence=0.5,
                      base_scale=3, wrap_u=True, device=device)
    return _upscale(wave * noise, scale, n_r, n_phi)


def generate_disturbance_mod(
    key, n_r: int, n_phi: int, kep_shift_pixels: torch.Tensor,
    generation_scale: int = 2, *, device,
) -> torch.Tensor:
    """Multi-scale multiplicative disturbance field in [0.1, 1]."""
    scale = _validate_scale(generation_scale, n_r, n_phi)
    lr, lp = n_r // scale, n_phi // scale
    _, r = polar_axes(lr, lp, device)
    keys = split(key, 5)

    # [::scale] strides the per-row shear shifts to the low-res radii, as
    # bhr_tpu does (the reference takes the first lr rows here,
    # render.py:818: docs/PARITY.md deviation 12).
    shift_low = torch.div(kep_shift_pixels[::scale], scale, rounding_mode="floor")
    layers = tileable_noise_many(list(keys[:4]), (lr, lp), device=device)
    layers = _roll_rows_by(layers, -shift_low)
    pixel = periodic_pixel_noise(keys[4], (lr, lp), device=device)

    mod = (0.05 * layers[0] + 0.15 * layers[1] + 0.30 * layers[2]
           + 0.30 * layers[3] + 0.20 * pixel)
    mod = torch.clamp(mod * 1.4, 0.05, 1.0)
    mod = torch.clamp(mod * (0.6 + 0.4 * r), 0.1, 1.0)
    return _upscale(mod, scale, n_r, n_phi)


# ---------------------------------------------------------------------------
# Compose: 13-component contract (reference render.py:3169-3259 /
# 1014-1021) + exact percentile normalization stats.
# ---------------------------------------------------------------------------

# Component-field pack order (reference upload_parametric_state,
# render.py:2328-2350):
#   0 temp_base 1 spiral 2 spiral_temp 3 turbulence 4 turb_temp
#   5 arcs 6 arcs_temp 7 rt_spikes 8 rt_temp 9 hotspot 10 hotspot_temp
#   11 az_hotspot 12 disturb_mod
N_COMPONENTS = 13


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


def _linear_pick(sorted_x: torch.Tensor, pos: torch.Tensor, count) -> torch.Tensor:
    """numpy's linear-interpolation quantile at float32 rank ``pos`` of
    the ascending ``sorted_x`` (last axis; ``count`` valid entries), as
    ``jnp.quantile`` evaluates it."""
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    top = count - 1
    low_i = torch.clamp(torch.minimum(low, top), min=0).to(torch.int64)
    high_i = torch.clamp(torch.minimum(high, top), min=0).to(torch.int64)
    return (torch.gather(sorted_x, -1, low_i) * low_w
            + torch.gather(sorted_x, -1, high_i) * high_w)


def _quantile_rank(q: float, count) -> torch.Tensor:
    """float32 q * (count - 1)."""
    return torch.as_tensor(np.float32(q), dtype=torch.float32) * (count - 1)


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, 100 q)`` over all of ``x`` (0-dim)."""
    flat = torch.sort(x.reshape(-1)).values
    n = torch.tensor(float(flat.numel()), device=x.device)
    pos = _quantile_rank(q, n).to(x.device)
    return _linear_pick(flat, pos.reshape(1), n)[0]


def _masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.nanpercentile(where(mask, x, nan), 100 q)`` (0-dim): the
    masked-out entries sort last and do not count."""
    flat = torch.sort(torch.where(mask, x, math.nan).reshape(-1)).values
    n = mask.sum().to(torch.float32)
    return _linear_pick(flat, _quantile_rank(q, n).to(x.device).reshape(1), n)[0]


def _row_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=1)`` of an (R, C) array -> (R,)."""
    rows, cols = x.shape
    srt = torch.sort(x, dim=1).values
    n = torch.tensor(float(cols), device=x.device)
    pos = _quantile_rank(q, n).to(x.device).expand(rows, 1)
    return _linear_pick(srt, pos, n)[:, 0]


def _field_stats(density, temp_struct):
    """Exact percentile normalization stats from mixed fields: (density
    P98, positive-struct P95, per-row [max, P70] of the scaled struct
    field) — reference render.py:2361-2383."""
    density_p98 = _percentile(density, 0.98)
    pos = temp_struct > 0
    struct_scale = torch.where(torch.any(pos),
                               _masked_percentile(temp_struct, pos, 0.95), 1.0)
    ts_scaled = torch.clamp(temp_struct / (struct_scale + 1e-6) * 0.8, 0.0, 1.2)
    row_stats = torch.stack(
        [torch.amax(ts_scaled, dim=1), _row_quantile(ts_scaled, 0.7)], dim=1)
    return density_p98, struct_scale, row_stats


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


def compose_disk_texture(temp_base, temp_struct, density, az_hotspot, edge,
                         color_temp: float) -> torch.Tensor:
    """Final RGBA from pre-mixed temperature/density fields, stats
    computed on the fly: density is edge-softened then normalized by its
    P98; structural temperature scaled by the P95 of its positive values;
    the temperature floor is clamped per row so structure stays dominant."""
    density = density * edge[:, None]
    stats = _field_stats(density, temp_struct)
    return _normalize_and_colorize(
        temp_base, temp_struct, density, az_hotspot, *stats, color_temp)


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


@dataclass(frozen=True)
class ParametricDiskState:
    """Precomputed 13-component state of the parametric rotating texture
    (the reference's DiskTextureRotatingState + upload_parametric_state,
    render.py:462-486, 2314-2387): the components packed as one
    (13, n_r, n_phi) tensor plus their normalization stats, so a texture
    at any rotation time is one roll + compose."""

    comp: torch.Tensor  # (13, n_r, n_phi)
    omega_rows: torch.Tensor  # (n_r,)
    edge: torch.Tensor  # (n_r,)
    density_p98: torch.Tensor  # ()
    struct_scale: torch.Tensor  # ()
    row_stats: torch.Tensor  # (n_r, 2): [struct_max, struct_p70]
    enable_rt: bool
    color_temp: float
    n_r: int
    n_phi: int
    generation_scale: int
    seed: int


def _component_stats(comp, edge, enable_rt):
    """Normalization stats from the 13-component pack (t=0)."""
    return _field_stats(density_from_comp(comp, edge, enable_rt),
                        temp_struct_from_comp(comp))


def generate_component_fields(
    seed: int, n_r: int, n_phi: int, r_inner: float, r_outer: float,
    enable_rt: bool = True, generation_scale: int = 2, device="cuda",
    on_stage=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate the full 13-component pack on ``device``.
    Returns (comp, omega_rows). ``on_stage(name)``, where given, is called
    after each generator has been enqueued (the timing marks of
    ``chip_smoke.py``)."""
    device = torch_device(device) if isinstance(device, str) else device
    mark = on_stage or (lambda name: None)
    ks = split(prng_key(seed), 9)
    r_norm = linspace0(1.0, n_r, True, device)
    omega_rows = keplerian_omega(r_inner + (r_outer - r_inner) * r_norm)
    disk_area = (r_outer ** 2 - r_inner ** 2) / 10.0
    kw = dict(device=device)

    temp_base = generate_temperature_base(ks[0], n_r, n_phi, **kw)
    mark("temperature_base")
    spiral, spiral_t = generate_spiral_arms(ks[1], n_r, n_phi, generation_scale, **kw)
    mark("spiral_arms")
    turb, kep_shift, turb_t = generate_turbulence(ks[2], n_r, n_phi,
                                                  generation_scale, **kw)
    mark("turbulence")
    arcs, arcs_t = generate_filaments(ks[3], n_r, n_phi, generation_scale, **kw)
    mark("filaments")
    rt, rt_t = generate_rt_spikes(ks[4], n_r, n_phi, disk_area, enable_rt,
                                  generation_scale, **kw)
    mark("rt_spikes")
    hs, hs_t = generate_hotspots(ks[5], n_r, n_phi, **kw)
    mark("hotspots")
    az = generate_azimuthal_hotspot(ks[6], n_r, n_phi, generation_scale, **kw)
    mark("azimuthal_hotspot")
    dm = generate_disturbance_mod(ks[7], n_r, n_phi, kep_shift, generation_scale, **kw)
    mark("disturbance_mod")

    comp = torch.stack([temp_base, spiral, spiral_t, turb, turb_t, arcs, arcs_t,
                        rt, rt_t, hs, hs_t, az, dm], dim=0)
    return comp, omega_rows


def build_parametric_state(
    n_phi: int = 1024, n_r: int = 512, seed: int = 42,
    r_inner: float = 2.0, r_outer: float = 3.5,
    enable_rt: bool = True, color_temp: Optional[float] = None,
    generation_scale: int = 2, device="cuda",
) -> ParametricDiskState:
    """Precompute the parametric rotating-texture state on ``device``."""
    _validate_scale(generation_scale, n_r, n_phi)
    if color_temp is None:
        color_temp = DISK_COLOR_TEMPERATURE
    device = torch_device(device) if isinstance(device, str) else device
    comp, omega_rows = generate_component_fields(
        seed, n_r, n_phi, r_inner, r_outer, enable_rt, generation_scale, device)
    edge = torch.as_tensor(compute_edge_alpha(n_r), device=device)
    density_p98, struct_scale, row_stats = _component_stats(comp, edge, enable_rt)
    return ParametricDiskState(
        comp=comp, omega_rows=omega_rows, edge=edge,
        density_p98=density_p98, struct_scale=struct_scale,
        row_stats=row_stats, enable_rt=enable_rt,
        color_temp=float(color_temp), n_r=n_r, n_phi=n_phi,
        generation_scale=generation_scale, seed=seed,
    )


def compose_from_state(state: ParametricDiskState, t_offset: float = 0.0,
                       color_temp: Optional[float] = None) -> torch.Tensor:
    """Texture at rotation time ``t_offset`` from a precomputed state."""
    ct = state.color_temp if color_temp is None else float(color_temp)
    return compose_from_components(
        state.comp, state.edge, state.density_p98, state.struct_scale,
        state.row_stats, state.enable_rt,
        torch.tensor(ct, dtype=torch.float32, device=state.comp.device),
        t_offset=t_offset, omega_rows=state.omega_rows,
    )


def generate_disk_texture(
    n_phi: int = 1024, n_r: int = 512, seed: int = 42,
    r_inner: float = 2.0, r_outer: float = 3.5,
    enable_rt: bool = True, color_temp: Optional[float] = None,
    generation_scale: int = 2, device="cuda",
) -> torch.Tensor:
    """One-shot static texture: (n_r, n_phi, 4) float32 RGBA on
    ``device``, the parametric state composed at t = 0 (the reference's
    static generate_disk_texture, render.py:1869-2010)."""
    state = build_parametric_state(
        n_phi=n_phi, n_r=n_r, seed=seed, r_inner=r_inner, r_outer=r_outer,
        enable_rt=enable_rt, color_temp=color_temp,
        generation_scale=generation_scale, device=device,
    )
    tex = compose_from_state(state, 0.0)
    # The NaN trap's stage (``utils/nans.py``): bhr_tpu's generator ends
    # in the jitted compose of this state.
    check_nans("static_texture", tex, state.comp, state.density_p98,
               state.struct_scale, state.row_stats)
    return tex
