"""Color and relativistic shading ops (torch, fully vectorized).

The port of ``bhr_tpu/ops/shading.py``: blackbody color, the Keplerian
rotation law, and the Doppler-beaming + gravitational-redshift shading
of disk hits (reference render.py:136-150, 2407-2516).
"""

from __future__ import annotations

import math

import torch

from ..constants import (
    DISK_COLOR_TEMPERATURE,
    DISK_RADIAL_BRIGHTNESS_MAX,
    DISK_RADIAL_BRIGHTNESS_MIN,
    DISK_RADIAL_BRIGHTNESS_POWER,
    G_BRIGHTNESS_GAIN,
    G_FACTOR_CAP,
    G_LUMINOSITY_POWER,
    RS,
)


def pow_const(x: torch.Tensor, p: float) -> torch.Tensor:
    """x**p with square-and-multiply for small integer and half-integer
    exponents (p = k/2, e.g. 1.5 -> x*sqrt(x)); the same multiply order
    as the JAX package's strength reduction. Valid for x >= 0."""
    if float(2.0 * p).is_integer() and 0.5 <= p <= 16.0:
        n = int(2.0 * p)
        acc = torch.sqrt(x) if n & 1 else None
        n >>= 1
        base = x
        while n:
            if n & 1:
                acc = base if acc is None else acc * base
            n >>= 1
            if n:
                base = base * base
        return acc
    return torch.pow(x, p)


def keplerian_omega(r_vals: torch.Tensor) -> torch.Tensor:
    """omega(r) = sqrt(0.5 / r^3) — THE disk rotation law (reference
    render.py:2451, 930). Texture roll, entity advection, background
    noise rotation and relativistic beaming all use this one definition."""
    return torch.sqrt(0.5 / (r_vals * r_vals * r_vals + 1e-6))


def blackbody_rgb(temp_k: torch.Tensor) -> torch.Tensor:
    """Kelvin -> linear RGB (Tanner Helland fit); trailing channel axis."""
    t = temp_k / 100.0
    safe = torch.clamp(t - 60.0, min=1e-6)
    r = torch.where(
        t <= 66.0, 1.0,
        torch.clamp(1.292936 * torch.pow(safe, -0.1332047592), 0.0, 1.0))
    g = torch.where(
        t <= 66.0,
        torch.clamp(0.390082 * torch.log(torch.clamp(t, min=1e-6)) - 0.631841,
                    0.0, 1.0),
        torch.clamp(1.129891 * torch.pow(safe, -0.0755148492), 0.0, 1.0),
    )
    b = torch.where(
        t >= 66.0,
        1.0,
        torch.where(
            t <= 19.0,
            0.0,
            torch.clamp(
                0.543207 * torch.log(torch.clamp(t - 10.0, min=1e-6)) - 1.19625,
                0.0, 1.0),
        ),
    )
    return torch.stack([r, g, b], dim=-1)


def color_temp_tint(color_temp: float = DISK_COLOR_TEMPERATURE,
                    device=None) -> torch.Tensor:
    """Scalar color-temperature tint as an RGB triple."""
    return blackbody_rgb(torch.tensor(color_temp, dtype=torch.float32,
                                      device=device))


def _norm3(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis of (..., 3), summed x, y, z."""
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])
    return n[..., None] if keepdim else n


def apply_g_factor(
    base_color: torch.Tensor,
    hit_pos: torch.Tensor,
    hit_r: torch.Tensor,
    ray_dir_to_cam: torch.Tensor,
    cam_pos: torch.Tensor,
    r_inner: float,
    r_outer: float,
    tilt_rad: float,
    color_temp: float = DISK_COLOR_TEMPERATURE,
) -> torch.Tensor:
    """Relativistic disk shading: Doppler beaming + gravitational redshift.

    Batched over a leading shape ``B``: base_color, hit_pos and
    ray_dir_to_cam are (*B, 3), hit_r is (*B,), cam_pos is (3,).
    Keplerian omega = sqrt(0.5/r^3); beta = r*omega/sqrt(1-rs/r) capped
    at 0.99; flow direction r_hat x n_disk(tilt); g = min(g_doppler *
    g_grav, cap); Reinhard-style brightness gain*g^p/(1+g^p/cap); radial
    boost (1-radial_t)^1.2 in [0.2, 8]; Wien per-channel shift
    normalized to green; final tint by the disk color temperature.
    """
    dev = base_color.device
    rs = RS
    r_obs = _norm3(cam_pos)
    r_em = _norm3(hit_pos)
    r_safe = torch.clamp(r_em, min=rs + 1e-3)

    omega = keplerian_omega(r_safe)
    lorentz = torch.sqrt(torch.clamp(1.0 - rs / r_safe, min=1e-6))
    beta = torch.clamp(r_safe * omega / torch.clamp(lorentz, min=1e-6), max=0.99)
    gamma = 1.0 / torch.sqrt(torch.clamp(1.0 - beta * beta, min=1e-6))

    sin_t = math.sin(tilt_rad)
    cos_t = math.cos(tilt_rad)
    r_hat = hit_pos / torch.clamp(r_em, min=1e-9)[..., None]
    # v_hat = r_hat x (0, -sin_t, cos_t)
    v_hat = torch.stack(
        [
            r_hat[..., 1] * cos_t - r_hat[..., 2] * -sin_t,
            r_hat[..., 2] * 0.0 - r_hat[..., 0] * cos_t,
            r_hat[..., 0] * -sin_t - r_hat[..., 1] * 0.0,
        ],
        dim=-1,
    )
    v_norm = _norm3(v_hat, keepdim=True)
    v_fallback = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    v_hat = torch.where(v_norm > 1e-6, v_hat / torch.clamp(v_norm, min=1e-9),
                        v_fallback)

    ray_hat = ray_dir_to_cam / torch.clamp(
        _norm3(ray_dir_to_cam, keepdim=True), min=1e-9)
    cos_theta = (v_hat[..., 0] * ray_hat[..., 0] + v_hat[..., 1] * ray_hat[..., 1]
                 + v_hat[..., 2] * ray_hat[..., 2])
    denom = torch.clamp(1.0 - beta * cos_theta, min=1e-3)
    g_doppler = 1.0 / (gamma * denom)

    grav_num = torch.sqrt(torch.clamp(
        1.0 - rs / torch.clamp(r_obs, min=rs + 1e-3), min=1e-6))
    grav_den = torch.sqrt(torch.clamp(
        1.0 - rs / torch.clamp(r_em, min=rs + 1e-3), min=1e-6))
    g_grav = grav_num / grav_den

    g = torch.clamp(g_doppler * g_grav, max=G_FACTOR_CAP)
    intensity = pow_const(torch.clamp(g, min=0.0), G_LUMINOSITY_POWER)
    brightness = G_BRIGHTNESS_GAIN * intensity / (1.0 + intensity / G_FACTOR_CAP)

    radial_span = max(r_outer - r_inner, 1e-3)
    radial_t = torch.clamp(
        (torch.clamp(hit_r, min=r_inner) - r_inner) / radial_span, 0.0, 1.0)
    radial_profile = torch.pow(1.0 - radial_t, DISK_RADIAL_BRIGHTNESS_POWER)
    radial_boost = DISK_RADIAL_BRIGHTNESS_MIN + (
        DISK_RADIAL_BRIGHTNESS_MAX - DISK_RADIAL_BRIGHTNESS_MIN
    ) * radial_profile
    brightness = brightness * radial_boost

    # Wien-approximation chromatic shift, normalized to the green
    # channel: exp((x_c - x_g) * (1 - 1/g)) with x = 2.21 / 2.72 / 3.13.
    g_safe = torch.clamp(g, min=0.1)
    wien = 1.0 - 1.0 / g_safe
    r_scale = torch.clamp(torch.exp((2.21 - 2.72) * wien), max=3.0)
    b_scale = torch.clamp(torch.exp((3.13 - 2.72) * wien), max=3.0)

    shifted = torch.stack(
        [
            base_color[..., 0] * r_scale,
            base_color[..., 1],
            base_color[..., 2] * b_scale,
        ],
        dim=-1,
    )
    tint = color_temp_tint(color_temp, device=dev)
    return torch.clamp(shifted * tint * brightness[..., None], 0.0, 10.0)
