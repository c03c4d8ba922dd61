"""Gather-based texture sampling (equirect skybox, polar disk).

The port of the f32 samplers the renderer uses in ``bhr_tpu/ops/
sampling.py`` (``sample_skybox_quad``, ``sample_disk_quad`` and
``sample_disk_mip_atlas`` off the TPU, where textures stay f32). The TPU storage layouts (quad packing,
gamma-u8 words, the mip atlas, gather bands) exist for TPU gather cost
and are not ported: a plain 4-tap bilinear gather gives the same values,
with the quad path's clamp and wrap rule —

  * texel addressing is floor-based with no half-texel offset;
  * u (azimuth) wraps; v (radius / polar angle) clamps, and above the
    top row the blend weight fv is 0, so row 0 is sampled alone;
  * the disk texture is polar, rows = radius in [r_inner, r_outer],
    columns = phi in [0, 2pi), with a Keplerian rotation offset
    phi' = phi + t_offset * omega(r).
"""

from __future__ import annotations

import math

import torch

from .fastmath import fast_arccos, fast_atan2

TWO_PI = 2.0 * math.pi


def _bilinear_flat(flat: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   tex_w, tex_h, stride: int, base=0) -> torch.Tensor:
    """Bilinear lookup at texel coords (v=row, u=col) in a tex_h x tex_w
    texture whose texel (row, col) is ``flat[base + row * stride + col]``
    (``flat``: (texels, C)). ``tex_w``, ``tex_h`` and ``base`` are ints,
    or int64 tensors shaped like ``u`` for a per-sample mip level.

    u wraps modulo tex_w; v clamps to [0, tex_h - 1] with fv forced to 0
    above the top row (``bhr_tpu.ops.sampling._bilinear_quad_gather``).
    Returns (*batch, C).
    """
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = v - v0
    u0 = u0.to(torch.int64)
    v0 = v0.to(torch.int64)
    fv = torch.where(v0 < 0, 0.0, torch.clamp(fv, 0.0, 1.0))[..., None]

    u0w = torch.remainder(u0, tex_w)
    u1w = torch.remainder(u0w + 1, tex_w)
    last = tex_h - 1
    v0h = torch.clamp(v0, min=0)
    v0h = torch.where(v0h > last, last, v0h)
    v1h = torch.where(v0h + 1 > last, last, v0h + 1)
    row0 = base + v0h * stride
    row1 = base + v1h * stride

    c00 = flat[row0 + u0w]
    c10 = flat[row0 + u1w]
    c01 = flat[row1 + u0w]
    c11 = flat[row1 + u1w]
    return (
        c00 * (1 - fu) * (1 - fv)
        + c10 * fu * (1 - fv)
        + c01 * (1 - fu) * fv
        + c11 * fu * fv
    )


def _bilinear_gather(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of ``tex`` (H, W, C) at texel coords (v=row, u=col)."""
    tex_h, tex_w = tex.shape[0], tex.shape[1]
    return _bilinear_flat(tex.reshape(tex_h * tex_w, -1), u, v, tex_w, tex_h,
                          tex_w)


def sample_skybox(texture: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Equirect skybox (H, W, 3) sampled along unit ``directions``
    (*B, 3) with the fast polynomial trig. Returns (*B, 3)."""
    tex_h, tex_w = texture.shape[0], texture.shape[1]
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    theta = fast_arccos(z)
    phi = fast_atan2(y, x)
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    u = phi / TWO_PI * tex_w
    v = theta / math.pi * tex_h
    return _bilinear_gather(texture, u, v)


def _disk_polar(hit_x: torch.Tensor, hit_y: torch.Tensor, t_offset: float):
    """(r, Keplerian-advected phi in [0, 2pi)) for a disk-plane hit."""
    r = torch.sqrt(hit_x * hit_x + hit_y * hit_y)
    phi = fast_atan2(hit_y, hit_x)
    r_safe = torch.clamp(r, min=1e-3)
    omega = torch.sqrt(0.5 / (r_safe * r_safe * r_safe + 1e-6))
    phi = torch.remainder(phi + t_offset * omega, TWO_PI)
    return r, phi


def _disk_uv(hit_x, hit_y, r_inner: float, r_outer: float, t_offset: float,
             tex_w: int, tex_h: int):
    """Polar texture coordinates for a disk-plane hit, with Keplerian spin."""
    r, phi = _disk_polar(hit_x, hit_y, t_offset)
    u = phi / TWO_PI * tex_w
    v = (r - r_inner) / (r_outer - r_inner) * tex_h
    return u, v


def sample_disk(
    disk_tex: torch.Tensor,
    hit_x: torch.Tensor,
    hit_y: torch.Tensor,
    r_inner: float,
    r_outer: float,
    t_offset: float = 0.0,
) -> torch.Tensor:
    """Bilinear RGBA sample of the (n_r, n_phi, 4) polar disk texture."""
    u, v = _disk_uv(hit_x, hit_y, r_inner, r_outer, t_offset,
                    disk_tex.shape[1], disk_tex.shape[0])
    return _bilinear_gather(disk_tex, u, v)


