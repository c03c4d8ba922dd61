"""Gather-based texture sampling (equirect skybox, polar disk) + mips.

The port of the f32 samplers the renderer uses in ``bhr_tpu/ops/
sampling.py`` (``sample_skybox_quad``, ``sample_disk_quad`` and
``sample_disk_mip_atlas`` off the TPU, where textures stay f32). The TPU storage layouts (quad packing,
gamma-u8 words, the mip atlas, gather bands) exist for TPU gather cost
and are not ported: a plain 4-tap bilinear gather gives the same values,
with the quad path's clamp and wrap rule —

  * texel addressing is floor-based with no half-texel offset;
  * u (azimuth) wraps; v (radius / polar angle) clamps, and above the
    top row the blend weight fv is 0, so row 0 is sampled alone; a mip
    level wraps and clamps at its own size;
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


def build_mipmaps(base: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """2x2 box-filter mip pyramid packed into one padded (L, H, W, C) array.

    Level l occupies the top-left (H >> l, W >> l) corner; remaining texels
    are zero (reference render.py:1113-1125, 2239-2251).
    """
    h, w = base.shape[0], base.shape[1]
    mips = [base]
    cur = base
    for _ in range(levels):
        ch, cw = cur.shape[0], cur.shape[1]
        if ch < 2 or cw < 2:
            break
        # Drop a trailing odd row/column before halving (external
        # --disk_texture images can have any dimensions).
        cur = cur[: ch - ch % 2, : cw - cw % 2]
        cur = (
            cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
        ) * 0.25
        mips.append(cur)
    out = base.new_zeros((len(mips), h, w) + tuple(base.shape[2:]))
    for lvl, m in enumerate(mips):
        out[lvl, : m.shape[0], : m.shape[1]] = m
    return out


def sample_disk_mip(
    mips: torch.Tensor,
    num_levels: int,
    hit_x: torch.Tensor,
    hit_y: torch.Tensor,
    r_inner: float,
    r_outer: float,
    t_offset: float,
    lod: torch.Tensor,
) -> torch.Tensor:
    """Mip-LOD RGBA sample of the padded (L, H, W, 4) pyramid of
    :func:`build_mipmaps`: the nearest level trunc(clip(lod, 0, L-1)),
    bilinear within it, with u wrapping modulo the level's own width
    W >> l and v clamping at its own last row (H >> l) - 1.

    Gives the values of ``bhr_tpu``'s ``sample_disk_mip_atlas`` (and
    ``sample_disk_mip_quad``), which its Renderer samples off the TPU:
    fast_atan2 and fv = 0 above the top row. (``bhr_tpu``'s own
    ``sample_disk_mip`` is its exact-arctan2 f32 oracle, not what it
    renders with.)
    """
    base_h, base_w = mips.shape[1], mips.shape[2]
    r, phi = _disk_polar(hit_x, hit_y, t_offset)

    lod_i = torch.clamp(lod, 0.0, float(num_levels - 1)).to(torch.int64)
    pow2 = 2 ** lod_i
    scale = pow2.to(torch.float32)
    w_lod = base_w / scale
    h_lod = base_h / scale
    u = phi / TWO_PI * w_lod
    v = (r - r_inner) / (r_outer - r_inner) * h_lod
    flat = mips.reshape(mips.shape[0] * base_h * base_w, -1)
    return _bilinear_flat(flat, u, v, base_w // pow2, base_h // pow2, base_w,
                          lod_i * (base_h * base_w))
