"""The anti-aliased disk: ray differentials, mip pyramid and LOD shade.

Part of the frozen copy (see the package docstring), for the scenes that
render with ``anti_alias="lod_radius"``: the port's
``ops/geodesic.primary_differentials_from_params`` (the initial
one-pixel direction deltas that ``ops/geodesic.trace_geodesics`` takes
as ``d_dir_dx0`` / ``d_dir_dy0``), ``ops/sampling.build_mipmaps`` and
``sample_disk_mip``, ``pipeline._lod`` and the LOD branch of
``pipeline.shade_frame`` (:func:`shade_frame_lod`), which samples each
hit at the mip level its transported differentials select.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .constants import DISK_ALPHA_GAIN, DISK_COLOR_TEMPERATURE
from .ops import geodesic
from .ops.geodesic import _image_plane
from .ops.sampling import TWO_PI, _bilinear_flat, _disk_polar, sample_skybox
from .ops.shading import apply_g_factor, pow_const

# Mip levels of the disk texture's pyramid (level 0 included).
MIP_LEVELS = 4


def _pixel_delta(v, iv, d):
    """normalize(v + d) - normalize(v) for the unnormalised ray ``v``
    (three tensors) with ``iv`` = 1/|v| and a one-pixel step ``d`` on the
    image plane (three scalars), without subtracting two unit vectors:

        (v + d) ia - v iv = d ia - v (ia - iv),
        ia - iv = -(d.(2v + d)) (ia iv)^2 / (ia + iv),   ia = 1/|v + d|.
    """
    a = [v[c] + d[c] for c in range(3)]
    ia = torch.rsqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2])
    s = d[0] * (v[0] + a[0]) + d[1] * (v[1] + a[1]) + d[2] * (v[2] + a[2])
    ii = ia * iv
    g = s * (ii * ii) * torch.reciprocal(ia + iv)
    return torch.stack([d[c] * ia - v[c] * g for c in range(3)], dim=-1)


def primary_differentials_from_params(cam_params: torch.Tensor, width: int,
                                      height: int, row_start: int = 0,
                                      row_count: Optional[int] = None):
    """(d_dir_dx0, d_dir_dy0), each (R*W, 3): the one-pixel direction
    deltas, normalize(ray through (col + 1.5, row + 0.5)) minus the unit
    primary ray, and likewise one row down, over rows [row_start,
    row_start + R)."""
    v, c = _image_plane(cam_params, width, height, row_start, row_count)
    iv = torch.rsqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + 1e-18)
    pw, ph = c[12], c[13]
    step_x = (pw * c[3], pw * c[4], pw * c[5])  # +1 column: + pw * right
    step_y = (-ph * c[6], -ph * c[7], -ph * c[8])  # +1 row: - ph * up
    return (_pixel_delta(v, iv, step_x).reshape(-1, 3),
            _pixel_delta(v, iv, step_y).reshape(-1, 3))


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
    W >> l and v clamping at its own last row (H >> l) - 1."""
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


def _lod(feat: torch.Tensor, hit_x: torch.Tensor, hit_y: torch.Tensor,
         tex_w: int, tex_h: int, r_inner: float, r_outer: float,
         aa_strength: float) -> torch.Tensor:
    """Mip LOD of a hit slot from its transported ray differentials
    (features 5..10): the larger texture-space footprint of one pixel
    step in x or y, log2 of it, times aa_strength, clipped to [0, 3]
    (reference render.py:2961-2990)."""
    dpx = feat[5:8]
    dpy = feat[8:11]
    r_cyl = torch.sqrt(hit_x ** 2 + hit_y ** 2 + 1e-6)
    dr_dx = (hit_x * dpx[0] + hit_y * dpx[1]) / r_cyl
    dphi_dx = (-hit_y * dpx[0] + hit_x * dpx[1]) / (r_cyl ** 2 + 1e-6)
    dr_dy = (hit_x * dpy[0] + hit_y * dpy[1]) / r_cyl
    dphi_dy = (-hit_y * dpy[0] + hit_x * dpy[1]) / (r_cyl ** 2 + 1e-6)
    dudx = dphi_dx * tex_w / (2.0 * np.pi)
    dvdx = dr_dx * tex_h / (r_outer - r_inner)
    dudy = dphi_dy * tex_w / (2.0 * np.pi)
    dvdy = dr_dy * tex_h / (r_outer - r_inner)
    grad_sq = torch.maximum(dudx ** 2 + dvdx ** 2, dudy ** 2 + dvdy ** 2)
    return torch.clamp(
        torch.log2(torch.clamp(grad_sq, min=1.0)) * aa_strength, 0.0, 3.0)


def shade_frame_lod(
    trace: geodesic.TraceResult,
    skybox: torch.Tensor,
    disk_mips: torch.Tensor,
    cam_pos: torch.Tensor,
    *,
    r_inner: float,
    r_outer: float,
    tilt_deg: float,
    t_offset: float,
    aa_strength: float,
    color_temp: float = DISK_COLOR_TEMPERATURE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deferred shading over recorded hits of a trace with differentials:
    each hit slot k samples the padded (L, n_r, n_phi, 4) pyramid
    ``disk_mips`` at the level :func:`_lod` gives, shades the sample and
    composites front to back where k < hit_count. Slot 0 always runs; a
    slot k >= 1 runs only when some ray recorded k + 1 hits. Escaped rays
    sample the skybox.

    Returns (bg_rgb, disk_rgb, alpha_total), each flattened over the N
    pixels.
    """
    k_slots = trace.hits.shape[0]
    n = trace.hits.shape[2]
    dev = trace.hits.device
    tilt_rad = float(np.deg2rad(tilt_deg))
    tan_t = float(np.tan(tilt_rad))

    accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alpha_total = torch.zeros((n,), dtype=torch.float32, device=dev)

    tex_h, tex_w = disk_mips.shape[1], disk_mips.shape[2]
    max_hits = int(trace.hit_count.max()) if n else 0
    for k in range(k_slots):
        if k > 0 and k >= max_hits:
            break
        feat = trace.hits[k]
        valid = k < trace.hit_count
        hit_x, hit_y = feat[0], feat[1]
        ray_dir = feat[2:5].T
        lod = _lod(feat, hit_x, hit_y, tex_w, tex_h, r_inner, r_outer,
                   aa_strength)
        rgba = sample_disk_mip(disk_mips, disk_mips.shape[0], hit_x, hit_y,
                               r_inner, r_outer, t_offset, lod)

        hit_r = torch.sqrt(hit_x * hit_x + hit_y * hit_y)
        hit_z = hit_y * tan_t
        hit_pos = torch.stack([hit_x, hit_y, hit_z], dim=-1)
        shaded = apply_g_factor(
            rgba[:, :3], hit_pos, hit_r, -ray_dir, cam_pos,
            r_inner, r_outer, tilt_rad, color_temp,
        )
        base_alpha = torch.clamp(rgba[:, 3], max=0.999)
        disk_alpha = 1.0 - pow_const(1.0 - base_alpha, DISK_ALPHA_GAIN)
        disk_alpha = torch.where(valid, disk_alpha, 0.0)

        front = 1.0 - alpha_total
        accum = accum + shaded * (disk_alpha * front)[:, None]
        alpha_total = 1.0 - front * (1.0 - disk_alpha)

    bg = torch.where(trace.escaped[:, None],
                     sample_skybox(skybox, trace.escape_dir), 0.0)
    bg = bg * (1.0 - alpha_total)[:, None]
    disk_rgb = torch.clamp(accum, 0.0, 1.0)
    return bg, disk_rgb, alpha_total
