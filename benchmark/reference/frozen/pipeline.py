"""Per-frame render pipeline: deferred shade, then bloom and a clamp.

The plain part of the port's ``pipeline.py`` that the benchmark's scenes
reach: ``shade_frame`` samples the disk texture at every recorded hit of
the trace (``ops/geodesic.py``), applies the relativistic g-factor,
composites the K slots front to back and samples the skybox for escaped
rays; with ``disk_model="v2"`` there is no texture, and
``_shade_frame_v2_masked`` integrates emission and absorption through a
finite-thickness slab at every recorded hit (``models/disk_v2``), only
the rays that recorded a hit in a slot, all slots' in one pass.
``post_process`` finishes the frame with bloom and a clamp. The AA mip
path and the lens flare are not copied: no cell of the benchmark
renders with them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .constants import DISK_ALPHA_GAIN, DISK_COLOR_TEMPERATURE
from .ops import geodesic
from .ops.bloom import apply_bloom
from .ops.sampling import sample_disk, sample_skybox
from .ops.shading import apply_g_factor, pow_const


def shade_frame(
    trace: geodesic.TraceResult,
    skybox: torch.Tensor,
    disk_mips: Optional[torch.Tensor],
    cam_pos: torch.Tensor,
    *,
    r_inner: float,
    r_outer: float,
    tilt_deg: float,
    t_offset: float,
    color_temp: float = DISK_COLOR_TEMPERATURE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deferred shading over recorded hits.

    ``disk_mips`` is the disk texture as a (1, n_r, n_phi, 4) stack (the
    benchmark's scenes render without AA, so with no further mip level),
    or None for a scene without a disk. Each hit slot k samples its
    level 0, shades the sample and composites front to back where
    k < hit_count. Slot 0 always
    runs; a slot k >= 1 runs only when some ray recorded k + 1 hits
    (``bhr_tpu`` skips it the same way, and running it would round
    alpha through 1 - (1 - alpha)). Escaped rays sample the skybox.

    Returns (bg_rgb, disk_rgb, alpha_total), each flattened over the N
    pixels, front-to-back compositing as the reference's in-loop
    accumulation (render.py:2992-3018).
    """
    k_slots = trace.hits.shape[0]
    n = trace.hits.shape[2]
    dev = trace.hits.device
    tilt_rad = float(np.deg2rad(tilt_deg))
    tan_t = float(np.tan(tilt_rad))

    accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alpha_total = torch.zeros((n,), dtype=torch.float32, device=dev)

    if disk_mips is not None:
        max_hits = int(trace.hit_count.max()) if n else 0
        for k in range(k_slots):
            if k > 0 and k >= max_hits:
                break
            feat = trace.hits[k]
            valid = k < trace.hit_count
            hit_x, hit_y = feat[0], feat[1]
            ray_dir = feat[2:5].T
            rgba = sample_disk(disk_mips[0], hit_x, hit_y, r_inner, r_outer,
                               t_offset)

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


def _v2_slot_shader(cam_pos, *, v2_params, v2_structure, tilt_deg, t_offset,
                    palette, n_samples, seed, color_temp):
    """The V2 shade of a batch of hits: a function from ``feat`` (5+, M)
    (x, y, direction of M recorded crossings) to (shaded colour (M, 3),
    alpha (M,)). Element-wise per hit."""
    from .models.disk_v2.integrator import integrate_emission
    from .models.disk_v2.palette import apply_palette

    tilt_rad = float(np.deg2rad(tilt_deg))
    tan_t = float(np.tan(tilt_rad))
    cos_t, sin_t = float(np.cos(tilt_rad)), float(np.sin(tilt_rad))
    t_peak = float(v2_params.temp_scale)

    def to_disk_frame(v):
        """Rotate world -> disk frame (tilt about x-axis undone)."""
        x, y, z = v[:, 0], v[:, 1], v[:, 2]
        return torch.stack(
            [x, y * cos_t + z * sin_t, -y * sin_t + z * cos_t], dim=-1)

    def shade_slot(feat):
        hit_x, hit_y = feat[0], feat[1]
        hit_pos_w = torch.stack([hit_x, hit_y, hit_y * tan_t], dim=-1)
        ray_dir_w = feat[2:5].T
        intensity, temp_mean, alpha = integrate_emission(
            to_disk_frame(hit_pos_w), to_disk_frame(ray_dir_w),
            v2_params, v2_structure,
            n_samples=n_samples, seed=seed, t=t_offset,
        )
        color = apply_palette(
            intensity * 4.0, temp_mean / max(t_peak * 0.45, 1e-6), palette)
        hit_r = torch.sqrt(hit_x ** 2 + hit_y ** 2)
        shaded = apply_g_factor(
            color, hit_pos_w, hit_r, -ray_dir_w, cam_pos,
            float(v2_params.r_in), float(v2_params.r_out), tilt_rad,
            color_temp,
        )
        return shaded, torch.clamp(alpha, 0.0, 0.999)

    return shade_slot


def _v2_layers(trace, skybox, accum, alpha_total):
    """(bg_rgb, disk_rgb, alpha_total) from the composited disk layer."""
    bg = torch.where(trace.escaped[:, None],
                     sample_skybox(skybox, trace.escape_dir), 0.0)
    bg = bg * (1.0 - alpha_total)[:, None]
    return bg, torch.clamp(accum, 0.0, 1.0), alpha_total


def _shade_frame_v2_masked(trace, skybox, cam_pos, *, on_slot=None,
                           color_temp: float = DISK_COLOR_TEMPERATURE,
                           **scene):
    """:func:`shade_frame_v2`'s reference: every populated slot runs over
    all N rays with alpha masked to 0 where there is no hit, as
    ``bhr_tpu``'s full-frame pass does. Used by the tests and by
    ``chip_smoke.py`` to hold the gathered pass; no entry point runs it."""
    shade_slot = _v2_slot_shader(cam_pos, color_temp=color_temp, **scene)
    n = trace.hits.shape[2]
    dev = trace.hits.device
    accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alpha_total = torch.zeros((n,), dtype=torch.float32, device=dev)
    max_hits = int(trace.hit_count.max()) if n else 0
    for k in range(min(trace.hits.shape[0], max_hits)):
        shaded, alpha = shade_slot(trace.hits[k])
        alpha = torch.where(k < trace.hit_count, alpha, 0.0)
        front = 1.0 - alpha_total
        accum = accum + shaded * (alpha * front)[:, None]
        alpha_total = 1.0 - front * (1.0 - alpha)
        if on_slot is not None:
            on_slot(k, n)
    return _v2_layers(trace, skybox, accum, alpha_total)


def post_process(bg_img: torch.Tensor, disk_img: torch.Tensor,
                 use_bloom: bool) -> torch.Tensor:
    """The frame-global post of (H, W, 3) layers: bloom of the disk layer
    (``width_ref`` = W) and a clamp -> (H, W, 3) (the benchmark's scenes
    render without the lens flare)."""
    if use_bloom:
        # The reference's PNG path composites the raw blur field
        # (render.py:3916-3918); see ops/bloom.py.
        blur = apply_bloom(disk_img, width_ref=disk_img.shape[1])
        final = torch.clamp(bg_img + disk_img + blur, 0.0, 1.0)
    else:
        final = torch.clamp(bg_img + disk_img, 0.0, 1.0)
    return final
