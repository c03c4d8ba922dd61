"""The plain reference of the anti-aliased, lens-flared orbit video.

A scene with ``anti_alias="lod_radius"`` (and, as the configuration
states it, ``lens_flare``): :class:`Scene` is ``frame.Scene`` with the
frame the port's batched engine renders for it, in plain float32 torch
from the frozen copy and nothing of the port: the lifecycle texture ->
its mip pyramid -> the plain ray march carrying the two ray
differentials -> the LOD shade (each hit at the mip level its
differentials select) -> bloom and the clamp -> the lens flare -> the
uint8 quantise. ``frame.video_frames`` renders an orbit's frames with it
as it stands (the lifecycle replay, cameras and escape radius are the
same).

``lowp=True`` is the control: every stage's floating-point output
(skybox, texture, mips, trace, shade, post, flare) is rounded to
bfloat16, below the float32 the configuration states. The other
controls are scenes changed by one field: ``aa_strength`` 0 puts every
hit at mip level 0; ``lens_flare`` False leaves the flare out.

Departures from the port: the port traces with the CUDA kernel, which
fuses multiply-adds where this plain tracer does not, so a ray that
grazes the horizon, the disk's edge or a mip level's boundary may land
on the other side of it (the limits leave room for that and no more);
the port's batched engine makes a batch's background noise in one pass
where this makes each frame's on its own, the same values bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import frame
from .frame import _lowp
from .frozen.constants import DISK_COLOR_TEMPERATURE, MAX_DISK_CROSSINGS
from .frozen.lod import (
    MIP_LEVELS,
    build_mipmaps,
    primary_differentials_from_params,
    shade_frame_lod,
)
from .frozen.models.dynamic_disk import frame_texture
from .frozen.ops.geodesic import (
    TraceResult,
    primary_rays_from_params,
    trace_geodesics,
)
from .frozen.ops.lens_flare import apply_lens_flare
from .frozen.pipeline import post_process


def trace_frame_aa(scene: Dict, cam_params: np.ndarray, r_escape: float,
                   device, record_step_counts: bool = False) -> TraceResult:
    """The plain ray march of a whole frame of ``scene`` with the two ray
    differentials transported to every recorded hit."""
    cam = torch.tensor(cam_params, device=torch.device(device))
    width, height = int(scene["width"]), int(scene["height"])
    dirs = primary_rays_from_params(cam, width, height)
    ddx, ddy = primary_differentials_from_params(cam, width, height)
    return trace_geodesics(
        cam[0:3], dirs, h_base=float(scene["step_size"]),
        r_escape=float(r_escape), tilt_deg=float(scene["disk_tilt"]),
        r_inner=float(scene["disk_inner_radius"]),
        r_outer=float(scene["disk_outer_radius"]),
        with_differentials=True, d_dir_dx0=ddx, d_dir_dy0=ddy,
        max_crossings=MAX_DISK_CROSSINGS, record_hits=True,
        record_step_counts=record_step_counts)


class Scene(frame.Scene):
    """An anti-aliased lifecycle scene on ``device``."""

    def __init__(self, scene: Dict, device, lowp: bool = False):
        if scene["disk_model"] == "v2" or scene["anti_alias"] == "disabled":
            raise ValueError("the AA reference renders an anti-aliased "
                             "lifecycle disk")
        super().__init__(scene, device, lowp)

    def trace(self, cam_params: np.ndarray, r_escape: float) -> TraceResult:
        return trace_frame_aa(self.s, cam_params, r_escape, self.device)

    def frame(self, cam_params: np.ndarray, t: float, packs, r_escape: float,
              bloom: bool = True) -> torch.Tensor:
        """One (H, W, 3) uint8 frame, as ``frame.Scene.frame``."""
        lp = self.lowp
        dev = self.device
        fil, hs, rt = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                       for a in packs)
        tex, _, _ = frame_texture(
            fil, hs, rt, self.omega_rows, self.edge, t,
            n_r=self.n_r, n_phi=self.n_phi, az_freq=self.az[0],
            az_shear=self.az[1], r_inner=self.r_inner, r_outer=self.r_outer,
            generation_scale=self.generation_scale,
            color_temp=DISK_COLOR_TEMPERATURE)
        mips = _lowp(build_mipmaps(_lowp(tex, lp), levels=MIP_LEVELS), lp)
        tr = self.trace(cam_params, r_escape)
        if lp:
            tr = tr._replace(escape_dir=_lowp(tr.escape_dir, True),
                             hits=_lowp(tr.hits, True))
        cam_pos = torch.tensor(cam_params[0:3], device=dev)
        bg, disk, _ = shade_frame_lod(
            tr, self.skybox, mips, cam_pos, r_inner=self.r_inner,
            r_outer=self.r_outer, tilt_deg=float(self.s["disk_tilt"]),
            t_offset=0.0, aa_strength=float(self.s["aa_strength"]))
        del tr
        shape = (self.height, self.width, 3)
        bg, disk = _lowp(bg, lp).reshape(shape), _lowp(disk, lp).reshape(shape)
        final = _lowp(post_process(bg, disk, bloom), lp)
        if self.s["lens_flare"]:
            final = _lowp(apply_lens_flare(final, disk), lp)
        return torch.round(final * 255.0).to(torch.uint8)
