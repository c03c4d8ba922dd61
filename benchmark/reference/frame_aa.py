"""The plain reference of the anti-aliased, lens-flared frame, of an orbit
video or of a still.

A scene with ``anti_alias="lod_radius"`` (and, as the configuration
states it, ``lens_flare``): :class:`Scene` is ``frame.Scene`` with the
frame the port's batched engine renders for it, in plain float32 torch
from the frozen copy and nothing of the port: the lifecycle texture ->
its mip pyramid -> the plain ray march carrying the two ray
differentials -> the LOD shade (each hit at the mip level its
differentials select) -> bloom and the clamp -> the lens flare -> the
uint8 quantise. ``frame.video_frames`` renders an orbit's frames with it
as it stands (the lifecycle replay, cameras and escape radius are the
same), and ``still.frames_of`` a still's (its t=0 lifecycle or its
static texture, its camera and escape radius).

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
from .frozen.constants import MAX_DISK_CROSSINGS
from .frozen.lod import (
    MIP_LEVELS,
    build_mipmaps,
    primary_differentials_from_params,
    shade_frame_lod,
)
from .frozen.ops.geodesic import (
    TraceResult,
    primary_rays_from_params,
    trace_geodesics,
)


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

    def shade(self, tr: TraceResult, tex, cam_pos: torch.Tensor, t: float):
        """(background, disk) layers: the texture's mip pyramid, each hit
        at the level its differentials select."""
        lp = self.lowp
        mips = _lowp(build_mipmaps(_lowp(tex, lp), levels=MIP_LEVELS), lp)
        bg, disk, _ = shade_frame_lod(
            tr, self.skybox, mips, cam_pos, r_inner=self.r_inner,
            r_outer=self.r_outer, tilt_deg=float(self.s["disk_tilt"]),
            t_offset=0.0, aa_strength=float(self.s["aa_strength"]))
        return bg, disk

    def frame(self, cam_params: np.ndarray, t: float, packs, r_escape: float,
              bloom: bool = True) -> torch.Tensor:
        """One (H, W, 3) uint8 frame, as ``frame.Scene.frame``, with the
        lens flare as the configuration states it."""
        return self.render(self.texture(packs, t), cam_params, r_escape, t,
                           bloom, bool(self.s["lens_flare"]))
