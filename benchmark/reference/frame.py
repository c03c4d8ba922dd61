"""The plain reference of the frames the benchmark's cells render.

It works every frame out again from the scene's settings and the seed
alone: the skybox, the lifecycle's entities (replayed tick by tick), the
per-frame disk texture (background noise, entities, stats, compose), the
plain ray march, the deferred shade (or the V2 volume shade, in its
masked full-frame form), bloom, the lens flare where a still states it,
and the uint8 quantise. It runs the frozen copy of the port's plain
modules (``frozen/``) and nothing of the port. ``lowp=True`` is the
control: every stage's floating-point output (skybox, texture, trace,
shade, post, flare) is rounded to bfloat16, the precision below the
float32 that the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .frozen.camera import build_camera, orbit_camera_position
from .frozen.config import (
    compute_disk_texture_resolution,
    escape_radius,
    orbit_escape_radius,
)
from .frozen.constants import DISK_COLOR_TEMPERATURE, MAX_DISK_CROSSINGS
from .frozen.models.disk_v2.params import DiskV2Params, DiskV2StructureParams
from .frozen.models.dynamic_disk import (
    DynamicDiskSystem,
    adaptive_generation_scale,
    frame_texture,
)
from .frozen.models.lifecycle import (
    MAX_HOTSPOTS,
    MAX_RT_SPIKES,
    pack_filaments,
    pack_timer_entities,
    radial_omega_rows,
)
from .frozen.models.skybox import generate_skybox
from .frozen.ops.geodesic import (
    TraceResult,
    primary_rays_from_params,
    trace_geodesics,
)
from .frozen.ops.lens_flare import apply_lens_flare
from .frozen.pipeline import _shade_frame_v2_masked, post_process, shade_frame
from .frozen.utils.io import compute_edge_alpha

# The skybox every scene of the port generates (2048 x 1024).
SKYBOX_SIZE = (2048, 1024)
# The session's zoom rounds the escape radius up to this grid.
SESSION_R_ESCAPE_QUANTUM = 4.0


def _lowp(x: torch.Tensor, on: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if on else x


def camera_params(cam_pos, fov: float, width: int, height: int) -> np.ndarray:
    """The (14,) float32 camera vector: position, right, up, forward,
    pixel width and height."""
    cam = build_camera(cam_pos, fov, width, height)
    return np.concatenate([
        cam.pos, cam.right, cam.up, cam.forward,
        np.asarray([cam.pixel_width, cam.pixel_height], np.float32),
    ]).astype(np.float32)


def trace_frame(scene: Dict, cam_params: np.ndarray, r_escape: float, device,
                record_step_counts: bool = False) -> TraceResult:
    """The plain ray march of a whole frame of ``scene`` (hits recorded,
    no differentials: the configurations render without AA)."""
    cam = torch.tensor(cam_params, device=torch.device(device))
    width, height = int(scene["width"]), int(scene["height"])
    dirs = primary_rays_from_params(cam, width, height)
    return trace_geodesics(
        cam[0:3], dirs, h_base=float(scene["step_size"]),
        r_escape=float(r_escape), tilt_deg=float(scene["disk_tilt"]),
        r_inner=float(scene["disk_inner_radius"]),
        r_outer=float(scene["disk_outer_radius"]),
        with_differentials=False, max_crossings=MAX_DISK_CROSSINGS,
        record_hits=True, record_step_counts=record_step_counts)


def orbit_camera(scene: Dict, frame: int, n_frames: int) -> np.ndarray:
    """The camera vector of orbit frame ``frame`` of ``n_frames``."""
    pos = orbit_camera_position(frame, n_frames, float(scene["orbit_degrees"]),
                                scene["pov"])
    return camera_params(pos, float(scene["fov"]), int(scene["width"]),
                         int(scene["height"]))


class Scene:
    """One configuration's scene on ``device``: its skybox and, for the
    lifecycle disk, the texture's size and per-row tables."""

    def __init__(self, scene: Dict, device, lowp: bool = False):
        self.s = scene
        self.device = torch.device(device)
        self.lowp = lowp
        self.width, self.height = int(scene["width"]), int(scene["height"])
        self.r_inner = float(scene["disk_inner_radius"])
        self.r_outer = float(scene["disk_outer_radius"])
        self.is_v2 = scene["disk_model"] == "v2"
        sky = generate_skybox(*SKYBOX_SIZE, seed=int(scene["skybox_seed"]),
                              n_stars=int(scene["n_stars"]))
        self.skybox = _lowp(torch.tensor(sky, device=self.device), lowp)
        if self.is_v2:
            self.v2_args = v2_arguments(scene)
            return
        self.n_phi, self.n_r = compute_disk_texture_resolution(
            self.width, self.height, tuple(scene["pov"]), float(scene["fov"]),
            self.r_inner, self.r_outer)
        self.generation_scale = adaptive_generation_scale(self.n_r, self.n_phi)
        _, omega = radial_omega_rows(self.n_r, self.r_inner, self.r_outer)
        self.omega_rows = torch.tensor(omega, dtype=torch.float32,
                                       device=self.device)
        self.edge = torch.tensor(compute_edge_alpha(self.n_r),
                                 dtype=torch.float32, device=self.device)

    def lifecycle(self) -> DynamicDiskSystem:
        """A fresh lifecycle system of this scene's seed (none for V2);
        its draws of the background's azimuthal frequency and shear are
        the scene's."""
        dyn = DynamicDiskSystem(self.n_r, self.n_phi, self.r_inner,
                                self.r_outer, seed=int(self.s["seed"]),
                                device=self.device)
        self.az = (dyn.az_freq, dyn.az_shear)
        return dyn

    def texture(self, packs, t: float) -> torch.Tensor:
        """The lifecycle's (n_r, n_phi, 4) disk texture of a frame at
        ``t`` from the frame's (filament, hotspot, rt_spike) ``packs``,
        with the frame's own stats."""
        fil, hs, rt = (torch.as_tensor(a, dtype=torch.float32, device=self.device)
                       for a in packs)
        tex, _, _ = frame_texture(
            fil, hs, rt, self.omega_rows, self.edge, t,
            n_r=self.n_r, n_phi=self.n_phi, az_freq=self.az[0],
            az_shear=self.az[1], r_inner=self.r_inner, r_outer=self.r_outer,
            generation_scale=self.generation_scale,
            color_temp=DISK_COLOR_TEMPERATURE)
        return tex

    def trace(self, cam_params: np.ndarray, r_escape: float) -> TraceResult:
        return trace_frame(self.s, cam_params, r_escape, self.device)

    def shade(self, tr: TraceResult, tex, cam_pos: torch.Tensor, t: float):
        """(background, disk) layers, each (N, 3): the deferred shade of
        the disk texture ``tex``, or for V2 the volume at time ``t``."""
        if self.is_v2:
            bg, disk, _ = _shade_frame_v2_masked(
                tr, self.skybox, cam_pos, t_offset=t, **self.v2_args)
        else:
            bg, disk, _ = shade_frame(
                tr, self.skybox, _lowp(tex, self.lowp)[None], cam_pos,
                r_inner=self.r_inner, r_outer=self.r_outer,
                tilt_deg=float(self.s["disk_tilt"]), t_offset=0.0)
        return bg, disk

    def render(self, tex, cam_params: np.ndarray, r_escape: float,
               t: float = 0.0, bloom: bool = True,
               flare: bool = False) -> torch.Tensor:
        """One (H, W, 3) uint8 frame of the disk texture ``tex`` (None for
        V2) from ``cam_params``: the trace, the shade, bloom and the
        clamp, the lens flare where ``flare``, the uint8 quantise."""
        lp = self.lowp
        tr = self.trace(cam_params, r_escape)
        if lp:
            tr = tr._replace(escape_dir=_lowp(tr.escape_dir, True),
                             hits=_lowp(tr.hits, True))
        cam_pos = torch.tensor(cam_params[0:3], device=self.device)
        bg, disk = self.shade(tr, tex, cam_pos, t)
        del tr
        shape = (self.height, self.width, 3)
        bg, disk = _lowp(bg, lp).reshape(shape), _lowp(disk, lp).reshape(shape)
        final = _lowp(post_process(bg, disk, bloom), lp)
        if flare:
            final = _lowp(apply_lens_flare(final, disk), lp)
        return torch.round(final * 255.0).to(torch.uint8)

    def frame(self, cam_params: np.ndarray, t: float, packs, r_escape: float,
              bloom: bool = True) -> torch.Tensor:
        """One (H, W, 3) uint8 frame of a video or a session, without the
        flare. ``t`` is the frame's time as the float32 the program hands
        its device; ``packs`` the (filament, hotspot, rt_spike) rows of
        the frame (None for V2)."""
        tex = None if self.is_v2 else self.texture(packs, t)
        return self.render(tex, cam_params, r_escape, t, bloom)


def v2_arguments(scene: Dict) -> dict:
    """The V2 shade's scene arguments from the configuration's fields."""
    params = DiskV2Params(
        r_in=float(scene["disk_inner_radius"]),
        r_out=float(scene["disk_outer_radius"]),
        h0=float(scene["v2_h0"]), beta_h=float(scene["v2_beta_h"]),
        rho_power=float(scene["v2_rho_power"]),
        temp_scale=float(scene["v2_temp_scale"]),
        omega_scale=float(scene["v2_omega_scale"]),
        edge_softness=float(scene["v2_edge_softness"]))
    structure = None if not scene["v2_structure"] else DiskV2StructureParams(
        mode1_strength=float(scene["v2_mode1_strength"]),
        mode2_strength=float(scene["v2_mode2_strength"]),
        shear_strength=float(scene["v2_shear_strength"]),
        shear_components=int(scene["v2_shear_components"]),
        hotspot_strength=float(scene["v2_hotspot_strength"]),
        hotspot_count=int(scene["v2_hotspot_count"]),
        hotspot_phi_sigma=float(scene["v2_hotspot_phi_sigma"]),
        hotspot_logr_sigma=float(scene["v2_hotspot_logr_sigma"]),
        hotspot_inner_bias=float(scene["v2_hotspot_inner_bias"]))
    return dict(v2_params=params, v2_structure=structure,
                tilt_deg=float(scene["disk_tilt"]),
                palette=scene["v2_palette"], n_samples=int(scene["v2_samples"]),
                seed=int(scene["seed"]))


def _packs(dyn: DynamicDiskSystem, now: float):
    return (pack_filaments(dyn.factories["filament"], now),
            pack_timer_entities(dyn.factories["hotspot"], now, MAX_HOTSPOTS),
            pack_timer_entities(dyn.factories["rt_spike"], now, MAX_RT_SPIKES))


def video_frames(scene: Scene, n_frames: int, indices: Iterable[int]
                 ) -> Dict[int, torch.Tensor]:
    """{frame index: uint8 frame} of an orbit video of ``n_frames``
    frames over ``orbit_degrees``: the lifecycle replayed from frame 0
    (one tick a frame at t = frame x rotation speed), the frame's own
    stats, the orbit's one escape radius."""
    s = scene.s
    want = sorted(set(int(i) for i in indices))
    dt = float(s["disk_rotation_speed"])
    r_escape = orbit_escape_radius(float(s["r_max"]), s["pov"])
    packs = {}
    if not scene.is_v2 and want:
        dyn = scene.lifecycle()
        for f in range(want[-1] + 1):
            for fac in dyn.factories.values():
                fac.tick(now=f * dt, dt=dt)
            if f in want:
                packs[f] = _packs(dyn, f * dt)
    out = {}
    for f in want:
        cam = orbit_camera(s, f, n_frames)
        t32 = float(np.float32(f * dt))
        out[f] = scene.frame(cam, t32, packs.get(f), r_escape)
    return out


# -- the interactive session -------------------------------------------------


class SessionState:
    """The session's camera and clock as its keys and drags move them:
    spherical camera about the origin, zoom keys, drags of the mouse."""

    def __init__(self, scene: Dict):
        cam = np.asarray(scene["pov"], dtype=np.float64)
        self.r = float(np.linalg.norm(cam))
        self.theta = float(np.arccos(np.clip(cam[2] / self.r, -1, 1)))
        self.phi = float(np.arctan2(cam[1], cam[0]))
        self.fov = float(scene["fov"])
        self.drag = None
        self.wall_time = 0.0
        self.speed = float(scene["disk_rotation_speed"])

    def key(self, k: str) -> None:
        if k in ("+", "="):
            self.r = max(2.0, self.r * 0.97)
        elif k == "-":
            self.r *= 1.03
        elif k == "up":
            self.fov = max(10.0, self.fov - 5.0)
        elif k == "down":
            self.fov = min(170.0, self.fov + 5.0)
        else:
            raise ValueError(f"the reference moves no state for key {k!r}")

    def drag_to(self, x, y) -> None:
        if self.drag is None or x is None:
            self.drag = (x, y) if x is not None else None
            return
        self.phi -= (x - self.drag[0]) / 200.0
        self.theta = float(np.clip(self.theta - (y - self.drag[1]) / 200.0,
                                   0.05, np.pi - 0.05))
        self.drag = (x, y)

    def advance(self, real_dt: float) -> float:
        """The simulation step of one display frame: returns its dt."""
        scaled = min(real_dt, 0.1) * self.speed * 20.0
        self.wall_time += scaled
        return scaled

    def cam_pos(self) -> List[float]:
        r, th, ph = self.r, self.theta, self.phi
        return [r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                r * np.cos(th)]


def session_frames(scene: Scene, script: List[Tuple[list, list, float]],
                   indices: Iterable[int]) -> Dict[int, torch.Tensor]:
    """{step: uint8 frame rendered at that step} for a session driven
    by ``script``: one (keys, drags, real_dt) entry per step, the keys
    and drags applied before the step. Each step ticks the lifecycle at
    the step's clock and renders with the frame's own stats, bloom on,
    no flare, no AA, the escape radius rounded up to the zoom grid."""
    want = set(int(i) for i in indices)
    st = SessionState(scene.s)
    dyn = None
    if not scene.is_v2:
        dyn = scene.lifecycle()
    out = {}
    q = SESSION_R_ESCAPE_QUANTUM
    for i, (keys, drags, real_dt) in enumerate(script):
        if not want:
            break
        for k in keys:
            st.key(k)
        for xy in drags:
            st.drag_to(*xy)
        scaled = st.advance(real_dt)
        if dyn is not None:
            for fac in dyn.factories.values():
                fac.tick(now=st.wall_time, dt=scaled)
        if i not in want:
            continue
        want.discard(i)
        pos = st.cam_pos()
        r_esc = float(math.ceil(escape_radius(float(scene.s["r_max"]), pos) / q) * q)
        cam = camera_params(pos, st.fov, scene.width, scene.height)
        t32 = float(np.float32(st.wall_time))
        packs = None if dyn is None else _packs(dyn, st.wall_time)
        out[i] = scene.frame(cam, t32, packs, r_esc)
    return out
