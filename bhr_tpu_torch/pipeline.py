"""Per-frame render pipeline: trace -> deferred shade -> bloom, clamp, flare.

The port of ``bhr_tpu/pipeline.py``. The trace records up to K disk crossings per ray (on a CUDA device
through the hand-written ray-march kernel, on the CPU through its plain
version), with two transported ray differentials per crossing when
anti-aliasing is on; shading then samples the disk texture at every
recorded hit (with AA, at the mip level the differentials' texture-space
footprint selects), applies the relativistic g-factor, composites the K
slots front to back, and samples the skybox for escaped rays; bloom, a
clamp and the optional lens flare finish the frame. With
``disk_model="v2"`` there is no texture: ``shade_frame_v2`` integrates
emission and absorption through a finite-thickness slab at every
recorded hit (``models/disk_v2``). PyTorch runs eagerly, so the
``Renderer`` holds the device assets (skybox, disk mip pyramid) and
calls each stage in turn.

With the NaN trap on (``utils/nans.py``, ``--debug_nans``) each stage of
the ``Renderer`` checks its outputs where ``bhr_tpu``'s are the outputs
of a ``jax.jit``: ``skybox`` (the upload), ``mips``,
``trace[<kernel instantiation>]`` (the kernel's outputs on CUDA, its
plain version's on the CPU), ``shade`` or ``shade_v2``, and ``post``.

``bhr_tpu``'s ghost-slot crop window is left out of the texture path on
purpose: it only cuts gather counts and is exact by construction, so the
masked pass over all slots gives the same image. The V2 path has the
eager counterpart of it: shapes are free to change from call to call, so
only the rays that recorded a hit in a slot are integrated, all slots'
in one pass.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .camera import Camera, build_camera
from .config import SceneConfig, escape_radius, torch_device
from .constants import DISK_ALPHA_GAIN, DISK_COLOR_TEMPERATURE, MAX_DISK_CROSSINGS
from .ops import geodesic
from .ops.bloom import bloom_composite
from .ops.geodesic_cuda import camera_params, kernel_name, trace_geodesics_cuda
from .ops.lens_flare import apply_lens_flare
from .ops.sampling import build_mipmaps, sample_disk, sample_disk_mip, sample_skybox
from .ops.shading import apply_g_factor, pow_const
from .utils.nans import check_nans
from .utils.profiling import span


# Mip levels of the disk texture's pyramid (level 0 included).
MIP_LEVELS = 4


def _lod(feat: torch.Tensor, hit_x: torch.Tensor, hit_y: torch.Tensor,
         tex_w: int, tex_h: int, r_inner: float, r_outer: float,
         aa_strength: float) -> torch.Tensor:
    """Mip LOD of a hit slot from its transported ray differentials
    (features 5..10): the larger texture-space footprint of one pixel
    step in x or y, log2 of it, times aa_strength, clipped to [0, 3]
    (``bhr_tpu/pipeline.py:227-244``, reference render.py:2961-2990)."""
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


def _max_hits(trace, n: int) -> int:
    """The most disk hits of any ray: the host's one wait inside a frame
    (the span ``frame.hit_sync``), after which the device's queue is
    empty."""
    if not n:
        return 0
    with span("frame.hit_sync"):
        return int(trace.hit_count.max())


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
    use_lod: bool = False,
    aa_strength: float = 1.0,
    color_temp: float = DISK_COLOR_TEMPERATURE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deferred shading over recorded hits.

    ``disk_mips`` is the disk texture's padded (L, n_r, n_phi, 4) mip
    pyramid (``build_mipmaps``), or None for a scene without a disk.
    Each hit slot k samples it, shades the sample
    and composites front to back where k < hit_count: at level 0, or
    with ``use_lod`` (an AA trace, whose hits carry differentials) at
    the mip level of :func:`_lod` (``sample_disk_mip``). Slot 0 always
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
        tex_h, tex_w = disk_mips.shape[1], disk_mips.shape[2]
        max_hits = _max_hits(trace, n)
        for k in range(k_slots):
            if k > 0 and k >= max_hits:
                break
            feat = trace.hits[k]
            valid = k < trace.hit_count
            hit_x, hit_y = feat[0], feat[1]
            ray_dir = feat[2:5].T
            if use_lod:
                lod = _lod(feat, hit_x, hit_y, tex_w, tex_h, r_inner, r_outer,
                           aa_strength)
                rgba = sample_disk_mip(disk_mips, disk_mips.shape[0], hit_x,
                                       hit_y, r_inner, r_outer, t_offset, lod)
            else:
                rgba = sample_disk(disk_mips[0], hit_x, hit_y, r_inner,
                                   r_outer, t_offset)

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


def v2_shade_args(config: SceneConfig) -> dict:
    """The scene arguments of :func:`shade_frame_v2` for a V2 config: the
    whole V2 surface (body params, structure layer, palette, quadrature
    samples), the tilt and the seed."""
    return dict(
        v2_params=config.v2_params(),
        v2_structure=config.v2_structure_params(),
        tilt_deg=float(config.disk_tilt),
        palette=config.v2_palette,
        n_samples=int(config.v2_samples),
        seed=int(config.seed),
    )


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


def shade_frame_v2(
    trace: geodesic.TraceResult,
    skybox: torch.Tensor,
    cam_pos: torch.Tensor,
    *,
    v2_params,
    v2_structure,
    tilt_deg: float,
    t_offset: float,
    palette: str = "cinematic",
    n_samples: int = 8,
    seed: int = 42,
    color_temp: float = DISK_COLOR_TEMPERATURE,
    on_slot=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Disk V2 deferred shading: emission-absorption slab integration.

    Replaces the texture lookup of :func:`shade_frame` with the disk_v2
    volume model (``models/disk_v2/integrator.py``): at each recorded
    midplane crossing, integrate j * exp(-tau) through the
    finite-thickness slab along the ray, map (intensity, temperature)
    through the palette, and apply the same relativistic g-factor
    shading and front-to-back compositing as the texture path.
    ``t_offset`` is the advection time of the structure pattern
    (phi - Omega(r) t).

    A slot k counts only when some ray recorded k + 1 hits. The rays
    with ``k < hit_count`` of every such slot are gathered into one
    batch, integrated in one pass (a ghost slot holds a few percent of
    the frame's hits, too few to pay for its own ~600 launches) and
    composited slot by slot, front to back; rays without a hit in a slot
    are left untouched. The integrator is element-wise per ray, so a
    ray's value does not depend on the selection.
    ``on_slot(k, n_rays)``, if given, is called after slot k is
    composited with the number of rays integrated for it.

    Returns (bg_rgb, disk_rgb, alpha_total), each flattened over the N
    pixels.
    """
    shade_slot = _v2_slot_shader(
        cam_pos, v2_params=v2_params, v2_structure=v2_structure,
        tilt_deg=tilt_deg, t_offset=t_offset, palette=palette,
        n_samples=n_samples, seed=seed, color_temp=color_temp)
    n = trace.hits.shape[2]
    dev = trace.hits.device
    accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alpha_total = torch.zeros((n,), dtype=torch.float32, device=dev)
    max_hits = _max_hits(trace, n)

    slots = range(min(trace.hits.shape[0], max_hits))
    if slots:  # (no slot: nothing to gather)
        rays = [torch.nonzero(k < trace.hit_count).squeeze(1) for k in slots]
        sizes = [idx.numel() for idx in rays]
        shaded, alpha = shade_slot(torch.cat(
            [trace.hits[k][:5, idx] for k, idx in zip(slots, rays)], dim=1))
        for k, idx, col, a in zip(slots, rays, shaded.split(sizes),
                                  alpha.split(sizes)):
            front = 1.0 - alpha_total[idx]
            accum[idx] += col * (a * front)[:, None]
            alpha_total[idx] = 1.0 - front * (1.0 - a)
            if on_slot is not None:
                on_slot(k, idx.numel())
    return _v2_layers(trace, skybox, accum, alpha_total)


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
                 use_bloom: bool, use_flare: bool) -> torch.Tensor:
    """The frame-global post of (H, W, 3) layers: bloom of the disk layer
    (``width_ref`` = W) and a clamp, then the lens flare -> (H, W, 3)."""
    if use_bloom:
        # The reference's PNG path composites the raw blur field
        # (render.py:3916-3918); see ops/bloom.py.
        final = bloom_composite(bg_img, disk_img)
    else:
        final = torch.clamp(bg_img + disk_img, 0.0, 1.0)
    if use_flare:
        final = apply_lens_flare(final, disk_img)
    return final


class Renderer:
    """Holds the device assets and config; renders frames stage by stage.

    Usage:
        renderer = Renderer(config, skybox, disk_tex)  # None for V2
        img = renderer.render(cam_pos, fov)          # (H, W, 3) numpy
        renderer.update_disk_texture(new_tex)        # dynamic textures

    ``device`` defaults to ``config.device``; "cuda" without a GPU
    raises. On CUDA the trace goes through the ray-march kernel, on the
    CPU through its plain version. ``r_escape_override`` pins the
    trace's escape radius for every frame (the orbit video passes
    ``scene_escape_radius(config)``, so that both video engines trace
    the same scene); by default each frame uses
    ``escape_radius(r_max, cam_pos)``. Without an override, a non-zero
    ``r_escape_quantum`` rounds that radius up to a multiple of it
    (``ceil(r / q) * q``), as the interactive session asks with 4.0. In
    ``bhr_tpu`` the quantum bounds recompiles under zoom; here the escape
    radius is a runtime argument of the kernel and no value costs a
    rebuild. The quantum is kept because it decides what is rendered
    (rays escape a little later), and the session's frames are held
    against ``bhr_tpu``'s.
    """

    def __init__(
        self,
        config: SceneConfig,
        skybox: np.ndarray,
        disk_tex,
        mip_levels: int = MIP_LEVELS,
        device=None,
        r_escape_override: Optional[float] = None,
        r_escape_quantum: float = 0.0,
    ):
        self.config = config
        self.r_escape_quantum = float(r_escape_quantum)
        self.r_escape_override = (
            None if r_escape_override is None else float(r_escape_override))
        self.device = torch_device(config.device) if device is None else torch.device(device)
        self.width, self.height = config.image_size
        self.skybox = torch.as_tensor(np.asarray(skybox, np.float32),
                                      device=self.device)
        check_nans("skybox", self.skybox)
        self.mip_levels = mip_levels
        self.num_mip_levels = 1
        self.disk_mips: Optional[torch.Tensor] = None
        if disk_tex is not None:
            self.update_disk_texture(disk_tex)

    # -- disk texture management ------------------------------------------

    def update_disk_texture(self, tex) -> None:
        """Upload a new (n_r, n_phi, 4) texture and rebuild the mip pyramid."""
        tex = torch.as_tensor(tex, dtype=torch.float32, device=self.device)
        self.disk_mips = build_mipmaps(tex, levels=self.mip_levels)
        check_nans("mips", self.disk_mips)
        self.num_mip_levels = int(self.disk_mips.shape[0])

    # -- stages ------------------------------------------------------------

    def camera(self, cam_pos, fov: float) -> Camera:
        return build_camera(cam_pos, fov, self.width, self.height)

    def trace(self, camera: Camera, r_escape: float,
              use_diff: bool) -> geodesic.TraceResult:
        """Trace every pixel of ``camera``: the ray-march kernel on CUDA.

        ``r_escape`` is a runtime argument of the kernel, so no value of
        it costs a rebuild (``escape_radius(r_max, cam_pos)`` per frame).
        ``use_diff`` transports ray differentials (the AA trace);
        crossings are recorded only when there is something to shade
        them with: a disk texture, or the V2 volume model.
        """
        cfg = self.config
        cam = torch.as_tensor(camera_params(camera), device=self.device)
        variant = dict(with_differentials=use_diff,
                       record_hits=(self.disk_mips is not None
                                    or cfg.disk_model == "v2"))
        trace = trace_geodesics_cuda(
            cam, width=self.width, height=self.height,
            h_base=float(cfg.step_size),
            r_escape=float(r_escape),
            tilt_deg=float(cfg.disk_tilt),
            r_inner=float(cfg.disk_inner_radius),
            r_outer=float(cfg.disk_outer_radius),
            max_crossings=MAX_DISK_CROSSINGS,
            **variant,
        )
        check_nans(f"trace[{kernel_name(**variant, record_step_counts=False)}]",
                   trace)
        return trace

    def shade(self, trace: geodesic.TraceResult, camera: Camera, frame: int,
              use_diff: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deferred shade -> (bg, disk) layers, each (N, 3); ``use_diff``
        selects the mip LOD from the trace's differentials. A V2 scene
        integrates the volume model at advection time ``t_offset``."""
        cfg = self.config
        cam_pos = torch.as_tensor(camera.pos, device=self.device)
        t_offset = float(np.float32(frame * cfg.disk_rotation_speed))
        if cfg.disk_model == "v2":
            bg, disk_rgb, _ = shade_frame_v2(
                trace, self.skybox, cam_pos, t_offset=t_offset,
                **v2_shade_args(cfg))
            check_nans("shade_v2", bg, disk_rgb)
            return bg, disk_rgb
        bg, disk_rgb, _ = shade_frame(
            trace, self.skybox, self.disk_mips, cam_pos,
            r_inner=float(cfg.disk_inner_radius),
            r_outer=float(cfg.disk_outer_radius),
            tilt_deg=float(cfg.disk_tilt),
            t_offset=t_offset,
            use_lod=use_diff,
            aa_strength=float(cfg.aa_strength),
        )
        check_nans("shade", bg, disk_rgb)
        return bg, disk_rgb

    def post(self, bg: torch.Tensor, disk_rgb: torch.Tensor, use_bloom: bool,
             use_flare: bool):
        """Bloom + clamp, then the lens flare -> (final, bg, disk) images,
        each (H, W, 3)."""
        shape = (self.height, self.width, 3)
        bg_img = bg.reshape(shape)
        disk_img = disk_rgb.reshape(shape)
        final = post_process(bg_img, disk_img, use_bloom, use_flare)
        # (bg_img and disk_img are the shade's outputs, checked there.)
        check_nans("post", final)
        return final, bg_img, disk_img

    def frame_escape_radius(self, cam_pos) -> float:
        """The escape radius a frame from ``cam_pos`` is traced with: the
        override, else ``escape_radius(r_max, cam_pos)`` rounded up to
        the quantum (if any)."""
        if self.r_escape_override is not None:
            return self.r_escape_override
        r_escape = escape_radius(self.config.r_max, cam_pos)
        if self.r_escape_quantum > 0.0:
            q = self.r_escape_quantum
            r_escape = float(np.ceil(r_escape / q) * q)
        return r_escape

    def _run_frame(self, cam_pos, fov, frame, skip_differentials, skip_bloom,
                   use_flare, force_differentials=False):
        # force_differentials: the interactive 'd' key turns the
        # differential + mip-LOD path on in a session launched with
        # anti_alias="disabled"; inert for V2, which has no LOD path.
        use_diff = (
            self.config.use_ray_differentials
            or (force_differentials and self.config.disk_model != "v2")
        ) and not skip_differentials
        camera = self.camera(cam_pos, fov)
        r_escape = self.frame_escape_radius(cam_pos)
        trace = self.trace(camera, r_escape, use_diff)
        bg, disk_rgb = self.shade(trace, camera, frame, use_diff)
        return self.post(bg, disk_rgb, not skip_bloom, use_flare)

    # -- rendering ---------------------------------------------------------

    def render_layers(self, cam_pos, fov: float, frame: int = 0,
                      skip_differentials: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render background + disk layers, each (H, W, 3) on device."""
        _, bg, disk = self._run_frame(cam_pos, fov, frame, skip_differentials,
                                      True, False)
        return bg, disk

    def render_device(self, cam_pos, fov: float, frame: int = 0,
                      skip_differentials: bool = False,
                      skip_bloom: bool = False,
                      lens_flare: Optional[bool] = None,
                      force_differentials: bool = False) -> torch.Tensor:
        """Render a full frame, returned on device (H, W, 3)."""
        use_flare = self.config.lens_flare if lens_flare is None else lens_flare
        final, _, _ = self._run_frame(cam_pos, fov, frame, skip_differentials,
                                      skip_bloom, use_flare, force_differentials)
        return final

    def render(self, cam_pos, fov: float, frame: int = 0,
               skip_differentials: bool = False, skip_bloom: bool = False,
               lens_flare: Optional[bool] = None,
               force_differentials: bool = False) -> np.ndarray:
        """Render a full frame -> (H, W, 3) float32 numpy in [0, 1]."""
        return self.render_device(cam_pos, fov, frame, skip_differentials,
                                  skip_bloom, lens_flare,
                                  force_differentials).cpu().numpy()
