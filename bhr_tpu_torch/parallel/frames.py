"""Multi-frame and tile-sharded rendering over a device grid.

The port of ``bhr_tpu/parallel/frames.py``. Frames shard over the grid's
"frames" axis and the pixel rows of each frame over its "tile" axis
(``parallel.mesh.FrameMesh``). A shard traces its row band of the full
frame's image plane through the ray-march kernel's row band
(``trace_geodesics_cuda(cam, row_start, row_count=R)``) and shades it;
the bands land on the grid's first device as (F, H, W, 3) frames.
``render_image_tiled`` renders one still in ``tile_shards`` bands and
runs the frame-global post (bloom, clamp, flare) on the gathered layers.

Where ``bhr_tpu`` compiles one sharded program, this loop enqueues work
device by device: in each step every shard's trace is launched before
any shard is shaded, because shading reads ``max(hit_count)`` on the
host, which waits for that trace, and would otherwise keep the next
device's trace from being enqueued.

With the NaN trap on (``utils/nans.py``) each row band's trace and shade
check their outputs as stages ``band<k>/trace[<instantiation>]`` and
``band<k>/shade`` (``band<k>/shade_v2``), k the band's index;
``render_image_tiled`` adds the whole frame's ``skybox``, ``mips`` and
``post`` (and the lifecycle texture's ``disk_texture`` and
``disk_stats``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import build_camera, orbit_camera_position
from ..config import SceneConfig, escape_radius, torch_device
from ..constants import MAX_DISK_CROSSINGS
from ..ops.geodesic import CAM_PARAMS
from ..ops.geodesic_cuda import camera_params, kernel_name, trace_geodesics_cuda
from ..ops.sampling import build_mipmaps
from ..pipeline import (
    MIP_LEVELS,
    post_process,
    shade_frame,
    shade_frame_v2,
    v2_shade_args,
)
from ..utils.nans import check_nans
from .mesh import FrameMesh, cuda_devices, make_frame_mesh


def pack_cameras(cameras) -> np.ndarray:
    """Pack Camera objects into an (F, 14) float32 array, one
    ``geodesic_cuda.camera_params`` row per camera."""
    return np.stack([camera_params(cam) for cam in cameras], axis=0)


def cameras_for_orbit(config: SceneConfig, frame_indices, width: int,
                      height: int) -> list:
    """Per-frame orbit cameras for the given frame indices (``config.pov``
    for every frame when ``config.orbit`` is off)."""
    cams = []
    for f in frame_indices:
        if config.orbit:
            pos = orbit_camera_position(int(f), config.n_frames,
                                        config.orbit_degrees, config.pov)
        else:
            pos = config.pov
        cams.append(build_camera(pos, config.fov, width, height))
    return cams


def build_sharded_frame_renderer(mesh: FrameMesh, config: SceneConfig,
                                 width: int, height: int,
                                 frames_per_device: int, *, r_escape: float,
                                 has_disk: bool = True, use_diff: bool = False,
                                 return_layers: bool = False):
    """A renderer of F = frames_per_device x mesh.shape["frames"] frames,
    each in mesh.shape["tile"] row bands, over ``mesh``. ``use_diff``
    traces the ray differentials and shades with the mip LOD;
    ``has_disk=False`` traces without hit recording and shades the sky
    only. A ``disk_model="v2"`` config shades every band with the volume
    integrator (``pipeline.shade_frame_v2``) and takes no texture:
    ``disk_mips`` is None and ``t_offsets`` are the structure pattern's
    advection times. The route of each band follows its device: the ray-march kernel
    on CUDA, its plain version on the CPU.

    Call it as ``render(skybox, disk_mips, cam_pack, t_offsets,
    on_stage=None)``: ``skybox`` (Hs, Ws, 3), ``disk_mips`` the disk
    texture's padded (L, n_r, n_phi, 4) mip pyramid
    (``ops.sampling.build_mipmaps``) or None without a disk, ``cam_pack``
    (F, 14) (``pack_cameras``), ``t_offsets`` (F,) disk rotation offsets;
    tensors or NumPy arrays. It returns (F, H, W, 3) composites clipped to
    [0, 1], or with ``return_layers`` (F, 2, H, W, 3) stacked
    (background, disk) layers, on the grid's first device. ``on_stage``,
    if given, is called with each stage's name as it is enqueued:
    "replicas", then "trace", "shade" and "gather" for every step.
    """
    n_tile = mesh.shape["tile"]
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile axis {n_tile}")
    if frames_per_device < 1:
        raise ValueError(
            f"frames_per_device must be >= 1, got {frames_per_device}")
    rows = height // n_tile
    n_frames = frames_per_device * mesh.shape["frames"]
    first = mesh.devices[0][0]
    distinct = {d for row in mesh.devices for d in row}
    trace_kw = dict(
        width=width, height=height, row_count=rows,
        h_base=float(config.step_size), r_escape=float(r_escape),
        tilt_deg=float(config.disk_tilt),
        r_inner=float(config.disk_inner_radius),
        r_outer=float(config.disk_outer_radius),
        with_differentials=use_diff, max_crossings=MAX_DISK_CROSSINGS,
        record_hits=has_disk,
    )
    is_v2 = config.disk_model == "v2"
    v2_args = v2_shade_args(config) if is_v2 else None
    trace_stage = "trace[{}]".format(kernel_name(
        with_differentials=use_diff, record_hits=has_disk,
        record_step_counts=False))
    shade_stage = "shade_v2" if is_v2 else "shade"

    def replicas(x) -> dict:
        x = torch.as_tensor(x, dtype=torch.float32).contiguous()
        return {d: x.to(d) for d in distinct}

    def shade(trace, skybox, mips, cam, t_offset, tile) -> torch.Tensor:
        if is_v2:
            bg, disk_rgb, _ = shade_frame_v2(
                trace, skybox, cam[0:3], t_offset=t_offset, **v2_args)
        else:
            bg, disk_rgb, _ = shade_frame(
                trace, skybox, mips, cam[0:3],
                r_inner=float(config.disk_inner_radius),
                r_outer=float(config.disk_outer_radius),
                tilt_deg=float(config.disk_tilt),
                t_offset=t_offset,
                use_lod=use_diff,
                aa_strength=float(config.aa_strength),
            )
        shape = (rows, width, 3)
        if return_layers:
            band = torch.stack([bg.reshape(shape), disk_rgb.reshape(shape)])
        else:
            band = torch.clamp(bg + disk_rgb, 0.0, 1.0).reshape(shape)
        check_nans(f"band{tile}/{shade_stage}", band)
        return band

    def render(skybox, disk_mips, cam_pack, t_offsets, on_stage=None):
        if disk_mips is None and has_disk and not is_v2:
            raise ValueError(
                "disk_mips is required when the renderer was built with "
                "has_disk=True")
        mark = on_stage or (lambda stage: None)
        cam_pack = torch.as_tensor(cam_pack, dtype=torch.float32)
        t_offsets = torch.as_tensor(t_offsets, dtype=torch.float32).cpu()
        # The declared frames_per_device fixes the total frame count.
        if cam_pack.shape != (n_frames, CAM_PARAMS):
            raise ValueError(
                f"cam_pack has shape {tuple(cam_pack.shape)}, expected "
                f"({n_frames}, {CAM_PARAMS}) (= frames_per_device "
                f"{frames_per_device} x mesh frames axis "
                f"{mesh.shape['frames']})")
        if t_offsets.shape != (n_frames,):
            raise ValueError(
                f"t_offsets has shape {tuple(t_offsets.shape)}, expected "
                f"({n_frames},)")
        # One copy per device before any launch: a blocking host-to-device
        # copy between two launches would wait for the first.
        cams = replicas(cam_pack)
        skyboxes = replicas(skybox)
        mips = (replicas(disk_mips) if disk_mips is not None
                else dict.fromkeys(distinct))
        mark("replicas")
        frames = [None] * n_frames
        for step in range(frames_per_device):
            # (frame, tile, device) of every shard in this step: the
            # step-th frame of each frame shard, in all its row bands.
            shards = [(fs * frames_per_device + step, t, dev)
                      for fs, row in enumerate(mesh.devices)
                      for t, dev in enumerate(row)]
            traces = [trace_geodesics_cuda(cams[dev][f], t * rows, **trace_kw)
                      for f, t, dev in shards]
            for trace, (_, t, _) in zip(traces, shards):
                check_nans(f"band{t}/{trace_stage}", trace)
            mark("trace")
            bands = [shade(trace, skyboxes[dev], mips[dev], cams[dev][f],
                           float(t_offsets[f]), t)
                     for trace, (f, t, dev) in zip(traces, shards)]
            del traces
            mark("shade")
            for i in range(0, len(bands), n_tile):
                frames[shards[i][0]] = torch.cat(
                    [b.to(first) for b in bands[i:i + n_tile]],
                    dim=1 if return_layers else 0)
            mark("gather")
        return torch.stack(frames)

    return render


def render_image_tiled(config: SceneConfig, devices=None,
                       on_stage=None) -> np.ndarray:
    """One still with its pixel rows sharded over ``tile_shards`` devices
    -> (H, W, 3) float32 in [0, 1]; the same image as
    ``modes.render_image`` (up to the ulps of the note below).

    ``devices`` may repeat a device; it defaults to every visible CUDA
    device for ``device="cuda"`` (none raises RuntimeError) and the one
    CPU for ``device="cpu"``. Fewer devices than ``tile_shards`` raises
    ValueError. The scene's textures are made on the first device, as
    ``modes.render_image`` makes them. Each band is traced through the
    kernel's row band and shaded on its device; the (background, disk)
    layers are gathered to the first device, where bloom, the clamp and
    the flare run over the whole frame (``pipeline.post_process``).
    ``on_stage``, if given, is called with each stage's name as it is
    enqueued: "setup" (scene assets and renderer made), "disk_texture"
    (not for a V2 scene, which has none), the renderer's "replicas",
    "trace", "shade" and "gather", then "post".

    A band whose largest hit count is below the whole frame's skips the
    slots it does not need, where the whole frame runs them with alpha
    0; ``1 - (1 - alpha)`` then rounds the background by an ulp.
    """
    from ..modes import _scene_assets

    mark = on_stage or (lambda stage: None)
    config = config.validated()
    n_tile = max(int(config.tile_shards), 1)
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    elif torch_device(config.device).type == "cuda":
        devices = cuda_devices()
    else:
        devices = [torch.device("cpu")]
    if len(devices) < n_tile:
        raise ValueError(
            f"tile_shards={n_tile} but only {len(devices)} devices given")
    width, height = config.image_size
    skybox, disk_tex, dynamic = _scene_assets(config, devices[0])
    skybox = torch.as_tensor(np.asarray(skybox, np.float32), device=devices[0])
    check_nans("skybox", skybox)
    mesh = make_frame_mesh(1, n_tile, devices=devices[:n_tile])
    render = build_sharded_frame_renderer(
        mesh, config, width, height, 1,
        r_escape=escape_radius(config.r_max, config.pov), has_disk=True,
        use_diff=config.use_ray_differentials, return_layers=True)
    cam_pack = pack_cameras([build_camera(config.pov, config.fov, width, height)])
    mark("setup")
    mips = None
    if config.disk_model != "v2":
        if dynamic is not None:
            disk_tex = dynamic.advance(t=0.0, dt=0.0, recompute_stats=True)
        mips = build_mipmaps(
            torch.as_tensor(disk_tex, dtype=torch.float32, device=devices[0]),
            levels=MIP_LEVELS)
        check_nans("mips", mips)
        mark("disk_texture")
    layers = render(skybox, mips, cam_pack, np.zeros(1, np.float32), on_stage)
    final = post_process(layers[0, 0], layers[0, 1], True, config.lens_flare)
    check_nans("post", final)
    mark("post")
    return final.cpu().numpy()
