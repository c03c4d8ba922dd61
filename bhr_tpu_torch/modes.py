"""Run modes: the single still frame (whole or in row bands) and the
orbit video with resume.

The port of ``bhr_tpu/modes.py`` (reference ``render_image``,
render.py:4031-4076, and ``render_video``, render.py:4356-4511): the
same scene semantics, resume protocol and file layout
(``.frames_<md5>/``, ``progress.json`` invalidated by a parameter
change), so either package can resume the other's video. The interactive mode
is ``interactive.py``; it builds its renderer here (``_make_renderer``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import numpy as np

from .camera import orbit_camera_position
from .config import (
    SceneConfig,
    compute_disk_texture_resolution,
    scene_escape_radius,
    torch_device,
)
from .models.dynamic_disk import DynamicDiskSystem, adaptive_generation_scale
from .models.skybox import load_or_generate_skybox
from .pipeline import Renderer
from .utils.io import (
    H264_CONTAINER_EXTS,
    AsyncPNGWriter,
    InlineVideoAssembler,
    load_disk_texture,
    load_png_rgb8,
    mjpeg_avi_path,
    write_json_atomic,
    write_mjpeg_avi,
)
from .utils.profiling import spanned


def _scene_assets(config: SceneConfig, device) -> tuple:
    """(skybox, disk_tex_or_None, dynamic_or_None) for a config.

    One texture-source policy for every engine (the whole frame and the
    tiled still): V2 -> no texture and no lifecycle system;
    ``disk_texture='auto'`` -> the static texture of the ``.npy`` cache
    (generated on ``device`` once per radii, seed, texture size and
    generation scale, reloaded on later runs;
    ``force_regenerate_disk_texture`` makes it anew); an explicit path is
    loaded or fails loudly; otherwise the disk comes from the lifecycle
    system (a zero placeholder texture until it advances).
    """
    width, height = config.image_size
    skybox, _, _ = load_or_generate_skybox(
        config.texture, 2048, 1024, config.n_stars, seed=config.skybox_seed
    )
    if config.disk_model == "v2":
        # V2 shades by volume integration: no disk texture
        # (config.validated() rejects v2 + disk_texture).
        return skybox, None, None
    if config.disk_texture == "auto":
        from .utils.cache import load_cached_disk_texture

        disk_tex = load_cached_disk_texture(
            width, height, list(config.pov), config.fov,
            seed=config.seed,
            r_inner=config.disk_inner_radius,
            r_outer=config.disk_outer_radius,
            force=config.force_regenerate_disk_texture,
            generation_scale=config.disk_generation_scale,
            device=device,
        )
        return skybox, disk_tex, None
    disk_tex = load_disk_texture(config.disk_texture)
    if config.disk_texture is not None and disk_tex is None:
        # A path typo must not render the procedural disk instead.
        raise FileNotFoundError(
            f"--disk_texture not found or unreadable: {config.disk_texture}"
        )
    dynamic = None
    if disk_tex is None:
        n_phi, n_r = compute_disk_texture_resolution(
            width, height, config.pov, config.fov,
            config.disk_inner_radius, config.disk_outer_radius,
        )
        dynamic = DynamicDiskSystem(
            n_r, n_phi, config.disk_inner_radius, config.disk_outer_radius,
            seed=config.seed, device=device,
        )
        disk_tex = np.zeros((n_r, n_phi, 4), np.float32)
    return skybox, disk_tex, dynamic


def _make_renderer(config: SceneConfig,
                   r_escape_override: Optional[float] = None,
                   r_escape_quantum: float = 0.0) -> tuple:
    """Renderer + (optional) dynamic disk system for a config, both on
    ``config.device``. ``r_escape_override`` pins the trace's escape
    radius and ``r_escape_quantum`` rounds it up to a grid (see
    ``Renderer``)."""
    device = torch_device(config.device)
    skybox, disk_tex, dynamic = _scene_assets(config, device)
    return Renderer(config, skybox, disk_tex, device=device,
                    r_escape_override=r_escape_override,
                    r_escape_quantum=r_escape_quantum), dynamic


def render_image(config: SceneConfig) -> np.ndarray:
    """Render one frame -> (H, W, 3) float32 in [0, 1]; the disk texture
    is generated by the lifecycle system at t=0 unless an external disk
    texture or ``disk_texture='auto'`` (the static texture of the cache)
    is given (a V2 scene has neither: it shades by volume integration). With ``tile_shards > 1`` the frame's pixel rows
    shard over the visible devices (``parallel.frames.render_image_tiled``):
    the same image, traced band by band."""
    config = config.validated()
    if config.tile_shards > 1:
        from .parallel.frames import render_image_tiled

        t0 = time.time()
        img = render_image_tiled(config)
        print(f"Rendered {config.image_size[0]}x{config.image_size[1]} "
              f"({config.tile_shards} tile shards) in {time.time() - t0:.2f}s")
        return img
    renderer, dynamic = _make_renderer(config)
    if dynamic is not None:
        tex = dynamic.advance(t=0.0, dt=0.0, recompute_stats=True)
        renderer.update_disk_texture(tex)

    t0 = time.time()
    img = renderer.render(config.pov, config.fov, frame=0)
    print(f"Rendered {config.image_size[0]}x{config.image_size[1]} "
          f"on {renderer.device} in {time.time() - t0:.2f}s")
    return img


# -- orbit video ------------------------------------------------------------


def video_temp_paths(output_path: str) -> tuple:
    """(temp_dir, progress_file) for a video output path: the frame
    directory ``.frames_<md5(output)[:16]>`` beside the output
    (reference render.py:4380-4382)."""
    temp_dir = os.path.join(
        os.path.dirname(output_path) or ".",
        ".frames_" + hashlib.md5(output_path.encode()).hexdigest()[:16],
    )
    return temp_dir, os.path.join(temp_dir, "progress.json")


def video_resume_params(config: SceneConfig, *, sharded: bool = False) -> Dict:
    """The parameters ``progress.json`` is invalidated by: everything
    that determines a frame's content, so a resumed run never mixes two
    scenes. The same keys and value types as ``bhr_tpu``'s.
    ``sharded`` records which engine rendered the frames and is left out
    of the comparison (the scene is the same across engines).
    """
    width, height = config.image_size
    params = {
        "n_frames": config.n_frames,
        "fov": config.fov,
        "orbit": config.orbit,
        "disk_rotation_speed": config.disk_rotation_speed,
        "orbit_degrees": config.orbit_degrees,
        "width": width,
        "height": height,
        "pov": [float(x) for x in config.pov],
        "seed": config.seed,
        "skybox_seed": config.skybox_seed,
        "n_stars": config.n_stars,
        "texture": config.texture,
        "disk_texture": config.disk_texture,
        "disk_model": config.disk_model,
        "disk_inner_radius": float(config.disk_inner_radius),
        "disk_outer_radius": float(config.disk_outer_radius),
        "disk_tilt": float(config.disk_tilt),
        "step_size": float(config.step_size),
        "r_max": float(config.r_max),
        "anti_alias": config.anti_alias,
        "aa_strength": float(config.aa_strength),
        "lens_flare": bool(config.lens_flare),
        "sharded": bool(sharded),
    }
    if config.disk_texture is None and config.disk_model == "texture":
        # The resolved low-res generation factor is frame content (it
        # follows the texture size): a resumed video must not mix frames
        # generated at two scales.
        n_phi, n_r = compute_disk_texture_resolution(
            width, height, config.pov, config.fov,
            config.disk_inner_radius, config.disk_outer_radius,
        )
        params["generation_scale"] = adaptive_generation_scale(n_r, n_phi)
    if config.disk_model == "v2":
        # Every V2 knob changes frame content. Keyed only for V2 runs so
        # that a texture-model progress file is the same with or without
        # the V2 surface.
        params["v2"] = {
            "palette": config.v2_palette,
            "samples": int(config.v2_samples),
            "h0": float(config.v2_h0),
            "beta_h": float(config.v2_beta_h),
            "rho_power": float(config.v2_rho_power),
            "temp_scale": float(config.v2_temp_scale),
            "omega_scale": float(config.v2_omega_scale),
            "edge_softness": float(config.v2_edge_softness),
            "structure": bool(config.v2_structure),
            "mode1_strength": float(config.v2_mode1_strength),
            "mode2_strength": float(config.v2_mode2_strength),
            "shear_strength": float(config.v2_shear_strength),
            "shear_components": int(config.v2_shear_components),
            "hotspot_strength": float(config.v2_hotspot_strength),
            "hotspot_count": int(config.v2_hotspot_count),
            "hotspot_phi_sigma": float(config.v2_hotspot_phi_sigma),
            "hotspot_logr_sigma": float(config.v2_hotspot_logr_sigma),
            "hotspot_inner_bias": float(config.v2_hotspot_inner_bias),
        }
    return params


def load_video_progress(config: SceneConfig, temp_dir: str,
                        progress_file: str, params: Dict) -> tuple:
    """The resume protocol both engines share: returns (completed
    frames, cross_engine).

    A parameter mismatch or an unreadable ``progress.json`` wipes the
    frame directory and restarts (reference render.py:4393-4405); a run
    without ``resume`` also starts fresh. The ``sharded`` engine marker
    never invalidates: resuming the other engine's frames is supported
    (their stats cadence differs, see ``parallel/video.py``).
    """
    completed: set = set()
    cross_engine = False
    if (config.resume and os.path.isdir(temp_dir)
            and os.path.isfile(progress_file)):
        try:
            with open(progress_file) as f:
                saved = json.load(f)
        except (json.JSONDecodeError, OSError) as exc:
            # Writes are atomic (write_json_atomic), so this takes
            # corruption from outside: start over, as for a mismatch.
            print(f"progress.json unreadable ({exc}); starting over")
            saved = {}
        saved_params = dict(saved.get("params", {}))
        cross_engine = bool(saved_params.pop("sharded", False)) != bool(
            params.get("sharded", False)
        )
        compare = {k: v for k, v in params.items() if k != "sharded"}
        if saved_params != compare:
            if saved:  # the corrupt-file path printed its own reason
                print("Parameters changed; starting over")
            shutil.rmtree(temp_dir)
            os.makedirs(temp_dir, exist_ok=True)
        else:
            completed = set(saved.get("completed", []))
            if cross_engine and completed:
                print("Resuming frames rendered by the other engine "
                      "(per-frame stats cadence differs slightly)")
            print(f"Resuming: {len(completed)}/{config.n_frames} frames done")
    else:
        if os.path.isdir(temp_dir) and not config.resume:
            shutil.rmtree(temp_dir)
        os.makedirs(temp_dir, exist_ok=True)
    return completed, cross_engine


def sharded_video_eligible(config: SceneConfig) -> bool:
    """True when ``render_video`` dispatches to the batched engine
    (``parallel/video.py``): on a CUDA device, or when more than one
    frame shard is asked for or visible (every process of a fleet brings
    at least one, see ``parallel.mesh.initialize_multihost``).
    ``frame_shards=1`` opts out
    into the sequential per-frame loop, which is also what
    ``device="cpu"`` runs by default (one CPU device). Both disk models
    are eligible: the texture model renders its lifecycle texture per
    frame, V2 is trace + ``shade_frame_v2``, a function of camera and
    time alone. ``device="cuda"`` without a GPU raises here."""
    import torch

    from .parallel.mesh import process_count

    device = torch_device(config.device)
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    n_devices = max(n_devices, process_count())
    return (
        config.disk_texture is None
        and config.disk_model in ("texture", "v2")
        and (config.frame_shards > 1
             or (config.frame_shards == 0
                 and (n_devices > 1 or device.type == "cuda")))
    )


def render_video(config: SceneConfig,
                 renderer: Optional[Renderer] = None,
                 dynamic: Optional[DynamicDiskSystem] = None) -> dict:
    """Orbit or static-camera video with resumable per-frame checkpoints.

    Frames land as PNGs in ``.frames_<md5(output)[:16]>/`` next to the
    output; ``progress.json`` records {params, completed} and is
    invalidated when the parameters change. Interrupt and run again with
    ``config.resume=True`` to continue; the lifecycle state is re-created
    by replaying the factory ticks to the resume point (a V2 scene has
    none: its frame is a function of the camera and the frame index).

    Returns the run's statistics: ``frames`` rendered in this run,
    ``wall_s``, ``assembler`` (what finished the video file: "native",
    "ffmpeg", "mjpeg" or "none") and, from the batched engine,
    ``stage_ms`` and ``writer_wait_s``.
    """
    config = config.validated()
    if renderer is None and sharded_video_eligible(config):
        from .parallel.video import render_video_sharded

        return render_video_sharded(config)

    output_path = config.output
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    temp_dir, progress_file = video_temp_paths(output_path)
    params = video_resume_params(config, sharded=False)
    completed, _ = load_video_progress(config, temp_dir, progress_file, params)

    if renderer is None:
        # The same escape radius for every frame, and the one the
        # batched engine traces with.
        renderer, dynamic = _make_renderer(
            config, r_escape_override=scene_escape_radius(config)
        )
    dt = config.disk_rotation_speed

    # Replay the lifecycle to the resume point (host bookkeeping only).
    # The normalization stats are refreshed at the frame where an
    # uninterrupted run last recomputed them (frame % 60 == 0), so the
    # first resumed frames normalize as that run's did, not with the
    # permissive initial stats.
    if completed and dynamic is not None:
        max_done = max(completed)
        stats_frame = 60 * (max_done // 60)
        t0 = time.time()
        for f in range(max_done + 1):
            for fac in dynamic.factories.values():
                fac.tick(now=f * dt, dt=dt)
            if f == stats_frame:
                dynamic.refresh_stats(f * dt)
        print(f"Replayed lifecycle to frame {max_done} "
              f"in {time.time() - t0:.1f}s")

    writer = AsyncPNGWriter(max_workers=2, max_pending=4)
    assembler = InlineVideoAssembler(
        output_path, config.n_frames, config.fps, temp_dir,
        crf=config.video_crf,
    )
    total_t0 = time.time()
    n_before = len(completed)

    # The with-block covers everything through finalize: an exception
    # anywhere in it (frame loop, PNG drain in writer.close, progress
    # write) discards the partial video via __exit__.
    with assembler:
        try:
            _render_video_frames(config, temp_dir, renderer, dynamic, writer,
                                 assembler, completed, progress_file, params,
                                 total_t0)
        finally:
            writer.close()
        write_json_atomic(
            progress_file, {"params": params, "completed": sorted(completed)}
        )
        stats = {"frames": len(completed) - n_before,
                 "wall_s": time.time() - total_t0, "assembler": "none"}
        if len(completed) < config.n_frames:
            assembler.discard()
            print(f"Only {len(completed)}/{config.n_frames} frames done. "
                  "Run again with resume to continue.")
            return stats

        print(f"All frames rendered in "
              f"{(time.time() - total_t0) / 60:.1f} min")
        stats["assembler"] = _finish_video(assembler, temp_dir, config)
    return stats


def _finish_video(assembler, temp_dir: str, config: SceneConfig) -> str:
    """Finalize the inline video or run the post-pass chain -> the name
    of the assembler that finished the file: the inline writer's
    ("native" or "mjpeg") or the post-pass's."""
    if assembler.finalize():
        if assembler.kind == "mjpeg":
            _report_mjpeg_avi(assembler.path, config.output, config.video_crf)
        else:
            print(f"Video saved: {config.output}")
        return assembler.kind
    return _assemble_video(temp_dir, config.output, config.n_frames,
                           config.fps, crf=config.video_crf)


def _report_mjpeg_avi(avi_path: str, output_path: str, crf: int) -> None:
    """Where the MJPEG AVI landed, and how to re-mux it to the asked-for
    container."""
    print(f"Video saved (MJPEG AVI fallback): {avi_path}")
    if avi_path != output_path:
        ext = os.path.splitext(output_path)[1]
        print(f"Re-mux to {ext or '.mp4'} later: "
              f"ffmpeg -i {avi_path} -c:v libx264 -crf {crf} "
              f"-pix_fmt yuv420p {output_path}")


def _render_video_frames(config, temp_dir, renderer, dynamic, writer,
                         assembler, completed, progress_file, params,
                         total_t0) -> None:
    """The sequential per-frame loop of ``render_video``."""
    dt = config.disk_rotation_speed
    rendered = 0
    for frame in range(config.n_frames):
        t = frame * dt
        if config.orbit:
            cam_pos = orbit_camera_position(
                frame, config.n_frames, config.orbit_degrees, config.pov
            )
        else:
            cam_pos = config.pov

        if frame in completed:
            continue

        if dynamic is not None:
            tex = dynamic.advance(t, dt, recompute_stats=(frame % 60 == 0))
            renderer.update_disk_texture(tex)
        # A lifecycle texture already carries its rotation (advected to
        # time t), so it renders at frame 0; a V2 disk advects its
        # structure through t_offset = frame * dt.
        img = renderer.render(
            cam_pos, config.fov, frame=(0 if dynamic is not None else frame)
        )
        rendered += 1

        writer.submit(img, os.path.join(temp_dir, f"frame_{frame:04d}.png"))
        assembler.submit(frame, img)
        completed.add(frame)
        if rendered % 10 == 0 or frame == config.n_frames - 1:
            # A frame must be on disk before progress.json records it
            # (a crash in between would lose it for good under resume).
            writer.drain()
            write_json_atomic(
                progress_file,
                {"params": params, "completed": sorted(completed)},
            )

        if rendered % 100 == 0:
            eta = (time.time() - total_t0) / rendered * (
                config.n_frames - len(completed)
            )
            print(f"frame {frame}/{config.n_frames} "
                  f"done {len(completed)} ETA {eta / 60:.0f}min")


@spanned("video.assemble")
def _assemble_video(temp_dir: str, output_path: str, n_frames: int,
                    fps: int, crf: int = 18) -> str:
    """Post-pass assembly from the PNG frames: the native libavcodec
    writer, then the ffmpeg CLI, then the MJPEG AVI, then the frames are
    kept where they are. Returns which one finished: "native", "ffmpeg",
    "mjpeg" or "none". Each call is the span ``video.assemble``."""
    if _assemble_video_native(temp_dir, output_path, n_frames, fps, crf):
        return "native"
    if shutil.which("ffmpeg"):
        cmd = [
            "ffmpeg", "-y", "-framerate", str(fps),
            "-i", os.path.join(temp_dir, "frame_%04d.png"),
            "-c:v", "libx264", "-crf", str(crf), "-pix_fmt", "yuv420p",
            output_path,
        ]
        if subprocess.run(cmd, capture_output=True).returncode == 0:
            print(f"Video saved: {output_path}")
            return "ffmpeg"
    # The last resort must never lose a long render: a failure here
    # (Pillow missing, a corrupt frame) ends in the keep-frames message.
    avi_path = mjpeg_avi_path(output_path)
    frames = [
        os.path.join(temp_dir, f"frame_{f:04d}.png") for f in range(n_frames)
    ]
    try:
        write_mjpeg_avi(frames, avi_path, fps)
    except Exception as exc:
        print(f"MJPEG AVI fallback failed ({exc!r}); "
              f"frames kept in {temp_dir}")
        print(f"Assemble manually: ffmpeg -framerate {fps} -i "
              f"{temp_dir}/frame_%04d.png -c:v libx264 -crf {crf} "
              f"-pix_fmt yuv420p {output_path}")
        return "none"
    _report_mjpeg_avi(avi_path, output_path, crf)
    return "mjpeg"


def _assemble_video_native(temp_dir: str, output_path: str, n_frames: int,
                           fps: int, crf: int = 18) -> bool:
    """H.264 assembly from the PNG frames via the native libavcodec
    writer (``bhr_tpu_torch/native.py``). True on success; False means
    "try the next assembler" (no codec, odd frame dimensions, a bad
    frame PNG, ...) with any partial output removed."""
    from . import native

    if os.path.splitext(output_path)[1].lower() not in H264_CONTAINER_EXTS:
        return False
    if not native.video_available():
        return False
    try:
        first = load_png_rgb8(os.path.join(temp_dir, "frame_0000.png"))
        height, width = first.shape[:2]
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with native.H264Writer(output_path, width, height, fps,
                               crf=crf) as writer:
            writer.write(first)
            for frame in range(1, n_frames):
                writer.write(load_png_rgb8(
                    os.path.join(temp_dir, f"frame_{frame:04d}.png")))
        print(f"Video saved: {output_path}")
        return True
    except BaseException as exc:
        # A truncated file at the advertised path would look finished
        # (H264Writer.__exit__ skipped the trailer; remove the bytes
        # too). An interrupt still interrupts: only plain Exceptions go
        # on to the next assembler.
        try:
            os.remove(output_path)
        except OSError:
            pass
        if not isinstance(exc, Exception):
            raise
        print(f"native H.264 assembly failed ({exc!r}); "
              "trying the next assembler")
        return False
