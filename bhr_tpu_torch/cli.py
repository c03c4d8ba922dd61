"""Command-line interface of the PyTorch/CUDA port (stills, video and
the interactive session).

The port of ``bhr_tpu/cli.py``: the same scene flags and defaults
(reference render.py:4518-4695), plus ``--width`` / ``--height``, with
``--device`` choosing ``cuda`` (the default) or ``cpu``. ``--tile_shards N`` renders a still's pixel rows in
N bands, one per visible device of the ``--device`` kind. ``--video``
renders an orbit (``--orbit``) or static-camera video with resumable
per-frame checkpoints (``--resume``). ``--disk_model v2`` shades the disk
by volume integration (the ``--v2_*`` group) in all of these.
``--interactive`` opens the live session (``interactive.py``): a window
where there is a display, an MJPEG stream over HTTP with
``--preview_port``, else a short PNG preview. ``--coordinator_address
HOST:PORT --num_processes N --process_id K`` joins N processes into one
fleet that renders an orbit video together (``parallel/video.py``); each
process renders on the devices visible to it. ``--disk_texture auto``
renders a still with the static procedural disk, generated once per
radii, seed, texture size and ``--disk_generation_scale`` and then
loaded from ``output/.disk_texture_cache/`` (``utils/cache.py``;
``--force_regenerate_disk_texture`` makes it anew). ``--debug_nans``
raises ``FloatingPointError`` at the first stage whose outputs hold a
NaN (``utils/nans.py``); ``--no_compile_cache`` builds the ``csrc/``
libraries afresh into a temporary directory instead of
``bhr_tpu_torch/_build/`` (``utils/cache.py``). Every command line of
``bhr_tpu``'s CLI parses here.

Usage:
    python -m bhr_tpu_torch.cli --pov 6 0 0.5 --fov 90 -r fhd -o out/frame.png
    python -m bhr_tpu_torch.cli -r fhd --anti_alias lod_radius --lens_flare
    python -m bhr_tpu_torch.cli -r sd --device cpu -o out/frame.png
    python -m bhr_tpu_torch.cli -r 4k --tile_shards 4   # on a 4-GPU host
    python -m bhr_tpu_torch.cli -r fhd --disk_model v2 --v2_palette scientific
    python -m bhr_tpu_torch.cli -r fhd --disk_texture auto
    python -m bhr_tpu_torch.cli --video --orbit -r fhd --n_frames 240 \\
        --fps 24 -o out/orbit.mp4          # add --resume to continue
    python -m bhr_tpu_torch.cli --interactive --preview_port 8089
    # two processes, one video (here both on this machine):
    python -m bhr_tpu_torch.cli --video --orbit -o out/orbit.mp4 \
        --coordinator_address localhost:29500 --num_processes 2 --process_id 0
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import DEVICES, RESOLUTIONS, SceneConfig
from .constants import (
    DISK_GENERATION_SCALE_CHOICES,
    R_DISK_INNER_DEFAULT,
    R_DISK_OUTER_DEFAULT,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Schwarzschild black-hole ray-tracing renderer "
                    "(PyTorch/CUDA port)"
    )
    p.add_argument("--pov", type=float, nargs=3, default=[6.0, 0.0, 0.5],
                   metavar=("X", "Y", "Z"), help="camera position")
    p.add_argument("--fov", type=float, default=90.0,
                   help="field of view in degrees (0-180)")
    p.add_argument("--resolution", "-r", type=str, default="fhd",
                   choices=sorted(RESOLUTIONS), help="resolution preset")
    p.add_argument("--width", type=int, default=None,
                   help="image width in pixels (with --height; overrides -r)")
    p.add_argument("--height", type=int, default=None,
                   help="image height in pixels (with --width)")
    p.add_argument("--texture", "-t", type=str, default=None,
                   help="skybox texture path (default: procedural)")
    p.add_argument("--output", "-o", type=str, default="output/blackhole.png",
                   help="output path (a PNG, or the video file)")
    p.add_argument("--step_size", "-s", type=float, default=0.1,
                   help="integration base step")
    p.add_argument("--r_max", type=float, default=10.0, help="escape radius")
    p.add_argument("--n_stars", type=int, default=6000,
                   help="procedural skybox star count")
    p.add_argument("--disk_texture", type=str, default=None,
                   help="external disk texture (static single-frame "
                        "only), or 'auto' to generate-and-cache the "
                        "static procedural texture "
                        "(output/.disk_texture_cache)")
    p.add_argument("--disk_model", type=str, default="texture",
                   choices=["texture", "v2"],
                   help="disk shading model: the lifecycle texture, or "
                        "the v2 volume integrator")
    p.add_argument("--disk_generation_scale", type=int, default=2,
                   choices=DISK_GENERATION_SCALE_CHOICES,
                   help="low-res generation factor for --disk_texture "
                        "auto; unused by the lifecycle system")
    p.add_argument("--force_regenerate_disk_texture", action="store_true",
                   help="with --disk_texture auto: regenerate the cached "
                        "static texture; otherwise inert")
    v2 = p.add_argument_group(
        "disk_v2", "volume-model knobs (with --disk_model v2); "
        "mirrors DiskV2Params/DiskV2StructureParams"
    )
    v2.add_argument("--v2_palette", type=str, default="cinematic",
                    choices=["scientific", "cinematic"],
                    help="V2 intensity/temperature -> RGB mapping")
    v2.add_argument("--v2_samples", type=int, default=8,
                    help="V2 slab quadrature samples per disk crossing")
    v2.add_argument("--v2_h0", type=float, default=0.05,
                    help="V2 thickness fraction at r ~ r_in")
    v2.add_argument("--v2_beta_h", type=float, default=0.05,
                    help="V2 thickness growth power-law index")
    v2.add_argument("--v2_rho_power", type=float, default=1.0,
                    help="V2 midplane density radial decay exponent")
    v2.add_argument("--v2_temp_scale", type=float, default=1.0)
    v2.add_argument("--v2_omega_scale", type=float, default=1.0)
    v2.add_argument("--v2_edge_softness", type=float, default=0.1,
                    help="V2 smooth-edge width fraction, [0, 0.5)")
    v2.add_argument("--v2_structure", action="store_true",
                    help="take the V2 structure modulation layer's "
                         "strengths (m=1/m=2 modes, shear texture, "
                         "hotspots) from the flags below")
    v2.add_argument("--v2_mode1_strength", type=float, default=0.03)
    v2.add_argument("--v2_mode2_strength", type=float, default=0.05)
    v2.add_argument("--v2_shear_strength", type=float, default=0.22)
    v2.add_argument("--v2_shear_components", type=int, default=8)
    v2.add_argument("--v2_hotspot_strength", type=float, default=0.16)
    v2.add_argument("--v2_hotspot_count", type=int, default=8)
    v2.add_argument("--v2_hotspot_phi_sigma", type=float, default=0.18)
    v2.add_argument("--v2_hotspot_logr_sigma", type=float, default=0.12)
    v2.add_argument("--v2_hotspot_inner_bias", type=float, default=2.0)
    p.add_argument("--disk_inner_radius", "--ar1", dest="disk_inner_radius",
                   type=float, default=R_DISK_INNER_DEFAULT)
    p.add_argument("--disk_outer_radius", "--ar2", dest="disk_outer_radius",
                   type=float, default=R_DISK_OUTER_DEFAULT)
    p.add_argument("--disk_tilt", type=float, default=0.0,
                   help="disk tilt in degrees")
    p.add_argument("--lens_flare", action="store_true")
    p.add_argument("--anti_alias", type=str, default="disabled",
                   choices=["disabled", "lod_radius"])
    p.add_argument("--aa_strength", type=float, default=1.0,
                   help="AA LOD multiplier in [0.5, 2.0]")
    p.add_argument("--device", "-d", type=str, default="cuda",
                   choices=list(DEVICES), help="torch device")
    p.add_argument("--frame_shards", type=int, default=0,
                   help="video frame shards across devices "
                        "(0 = all devices, 1 = sequential)")
    p.add_argument("--frames_per_dispatch", type=int, default=0,
                   help="video frames per device per batch (0 = adaptive; "
                        "smaller batches lose less to an interruption)")
    p.add_argument("--tile_shards", type=int, default=0,
                   help="single-frame row sharding over this many devices")
    p.add_argument("--video", action="store_true")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--preview_port", type=int, default=0,
                   help="with --interactive on a headless host: serve "
                        "the live render as MJPEG over HTTP on this "
                        "port (keys injected via /key?k=...)")
    p.add_argument("--preview_host", type=str, default="127.0.0.1",
                   help="bind address for --preview_port (loopback by "
                        "default: /key is unauthenticated; pass "
                        "0.0.0.0 to expose beyond this host)")
    p.add_argument("--orbit", action="store_true")
    p.add_argument("--orbit_degrees", type=float, default=360.0,
                   help="total orbit sweep (negative = reverse)")
    p.add_argument("--n_frames", type=int, default=3600)
    p.add_argument("--fps", type=int, default=36)
    p.add_argument("--video_crf", type=int, default=18,
                   help="H.264 quality (x264 CRF, 0=lossless..51; "
                        "default 18 ~ visually lossless)")
    p.add_argument("--resume", action="store_true")
    # Deprecated in bhr_tpu and read by nothing here: parsed so that its
    # command lines run unchanged.
    p.add_argument("--disk_rotation_algorithm", type=str, default="baseline",
                   choices=["baseline", "parametric", "keyframes"],
                   help="[deprecated] ignored: the lifecycle system is "
                        "always used")
    p.add_argument("--disk_rotation_speed", type=float, default=0.1)
    p.add_argument("--keyframes_count", type=int, default=10,
                   help="[deprecated] ignored")
    p.add_argument("--ignore_taichi_cache", action="store_true",
                   help="[deprecated] Taichi-specific; the analogue here "
                        "is --no_compile_cache")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="multi-host rendering: host:port where process 0 "
                        "listens (run one process per host, or per card; "
                        "frames shard over all processes' devices with no "
                        "traffic between them; they share the output "
                        "directory)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-host: total process count "
                        "(with --coordinator_address)")
    p.add_argument("--process_id", type=int, default=None,
                   help="multi-host: this process's rank "
                        "(with --coordinator_address)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--debug_nans", action="store_true",
                   help="trap NaN: raise FloatingPointError at the first "
                        "stage of a frame (skybox, mips, trace, shade, "
                        "post, ...) whose outputs hold a NaN, the CUDA "
                        "kernel's included (as jax_debug_nans; Inf is not "
                        "trapped)")
    p.add_argument("--compile_cache", action="store_true",
                   help="[deprecated] the cache is on by default; "
                        "disable with --no_compile_cache")
    p.add_argument("--no_compile_cache", action="store_true",
                   help="build the CUDA kernels and host libraries of "
                        "csrc/ afresh into a temporary directory, removed "
                        "at exit, instead of loading them from the "
                        "persistent build cache (bhr_tpu_torch/_build/, "
                        "on by default)")
    return p


def config_from_args(args: argparse.Namespace) -> SceneConfig:
    return SceneConfig(
        pov=tuple(args.pov),
        fov=args.fov,
        resolution=args.resolution,
        width=args.width,
        height=args.height,
        texture=args.texture,
        output=args.output,
        step_size=args.step_size,
        r_max=args.r_max,
        n_stars=args.n_stars,
        disk_texture=args.disk_texture,
        disk_model=args.disk_model,
        **{name: value for name, value in vars(args).items()
           if name.startswith("v2_")},
        disk_inner_radius=args.disk_inner_radius,
        disk_outer_radius=args.disk_outer_radius,
        disk_tilt=args.disk_tilt,
        lens_flare=args.lens_flare,
        anti_alias=args.anti_alias,
        aa_strength=args.aa_strength,
        device=args.device,
        frame_shards=args.frame_shards,
        frames_per_dispatch=args.frames_per_dispatch,
        tile_shards=args.tile_shards,
        video=args.video,
        interactive=args.interactive,
        orbit=args.orbit,
        orbit_degrees=args.orbit_degrees,
        n_frames=args.n_frames,
        fps=args.fps,
        video_crf=args.video_crf,
        resume=args.resume,
        disk_rotation_speed=args.disk_rotation_speed,
        seed=args.seed,
        disk_generation_scale=args.disk_generation_scale,
        force_regenerate_disk_texture=args.force_regenerate_disk_texture,
    ).validated()


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.coordinator_address is None and (
            args.num_processes is not None or args.process_id is not None):
        # Without the coordinator this process would run a normal
        # single-process render racing the real fleet's frame directory
        # and progress file on the shared filesystem.
        parser.error("--num_processes/--process_id require "
                     "--coordinator_address")
    if args.coordinator_address is not None and (
            args.num_processes is None or args.process_id is None):
        parser.error("--coordinator_address requires --num_processes and "
                     "--process_id")
    config = config_from_args(args)
    # The trap and the build cache are set before anything is built or
    # rendered, in every process of a fleet, and restored on return.
    from .utils.cache import (
        compile_cache_dir,
        disable_compile_cache,
        enable_compile_cache,
    )
    from .utils.nans import debug_nans, debug_nans_enabled

    build_dir = compile_cache_dir()
    if args.no_compile_cache:
        disable_compile_cache()
    try:
        with debug_nans(args.debug_nans or debug_nans_enabled()):
            if args.coordinator_address is None:
                return _run(config, args)
            from .parallel.mesh import initialize_multihost, shutdown_multihost

            initialize_multihost(args.coordinator_address, args.num_processes,
                                 args.process_id)
            try:
                _check_fleet_mode(parser, config)
                return _run(config, args)
            finally:
                shutdown_multihost()
    finally:
        enable_compile_cache(build_dir)


def _check_fleet_mode(parser, config: SceneConfig) -> None:
    """Print the fleet's size on process 0 and end every process (exit
    code 2) unless the run is one the fleet can share."""
    import torch

    from .config import torch_device
    from .parallel.mesh import fleet_slot_counts, process_count, process_index

    n_local = (torch.cuda.device_count()
               if torch_device(config.device).type == "cuda" else 1)
    total = sum(fleet_slot_counts(n_local))
    if process_index() == 0:
        print(f"multi-host: {process_count()} processes, "
              f"{total} devices total")
    if process_count() > 1:
        # Only the batched video engine knows of the fleet; any other
        # mode would run N duplicated renders against the same output
        # files. The predicate render_video dispatches on, plus the
        # all-devices frame_shards the engine itself insists on (failing
        # here keeps the message actionable), on every process.
        from .modes import sharded_video_eligible

        if not (config.video
                and not config.interactive
                and sharded_video_eligible(config)
                and config.frame_shards in (0, total)):
            parser.error(
                "multi-host runs support only sharded orbit video: "
                "--video without --interactive/--disk_texture, "
                f"and --frame_shards 0 (all devices) or {total}"
            )


def _run(config: SceneConfig, args: argparse.Namespace) -> int:
    if config.interactive:
        from .interactive import run_interactive

        run_interactive(config, preview_port=args.preview_port,
                        preview_host=args.preview_host)
    elif config.video:
        from .modes import render_video

        print("Video stats: " + json.dumps(render_video(config)))
    else:
        from .modes import render_image
        from .utils.io import save_image

        img = render_image(config)
        save_image(img, config.output)
        print(f"Saved: {config.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
