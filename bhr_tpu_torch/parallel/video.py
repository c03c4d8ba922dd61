"""The batched orbit-video engine: frames over a device grid, written
out while the next ones render.

The port of ``bhr_tpu/parallel/video.py``. Frames are independent once
the per-frame scene state is known, and it is: the entity lifecycle is
deterministic host bookkeeping, so it is replayed once for all frames,
the per-frame entity parameters are packed, and every device renders its
share of each batch with no traffic between devices:

  host:   factory replay -> per-frame entity params (F, MAX_E, 8)
  device: background noise of the batch's frames, in one pass
          per frame: entity evaluation -> component field
          -> this frame's stats -> compose -> mips (with AA)
          -> ray-march kernel -> deferred shade -> bloom, clamp, flare
          -> uint8 frame

A ``disk_model="v2"`` scene has no lifecycle and no texture: its frame
is trace -> ``shade_frame_v2`` -> post, a function of the camera and the
frame's time alone, so nothing is replayed or packed for it and no
background pass runs.

The background noise is ~10 k small element-wise device operations a
frame, bound by their launches and not by their sizes, so a device makes
the noise of all its frames of a batch in one pass over a leading frame
axis (``ops.background.generate_background_components``): the same
values bit for bit, at the launches of one frame.

As in ``bhr_tpu``, the normalization stats are recomputed every frame
here, where the sequential engine (``modes.render_video``) recomputes
them every 60 frames; frames that are multiples of 60 agree between the
two engines, and a resume may mix them.

Where ``bhr_tpu`` compiles one sharded program whose call returns at
once, PyTorch runs eagerly and the host waits inside every frame
(shading reads ``max(hit_count)``). So the overlap of rendering with the
frame fetch, the PNG encode and the video file's encode is built by
hand: each finished uint8 frame is copied to pinned host memory on a
copy stream, and writer threads wait for that copy, encode the PNG and
feed the inline video assembler (H.264 or MJPEG AVI, in frame order)
while the main thread goes on enqueueing. ``progress.json`` records a batch only after its PNGs are on
disk, and batch b is recorded after batch b + 1 has been enqueued (the
one-batch lookahead).

Not ported, because it is XLA and TPU layout machinery: the
``tex_dtype`` / quad-pack / mip-atlas texture storage (the port's
samplers read plain float32 textures) and the ``_RENDERER_MEMO`` /
``_SKYBOX_Q_MEMO`` tables (nothing is traced or compiled per renderer
here).

A fleet of processes (``parallel.mesh.initialize_multihost``, the CLI's
``--coordinator_address``) renders one video together. Where ``bhr_tpu``
runs one sharded program over every host's chips, here every process
runs this same loop over its own devices: the grid is every process's
slots in rank order, position p of a batch belongs to slot p % G of the
G slots, and a process renders and writes the frames of its own slots
only. Nothing but a bool mask and barriers crosses between processes;
the output directory is shared. See ``render_video_sharded``.

With the NaN trap on (``utils/nans.py``) the stages of a frame check
their outputs with the prefix ``video/``: ``video/background`` (a
device's pass over a batch), ``video/disk_texture``, ``video/disk_stats``,
``video/mips`` (with AA), ``video/trace[<instantiation>]``,
``video/shade`` (``video/shade_v2``), ``video/post`` (bloom and the
clamp) and, with the flare, ``video/flare`` (the frame before it is
quantized to uint8); ``render_video_sharded`` adds ``video/skybox``.
The interactive session's frame runs here and checks the same stages.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import (
    SceneConfig,
    compute_disk_texture_resolution,
    scene_escape_radius,
    torch_device,
)
from ..constants import DISK_COLOR_TEMPERATURE, MAX_DISK_CROSSINGS
from ..models.dynamic_disk import (
    DynamicDiskSystem,
    adaptive_generation_scale,
    frame_texture,
)
from ..models.lifecycle import (
    MAX_HOTSPOTS,
    MAX_RT_SPIKES,
    pack_filaments,
    pack_timer_entities,
    radial_omega_rows,
)
from ..models.skybox import load_or_generate_skybox
from ..ops.background import generate_background_components
from ..ops.geodesic_cuda import kernel_name, trace_geodesics_cuda
from ..ops.lens_flare import apply_lens_flare
from ..ops.sampling import build_mipmaps
from ..pipeline import (
    MIP_LEVELS,
    post_process,
    shade_frame,
    shade_frame_v2,
    v2_shade_args,
)
from ..utils.io import (
    AsyncPNGWriter,
    InlineVideoAssembler,
    compute_edge_alpha,
    write_json_atomic,
)
from ..utils.nans import check_nans
from ..utils.profiling import SPANS, span, spanned
from .frames import cameras_for_orbit, pack_cameras
from .mesh import (
    FrameMesh,
    cuda_devices,
    fleet_barrier,
    fleet_broadcast_mask,
    fleet_slot_counts,
    make_frame_mesh,
    process_count,
    process_index,
)

# The stages of one frame, in the order ``on_stage`` reports them;
# "background" is reported once per device and batch, before its frames.
# A V2 frame has no background and no texture stage; "mips" (the disk
# texture's pyramid) runs only with AA and "flare" (the lens flare and
# the uint8 quantise, which "post" does otherwise) only with the flare.
STAGES = ("texture", "mips", "trace", "shade", "post", "flare")


def frame_stages(config: SceneConfig) -> tuple:
    """The stages ``on_stage`` reports for each frame of ``config``."""
    left_out = {"texture"} if config.disk_model == "v2" else set()
    if not config.use_ray_differentials:
        left_out.add("mips")
    if not config.lens_flare:
        left_out.add("flare")
    return tuple(s for s in STAGES if s not in left_out)


@spanned("lifecycle.pack")
def pack_frame_params(
    dynamic: DynamicDiskSystem, n_frames: int, dt: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replay the lifecycle for all frames; pack per-frame entity params.

    Returns (fil (F, MF, 8), hs (F, MH, 8), rt (F, MR, 8)) float32.
    Mutates the dynamic system's factories (replay to frame n_frames-1).
    """
    fils, hss, rts = [], [], []
    for frame in range(n_frames):
        t = frame * dt
        for fac in dynamic.factories.values():
            fac.tick(now=t, dt=dt)
        fils.append(pack_filaments(dynamic.factories["filament"], t))
        hss.append(pack_timer_entities(dynamic.factories["hotspot"], t,
                                       MAX_HOTSPOTS))
        rts.append(pack_timer_entities(dynamic.factories["rt_spike"], t,
                                       MAX_RT_SPIKES))
    return (np.stack(fils), np.stack(hss), np.stack(rts))


def replicate(mesh: FrameMesh, array) -> dict:
    """{device: float32 tensor} of ``array`` on every device of ``mesh``."""
    x = torch.as_tensor(array, dtype=torch.float32).contiguous()
    return {d: x.to(d) for row in mesh.devices for d in row}


def build_sharded_video_renderer(
    mesh: FrameMesh,
    config: SceneConfig,
    n_r: int,
    n_phi: int,
    *,
    r_escape: float,
    az_freq: float,
    az_shear: float,
    generation_scale: Optional[int] = None,
    use_bloom: bool = True,
    solo_idx: int = -1,
):
    """The per-frame dynamic renderer over ``mesh`` (its "tile" axis must
    be 1: a video shards whole frames).

    Returns ``fn(skybox, cam_pack (F, 14), t_arr (F,), fil, hs, rt,
    on_frame=None, on_stage=None) -> (F, H, W, 3)`` uint8 frames on the
    mesh's first device. F must be a multiple of the mesh's "frames"
    axis n. The frames go round that axis device by device, frame i on
    device i % n, so they finish in index order (the video assembler
    wants them so); in each round every device's texture and trace are
    enqueued before any is shaded, since shading waits for its trace.
    Which device renders a frame does not change it. The mesh may name a
    device more than once.

    ``skybox`` is an (Hs, Ws, 3) array or the dict ``replicate(mesh,
    skybox)``, so that a caller with many batches uploads it once.
    ``fil``, ``hs``, ``rt`` are ``pack_frame_params``' rows for these F
    frames. For a ``disk_model="v2"`` config they are None, ``n_r``,
    ``n_phi``, ``az_freq`` and ``az_shear`` are unused (pass 0), and a
    frame is its trace shaded by ``shade_frame_v2`` at advection time
    ``t_arr[i]``, with no background pass. Each frame's texture is normalized with stats recomputed for
    that frame (``models.dynamic_disk.frame_texture``); with AA the mip
    pyramid is built, else only level 0 is ever sampled. The trace goes
    through ``trace_geodesics_cuda``: the ray-march kernel on a CUDA
    device. ``on_frame(pos, frame)`` is called with each frame's uint8
    tensor, on its device, as soon as it is enqueued;
    ``on_stage(stage, pos, device)`` at the start of each frame
    ("start") and after each of ``frame_stages(config)`` is enqueued, and with
    ``pos=None`` before ("start") and after ("background") each device's
    background pass. ``use_bloom`` is for the interactive mode's
    toggle; a video always blooms. ``solo_idx`` >= 0 (texture model only;
    ignored for V2) renders the interactive mode's solo-component debug
    view: the component field is masked to the soloed density/temperature
    pair (``models.dynamic_disk.solo_comp``) before the frame's stats and
    compose, so the view is normalized with its own stats, as the staged
    path's (``DynamicDiskSystem.advance(solo_idx=...)``) is.
    """
    if mesh.shape["tile"] != 1:
        raise ValueError(
            f"video shards whole frames: the mesh's tile axis must be 1, "
            f"got {mesh.shape['tile']}")
    cfg = config
    width, height = cfg.image_size
    is_v2 = cfg.disk_model == "v2"
    if is_v2:
        generation_scale = 1  # no texture pipeline, nothing to scale
    elif generation_scale is None:
        generation_scale = adaptive_generation_scale(n_r, n_phi)
    elif n_r % generation_scale or n_phi % generation_scale:
        generation_scale = 1
    use_diff = cfg.use_ray_differentials
    devices = [row[0] for row in mesh.devices]
    r_inner, r_outer = float(cfg.disk_inner_radius), float(cfg.disk_outer_radius)
    if is_v2:
        v2_args = v2_shade_args(cfg)
    else:
        # The lifecycle's own radial helper, so that entity phases are
        # the same in the sequential and the batched engine.
        _, omega_np = radial_omega_rows(n_r, r_inner, r_outer)
        omega_rows = replicate(mesh, omega_np)
        edge = replicate(mesh, compute_edge_alpha(n_r))
    shape = (height, width, 3)
    trace_stage = "video/trace[{}]".format(kernel_name(
        with_differentials=use_diff, record_hits=True,
        record_step_counts=False))

    def quantize(final):
        # uint8 on the device: a quarter of the bytes to fetch, and what
        # the PNG wants; round half to even, as bhr_tpu's jnp.round.
        return torch.round(final * 255.0).to(torch.uint8)

    @contextlib.contextmanager
    def frame_stage(name, mark):
        """One stage of a frame: the span ``frame.<name>`` on the host's
        clock, then ``mark(name)`` (the stage's CUDA event) once the
        stage is enqueued."""
        with span("frame." + name):
            yield
        mark(name)

    def start_frame(dev, cam, t, entities, background, mark):
        """Texture, mips and trace of one frame (a V2 frame: the trace
        alone): nothing here waits for the device."""
        mark("start")
        mips = None
        if not is_v2:
            with frame_stage("texture", mark):
                tex, _, _ = frame_texture(
                    *entities, omega_rows[dev], edge[dev], t,
                    n_r=n_r, n_phi=n_phi, az_freq=az_freq, az_shear=az_shear,
                    r_inner=r_inner, r_outer=r_outer,
                    generation_scale=generation_scale,
                    color_temp=DISK_COLOR_TEMPERATURE, background=background,
                    solo_idx=solo_idx, stage_prefix="video/",
                )
                mips = tex[None]
            if use_diff:
                with frame_stage("mips", mark):
                    mips = build_mipmaps(tex, levels=MIP_LEVELS)
                    check_nans("video/mips", mips)
        with frame_stage("trace", mark):
            trace = trace_geodesics_cuda(
                cam, width=width, height=height,
                h_base=float(cfg.step_size), r_escape=float(r_escape),
                tilt_deg=float(cfg.disk_tilt), r_inner=r_inner, r_outer=r_outer,
                with_differentials=use_diff, max_crossings=MAX_DISK_CROSSINGS,
                record_hits=True,
            )
            check_nans(trace_stage, trace)
        return mips, trace

    def finish_frame(skybox, cam, t, mips, trace, mark) -> torch.Tensor:
        """Shade, post and quantize one frame -> (H, W, 3) uint8."""
        with frame_stage("shade", mark):
            if is_v2:
                # The structure pattern advects with the frame's time.
                bg, disk, _ = shade_frame_v2(
                    trace, skybox, cam[0:3], t_offset=t, **v2_args)
                check_nans("video/shade_v2", bg, disk)
            else:
                # The lifecycle texture carries its own rotation: t_offset 0.
                bg, disk, _ = shade_frame(
                    trace, skybox, mips, cam[0:3],
                    r_inner=r_inner, r_outer=r_outer,
                    tilt_deg=float(cfg.disk_tilt), t_offset=0.0,
                    use_lod=use_diff, aa_strength=float(cfg.aa_strength),
                )
                check_nans("video/shade", bg, disk)
        disk = disk.reshape(shape)
        with frame_stage("post", mark):
            final = post_process(bg.reshape(shape), disk, use_bloom, False)
            check_nans("video/post", final)
            if not cfg.lens_flare:
                out = quantize(final)
        if cfg.lens_flare:
            # post_process's own last step, as a stage of its own.
            with frame_stage("flare", mark):
                final = apply_lens_flare(final, disk)
                check_nans("video/flare", final)
                out = quantize(final)
        return out

    def render(skybox, cam_pack, t_arr, fil, hs, rt, on_frame=None,
               on_stage=None):
        n = len(devices)
        cam_np = np.asarray(cam_pack, np.float32)
        t_np = np.asarray(t_arr, np.float32)
        n_frames = cam_np.shape[0]
        if n_frames == 0 or n_frames % n:
            raise ValueError(
                f"{n_frames} frames do not divide over the mesh's frames "
                f"axis {n}")
        packs = () if is_v2 else (("fil", fil), ("hs", hs), ("rt", rt))
        for name, a in (("t_arr", t_np), *packs):
            if len(a) != n_frames:
                raise ValueError(
                    f"{name} holds {len(a)} frames, cam_pack {n_frames}")
        # Every host-to-device copy before the first launch: a blocking
        # copy between two launches would wait for the first.
        skyboxes = skybox if isinstance(skybox, dict) else replicate(mesh, skybox)
        cams = replicate(mesh, cam_np)
        entities = [replicate(mesh, a) for _, a in packs]
        # The background noise of each device's frames (i, i + n, ...) in
        # one pass: backgrounds[i][k] is frame i + k * n's.
        backgrounds = []
        for i, dev in enumerate(() if is_v2 else devices):
            mark = (lambda stage, dev=dev:
                    on_stage and on_stage(stage, None, dev))
            mark("start")
            with frame_stage("background", mark):
                backgrounds.append(generate_background_components(
                    n_r, n_phi, az_freq, az_shear, r_inner, r_outer, t_np[i::n],
                    generation_scale=generation_scale, device=dev))
                check_nans("video/background", backgrounds[-1])
        frames = [None] * n_frames
        for first in range(0, n_frames, n):
            # One round: the next frame of every device.
            shards = [(first + i, dev) for i, dev in enumerate(devices)]
            marks = {pos: (lambda stage, pos=pos, dev=dev:
                           on_stage and on_stage(stage, pos, dev))
                     for pos, dev in shards}
            started = [start_frame(dev, cams[dev][pos], float(t_np[pos]),
                                   [e[dev][pos] for e in entities],
                                   None if is_v2 else backgrounds[i][first // n],
                                   marks[pos])
                       for i, (pos, dev) in enumerate(shards)]
            for (pos, dev), (mips, trace) in zip(shards, started):
                frames[pos] = finish_frame(skyboxes[dev], cams[dev][pos],
                                           float(t_np[pos]), mips, trace,
                                           marks[pos])
                if on_frame is not None:
                    on_frame(pos, frames[pos])
            # Each frame's float layers are freed before the next round.
            del started, mips, trace
        return torch.stack([f.to(devices[0]) for f in frames])

    return render


def render_video_frames_sharded(
    config: SceneConfig,
    mesh: FrameMesh,
    frame_indices,
    skybox,
    dynamic: Optional[DynamicDiskSystem],
    all_fil: Optional[np.ndarray],
    all_hs: Optional[np.ndarray],
    all_rt: Optional[np.ndarray],
    renderer_fn=None,
    defer_fetch: bool = False,
    on_frame=None,
    on_stage=None,
) -> Tuple[object, object]:
    """Render one batch of frames (as many as a multiple of the mesh's
    frames axis).

    Returns ([(position_in_batch, (H, W, 3) uint8 NumPy frame)], the
    renderer for reuse). With ``defer_fetch=True`` the first element is
    the (F, H, W, 3) uint8 tensor still on the device: the caller fetches
    when it needs the pixels. ``skybox``, ``on_frame`` and ``on_stage``
    are the renderer's (``build_sharded_video_renderer``). A V2 scene
    has no lifecycle: ``dynamic`` and the three packs are None.
    """
    width, height = config.image_size
    # One camera placement for every engine: a drift between this and the
    # sequential path would break the frame identity a resume relies on.
    cams = cameras_for_orbit(config, frame_indices, width, height)
    t_np = np.asarray(
        [f * config.disk_rotation_speed for f in frame_indices], np.float32
    )
    idx = np.asarray(frame_indices)
    if renderer_fn is None:
        renderer_fn = _video_renderer(mesh, config, dynamic)
    fil, hs, rt = (None if a is None else a[idx]
                   for a in (all_fil, all_hs, all_rt))
    out = renderer_fn(skybox, pack_cameras(cams), t_np, fil, hs, rt,
                      on_frame=on_frame, on_stage=on_stage)
    if defer_fetch:
        return out, renderer_fn
    return list(enumerate(out.cpu().numpy())), renderer_fn


def _video_renderer(mesh: FrameMesh, config: SceneConfig,
                    dynamic: Optional[DynamicDiskSystem]):
    """The video renderer of a scene: sized by its lifecycle system, or
    (``dynamic`` None) the V2 frame program, which has no texture."""
    r_escape = scene_escape_radius(config)
    if dynamic is None:
        return build_sharded_video_renderer(
            mesh, config, 0, 0, r_escape=r_escape, az_freq=0.0, az_shear=0.0)
    return build_sharded_video_renderer(
        mesh, config, dynamic.n_r, dynamic.n_phi, r_escape=r_escape,
        az_freq=dynamic.az_freq, az_shear=dynamic.az_shear)


class _FrameFetcher:
    """Device uint8 frames -> host memory without stalling the render:
    a CUDA frame is copied to a pinned buffer on its device's copy
    stream; a CPU frame is already there."""

    def __init__(self):
        self._streams = {}

    def start(self, frame: torch.Tensor):
        """-> (NumPy view of the host frame, (begin, done) CUDA events of
        the copy or None). The view is valid once ``done`` has passed."""
        if frame.device.type != "cuda":
            return frame.numpy(), None
        dev = frame.device
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        stream = self._streams[dev]
        host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
        begin, done = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            begin.record()
            host.copy_(frame, non_blocking=True)
            done.record()
        # The frame's memory is not handed out again before the copy ran.
        frame.record_stream(stream)
        return host.numpy(), (begin, done)


def _stamp(device: torch.device):
    """A point in ``device``'s time: a CUDA event on its current stream,
    or the host clock for the CPU (whose work is done when it returns)."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)


def _median_ms(values) -> Optional[float]:
    return statistics.median(values) if values else None


@contextlib.contextmanager
def _abort_fleet_on_error(pid: int):
    """Die loudly instead of stranding the fleet.

    A process that raises between barriers (a full disk while a PNG is
    written, a device error) would leave every other process waiting in
    the next barrier until the group's timeout. Exiting hard closes this
    process's connections, which fails the other processes' barrier at
    once (and a process that hangs instead is caught by the timeout), so
    the whole run dies visibly and can be resumed.
    """
    try:
        yield
    except BaseException:
        print(f"[process {pid}] fatal error, aborting the fleet:",
              file=sys.stderr)
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def render_video_sharded(config: SceneConfig, devices=None) -> dict:
    """The batched video loop: batches of frames over the device grid,
    with the resume protocol of the sequential path
    (``modes.render_video``).

    ``devices`` defaults to every visible CUDA device for
    ``device="cuda"`` (none raises) and the one CPU for ``device="cpu"``;
    it may repeat a device. Batch size = frame shards x frames per
    device; ``progress.json`` is updated after each batch's PNGs are on
    disk, so an interruption loses at most the two batches in flight.

    In a fleet (``parallel.mesh.process_count() > 1``) every process
    calls this with the same config. The grid is every process's
    ``devices`` in rank order, G slots in all (``frame_shards`` must be 0
    or G), and the batch size follows from the config and G alone, so
    all agree on it. Position p of a batch belongs to slot p % G: a
    process renders the positions of its own slots and writes their
    PNGs; a padding repeat is rendered and never written, whichever
    process it falls on. Process 0 alone reads ``progress.json``,
    decides between resume and wipe and broadcasts the completed frames;
    after each batch every process waits for its own PNGs, then for the
    others at a barrier, then process 0 records the batch. No process
    holds every frame, so the video file is not encoded inline: process
    0 assembles the video from the shared frame directory at the end,
    while the others wait at a last barrier (the processes must share
    the output directory). An exception on any process ends it with
    exit code 1 and, through the failed barrier, the others too. Only
    process 0 prints progress.

    Returns the run's statistics: ``frames`` rendered in this run (by
    the whole fleet), ``own_frames`` written by this process,
    ``padded`` repeats of the last frame that filled the last batch
    (rendered, never written), ``wall_s``, ``assembler``
    ("native", "ffmpeg", "mjpeg" or "none"; None on the processes of a
    fleet that do not assemble), ``stage_ms`` (per-frame medians:
    background (a batch's pass over its frames) and each of
    ``frame_stages(config)`` on the device's clock, fetch on the copy
    stream's, png, h264 and hit_sync (``frame.hit_sync``, the shade's
    wait for the trace) on the host's; a V2 video has no background
    entry; and the job's four top-level spans on the host's clock, each
    its total over the frames rendered: job_setup (entry to the first batch's
    enqueue), enqueue (the batches' enqueue), record (each batch's PNGs
    waited for and recorded) and finish (the writers' drain and the
    video file)) and ``writer_wait_s`` (how long the main thread waited
    on the writers). The spans are ``utils.profiling.SPANS``'.
    """
    mark = SPANS.mark()
    # The job's set-up is the span ``video.job_setup``, from here to the
    # first batch's enqueue: the job closes it (``end_setup``), or the
    # stack does where the set-up raises.
    with contextlib.ExitStack() as setup:
        setup.enter_context(span("video.job_setup"))
        stats = _render_video_job(config, devices, setup.close)
    frames = stats["frames"]

    def job_ms(name: str) -> Optional[float]:
        # A span's time in this job, in ms per frame rendered.
        return SPANS.total_s(name, mark) * 1e3 / frames if frames else None

    stats["stage_ms"].update(
        png=SPANS.median_ms("writers.png", mark),
        h264=SPANS.median_ms("writers.h264", mark),
        hit_sync=SPANS.median_ms("frame.hit_sync", mark),
        **{name: job_ms("video." + name)
           for name in ("job_setup", "enqueue", "record", "finish")})
    return stats


def _render_video_job(config: SceneConfig, devices, end_setup) -> dict:
    """``render_video_sharded``'s job, with the span-derived entries of
    ``stage_ms`` left out; ``end_setup()`` ends the set-up's span before
    the first batch is enqueued."""
    from ..modes import (
        _assemble_video,
        _finish_video,
        load_video_progress,
        video_resume_params,
        video_temp_paths,
    )

    config = config.validated()
    if config.disk_texture is not None:
        raise ValueError(
            "the batched video engine renders the lifecycle texture disk "
            "or the V2 volume disk, not an external disk texture")
    is_v2 = config.disk_model == "v2"
    width, height = config.image_size
    n_proc, pid = process_count(), process_index()

    def say(msg: str) -> None:
        if pid == 0:
            print(msg)

    if devices is not None:
        devices = [torch.device(d) for d in devices]
    elif torch_device(config.device).type == "cuda":
        devices = cuda_devices()
    else:
        devices = [torch.device("cpu")]
    if n_proc == 1:
        n_shards = config.frame_shards or len(devices)
        if n_shards > len(devices):
            # Clamped, but never in silence: an explicit shard count above
            # the visible devices usually means a mis-set machine.
            print(f"warning: --frame_shards {n_shards} exceeds the "
                  f"{len(devices)} visible devices; using {len(devices)}")
        n_shards = min(n_shards, len(devices))
        devices, first_slot = devices[:n_shards], 0
    else:
        slots = fleet_slot_counts(len(devices))
        n_shards, first_slot = sum(slots), sum(slots[:pid])
        if config.frame_shards not in (0, n_shards):
            # Every process renders its share of every batch; a grid that
            # left some process out would strand it at the barriers.
            raise ValueError(
                f"multi-host video requires frame_shards == all devices "
                f"({n_shards}), got {config.frame_shards}")
    # This process's slots of the grid (all of them but in a fleet).
    mesh = make_frame_mesh(len(devices), 1, devices=devices)
    # Frames per device per batch: small frames are batched until a batch
    # carries ~4 FHD frames' worth of pixels, capped at 16, floored at 4
    # (2 with several shards), and bounded by the video's length so a
    # short video is not mostly padding. --frames_per_dispatch pins it.
    # From the config and the grid's size alone: a fleet's processes
    # must agree on the batch.
    if config.frames_per_dispatch:
        frames_per_device = int(config.frames_per_dispatch)
    else:
        frames_per_device = min(
            16, max(2 if n_shards > 1 else 4,
                    (4 * 1920 * 1080) // (width * height)))
        frames_per_device = max(
            1, min(frames_per_device, -(-config.n_frames // n_shards)))
    batch = n_shards * frames_per_device
    # The batch positions this process renders, in order: position p
    # belongs to grid slot p % n_shards, and own[j] runs on this
    # process's device j % len(devices), as the renderer deals them.
    own = [p for p in range(batch)
           if first_slot <= p % n_shards < first_slot + len(devices)]

    output_path = config.output
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    temp_dir, progress_file = video_temp_paths(output_path)
    params = video_resume_params(config, sharded=True)
    completed = set()
    if pid == 0:
        completed, _ = load_video_progress(config, temp_dir, progress_file,
                                           params)
    if n_proc > 1:
        # Process 0 arbitrates resume against wipe and broadcasts the
        # surviving frames as a mask: were every process to read the file
        # itself, a stale read on a shared filesystem could give them
        # different pending sets and so different barrier sequences. The
        # broadcast also holds the others until process 0 has wiped.
        mask = np.zeros(config.n_frames, bool)
        # Junk entries (negative, fractional, out of range) are ignored,
        # as the pending computation below ignores them.
        mask[[int(f) for f in completed
              if isinstance(f, (int, float)) and not isinstance(f, bool)
              and float(f).is_integer() and 0 <= f < config.n_frames]] = True
        completed = {int(f) for f in np.nonzero(fleet_broadcast_mask(mask))[0]}
        os.makedirs(temp_dir, exist_ok=True)

    skybox_np, _, _ = load_or_generate_skybox(
        config.texture, 2048, 1024, config.n_stars, seed=config.skybox_seed)
    skybox = replicate(mesh, skybox_np)  # once per call, not per batch
    check_nans("video/skybox", *skybox.values())

    # V2 renders by volume integration: no lifecycle system to replay,
    # every frame is a function of (camera, t).
    dynamic, all_fil, all_hs, all_rt = None, None, None, None
    if not is_v2:
        n_phi, n_r = compute_disk_texture_resolution(
            width, height, config.pov, config.fov,
            config.disk_inner_radius, config.disk_outer_radius,
        )
        dynamic = DynamicDiskSystem(
            n_r, n_phi, config.disk_inner_radius, config.disk_outer_radius,
            seed=config.seed, device=mesh.devices[0][0],
        )
        say(f"Packing lifecycle params for {config.n_frames} frames...")
        t0 = time.time()
        all_fil, all_hs, all_rt = pack_frame_params(
            dynamic, config.n_frames, config.disk_rotation_speed
        )
        say(f"  packed in {time.time() - t0:.1f}s")
    renderer_fn = _video_renderer(mesh, config, dynamic)
    stages = frame_stages(config)

    writer = AsyncPNGWriter(max_workers=4, max_pending=8)
    # One thread feeds the video assembler, so frames reach it in the
    # order they were queued: index order. In a fleet no process holds
    # every frame: the inline encoder is left out and process 0 runs the
    # post-pass over the shared frame directory instead.
    inline = n_proc == 1
    video_pool = ThreadPoolExecutor(max_workers=1)
    assembler = (InlineVideoAssembler(
        output_path, config.n_frames, config.fps, temp_dir,
        crf=config.video_crf) if inline else None)
    fetcher = _FrameFetcher()
    total_t0 = time.time()
    pending = [f for f in range(config.n_frames) if f not in completed]
    n_batches = (len(pending) + batch - 1) // batch
    waited = [0.0]  # seconds the main thread was blocked on the writers
    written = [0]  # frames this process handed to its writers
    stage_ms = {name: [] for name in
                (*(() if is_v2 else ("background",)), *stages, "fetch")}

    def encode_video(f, frame, copied) -> None:
        if copied is not None:
            copied[1].synchronize()
        assembler.submit(f, frame)

    class Batch:
        """One enqueued batch: its real frames, the stamps of its stages
        and the copies, PNG writes and video encodes still under way. The
        renderer numbers this process's frames 0, 1, ...: frame j of it
        is position ``own[j]`` of the batch."""

        def __init__(self, b, chunk):
            self.b, self.chunk = b, chunk
            self.stamps, self.copies, self.jobs = {}, [], []

        def on_stage(self, stage, j, device):
            key = own[j] if j is not None else ("background", device)
            self.stamps.setdefault(key, []).append(_stamp(device))

        def on_frame(self, j, frame):
            pos = own[j]
            if pos >= len(self.chunk):
                return  # a padding repeat of the last frame
            f = self.chunk[pos]
            host, copied = fetcher.start(frame)
            if copied is not None:
                self.copies.append(copied)
            t0 = time.perf_counter()
            self.jobs.append(writer.submit(
                host, os.path.join(temp_dir, f"frame_{f:04d}.png"),
                ready=copied and copied[1]))
            waited[0] += time.perf_counter() - t0
            written[0] += 1
            if inline:
                self.jobs.append(video_pool.submit(encode_video, f, host, copied))

    def process(done: Batch) -> None:
        """Record a batch once its PNGs are on disk."""
        t0 = time.perf_counter()
        # A frame's PNG is on disk before progress.json records it: a
        # crash in between would lose the frame for good under resume.
        # Only this batch's frames are waited for: the next batch's are
        # still being written, and that is the overlap. In a fleet the
        # barrier extends this to every process's PNGs (each reaches it
        # only after its own are written), and the whole chunk counts:
        # its other frames are the other processes'.
        for job in done.jobs:
            job.result()
        waited[0] += time.perf_counter() - t0
        fleet_barrier()
        completed.update(done.chunk)
        if pid == 0:
            write_json_atomic(
                progress_file,
                {"params": params, "completed": sorted(completed)})
        for pos, stamps in done.stamps.items():
            if isinstance(pos, tuple):
                # One pass made the background of every frame of a mesh
                # slot (a device named twice has two passes here).
                stage_ms["background"] += [
                    _elapsed_ms(a, b) / frames_per_device
                    for a, b in zip(stamps[::2], stamps[1::2])]
            elif pos < len(done.chunk):
                # (Nothing waited for a padding frame's events.)
                for name, a, b in zip(stages, stamps, stamps[1:]):
                    stage_ms[name].append(_elapsed_ms(a, b))
        stage_ms["fetch"] += [a.elapsed_time(b) for a, b in done.copies]
        if (done.b + 1) % 10 == 0 or done.b == n_batches - 1:
            # The rate over this run's frames only: `completed` also
            # counts the frames of earlier runs.
            run_done = min((done.b + 1) * batch, len(pending))
            rate = run_done / max(time.time() - total_t0, 1e-9)
            say(f"batch {done.b + 1}/{n_batches} "
                f"done {len(completed)}/{config.n_frames} "
                f"({rate:.2f} frames/s)")

    end_setup()
    # The with-block covers everything through finalize: an exception
    # anywhere in it discards the partial video via __exit__, after the
    # inner finally has stopped the threads that feed it; in a fleet it
    # then ends this process hard (entered first, so it covers the rest).
    with contextlib.ExitStack() as stack:
        if n_proc > 1:
            stack.enter_context(_abort_fleet_on_error(pid))
        if inline:
            stack.enter_context(assembler)
        try:
            # One-batch lookahead: batch b + 1 is enqueued before batch b
            # is recorded, so b's fetch, PNG and video work overlaps
            # b + 1's rendering.
            inflight = None
            for b in range(n_batches):
                chunk = pending[b * batch: (b + 1) * batch]
                # The last batch is padded with repeats of its last frame.
                idx = chunk + [chunk[-1]] * (batch - len(chunk))
                current = Batch(b, chunk)
                with span("video.enqueue"):
                    render_video_frames_sharded(
                        config, mesh, [idx[p] for p in own], skybox, dynamic,
                        all_fil, all_hs, all_rt, renderer_fn, defer_fetch=True,
                        on_frame=current.on_frame, on_stage=current.on_stage)
                if inflight is not None:
                    with span("video.record"):
                        process(inflight)
                inflight = current
            if inflight is not None:
                with span("video.record"):
                    process(inflight)
        finally:
            # The job's last span, from the writers' drain to the video
            # file: the stack closes it after the file is finished.
            stack.enter_context(span("video.finish"))
            try:
                video_pool.shutdown(wait=True)
            finally:
                writer.close()
        say(f"All frames rendered in {(time.time() - total_t0) / 60:.1f} min")
        finished_by = None
        if inline:
            finished_by = _finish_video(assembler, temp_dir, config)
        elif pid == 0:
            finished_by = _assemble_video(temp_dir, output_path,
                                          config.n_frames, config.fps,
                                          crf=config.video_crf)
    # Every process stays until the video exists: nobody leaves the group
    # while process 0 is still assembling.
    fleet_barrier()
    wall_s = time.time() - total_t0
    return {
        "frames": len(pending),
        "own_frames": written[0],
        "padded": n_batches * batch - len(pending),
        "wall_s": wall_s,
        "assembler": finished_by,
        "stage_ms": {name: _median_ms(v) for name, v in stage_ms.items()},
        "writer_wait_s": waited[0],
    }
