"""The trace's op model, the golden tables and the timing helpers that
``chip_smoke.py`` and ``bhr_tpu_torch/tools/`` read.

The port's benchmark is ``benchmark/`` over ``BENCHMARK.json``'s cells
(``python3 -m benchmark.run``); this module is a library for the smoke
run and the tools, not a program:

- the op model of ``csrc/ray_march.cu`` (``STEP_OPS`` ...
  ``MUFU_LANES_PER_SM``), the SASS parser (``parse_sass_loops``) and the
  bounds built on them (``bound``, ``issue_bounds``), and the card's busy
  share from torch.profiler (``profile_device``, ``device_busy_share``);
  ``benchmark/opmodel.py`` is a frozen copy of the op model, which the
  tests hold to this one;
- the golden scenes (``GOLDEN``, ``SCENES``, ``V2_SCENES``,
  ``GOLDEN_VIDEO``) and ``golden_diff``;
- the bench scene (``bench_scene_config``, ``build_skybox``) and its
  timings: ``time_resolution`` (a frame through the batched video
  renderer), ``time_trace`` (the ray-march kernel alone), ``time_gather``
  (the shade's row gather) and ``gpu_query`` (``nvidia-smi``).

Every function takes ``device=`` so that it also runs on the CPU; the
trace's bound shares, which are the H100's, read "not measured" there,
and no CPU number is written under a device metric's name.
"""

from __future__ import annotations

import itertools
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")

# --- The op model of csrc/ray_march.cu ------------------------------------
#
# FP32 operations of each instantiation for its bound: an add, multiply,
# sqrt, rsqrt or reciprocal counts one, a fused multiply-add two (its
# multiply and its add); fmin/fmax and compares are not counted.
# - per RK4 step: adaptive step 16 (r^2 5, two sqrt, 1/rs multiply,
#   rs*, q^3 and 1 + 2q^3 4, reciprocal, h 2), four stages 35 (one
#   rsqrt and 4 multiplies each, r^2 5 for stages 2-4), stage slopes and
#   positions 66, update 42, r^2 and affine tests 6, plus the disk-plane
#   test 5 where hits are recorded; AA adds two diff_rk4 of 168 each on
#   every step that survives (not the terminating one);
# - per ray: image plane and primary ray 63 (AA: 127 with the two
#   differential rays), escape direction 10 per escaped ray;
# - per recorded crossing: 13 (AA: 31 with the differentials' lerp).
STEP_OPS = {"slim": 170, "aa": 170, "nodisk": 165}
DIFF_STEP_OPS = {"slim": 0, "aa": 336, "nodisk": 0}
RAY_OPS = {"slim": 63, "aa": 127, "nodisk": 63}
ESCAPE_OPS = 10
HIT_OPS = {"slim": 13, "aa": 31, "nodisk": 0}
# Bytes written per ray: captured, escaped, escape_dir, hit_count, hits
# (K=4 x 12 floats), plus steps for the _steps instantiations.
RAY_BYTES = 1 + 1 + 12 + 4 + 4 * 12 * 4
# NVIDIA H100 SXM published peaks (dense FP32 outside the tensor cores,
# counting a fused multiply-add as two operations; HBM3 bandwidth). A
# square root or reciprocal counts as one operation but takes several
# instructions, and the kernel's adds and multiplies do not all fuse, so
# this bound is below the kernel's true least time. The issue bound
# (the fewest SASS instructions the steps issue, over the SMs' issue
# rate) is the tighter one.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Issue rates of one Hopper SM per clock: 4 schedulers each issue one
# warp instruction (32 thread-instructions); the MUFU units (rsqrt, rcp,
# the seeds of sqrt and divide) serve 16 threads.
ISSUE_LANES_PER_SM = 4 * 32
MUFU_LANES_PER_SM = 16

def sass_loop_counts(lib_path: str) -> dict:
    """:func:`parse_sass_loops` of the built library's ``cuobjdump -sass``
    (``cuobjdump`` beside ``nvcc``); raises where either is missing."""
    from . import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        raise FileNotFoundError(f"no cuobjdump beside nvcc ({tool})")
    return parse_sass_loops(subprocess.run(
        [tool, "-sass", lib_path], capture_output=True, text=True, timeout=120,
        check=True).stdout)


def parse_sass_loops(sass: str) -> dict:
    """Each instantiation's ray-march loop in ``cuobjdump -sass`` text,
    from the loop's head to its back-branch (the backward branch that
    spans the most code) -> {name: counts}, NOPs not counted:

    - "total", "mufu", "fp32": the loop body's instructions, its MUFU ones
      and its FFMA/FADD/FMUL ones — code a step rarely runs included;
    - "step", "step_mufu": the fewest instructions (MUFU instructions) a
      surviving step issues: the shortest way from the head to the
      back-branch, which skips the crossing record and takes the fast
      path of each correctly rounded sqrt and reciprocal. A way through a
      CALL (the slow path's subroutine) is not taken: it issues the
      callee too, more than the fast path it replaces;
    - "last", "last_mufu": the fewest a terminating step issues, to the
      first branch out of the loop (the capture or escape break).
    """
    from .ops.geodesic_cuda import kernel_name

    counts = {}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*ray_marchILb([01])ELb([01])ELb([01])E", block)
        if not m:
            continue
        # (address, opcode, predicated, branch target or None)
        labels, code = {}, []
        for line in block.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if lab:
                labels[lab.group(1)] = None
            elif ins:
                addr = int(ins.group(1), 16)
                for k, v in labels.items():
                    if v is None:
                        labels[k] = addr
                pred = re.match(r"@!?U?P\w+\s+", ins.group(2))
                text = ins.group(2)[pred.end():] if pred else ins.group(2)
                op = text.split()[0]
                target = None
                t = op.startswith("BRA") and re.search(
                    r"0x([0-9a-f]+)|(\.L_x_\d+)", text[3:])
                if t:
                    target = int(t.group(1), 16) if t.group(1) else t.group(2)
                code.append([addr, op, bool(pred) and pred.group(0)[:3] != "@PT",
                             target])
        for ins in code:
            if isinstance(ins[3], str):
                ins[3] = labels.get(ins[3])
        head = tail = None
        for addr, op, _, target in code:
            if target is not None and target < addr and (
                    head is None or addr - target > tail - head):
                head, tail = target, addr
        body = [ins for ins in code if head is not None and head <= ins[0] <= tail]
        ops = [op for _, op, _, _ in body if op != "NOP"]

        def fewest(weight):
            """Shortest ways from the head over the body's forward edges:
            (to the back-branch, to the first branch out of the loop)."""
            index = {ins[0]: i for i, ins in enumerate(body)}
            inf = float("inf")
            dist = [inf] * len(body)
            dist[0] = weight(body[0][1])
            out = inf
            for i, (addr, op, pred, target) in enumerate(body):
                if dist[i] == inf or op.startswith("CALL"):
                    continue
                if target is not None and not head <= target <= tail or (
                        op == "EXIT"):
                    out = min(out, dist[i])
                nxt = []
                if target is not None and target > addr and target in index:
                    nxt.append(index[target])
                if pred or op.split(".")[0] not in ("BRA", "EXIT", "RET"):
                    nxt.append(i + 1)
                for j in nxt:
                    if j < len(body):
                        dist[j] = min(dist[j], dist[i] + weight(body[j][1]))
            return dist[-1], out

        step, last = fewest(lambda op: op != "NOP")
        step_mufu, last_mufu = fewest(lambda op: op.startswith("MUFU"))
        diff, record, steps = (c == "1" for c in m.groups())
        counts[kernel_name(with_differentials=diff, record_hits=record,
                           record_step_counts=steps)] = {
            "total": len(ops),
            "mufu": sum(op.startswith("MUFU") for op in ops),
            "fp32": sum(op.split(".")[0] in ("FFMA", "FADD", "FMUL") for op in ops),
            "step": step, "step_mufu": step_mufu, "last": last,
            "last_mufu": last_mufu,
        }
    return counts


def terminated(trace) -> int:
    """Rays of ``trace`` that were captured or escaped: each ends on a
    step that breaks out of the loop."""
    return int((trace.captured | trace.escaped).sum())


def bound(name, steps, trace):
    """(least ms the card could take, "operations" or "bytes") for the
    instantiation ``name`` on this trace: FP32 operations (STEP_OPS etc.,
    over the measured per-ray ``steps``) over PEAK_FP32, and the bytes
    written over PEAK_BYTES."""
    base = name.removeprefix("ray_march_").removesuffix("_steps")
    n = steps.numel()
    total = float(steps.sum())
    ops = (STEP_OPS[base] * total + DIFF_STEP_OPS[base] * (total - terminated(trace))
           + RAY_OPS[base] * n + ESCAPE_OPS * int(trace.escaped.sum())
           + HIT_OPS[base] * int(trace.hit_count.sum()))
    nbytes = 14 * 4 + n * (RAY_BYTES + (4 if name.endswith("_steps") else 0))
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def issue_bounds(counts: dict, ray_steps: float, n_terminated: int, n_sms: int,
                 clock_mhz: float):
    """(issue bound ms, MUFU bound ms) of one instantiation, from its
    ``parse_sass_loops`` ``counts``: the fewest SASS instructions (MUFU
    ones) a step issues — a surviving step for ``ray_steps`` -
    ``n_terminated``, a terminating one for ``n_terminated`` — over the
    issue (MUFU) rate of ``n_sms`` SMs at ``clock_mhz``, every lane of
    every warp busy."""
    rate = n_sms * clock_mhz * 1e6 / 1e3  # SM-clocks per ms
    survived = ray_steps - n_terminated
    return ((counts["step"] * survived + counts["last"] * n_terminated)
            / (ISSUE_LANES_PER_SM * rate),
            (counts["step_mufu"] * survived + counts["last_mufu"] * n_terminated)
            / (MUFU_LANES_PER_SM * rate))


def profile_device(fn):
    """(the card's busy µs, the kernels and copies it ran, wall µs) of
    one call of ``fn``, from torch.profiler's device rows (their sum: one
    stream, so they do not overlap); busy 0 where the profiler reports
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # The kernels' and copies' own rows: an operator's row repeats the
    # device time of the kernels it launched.
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) for e in on_card)
    return busy_us, sum(e.count for e in on_card), wall_us


def device_busy_share(fn):
    """(the share of ``fn``'s wall time in which the card ran a kernel or
    a copy, how many kernels and copies it ran) (``profile_device``);
    (None, 0) where the profiler reports no device time."""
    busy_us, count, wall_us = profile_device(fn)
    if busy_us <= 0:
        return None, 0
    return busy_us / wall_us, count


# --- The golden scenes (tests/e2e_render.py's families) --------------------

POV = (6.0, 0.0, 0.5)
GOLDEN = dict(width=320, height=180, pov=POV, fov=60.0, step_size=0.1,
              r_max=10.0, n_stars=100, disk_inner_radius=2.0,
              disk_outer_radius=3.5, disk_tilt=15.0, anti_alias="disabled",
              seed=42)
# The texture-model families and the kernel each launches.
SCENES = {"default": ({}, "ray_march_slim"),
          "aa": ({"anti_alias": "lod_radius"}, "ray_march_aa"),
          "flare": ({"lens_flare": True}, "ray_march_slim")}
# The V2 volume disk's families: every V2 frame launches the slim kernel
# (hits recorded, no differentials).
V2_SCENES = {"v2": {"disk_model": "v2"},
             "v2sci": {"disk_model": "v2", "v2_palette": "scientific",
                       "v2_structure": True}}
# The golden video: an 8-frame 45-degree orbit of the golden scene in one
# batch; its PNG frames 0 and 4 stacked are the golden image.
GOLDEN_VIDEO = dict(GOLDEN, video=True, orbit=True, orbit_degrees=45.0,
                    n_frames=8, fps=24, frame_shards=1, frames_per_dispatch=8)
def golden_diff(img, name):
    """(max, mean) |img - tests/goldens/<name>.npz| in float64; raises
    ValueError when the shapes differ."""
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
    if img.shape != golden.shape:
        raise ValueError(f"{name}: shape {img.shape} vs {golden.shape}")
    diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
    return diff.max(), diff.mean()


# --- The measurements -------------------------------------------------------

# Launches before a timed kernel run: the first kernels after a
# host-bound stretch run slower than later ones.
WARMUP = 2


def _as_device(device) -> torch.device:
    """``device`` as a torch.device; a name through ``config.torch_device``,
    which raises for "cuda" on a host without a GPU."""
    from .config import torch_device

    return torch_device(device) if isinstance(device, str) else torch.device(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_scene_config(resolution: str, anti_alias: str = "disabled",
                       lens_flare: bool = False, *, device="cuda", size=None):
    """The bench scene (the root ``bench.py``'s; one source for the
    timings here and the tools): fov 90, pov (6, 0, 0.5), step 0.1, disk
    2-15 at tilt 15, orbit — not the CLI default of tilt 0. ``device`` is
    a name or a torch.device; ``size`` (width, height) overrides the
    preset's pixels (the tests' tiny frames)."""
    from .config import SceneConfig

    w, h = size if size is not None else (None, None)
    if not isinstance(device, str):
        device = torch.device(device).type
    return SceneConfig(
        resolution=resolution,
        width=w,
        height=h,
        pov=(6.0, 0.0, 0.5),
        fov=90.0,
        step_size=0.1,
        disk_inner_radius=2.0,
        disk_outer_radius=15.0,
        disk_tilt=15.0,
        orbit=True,
        n_frames=3600,
        anti_alias=anti_alias,
        lens_flare=lens_flare,
        device=device,
    ).validated()


def build_skybox(device="cuda") -> torch.Tensor:
    """The benchmark's float32 skybox on ``device`` (``bhr_tpu``'s
    ``build_skybox_q`` without its quad pack: the port samples f32)."""
    from .models.skybox import generate_skybox

    return torch.as_tensor(generate_skybox(2048, 1024, seed=42, n_stars=6000),
                           device=_as_device(device))


def _batch_runner(cfg, n_frames: int, skybox, device, use_bloom: bool = True):
    """``run(frame_indices)`` -> the uint8 frames of ``cfg``'s orbit from
    ``parallel/video.build_sharded_video_renderer`` on a one-device grid
    (the lifecycle replayed and packed for frames 0..n_frames-1)."""
    from .config import compute_disk_texture_resolution, scene_escape_radius
    from .models.dynamic_disk import DynamicDiskSystem
    from .parallel.frames import cameras_for_orbit, pack_cameras
    from .parallel.mesh import make_frame_mesh
    from .parallel.video import (
        build_sharded_video_renderer,
        pack_frame_params,
        replicate,
    )

    width, height = cfg.image_size
    mesh = make_frame_mesh(1, 1, devices=[device])
    r_escape = scene_escape_radius(cfg)
    packs = None
    if cfg.disk_model == "v2":
        render = build_sharded_video_renderer(
            mesh, cfg, 0, 0, r_escape=r_escape, az_freq=0.0, az_shear=0.0,
            use_bloom=use_bloom)
    else:
        n_phi, n_r = compute_disk_texture_resolution(
            width, height, cfg.pov, cfg.fov, cfg.disk_inner_radius,
            cfg.disk_outer_radius)
        dynamic = DynamicDiskSystem(n_r, n_phi, cfg.disk_inner_radius,
                                    cfg.disk_outer_radius, seed=42, device=device)
        packs = pack_frame_params(dynamic, n_frames, cfg.disk_rotation_speed)
        render = build_sharded_video_renderer(
            mesh, cfg, n_r, n_phi, r_escape=r_escape, az_freq=dynamic.az_freq,
            az_shear=dynamic.az_shear, use_bloom=use_bloom)
    sky = replicate(mesh, skybox)

    def run(idx):
        idx = list(idx)
        cams = pack_cameras(cameras_for_orbit(cfg, idx, width, height))
        t_arr = np.asarray([f * cfg.disk_rotation_speed for f in idx], np.float32)
        rows = (None,) * 3 if packs is None else tuple(p[idx] for p in packs)
        return render(sky, cams, t_arr, *rows)

    return run


def time_resolution(resolution: str, batch: int, skybox=None,
                    anti_alias: str = "disabled", lens_flare: bool = False, *,
                    device="cuda", repeats: int = 5, size=None,
                    use_bloom: bool = True) -> dict:
    """ms a frame of the bench scene at a preset, dynamic texture: one
    batch of frames through ``build_sharded_video_renderer`` on a
    one-device grid, warmed once, then ``repeats`` fresh batches each
    timed on the host clock to a ``torch.cuda.synchronize()`` ->
    {"frame_ms": the median ms a frame, "spread": [min, max], "frames":
    frames rendered}.

    Unlike ``bhr_tpu``'s (one compiled program timed once, its dispatch
    excluded) this time includes the host's dispatch of every launch:
    eager PyTorch has no single program, and the dispatch is the
    bottleneck of a frame on the card. ``use_bloom=False`` is
    ``tools/ablate_pipeline``'s ``nobloom`` stage."""
    cfg = bench_scene_config(resolution, anti_alias, lens_flare, device=device,
                             size=size)
    device = _as_device(device)
    if skybox is None:
        skybox = build_skybox(device)
    run = _batch_runner(cfg, (repeats + 1) * batch, skybox, device, use_bloom)
    run(range(batch))  # warm: caches, allocator, kernel library
    _sync(device)
    per_frame = []
    for r in range(1, repeats + 1):
        t0 = time.perf_counter()
        out = run(range(r * batch, (r + 1) * batch))
        _sync(device)
        per_frame.append((time.perf_counter() - t0) / batch * 1e3)
        del out
    return {"frame_ms": statistics.median(per_frame),
            "spread": [min(per_frame), max(per_frame)],
            "frames": (repeats + 1) * batch}


def gpu_query(field: str) -> str:
    """``nvidia-smi --query-gpu=<field>`` of the first card, no units."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()


def sass_counts_or_none():
    """``sass_loop_counts`` of the built ray-march library (built here if
    it is not yet), or None where ``nvcc`` or ``cuobjdump`` is missing."""
    from . import _build

    try:
        return sass_loop_counts(_build.build("ray_march").path)
    except (FileNotFoundError, RuntimeError, subprocess.SubprocessError) as exc:
        print(f"SASS counts not measured: {exc}", file=sys.stderr)
        return None


def time_trace(aa: bool, *, device="cuda", size=(1920, 1080), iters: int = 20,
               sass=None, n_sms=None, clock_mhz=None) -> dict:
    """FHD ray-march throughput of the bench scene -> {trace_ms,
    mray_steps_per_s, steps_per_frame, mean_steps_per_ray,
    fp32_bound_share, issue_bound_share, launches}.

    A "ray-step" is one useful RK4 step of one ray, counted once by the
    step-count instantiation; the time is the production instantiation's
    (``utils/profiling.device_time``: CUDA events around ``iters``
    enqueued launches after WARMUP). ``bhr_tpu`` perturbed the camera
    each launch so that XLA could not hoist the trace out of its loop;
    eager torch hoists nothing, so every launch takes the same camera.

    ``fp32_bound_share`` is ``bound`` over the kernel ms;
    ``issue_bound_share`` is ``issue_bounds`` over it, from ``sass``
    (``parse_sass_loops`` counts; read from the built library when None),
    ``n_sms`` and ``clock_mhz`` (default: the card's SM count and
    ``nvidia-smi``'s maximum SM clock). Either is "not measured" where
    it cannot be had: on the CPU (the bounds are the H100's), and the
    issue share without ``cuobjdump``. ``launches`` is what this made,
    by instantiation.
    """
    from .camera import build_camera
    from .config import escape_radius
    from .ops.geodesic_cuda import camera_params, kernel_name, trace_geodesics_cuda
    from .utils.profiling import device_time

    dev = _as_device(device)
    width, height = size
    cam = torch.as_tensor(camera_params(build_camera(POV, 90.0, width, height)),
                          device=dev)
    kw = dict(width=width, height=height, h_base=0.1,
              r_escape=escape_radius(10.0, POV), tilt_deg=15.0,
              r_inner=2.0, r_outer=15.0, with_differentials=aa)
    name = kernel_name(with_differentials=aa, record_hits=True,
                       record_step_counts=False)
    counted = trace_geodesics_cuda(cam, record_step_counts=True, **kw)
    steps = counted.steps.to(torch.float64)
    total = float(steps.sum())
    seconds = device_time(lambda: trace_geodesics_cuda(cam, **kw), iters=iters,
                          warmup=WARMUP)
    ms = seconds * 1e3
    fp32_share = issue_share = "not measured"
    if dev.type == "cuda":
        fp32_share = bound(name, steps, counted)[0] / ms
        if sass is None:
            sass = sass_counts_or_none()
        if sass is not None:
            if n_sms is None:
                n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
            if clock_mhz is None:
                clock_mhz = float(gpu_query("clocks.max.sm"))
            issue_share = issue_bounds(sass[name], total, terminated(counted),
                                       n_sms, clock_mhz)[0] / ms
    launches = ({name: WARMUP + iters, name + "_steps": 1} if dev.type == "cuda"
                else {})
    return {"trace_ms": ms, "mray_steps_per_s": total / seconds / 1e6,
            "steps_per_frame": int(total),
            "mean_steps_per_ray": total / (width * height),
            "fp32_bound_share": fp32_share, "issue_bound_share": issue_share,
            "launches": launches}


def time_gather(n_indices: int = 1920 * 1080, reps: int = 8, *,
                device="cuda") -> float:
    """ns an index of the shade's row gather, ``tab[idx]``: the floor of
    the port's shade, whose samplers gather 16-byte rows of 4 float32
    (the count and size of ``bhr_tpu``'s quad-packed rows; its banded
    ``_take_rows`` has no counterpart). Random int64 indices from
    ``numpy.random.default_rng(0)``, rotated by one each repetition,
    ``reps`` gathers timed by ``device_time`` (CUDA events)."""
    from .utils.profiling import device_time

    dev = _as_device(device)
    n_rows = 512 * 2048  # the FHD disk texture's scale
    tab = torch.arange(n_rows * 4, dtype=torch.float32, device=dev).reshape(n_rows, 4)
    idx = torch.as_tensor(np.random.default_rng(0).integers(0, n_rows, size=n_indices),
                          device=dev)
    rotated = itertools.cycle([(idx + i) % n_rows for i in range(reps)])
    seconds = device_time(lambda: tab[next(rotated)], iters=reps, warmup=1)
    return seconds / n_indices * 1e9
