"""Benchmark of the port on one NVIDIA GPU: every metric of ``bhr_tpu``'s
bench in ONE JSON line.

    python -m bhr_tpu_torch.bench [--round N] [--artifacts DIR]

The port of the repository's ``bench.py``. The line carries the
counterpart of each of its metrics, under the same name:

  fhd_dynamic_frame_ms   headline ("value"): FHD frame of the bench scene,
                         dynamic lifecycle texture, through the batched
                         video renderer on one device
  sd_frame_ms, hd_frame_ms, fourk_frame_ms
                         the same scene at the other presets
  fhd_aa_frame_ms, fourk_aa_frame_ms
                         with ray-differential AA
  fhd_flare_frame_ms     with the lens flare
  fhd_trace_ms, fhd_trace_aa_ms
                         the FHD ray-march kernel alone (slim, AA)
  mray_steps_per_s(_aa)  useful RK4 ray-steps per second of kernel time
  fp32_bound_share(_aa)  the kernel's share of its FP32-operation bound
                         (``bound``); bhr_tpu's ``vpu_mfu`` was a TPU VPU
                         model and has no counterpart
  issue_bound_share(_aa) the kernel's share of its issue bound
                         (``issue_bounds``, from the built library's SASS;
                         "not measured" without ``cuobjdump``), in place
                         of bhr_tpu's ``vpu_issue_util``
  gather_ns_per_index    the floor of the shade's row gather
  v2_frame_ms            FHD V2 volume-disk frame
  sd_video_fps, sd_video_steady_fps, v2_sd_video_fps,
  v2_sd_video_steady_fps SD orbit video, end to end and steady
  interactive_sd_fps     ``InteractiveSession.step`` at SD
  e2e_golden, e2e_golden_ok
                         the six golden families rendered on the card

and, for the port: ``device``, ``power_limit_w`` and ``sm_clock_mhz``
(``nvidia-smi``), ``spread`` ({metric: [min, max]} of the repeated
frame timings), ``launch_us`` (host µs to enqueue one tiny CUDA op:
a slow host shows here as such), ``fhd_device_busy_share`` (the card's
busy share of one FHD frame, ``torch.profiler``), ``video_assembler``
and ``elapsed_s``. ``vs_baseline`` is 2000 ms (the reference's CPU
frame, BASELINE.md) over the headline.

Eager PyTorch has no single compiled program: every frame time here
includes the host's dispatch of its launches, which bhr_tpu's numbers
exclude, and which is the bottleneck of most frames on the card. Times
of two calls differ with the host; compare within one call.

The trace's op model (``STEP_OPS`` ... ``MUFU_LANES_PER_SM``, the SASS
parser, ``bound``, ``issue_bounds``) and the golden tables live here
and nowhere else; ``chip_smoke.py`` imports them. Every function takes
``device=`` so that it also runs on the CPU; only ``main`` refuses a
host without a GPU, and no CPU number is ever written under a device
metric's name.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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

# Metrics whose definition changed in round REDEFINED_IN_ROUND: the gate
# skips them only against an artifact of an earlier round (a change of
# definition is not a regression) and notes why; from the next round on
# they are gated again. No metric of the port has been redefined yet.
REDEFINED_IN_ROUND = 0
REDEFINED_METRICS: dict = {}


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
GOLDEN_BOUNDS = (5e-2, 5e-4)  # max, mean |image - golden|


def golden_diff(img, name):
    """(max, mean) |img - tests/goldens/<name>.npz| in float64; raises
    ValueError when the shapes differ."""
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
    if img.shape != golden.shape:
        raise ValueError(f"{name}: shape {img.shape} vs {golden.shape}")
    diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
    return diff.max(), diff.mean()


def render_golden(family: str, device="cuda", out_dir=None) -> np.ndarray:
    """The golden family's image rendered on ``device``: a still through
    ``modes.render_image``, or for ``video`` PNG frames 0 and 4 of the
    golden orbit through ``render_video_sharded`` (written under
    ``out_dir``), stacked."""
    from .config import SceneConfig
    from .modes import render_image

    if family == "video":
        from .modes import video_temp_paths
        from .parallel.video import render_video_sharded
        from .utils.io import load_png_rgb8

        cfg = SceneConfig(device=torch.device(device).type,
                          output=os.path.join(out_dir, "golden.mp4"), **GOLDEN_VIDEO)
        render_video_sharded(cfg, devices=[torch.device(device)])
        frames, _ = video_temp_paths(cfg.output)
        return np.concatenate(
            [load_png_rgb8(os.path.join(frames, f"frame_{f:04d}.png"))
             .astype(np.float32) / 255.0 for f in (0, 4)], axis=0)
    extra = SCENES[family][0] if family in SCENES else V2_SCENES[family]
    return render_image(SceneConfig(device=torch.device(device).type,
                                    **{**GOLDEN, **extra}))


GOLDEN_FAMILIES = ("aa", "default", "flare", "v2", "v2sci", "video")


def golden_check(beat=None, *, device="cuda") -> dict:
    """Each golden family rendered on ``device`` and held to
    ``tests/goldens/e2e_cpu*.npz`` within GOLDEN_BOUNDS -> {family:
    bool}. A render that raises is False for its family (the error goes
    to stderr). ``beat`` is called before each family, so the stall
    watchdog sees six short renders, not one long metric."""
    out = {}
    for family in GOLDEN_FAMILIES:
        if beat is not None:
            beat()
        name = "e2e_cpu" if family == "default" else f"e2e_cpu_{family}"
        try:
            with tempfile.TemporaryDirectory() as td:
                d_max, d_mean = golden_diff(render_golden(family, device, td), name)
            out[family] = bool(d_max <= GOLDEN_BOUNDS[0] and d_mean <= GOLDEN_BOUNDS[1])
            print(f"golden {family}: max {d_max:.3e} mean {d_mean:.3e}",
                  file=sys.stderr)
        except Exception as exc:  # noqa: BLE001 - one family's failure is its result
            print(f"golden {family}: {type(exc).__name__}: {exc}", file=sys.stderr)
            out[family] = False
    return out


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
    """THE benchmark scene (one source for the bench and the tools): fov
    90, pov (6, 0, 0.5), step 0.1, disk 2-15 at tilt 15, orbit — not the
    CLI default of tilt 0. ``device`` is a name or a torch.device;
    ``size`` (width, height) overrides the preset's pixels (the tests'
    tiny frames)."""
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


def _time_batches(cfg, batch: int, skybox, device, repeats: int,
                  use_bloom: bool = True, busy: bool = False) -> dict:
    """Warm one batch of ``cfg``'s frames, then time ``repeats`` fresh
    batches on the host clock, each ended by a synchronise -> {"frame_ms":
    the median ms a frame, "spread": [min, max], "frames": frames
    rendered, "device_busy_share": the card's busy share of one more
    frame (``busy`` on a CUDA device; else None)}."""
    device = _as_device(device)
    if skybox is None:
        skybox = build_skybox(device)
    run = _batch_runner(cfg, (repeats + 1) * batch + int(busy), skybox, device,
                        use_bloom)
    run(range(batch))  # warm: caches, allocator, kernel library
    _sync(device)
    per_frame = []
    for r in range(1, repeats + 1):
        t0 = time.perf_counter()
        out = run(range(r * batch, (r + 1) * batch))
        _sync(device)
        per_frame.append((time.perf_counter() - t0) / batch * 1e3)
        del out
    share = None
    if busy and device.type == "cuda":
        last = (repeats + 1) * batch
        share, _ = device_busy_share(lambda: run([last]))
    return {"frame_ms": statistics.median(per_frame),
            "spread": [min(per_frame), max(per_frame)],
            "frames": (repeats + 1) * batch + int(busy and device.type == "cuda"),
            "device_busy_share": share}


def time_resolution(resolution: str, batch: int, skybox=None,
                    anti_alias: str = "disabled", lens_flare: bool = False, *,
                    device="cuda", repeats: int = 5, size=None,
                    use_bloom: bool = True, busy: bool = False) -> dict:
    """ms a frame of the bench scene at a preset, dynamic texture
    (``_time_batches``): one batch of frames through
    ``build_sharded_video_renderer`` on a one-device grid, warmed once,
    then ``repeats`` batches each timed on the host clock to a
    ``torch.cuda.synchronize()``; the median and [min, max].

    Unlike ``bhr_tpu``'s (one compiled program timed once, its dispatch
    excluded) this time includes the host's dispatch of every launch:
    eager PyTorch has no single program, and the dispatch is the
    bottleneck of a frame on the card. The batches are ``bhr_tpu``'s
    plan's; none had to be lowered for memory (the renderer frees each
    frame's float layers before the next frame). ``use_bloom=False`` is
    ``tools/ablate_pipeline``'s ``nobloom`` stage."""
    cfg = bench_scene_config(resolution, anti_alias, lens_flare, device=device,
                             size=size)
    return _time_batches(cfg, batch, skybox, device, repeats, use_bloom, busy)


def time_v2(batch: int = 8, skybox=None, *, device="cuda", repeats: int = 5,
            size=None) -> dict:
    """ms a frame of the FHD V2 volume-disk frame, timed as
    ``time_resolution``: the slim kernel (hits recorded), ``shade_frame_v2``
    with all hits in one pass, bloom and clamp, as ``--disk_model v2``
    renders a video frame."""
    cfg = dataclasses.replace(bench_scene_config("fhd", device=device, size=size),
                              disk_model="v2").validated()
    return _time_batches(cfg, batch, skybox, device, repeats)


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


def time_video_sd(n_frames: int = 48, disk_model: str = "texture", *,
                  device="cuda", size=None) -> dict:
    """SD orbit video through ``parallel/video.render_video_sharded`` on
    one device into a temp directory, after a warm video of one batch ->
    {"fps": frames/s end to end, "steady_fps": the engine's
    ``steady_rate`` (frames after the first batch, padding not counted),
    "assembler": which writer finished the file}.

    Frames per batch are pinned (``n_frames`` // 3, at most 16) so that
    the timed video runs three batches and the warm one renders the same
    batch size. The end-to-end figure includes the call's set-up (skybox,
    lifecycle packing) and the writers: ``render_video_sharded`` joins
    its PNG and video threads before it returns, so the clock stops
    after the last file is written. On a host without libavcodec headers
    the assembler is MJPEG, and its name is in the result.
    """
    from .config import SceneConfig
    from .parallel.video import render_video_sharded

    dev = _as_device(device)
    fpd = max(1, min(16, n_frames // 3))
    w, h = size if size is not None else (None, None)

    def run(frames: int, td: str):
        cfg = SceneConfig(
            resolution="sd", width=w, height=h, pov=(6.0, 0.0, 0.5), fov=90.0,
            step_size=0.1, disk_inner_radius=2.0, disk_outer_radius=15.0,
            disk_tilt=15.0, disk_model=disk_model, video=True, orbit=True,
            n_frames=frames, fps=24, frames_per_dispatch=fpd,
            output=os.path.join(td, "bench.mp4"), device=dev.type,
        ).validated()
        t0 = time.perf_counter()
        # The engine prints progress; the bench's stdout is one JSON line.
        with contextlib.redirect_stdout(sys.stderr):
            stats = render_video_sharded(cfg, devices=[dev])
        return time.perf_counter() - t0, stats

    with tempfile.TemporaryDirectory() as td:
        run(fpd, td)
    with tempfile.TemporaryDirectory() as td:
        dt, stats = run(n_frames, td)
    return {"fps": n_frames / dt, "steady_fps": stats["steady_fps"],
            "assembler": stats["assembler"]}


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


def time_interactive(n_frames: int = 40, *, device="cuda", size=None) -> float:
    """``InteractiveSession.step`` frames/s: an SD session of the bench
    scene with the dynamic texture and the lookahead on (``bhr_tpu``'s
    default), 4 warm steps, then ``n_frames`` timed. The device is
    synchronised before and after the timed steps: with the lookahead a
    step returns the previous frame while its own still renders, so the
    last frame's work is counted and the warm frame's is not."""
    from .config import SceneConfig
    from .interactive import InteractiveSession

    dev = _as_device(device)
    w, h = size if size is not None else (None, None)
    cfg = SceneConfig(
        resolution="sd", width=w, height=h, pov=(6.0, 0.0, 0.5), fov=90.0,
        step_size=0.1, disk_inner_radius=2.0, disk_outer_radius=15.0,
        disk_tilt=15.0, interactive=True, device=dev.type,
    ).validated()
    sess = InteractiveSession(cfg)
    for _ in range(4):
        sess.step(1.0 / 30.0)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_frames):
        sess.step(1.0 / 30.0)
    _sync(dev)
    return n_frames / (time.perf_counter() - t0)


def launch_us(device="cuda") -> float:
    """Host µs to enqueue one tiny op (an in-place add on one float), over
    1000 after 100 warm ones: the host's dispatch cost in this call."""
    n = 1000
    device = _as_device(device)
    x = torch.zeros(1, device=device)
    for _ in range(100):
        x.add_(1.0)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    dt = time.perf_counter() - t0
    _sync(device)
    return dt / n * 1e6


# --- The stall watchdog ------------------------------------------------------

# A single metric taking longer than this is a hung device call, not a
# slow benchmark (the slowest metric, the 4K frames, takes under a minute).
_STALL_LIMIT_S = 900.0


def _start_stall_watchdog(result: dict, state: dict, out) -> None:
    """Emit the partial line instead of losing the whole run.

    A hung CUDA call blocks the main thread where no signal reaches it.
    This daemon thread watches the per-metric heartbeat; once a metric has
    been in flight past _STALL_LIMIT_S and the headline is in hand, it
    prints the line collected so far to ``out`` (``state["pending"]``
    names every metric not yet reached, ``"partial": true`` marks it) and
    exits the process. A stalled headline leaves nothing worth printing.
    """
    def watch():
        while not state.get("done"):
            time.sleep(10.0)
            stalled_for = time.monotonic() - state["beat"]
            if (not state.get("done") and stalled_for > _STALL_LIMIT_S
                    and "value" in result):
                for key in state.get("pending", []):
                    result.setdefault(key, "skipped (device stall)")
                result["stalled_in"] = state.get("current", "?")
                result["partial"] = True
                print(json.dumps(result), file=out, flush=True)
                os._exit(0)

    threading.Thread(target=watch, daemon=True).start()


# --- The round-over-round regression gate -----------------------------------
#
# Any metric more than 5% worse than the previous round's artifact lands
# in "regressions". The gate reads only the port's own artifacts,
# BENCH_TORCH_r{N}.json in the artifacts directory, and only rounds
# strictly below the current one; the repository's root BENCH_r*.json are
# a TPU's and are never read.

_LOWER_BETTER = ("_ms", "_ns_per_index")
_HIGHER_BETTER = ("_fps", "mray_steps_per_s", "fp32_bound_share",
                  "issue_bound_share", "vs_baseline")
_REGRESSION_TOL = 0.05
ARTIFACT_RE = re.compile(r"BENCH_TORCH_r(\d+)\.json$")


def _metric_direction(key: str):
    """"lower", "higher" or None (not gated: launch_us and the busy share
    describe the host and the card, not the program)."""
    if key == "value":  # the headline fhd_dynamic_frame_ms travels as "value"
        return "lower"
    if any(key.endswith(s) for s in _LOWER_BETTER):
        return "lower"
    if any(s in key for s in _HIGHER_BETTER):
        return "higher"
    return None


def is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)


def load_prev_artifact(artifacts_dir: str, round_n: int) -> dict:
    """{"round": N, "metrics": {...}} of the newest readable
    ``BENCH_TORCH_r{N}.json`` in ``artifacts_dir`` with N < ``round_n``;
    round -1 and no metrics where there is none. An artifact is the
    bench's line, or an object holding it under "parsed"."""
    best_n, best = -1, {}
    for path in glob.glob(os.path.join(artifacts_dir, "BENCH_TORCH_r*.json")):
        m = ARTIFACT_RE.search(os.path.basename(path))
        if not m or not best_n < int(m.group(1)) < round_n:
            continue
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = obj.get("parsed", obj) if isinstance(obj, dict) else None
        if isinstance(parsed, dict) and "metric" in parsed:
            best_n, best = int(m.group(1)), parsed
    return {"round": best_n, "metrics": best}


def regression_check(result: dict, prev: dict) -> None:
    """Compare ``result`` with ``prev`` (``load_prev_artifact``): sets
    "vs_prev_round" (None without a previous round), "regressions"
    ({key: {prev, now, worse_pct}} past 5%) and "metric_notes" (the
    redefined metrics skipped)."""
    if prev["round"] < 0:
        result["vs_prev_round"] = None
        return
    regressions, notes = {}, {}
    for key, old in prev["metrics"].items():
        if key in REDEFINED_METRICS and prev["round"] < REDEFINED_IN_ROUND:
            notes[key] = REDEFINED_METRICS[key]
            continue
        direction = _metric_direction(key)
        new = result.get(key)
        if direction is None or not is_number(old) or not is_number(new) or old == 0:
            continue
        worse = (new - old) / old if direction == "lower" else (old - new) / old
        if worse > _REGRESSION_TOL:
            regressions[key] = {"prev": old, "now": new,
                                "worse_pct": round(worse * 100, 1)}
    result["vs_prev_round"] = prev["round"]
    if notes:
        result["metric_notes"] = notes
    if regressions:
        result["regressions"] = regressions


# Sub-metrics map back to the measurement that produces them; the
# headline ("value", "vs_baseline") has no registered function and is
# never retried.
_RETRY_PARENT = {
    "mray_steps_per_s": "fhd_trace_ms",
    "fp32_bound_share": "fhd_trace_ms",
    "issue_bound_share": "fhd_trace_ms",
    "mray_steps_per_s_aa": "fhd_trace_aa_ms",
    "fp32_bound_share_aa": "fhd_trace_aa_ms",
    "issue_bound_share_aa": "fhd_trace_aa_ms",
    "sd_video_steady_fps": "sd_video_fps",
    "v2_sd_video_steady_fps": "v2_sd_video_fps",
}


def retry_flagged(result: dict, fn_registry: dict, rerun, prev: dict) -> None:
    """Measure each regression-flagged metric once more, then gate again.

    A one-off slow reading heals; a true regression reproduces and stays
    flagged. ``rerun(key, fn)`` is ``main``'s re-measure (it sets
    ``result[key]``). Where a retry raises, or leaves a value that is not
    a number (``main``'s re-measure stores an error string), the first reading
    of each metric it produces is put back, so its flag stays; the retry's
    error is kept under "retry_failed". The retried metrics are listed
    under "retried".
    """
    if not result.get("regressions"):
        return
    before = dict(result)
    retried, failed = [], {}
    for key in list(result["regressions"]):
        owner = _RETRY_PARENT.get(key, key)
        fn = fn_registry.get(owner)
        if fn is None or owner in retried:
            continue
        retried.append(owner)
        try:
            rerun(owner, fn)
        except Exception as exc:  # noqa: BLE001 - the first reading stands
            failed[owner] = f"{type(exc).__name__}: {exc}"
        for k in (owner, *(k for k, p in _RETRY_PARENT.items() if p == owner)):
            if k in before and is_number(before[k]) and not is_number(result.get(k)):
                failed.setdefault(owner, str(result.get(k)))
                result[k] = before[k]
    if retried:
        result["retried"] = retried
        if failed:
            result["retry_failed"] = failed
        for stale in ("regressions", "metric_notes", "vs_prev_round"):
            result.pop(stale, None)
        regression_check(result, prev)


# --- The run ------------------------------------------------------------------

# bhr_tpu's plan, in its order: the trace and video rows first, the 4K
# and AA frames last behind the time budget.
PLAN = [
    "fhd_trace_ms", "fhd_trace_aa_ms", "sd_frame_ms",
    "sd_video_fps", "interactive_sd_fps", "v2_sd_video_fps",
    "hd_frame_ms", "fhd_aa_frame_ms", "v2_frame_ms",
    "fourk_frame_ms", "fourk_aa_frame_ms", "fhd_flare_frame_ms",
    "gather_ns_per_index", "e2e_golden",
]
_BUDGET_S = 2700.0


def run_bench(result: dict, state: dict, log) -> dict:
    """Every metric of PLAN into ``result`` (the headline first) ->
    {key: the function that measured it}, for ``retry_flagged``. A
    metric that raises records its error string instead."""
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    skybox = build_skybox(dev)
    sass = sass_counts_or_none()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = result["sm_clock_mhz"]
    result["spread"] = {}

    log("bench: launch_us ...")
    result["launch_us"] = launch_us(device=dev)
    log("bench: fhd dynamic frame ...")
    fhd = time_resolution("fhd", 32, skybox, device=dev, busy=True)
    result.update({"metric": "fhd_dynamic_frame_ms", "value": fhd["frame_ms"],
                   "unit": "ms", "vs_baseline": 2000.0 / fhd["frame_ms"],
                   "fhd_device_busy_share": fhd["device_busy_share"]})
    result["spread"]["fhd_dynamic_frame_ms"] = fhd["spread"]

    fn_registry = {}

    def aux(key, fn):
        log(f"bench: {key} ...")
        state["current"] = key
        if key in state["pending"]:
            state["pending"].remove(key)
        fn_registry[key] = fn
        state["beat"] = time.monotonic()
        try:
            result[key] = fn()
        except Exception as exc:  # noqa: BLE001 - one metric's failure is its value
            result[key] = f"error: {type(exc).__name__}: {exc}"
        torch.cuda.empty_cache()  # one metric's cache does not distort the next
        state["beat"] = time.monotonic()

    def trace_metrics(aa, suffix):
        tr = time_trace(aa, device=dev, sass=sass, n_sms=n_sms, clock_mhz=clock)
        for k in ("mray_steps_per_s", "fp32_bound_share", "issue_bound_share"):
            result[k + suffix] = tr[k]
        return tr["trace_ms"]

    def frame(key, resolution, batch, **kw):
        def fn():
            r = time_resolution(resolution, batch, skybox, device=dev, **kw)
            result["spread"][key] = r["spread"]
            return r["frame_ms"]
        return fn

    def v2_frame():
        r = time_v2(8, skybox, device=dev)
        result["spread"]["v2_frame_ms"] = r["spread"]
        return r["frame_ms"]

    def video(key, **kw):
        def fn():
            r = time_video_sd(device=dev, **kw)
            result[key.replace("_fps", "_steady_fps")] = r["steady_fps"]
            result["video_assembler"] = r["assembler"]
            return r["fps"]
        return fn

    def gated(key, fn):
        if time.perf_counter() - t_start < _BUDGET_S:
            aux(key, fn)
        else:
            if key in state["pending"]:
                state["pending"].remove(key)
            result[key] = "skipped (bench time budget)"

    state["pending"] = list(PLAN)
    aux("fhd_trace_ms", lambda: trace_metrics(False, ""))
    aux("fhd_trace_aa_ms", lambda: trace_metrics(True, "_aa"))
    aux("sd_frame_ms", frame("sd_frame_ms", "sd", 32))
    aux("sd_video_fps", video("sd_video_fps"))
    aux("interactive_sd_fps", lambda: time_interactive(device=dev))
    aux("v2_sd_video_fps", video("v2_sd_video_fps", disk_model="v2"))
    aux("hd_frame_ms", frame("hd_frame_ms", "hd", 32))
    aux("fhd_aa_frame_ms", frame("fhd_aa_frame_ms", "fhd", 16,
                                 anti_alias="lod_radius"))
    aux("v2_frame_ms", v2_frame)
    gated("fourk_frame_ms", frame("fourk_frame_ms", "4k", 8))
    gated("fourk_aa_frame_ms", frame("fourk_aa_frame_ms", "4k", 4,
                                     anti_alias="lod_radius"))
    gated("fhd_flare_frame_ms", frame("fhd_flare_frame_ms", "fhd", 16,
                                      lens_flare=True))
    aux("gather_ns_per_index", lambda: time_gather(device=dev))
    aux("e2e_golden", lambda: golden_check(
        beat=lambda: state.__setitem__("beat", time.monotonic()), device=dev))
    result["e2e_golden_ok"] = (isinstance(result.get("e2e_golden"), dict)
                               and all(result["e2e_golden"].values()))
    return fn_registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", type=int, default=None,
                    help="this round's number: gate against the newest "
                         "BENCH_TORCH_r{N}.json below it and write this "
                         "line to BENCH_TORCH_r{round}.json")
    ap.add_argument("--artifacts", default=os.path.join("output", "bench_torch"),
                    help="directory of the BENCH_TORCH_r{N}.json artifacts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bhr_tpu_torch.bench: torch.cuda.is_available() is False; the "
              "bench measures an NVIDIA GPU and never times the CPU",
              file=sys.stderr)
        return 1

    out = sys.stdout
    t_start = time.perf_counter()
    result = {"device": torch.cuda.get_device_name(0),
              "power_limit_w": float(gpu_query("power.limit")),
              "sm_clock_mhz": float(gpu_query("clocks.max.sm"))}
    state = {"beat": time.monotonic(), "current": "headline", "done": False,
             "pending": []}
    _start_stall_watchdog(result, state, out)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    # Everything the renderers print goes to stderr: stdout is one line.
    with contextlib.redirect_stdout(sys.stderr):
        fn_registry = run_bench(result, state, log)
        prev = ({"round": -1, "metrics": {}} if args.round is None
                else load_prev_artifact(args.artifacts, args.round))

        def rerun(key, fn):
            log(f"bench: retry {key} ...")
            state["beat"] = time.monotonic()
            try:
                result[key] = fn()
            except Exception as exc:  # noqa: BLE001 - retry_flagged restores it
                result[key] = f"error: {type(exc).__name__}: {exc}"

        regression_check(result, prev)
        retry_flagged(result, fn_registry, rerun, prev)
    result["elapsed_s"] = time.perf_counter() - t_start
    state["done"] = True
    line = json.dumps(result)
    if args.round is not None:
        os.makedirs(args.artifacts, exist_ok=True)
        with open(os.path.join(args.artifacts,
                               f"BENCH_TORCH_r{args.round:02d}.json"), "w") as f:
            f.write(line + "\n")
    print(line, file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
