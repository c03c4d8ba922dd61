#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # every phase; the bands of phase 6 go on
                             # cuda:0..3 where four cards are visible

Phases, one line (or a few) each; any failure raises and the script
exits non-zero without printing a result:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build the ray-march kernel template from ``bhr_tpu_torch/csrc`` and
   time it; ptxas registers and spills of each instantiation;
3. every instantiation (slim, AA, no disk, and each with step counts) vs
   its plain PyTorch version on the card, at 128x32 and at the 320x180
   golden scene: rays whose captured/escaped/hit_count differ (pass at
   <= 0.1%); on agreeing rays the largest difference of the escape
   direction and hit features 0..4, which are of order 1 (pass at
   <= 2e-3), and of features 5..10, plus t_frac at 11 for AA, which must
   be equal (the differentials are of the order of a pixel's angle,
   ~1e-3, so a 2e-3 bound would not catch a wrong one; the slim kernel
   leaves t_frac at 11 zero, its plain version writes it); and step
   counts, which must be equal;
4. the ``default``, ``aa`` and ``flare`` golden scenes through
   ``bhr_tpu_torch.modes.render_image`` on CUDA, each within max 5e-2 /
   mean 5e-4 of ``tests/goldens/e2e_cpu{,_aa,_flare}.npz``, with exactly
   one launch of the expected kernel and the scene's sanity checks;
5. the main paths at full width (1920x1080), each with the launch
   counts set to 0 just before it and read just after: the default frame
   and the ``--anti_alias lod_radius --lens_flare`` frame through
   ``bhr_tpu_torch.cli.main``, and a Renderer without a disk texture;
   per-stage medians (CUDA events) of the default and the AA+flare
   frames; every instantiation vs its plain version at FHD, the timed
   runs of the step-count instantiations counted as their path; steps
   per ray (mean, p99, max), the warps' lane efficiency and useful
   ray-steps per second of kernel time;
6. the tile path (``parallel.frames``): (a) every instantiation's FHD
   row band 2 of 4 (rows 540-809) against the plain band and against
   those rows of the full-frame kernel trace (0 flips, 0.0 difference,
   equal steps), and each one's bound; (b) the ``default`` and ``aa``
   goldens through ``render_image_tiled`` in 4 bands (the goldens'
   bounds, exactly 4 launches); (c) the ``-r 4k --anti_alias lod_radius
   --aa_strength 1.0 --lens_flare`` still in 4 bands, with the counts
   set to 0 just before it and read just after (exactly 4
   ``ray_march_aa`` launches), within 2e-5 of the same frame rendered
   whole on cuda:0, with stage medians (CUDA events; the tiled stages
   as ``render_image_tiled``'s ``on_stage`` callback marks them) and peak
   memory of both. The bands of (b) and (c) run on cuda:0..3 where four
   cards are visible, else all on cuda:0;
7. a JSON line describing every instantiation at FHD (kernel, plain
   version and bound times; ``launches`` sums the paths of phases 5 and
   6), then the result line ``{"ok": true, "device": {...}}`` as the last
   line.

Imports torch, numpy and bhr_tpu_torch only.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

TOL_FLIP_FRAC = 1e-3  # rays allowed to change category
TOL_FLOAT = 2e-3  # escape direction / hit features 0..4 on agreeing rays
POV = (6.0, 0.0, 0.5)
GOLDEN = dict(width=320, height=180, pov=POV, fov=60.0, step_size=0.1,
              r_max=10.0, n_stars=100, disk_inner_radius=2.0,
              disk_outer_radius=3.5, disk_tilt=15.0, anti_alias="disabled",
              seed=42)
# The golden families of tests/e2e_render.py this script renders, and the
# kernel each launches.
SCENES = {"default": ({}, "ray_march_slim"),
          "aa": ({"anti_alias": "lod_radius"}, "ray_march_aa"),
          "flare": ({"lens_flare": True}, "ray_march_slim")}
# Trace variants by their kernel's instantiation name.
VARIANTS = {
    "ray_march_slim": {},
    "ray_march_aa": {"with_differentials": True},
    "ray_march_nodisk": {"record_hits": False},
}
VARIANTS.update({f"{k}_steps": dict(v, record_step_counts=True)
                 for k, v in list(VARIANTS.items())})
REPLACES = "bhr_tpu/ops/geodesic_pallas.py:582"  # pl.pallas_call of the kernel
AA_FLAGS = ["--anti_alias", "lod_radius", "--aa_strength", "1.0", "--lens_flare"]
TILES = 4  # row bands of the tile phase
TOL_TILED = 2e-5  # tiled vs whole frame (test_sharded_frames.py's bound)

# FP32 add/sub, mul, div and sqrt of csrc/ray_march.cu (fmin/fmax and
# compares not counted), for the bound of each instantiation:
# - per RK4 step: adaptive step 16, four accel_factor 36, stage slopes
#   and positions 66, update 42, r^2 and affine tests 6, plus the
#   disk-plane test 5 where hits are recorded; AA adds two diff_rk4 of
#   168 each on every step that survives (not the terminating one);
# - per ray: image plane and primary ray 62 (AA: 124 with the two
#   differential rays), escape direction 9 per escaped ray;
# - per recorded crossing: 12 (AA: 30 with the differentials' lerp).
STEP_OPS = {"slim": 171, "aa": 171, "nodisk": 166}
DIFF_STEP_OPS = {"slim": 0, "aa": 336, "nodisk": 0}
RAY_OPS = {"slim": 62, "aa": 124, "nodisk": 62}
HIT_OPS = {"slim": 12, "aa": 30, "nodisk": 0}
# Bytes written per ray: captured, escaped, escape_dir, hit_count, hits
# (K=4 x 12 floats), plus steps for the _steps instantiations.
RAY_BYTES = 1 + 1 + 12 + 4 + 4 * 12 * 4
# NVIDIA H100 SXM published peaks (dense FP32 outside the tensor cores,
# HBM3 bandwidth). The FP32 peak counts a fused multiply-add as two
# operations; ray_march.cu is built with -fmad=false, so its adds and
# muls issue one at a time, at half that rate (PEAK_FP32_UNFUSED). A
# divide or square root counts as one operation but takes several
# instructions, so either bound is below the kernel's true least time
# and the shares printed are lower estimates.
PEAK_FP32 = 67e12
PEAK_FP32_UNFUSED = PEAK_FP32 / 2
PEAK_BYTES = 3.35e12


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAIL: {msg}")


def cuda_ms(fn, reps: int = 1):
    """(result of the last call, mean device ms per call) via CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def compare(kernel, plain, n_feat):
    """(category flips, their fraction, largest diff on agreeing rays over
    escape_dir and hit features 0..4 of every slot, largest diff over
    features 5..n_feat-1, step-count mismatches)."""
    flip = ((kernel.captured != plain.captured) | (kernel.escaped != plain.escaped)
            | (kernel.hit_count != plain.hit_count))
    n_flip = int(flip.sum())
    agree = ~flip
    diff = (kernel.hits[:, :n_feat] - plain.hits[:, :n_feat]).abs()[..., agree]
    err = max(float((kernel.escape_dir - plain.escape_dir).abs()[agree].max()),
              float(diff[:, :5].max()))
    small_err = float(diff[:, 5:].max())
    step_diff = 0
    if plain.steps is not None:
        step_diff = int((kernel.steps != plain.steps).sum())
    return n_flip, n_flip / flip.numel(), err, small_err, step_diff


def trace_pair(name, w, h, fov, tilt, h_base, r_escape, r_inner, r_outer, reps):
    """Kernel ``name`` and its plain version on the same camera tensor on
    the card -> (kernel, plain, kernel ms, plain ms, comparison)."""
    from bhr_tpu_torch.camera import build_camera
    from bhr_tpu_torch.ops.geodesic import (
        primary_differentials_from_params,
        primary_rays_from_params,
        trace_geodesics,
    )
    from bhr_tpu_torch.ops.geodesic_cuda import camera_params, trace_geodesics_cuda

    cam = torch.as_tensor(camera_params(build_camera(POV, fov, w, h)), device="cuda")
    kw = dict(h_base=h_base, r_escape=r_escape, tilt_deg=tilt, r_inner=r_inner,
              r_outer=r_outer, **VARIANTS[name])
    trace_geodesics_cuda(cam, width=w, height=h, **kw)  # warm-up
    kernel, k_ms = cuda_ms(lambda: trace_geodesics_cuda(cam, width=w, height=h, **kw),
                           reps)

    def plain_fn():
        dirs = primary_rays_from_params(cam, w, h)
        ddx, ddy = primary_differentials_from_params(cam, w, h, dirs)
        return trace_geodesics(cam[0:3], dirs, d_dir_dx0=ddx, d_dir_dy0=ddy, **kw)

    plain, p_ms = cuda_ms(plain_fn)
    n_feat = 12 if kw.get("with_differentials") else 11
    return kernel, plain, k_ms, p_ms, compare(kernel, plain, n_feat)


def check_pair(tag, name, result):
    kernel, plain, k_ms, p_ms, (n_flip, frac, err, small_err, step_diff) = result
    say(f"[kernel-vs-plain {tag}] {name}: flipped rays {n_flip} ({frac:.3%}) "
        f"max float diff {err:.3e} (features 5.. {small_err:.3e}) "
        f"step-count mismatches {step_diff}; "
        f"kernel {k_ms:.3f} ms plain {p_ms:.3f} ms")
    check(frac <= TOL_FLIP_FRAC, f"{tag} {name}: {n_flip} rays change category")
    check(err <= TOL_FLOAT, f"{tag} {name}: float diff {err} > {TOL_FLOAT}")
    check(small_err == 0.0, f"{tag} {name}: features 5.. differ by {small_err}")
    check(step_diff == 0, f"{tag} {name}: {step_diff} step counts differ")
    if "nodisk" in name:
        check(not bool(kernel.hits.any()) and not bool(kernel.hit_count.any()),
              f"{tag} {name}: hits recorded without a disk")
    check((kernel.steps is not None) == name.endswith("_steps"),
          f"{tag} {name}: steps output")


def expect_launches(counts: dict, name: str, what: str) -> None:
    others = {k: v for k, v in counts.items() if k != name and v}
    check(counts[name] == 1 and not others,
          f"{what} launched {counts}, expected {name} exactly once")


def stage_times(cfg, frames: int = 4):
    """Median ms per stage over frames 1.. (frame 0 warms up) with CUDA
    events, and the last frame."""
    from bhr_tpu_torch.config import escape_radius
    from bhr_tpu_torch.modes import _make_renderer

    renderer, dynamic = _make_renderer(cfg)
    r_escape = escape_radius(cfg.r_max, cfg.pov)
    stages = {"disk_texture": [], "trace": [], "shade": [], "post": []}
    frame = None
    for i in range(frames):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        ev[0].record()
        renderer.update_disk_texture(dynamic.advance(t=0.0, dt=0.0, recompute_stats=True))
        ev[1].record()
        camera = renderer.camera(cfg.pov, cfg.fov)
        trace = renderer.trace(camera, r_escape, cfg.use_ray_differentials)
        ev[2].record()
        bg, disk = renderer.shade(trace, camera, 0, cfg.use_ray_differentials)
        ev[3].record()
        frame = renderer.post(bg, disk, True, cfg.lens_flare)[0]
        ev[4].record()
        torch.cuda.synchronize()
        if i:
            for j, name in enumerate(stages):
                stages[name].append(ev[j].elapsed_time(ev[j + 1]))
    return {k: statistics.median(v) for k, v in stages.items()}, frame


def tiled_stage_times(cfg, devices, frames: int = 4):
    """``render_image_tiled``'s stages, as its ``on_stage`` callback names
    them, timed as ``stage_times`` times the whole frame: median ms over
    frames 1.. (frame 0 warms up) of CUDA events on the first device,
    each recorded after the other devices are synchronized; and the last
    frame. The time from "setup" (scene assets made) on is timed."""
    from bhr_tpu_torch.parallel.frames import render_image_tiled

    first, others = devices[0], set(devices) - {devices[0]}
    stages, frame = {}, None
    for i in range(frames):
        events = []

        def mark(stage):
            for d in others:
                torch.cuda.synchronize(d)
            with torch.cuda.device(first):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            events.append((stage, ev))

        torch.cuda.synchronize()
        frame = render_image_tiled(cfg, devices=devices, on_stage=mark)
        torch.cuda.synchronize()
        check([name for name, _ in events] == [
            "setup", "disk_texture", "replicas", "trace", "shade", "gather",
            "post"], f"tiled stages {[name for name, _ in events]}")
        if i:
            for (_, start), (name, end) in zip(events, events[1:]):
                stages.setdefault(name, []).append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in stages.items()}, frame


def check_band(name, full, w, h, fov, tilt, h_base, r_escape, r_inner, r_outer,
               row_start, rows, reps):
    """Kernel ``name``'s row band [row_start, row_start + rows) against
    the plain band and those rows of ``full``, the full-frame kernel
    trace of the same camera: all must be equal. -> band kernel ms
    (the plain band's ms is printed)."""
    from bhr_tpu_torch.camera import build_camera
    from bhr_tpu_torch.ops.geodesic import (
        primary_differentials_from_params,
        primary_rays_from_params,
        trace_geodesics,
    )
    from bhr_tpu_torch.ops.geodesic_cuda import camera_params, trace_geodesics_cuda

    cam = torch.as_tensor(camera_params(build_camera(POV, fov, w, h)),
                          device=full.captured.device)
    kw = dict(h_base=h_base, r_escape=r_escape, tilt_deg=tilt, r_inner=r_inner,
              r_outer=r_outer, **VARIANTS[name])

    def band_fn():
        return trace_geodesics_cuda(cam, row_start, row_count=rows, width=w,
                                    height=h, **kw)

    def plain_fn():
        dirs = primary_rays_from_params(cam, w, h, row_start, rows)
        ddx, ddy = primary_differentials_from_params(cam, w, h, dirs, row_start,
                                                     rows)
        return trace_geodesics(cam[0:3], dirs, d_dir_dx0=ddx, d_dir_dy0=ddy, **kw)

    band_fn()  # warm-up
    band, ms = cuda_ms(band_fn, reps)
    plain, p_ms = cuda_ms(plain_fn)
    sel = slice(row_start * w, (row_start + rows) * w)
    rows_of_full = full._replace(
        **{f: getattr(full, f)[sel] for f in ("captured", "escaped", "escape_dir",
                                               "hit_count")},
        hits=full.hits[:, :, sel],
        steps=None if full.steps is None else full.steps[sel])
    # The slim kernel leaves t_frac (feature 11) zero, its plain version
    # writes it.
    n_feat = 11 if name.startswith("ray_march_slim") else 12
    for ref_name, ref, nf in (("full-frame rows", rows_of_full, 12),
                              ("plain band", plain, n_feat)):
        n_flip, _, err, small_err, step_diff = compare(band, ref, nf)
        say(f"[tile-band {w}x{h}] {name} rows {row_start}-{row_start + rows - 1} "
            f"vs {ref_name}: flipped rays {n_flip} max float diff {err:.3e} "
            f"(features 5.. {small_err:.3e}) step-count mismatches {step_diff}")
        check(n_flip == 0 and err == 0.0 and small_err == 0.0 and step_diff == 0,
              f"{name} band differs from the {ref_name}")
    check(band.captured.shape == (rows * w,), f"{name} band shape")
    say(f"[tile-band {w}x{h}] {name}: band kernel {ms:.3f} ms plain {p_ms:.3f} ms "
        f"({rows} of {h} rows)")
    return ms


def bound(name, steps, trace, peak=PEAK_FP32):
    """(least ms the card could take, "operations" or "bytes") for the
    instantiation ``name`` on this run's FHD trace: FP32 operations
    (STEP_OPS etc., over the measured per-ray ``steps``) over ``peak``,
    and the bytes written over PEAK_BYTES."""
    base = name.removeprefix("ray_march_").removesuffix("_steps")
    n = steps.numel()
    total = float(steps.sum())
    terminated = int((trace.captured | trace.escaped).sum())
    ops = (STEP_OPS[base] * total + DIFF_STEP_OPS[base] * (total - terminated)
           + RAY_OPS[base] * n + 9 * int(trace.escaped.sum())
           + HIT_OPS[base] * int(trace.hit_count.sum()))
    nbytes = 14 * 4 + n * (RAY_BYTES + (4 if name.endswith("_steps") else 0))
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tile_phase(launches, reset_counts) -> int:
    """Phases 6b and 6c on cuda:0..TILES-1 where that many cards are
    visible, else on cuda:0 alone; -> the 4K path's ray_march_aa
    launches."""
    import bhr_tpu_torch.cli as cli
    from bhr_tpu_torch.config import SceneConfig
    from bhr_tpu_torch.modes import render_image
    from bhr_tpu_torch.parallel.frames import render_image_tiled

    # 6b. the golden scenes through the tile path, in TILES bands
    n_cards = torch.cuda.device_count()
    tile_devs = ([torch.device("cuda", i) for i in range(TILES)] if n_cards >= TILES
                 else [torch.device("cuda", 0)] * TILES)
    say(f"[tiles] {TILES} bands on {', '.join(map(str, tile_devs))} "
        f"({n_cards} card(s) visible)")
    for scene in ("default", "aa"):
        extra, expected = SCENES[scene]
        reset_counts()
        img = render_image_tiled(
            SceneConfig(device="cuda", tile_shards=TILES, **{**GOLDEN, **extra}),
            devices=tile_devs)
        launched = dict(launches)
        suffix = "" if scene == "default" else f"_{scene}"
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      f"e2e_cpu{suffix}.npz"))["image"]
        diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
        whole = np.abs(img - render_image(SceneConfig(
            device="cuda", **{**GOLDEN, **extra}))).max()
        say(f"[tiles golden {scene}] vs e2e_cpu{suffix}.npz max {diff.max():.3e} "
            f"mean {diff.mean():.3e}; vs the whole frame max {whole:.3e}; "
            f"{expected} launches {launched[expected]}")
        check(img.shape == (180, 320, 3) and np.isfinite(img).all(),
              f"tiled golden {scene} shape/finite")
        check(diff.max() <= 5e-2 and diff.mean() <= 5e-4,
              f"tiled golden {scene} outside bounds")
        others = {k: v for k, v in launched.items() if k != expected and v}
        check(launched[expected] == TILES and not others,
              f"tiled golden {scene} launched {launched}, expected {expected} "
              f"{TILES} times")

    # 6c. the tile path at full width: the 4K AA + flare still in bands,
    # against the same frame rendered whole on the same card.
    flags_4k = ["-r", "4k", *AA_FLAGS]
    cfg_4k = cli.config_from_args(cli.build_parser().parse_args(
        [*flags_4k, "--tile_shards", str(TILES)]))
    whole_4k = cli.config_from_args(cli.build_parser().parse_args(flags_4k))
    reset_counts()
    t0 = time.perf_counter()
    tiled = render_image_tiled(cfg_4k, devices=tile_devs)
    t_tiled = time.perf_counter() - t0
    launched = dict(launches)
    others = {k: v for k, v in launched.items() if k != "ray_march_aa" and v}
    say(f"[tiles 4k] {' '.join(flags_4k)} --tile_shards {TILES}: "
        f"{t_tiled:.2f} s; ray_march_aa launches {launched['ray_march_aa']}")
    check(launched["ray_march_aa"] == TILES and not others,
          f"4K tiled frame launched {launched}, expected ray_march_aa {TILES} times")
    t0 = time.perf_counter()
    whole = render_image(whole_4k)
    t_whole = time.perf_counter() - t0
    diff = np.abs(tiled - whole)
    say(f"[tiles 4k] vs the whole frame ({t_whole:.2f} s): max {diff.max():.3e}, "
        f"{int((diff > 0).any(axis=-1).sum())} of {diff.shape[0] * diff.shape[1]} "
        f"pixels differ")
    check(tiled.shape == (2160, 3840, 3) and np.isfinite(tiled).all(),
          "4K tiled frame not finite or wrong shape")
    check(diff.max() <= TOL_TILED, f"4K tiled vs whole {diff.max()} > {TOL_TILED}")
    del whole
    for tag, timer in (("tiled", lambda: tiled_stage_times(cfg_4k, tile_devs)),
                       ("whole", lambda: stage_times(whole_4k))):
        for d in set(tile_devs):
            torch.cuda.reset_peak_memory_stats(d)
        med, frame = timer()
        frame = torch.as_tensor(frame)
        check(bool(torch.isfinite(frame).all()) and frame.shape == (2160, 3840, 3),
              f"4K {tag} frame not finite or wrong shape")
        if tag == "tiled":
            check(bool((frame == torch.from_numpy(tiled)).all()),
                  "4K timed tiled frame differs from the checked one")
        peak = max(torch.cuda.max_memory_allocated(d) for d in set(tile_devs))
        say(f"[tiles 4k-frame {tag}] median ms over 3 frames: " + ", ".join(
            f"{k} {v:.3f}" for k, v in med.items()) + f"; total "
            f"{sum(med.values()):.3f}; peak memory {peak / 2**30:.3f} GiB")
        del frame
    del tiled
    return launched["ray_march_aa"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import bhr_tpu_torch.cli as cli
    from bhr_tpu_torch import _build
    from bhr_tpu_torch.config import SceneConfig, escape_radius
    from bhr_tpu_torch.models.skybox import load_or_generate_skybox
    from bhr_tpu_torch.modes import render_image
    from bhr_tpu_torch.ops.geodesic_cuda import KERNELS, kernel_name, trace_geodesics_cuda
    from bhr_tpu_torch.pipeline import Renderer

    launches = trace_geodesics_cuda.launches  # per instantiation

    def reset_counts():
        launches.update(dict.fromkeys(launches, 0))

    check(sorted(KERNELS) == sorted(VARIANTS), f"kernels {KERNELS}")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build("ray_march")
    say(f"[build] ray_march: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {built.seconds:.2f} s) -> {os.path.relpath(built.path, ROOT)}")
    for line in built.log.splitlines():
        # ray_march<kDiff, kRecord, kSteps> mangles as ray_marchILb?ELb?ELb?E.
        entry = re.search(r"entry function .*ray_marchILb([01])ELb([01])ELb([01])E", line)
        if entry:
            diff, record, steps = (c == "1" for c in entry.groups())
            say("[build] ptxas: instantiation " + kernel_name(
                with_differentials=diff, record_hits=record, record_step_counts=steps))
        elif "registers" in line or "spill" in line:
            say(f"[build] ptxas: {line.strip()}")

    # 3. kernel vs plain at the small shapes
    for tag, args, reps in (
        ("128x32", (128, 32, 60.0, 15.0, 0.2, 12.04, 2.0, 3.5), 20),
        ("320x180", (320, 180, 60.0, 15.0, 0.1, escape_radius(10.0, POV), 2.0, 3.5), 20),
    ):
        for name in KERNELS:
            check_pair(tag, name, trace_pair(name, *args, reps))

    # 4. the golden scenes on CUDA through the main path's entry point
    images = {}
    for scene, (extra, expected) in SCENES.items():
        reset_counts()
        img = render_image(SceneConfig(device="cuda", **{**GOLDEN, **extra}))
        launched = dict(launches)
        suffix = "" if scene == "default" else f"_{scene}"
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      f"e2e_cpu{suffix}.npz"))["image"]
        diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
        h, w = 180, 320
        center = img[h // 2 - 16: h // 2 + 16, w // 2 - 16: w // 2 + 16]
        say(f"[golden {scene}] vs e2e_cpu{suffix}.npz max {diff.max():.3e} "
            f"mean {diff.mean():.3e}; {expected} launches {launched[expected]}")
        check(img.shape == (180, 320, 3) and np.isfinite(img).all(),
              f"golden {scene} shape/finite")
        check(diff.max() <= 5e-2 and diff.mean() <= 5e-4,
              f"golden {scene} outside bounds")
        expect_launches(launched, expected, f"golden {scene}")
        check(img.max() > 0.5 and (img.sum(axis=-1) > 0.02).mean() > 0.05,
              f"golden {scene}: no bright ring")
        if extra.get("lens_flare"):
            # The flare lifts pixels across the frame (the shadow too) and
            # never darkens one.
            lift = img - images["default"]
            check(bool((lift >= -1e-6).all()) and (lift.max(axis=-1) > 1e-3).mean() > 0.05,
                  f"golden {scene}: no flare over the default frame")
        else:
            check((center.sum(axis=-1) < 0.05).mean() > 0.5,
                  f"golden {scene}: no dark shadow")
        images[scene] = img

    # 5. the main paths at full width
    path_launches = {}

    def cli_frame(tag, flags, expected):
        out_png = os.path.join("output", f"torch_fhd_{tag}.png")
        reset_counts()
        t0 = time.perf_counter()
        check(cli.main(["-r", "fhd", *flags, "-o", out_png]) == 0, "CLI exit code")
        launched = dict(launches)
        say(f"[fhd-cli {tag}] {' '.join(flags) or '(defaults)'}: wrote {out_png} "
            f"({os.path.getsize(out_png)} bytes) in {time.perf_counter() - t0:.2f} s; "
            f"{expected} launches {launched[expected]}")
        expect_launches(launched, expected, f"FHD {tag} frame")
        path_launches[expected] = launched[expected]

    cli_frame("default", [], "ray_march_slim")
    cli_frame("aa_flare", AA_FLAGS, "ray_march_aa")

    cfg = SceneConfig(resolution="fhd", device="cuda").validated()
    aa_cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-r", "fhd", *AA_FLAGS]))
    r_escape = escape_radius(cfg.r_max, cfg.pov)
    for tag, c in (("default", cfg), ("aa_flare", aa_cfg)):
        med, frame = stage_times(c)
        check(bool(torch.isfinite(frame).all()) and frame.shape == (1080, 1920, 3),
              f"FHD {tag} frame not finite or wrong shape")
        say(f"[fhd-frame {tag}] median ms over 3 frames: " + ", ".join(
            f"{k} {v:.3f}" for k, v in med.items()) + f"; total {sum(med.values()):.3f}")

    # A scene without a disk texture: lensing of the sky only.
    skybox, _, _ = load_or_generate_skybox(None, 2048, 1024, cfg.n_stars,
                                           seed=cfg.skybox_seed)
    nodisk = Renderer(cfg, skybox, None)
    reset_counts()
    sky_frame = nodisk.render(cfg.pov, cfg.fov)
    launched = dict(launches)
    say(f"[fhd-nodisk] Renderer without a disk texture: frame mean "
        f"{sky_frame.mean():.4f}; ray_march_nodisk launches "
        f"{launched['ray_march_nodisk']}")
    check(np.isfinite(sky_frame).all() and sky_frame.shape == (1080, 1920, 3),
          "FHD no-disk frame")
    expect_launches(launched, "ray_march_nodisk", "FHD no-disk frame")
    path_launches["ray_march_nodisk"] = launched["ray_march_nodisk"]

    # Every instantiation vs its plain version at FHD. The step-count
    # instantiations run on no frame's path: their path is this
    # diagnostic, counted over its timed kernel runs (warm-up + 3).
    # 6a. Then each one's row band 2 of 4 (rows 540-809) against the
    # plain band and those rows of the full-frame kernel trace.
    fhd, steps, traces, band_ms = {}, {}, {}, {}
    fhd_args = (1920, 1080, cfg.fov, cfg.disk_tilt, cfg.step_size, r_escape,
                cfg.disk_inner_radius, cfg.disk_outer_radius)
    band_rows = 1080 // TILES
    for name in KERNELS:
        reset_counts()
        res = trace_pair(name, *fhd_args, 3)
        launched = dict(launches)
        check_pair("1920x1080", name, res)
        others = {k: v for k, v in launched.items() if k != name and v}
        check(launched[name] == 4 and not others,
              f"FHD {name} pair launched {launched}, expected {name} 4 times")
        fhd[name] = res[2:]
        traces[name] = res[0]
        if name.endswith("_steps"):
            path_launches[name] = launched[name]
            steps[name] = res[0].steps.to(torch.float64)
        band_ms[name] = check_band(name, res[0], *fhd_args, 2 * band_rows,
                                   band_rows, 3)
        del res

    for name, s in steps.items():
        base = name.removesuffix("_steps")
        total = float(s.sum())
        # A warp is an 8x4 pixel patch (8x16 blocks) and runs as long as
        # its longest ray: the share of its lane-steps that are useful.
        warp_max = s.reshape(1080 // 4, 4, 1920 // 8, 8).amax(dim=(1, 3))
        lanes = total / (32 * float(warp_max.sum()))
        say(f"[fhd-steps] {name}: mean {float(s.mean()):.2f} p99 "
            f"{float(torch.quantile(s, 0.99)):.0f} max {int(s.max())} steps/ray; "
            f"warp lane efficiency {lanes:.4f}; "
            f"{total:.4e} ray-steps; {total / (fhd[base][0] * 1e-3):.4e} useful "
            f"ray-steps/s of {base} kernel time ({fhd[base][0]:.3f} ms), "
            f"{total / (fhd[name][0] * 1e-3):.4e} of its own ({fhd[name][0]:.3f} ms)")

    # The bound of each instantiation on this run's FHD data; the
    # instantiations without step counts trace the same geodesics as
    # their _steps twins (equal step counts, checked against the plain
    # version above).
    bounds = {}
    sel = slice(2 * band_rows * 1920, 3 * band_rows * 1920)
    for name in KERNELS:
        twin = name if name.endswith("_steps") else name + "_steps"
        band_trace = traces[name]._replace(
            captured=traces[name].captured[sel], escaped=traces[name].escaped[sel],
            hit_count=traces[name].hit_count[sel])
        bounds[name] = bound(name, steps[twin], traces[name])
        unfused = bound(name, steps[twin], traces[name], PEAK_FP32_UNFUSED)[0]
        band_bound = bound(name, steps[twin][sel], band_trace)
        band_unfused = bound(name, steps[twin][sel], band_trace,
                             PEAK_FP32_UNFUSED)[0]
        say(f"[bound 1920x1080] {name}: {bounds[name][0]:.4f} ms by "
            f"{bounds[name][1]}; kernel {fhd[name][0]:.3f} ms "
            f"({bounds[name][0] / fhd[name][0]:.1%} of the bound's rate; "
            f"{unfused / fhd[name][0]:.1%} at the unfused FP32 rate, "
            f"{unfused:.4f} ms); band 2 of {TILES}: {band_bound[0]:.4f} ms by "
            f"{band_bound[1]}, kernel {band_ms[name]:.3f} ms "
            f"({band_bound[0] / band_ms[name]:.1%}; unfused "
            f"{band_unfused / band_ms[name]:.1%})")
    del traces

    # 6b, 6c. the tile path
    path_launches["ray_march_aa"] += tile_phase(launches, reset_counts)

    # 7. results
    say(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "bhr_tpu_torch/csrc/ray_march.cu",
        "replaces": REPLACES,
        "launches": path_launches[name],
        "max_abs_err": max(fhd[name][2][2], fhd[name][2][3]),
        "ms": fhd[name][0],
        "plain_ms": fhd[name][1],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": None,  # no PyTorch call computes a ray march
    } for name in KERNELS]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
