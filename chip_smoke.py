#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # every phase; the bands of phase 6 go on
                             # cuda:0..3 where four cards are visible

Phases, one line (or a few) each; any failure raises and the script
exits non-zero without printing a result:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build the ray-march kernel template from ``bhr_tpu_torch/csrc`` and
   time it; ptxas registers and spills of each instantiation (a spill
   fails the run); each instantiation's loop in the SASS (``cuobjdump``):
   its instructions, the MUFU ones and the FFMA/FADD/FMUL ones, and the
   fewest instructions (MUFU ones) a surviving and a terminating step
   issue (``bhr_tpu_torch.bench.parse_sass_loops``); the SMs and their
   maximum clock, for the issue bounds of phase 5; (2b) the
   background-noise kernel (``csrc/background_noise.cu``, ptxas
   registers, a spill fails the run) against its plain version at the
   FHD (2912x416, s = 2) and 4K (5824x832, s = 4) textures, one frame at
   t = 0 and 7.3 and a video batch's four frames: unequal values by
   plane (0 expected), max |diff| within 1e-5, one launch a pass, the
   kernel's ms beside its bound (the plain version's FP32 operations, one
   a lane and a clock) and, not as a bound, beside the plain version's
   int32 operations at 64 INT32 lanes an SM, the plain pass's ms and aten
   calls (``background_phase``); (2c) the bloom kernel (``csrc/bloom.cu``,
   ptxas registers, a spill fails the run) against its plain version on
   the bg and disk layers of a rendered FHD default and 4K AA + flare
   frame: 0 unequal values and the largest difference, two launches a
   call, the kernel's ms beside its bound (the blur's FP32 operations,
   one a lane and a clock), the plain pass's ms and aten calls, and each
   pass's kernel launches, copies and kernels by name on the card
   (torch.profiler; a warm kernel pass makes no copy)
   (``bloom_phase``);
3. every instantiation (slim, AA, no disk, and each with step counts) vs
   its plain PyTorch version on the card, at the 128x32 tilt-15 parity
   scene and at the 320x180 golden scene, with the tolerances of
   ``bhr_tpu_torch.ops.trace_compare`` (``test_pallas_parity.py``'s
   bounds and the port's own additions; the reasons are in that module's
   docstring): categories
   (captured, escaped, hit_count) and step counts equal at 128x32, at
   most 0.1% of rays flipping or changing their step count at 320x180;
   on the rays that agree, escape direction and hit features 0..4 within
   2e-3, the AA differentials (features 5..10) within 5e-3 with a p99
   relative difference of at most 1e-3 over values above 1e-6, t_frac
   (feature 11, AA) within 2e-3 (the slim kernel leaves it zero, its
   plain version writes it). For AA, the negative control: the same
   check fed the kernel's trace with its x and y differentials swapped
   must fail;
4. the ``default``, ``aa`` and ``flare`` golden scenes through
   ``bhr_tpu_torch.modes.render_image`` on CUDA, each within max 5e-2 /
   mean 5e-4 of ``tests/goldens/e2e_cpu{,_aa,_flare}.npz``, with exactly
   one launch of the expected kernel and the scene's sanity checks; the
   V2 volume disk's ``v2`` and ``v2sci`` goldens the same way
   (``e2e_cpu_v2.npz``, ``e2e_cpu_v2sci.npz``): one ``ray_march_slim``
   launch each, no ``ray_march_nodisk`` launch and no plain trace call,
   and ``v2`` with ``anti_alias="lod_radius"`` launches ``ray_march_slim``
   too and is bit-equal to ``v2``;
5. the main paths at full width (1920x1080), each with the launch
   counts set to 0 just before it and read just after: the default frame
   and the ``--anti_alias lod_radius --lens_flare`` frame through
   ``bhr_tpu_torch.cli.main``, a Renderer without a disk texture, and the
   V2 stills ``--disk_model v2`` and ``--disk_model v2 --v2_structure
   --v2_palette scientific`` through ``cli.main`` (one ``ray_march_slim``
   launch each); the V2 frames' per-stage medians (trace, shade, post: a
   V2 frame has no texture stage), the device's busy share of a frame
   (torch.profiler, where it reports device time), the shade split per
   hit slot (the masked full-frame pass slot by slot, each slot's own
   hits alone, and all hits in one pass) with the rays per slot, and the
   peak memory of the masked and the one-pass shade;
   per-stage medians (CUDA events) of the default and the AA+flare
   frames; every instantiation vs its plain version at FHD (as phase 3,
   but the agreeing rays over a float tolerance count with the flips
   and step changes toward the 0.1%), the timed runs of the step-count
   instantiations counted as their path; steps per ray (mean, p99, max),
   the warps' lane efficiency and useful ray-steps per second of kernel
   time; for AA, where the differentials' relative difference comes
   from (split by distance from the photon ring and by the slot's size
   against its vector; the plain initial differentials against float64);
   each instantiation's bounds: FP32 operations at 67 TFLOP/s, the issue
   bound (the fewest instructions each step issues, over 132 SMs x 4
   schedulers x 32 lanes x the maximum SM clock) and the MUFU bound (16
   lanes per SM), and the kernel's share of each;
6. the tile path (``parallel.frames``): (a) every instantiation's FHD
   row band 2 of 4 (rows 540-809) against those rows of the full-frame
   kernel trace (the same per-ray code: equal) and against the plain
   band (FHD's tolerances), and each one's bounds; the AA kernels' 4K
   band 2 of 4 (rows 1080-1619 of 3840x2160, the shape of each of (c)'s
   launches) against the plain band (FHD's tolerances, with AA's split
   of the differentials' difference); (b) the ``default`` and ``aa``
   goldens through ``render_image_tiled`` in 4 bands (the goldens'
   bounds, exactly 4 launches); (c) the ``-r 4k --anti_alias lod_radius
   --aa_strength 1.0 --lens_flare`` still in 4 bands, with the counts
   set to 0 just before it and read just after (exactly 4
   ``ray_march_aa`` launches), within 2e-5 of the same frame rendered
   whole on cuda:0, with stage medians (CUDA events; the tiled stages
   as ``render_image_tiled``'s ``on_stage`` callback marks them) and peak
   memory of both; (d) the V2 disk in 4 bands: the ``v2`` golden (4
   ``ray_march_slim`` launches, the goldens' bounds) and the FHD and 4K
   V2 stills tiled against whole within 2e-5, with the whole frames' peak
   memory. The bands of (b), (c) and (d) run on cuda:0..3 where four
   cards are visible, else all on cuda:0;
7. the orbit video (``parallel/video.py``, ``modes.render_video``), with
   the plain trace's calls counted beside the kernels' launches (none is
   allowed): first the background noise of 4 frames in one pass, as the
   batched engine makes it, bit-equal to 4 per-frame calls at the FHD
   video's texture size, and the time of both; (a) the golden 8-frame orbit of ``tests/e2e_render.py``
   through ``render_video_sharded``, PNG frames 0 and 4 read back with
   ``decode_png_rgb8`` against ``tests/goldens/e2e_cpu_video.npz`` (max
   5e-2 / mean 5e-4), exactly 8 ``ray_march_slim`` launches; (b) resume:
   the same video in batches of 4, then frames 4-7 removed and
   ``progress.json`` cut back to frames 0-3, and a ``resume`` run: 4
   launches, all 8 PNGs byte-equal to the uninterrupted run's; a changed
   seed with ``resume`` wipes and renders 8; (c) the sequential engine
   (``frame_shards=1``) on the same scene: frame 0 within one uint8 step
   of the batched engine's; (d) at full width through
   ``bhr_tpu_torch.cli.main``, each with the counts set to 0 just before
   and read just after: ``--video --orbit -r fhd --n_frames 24 --fps 24``
   (24 ``ray_march_slim`` launches), the same with 8 frames and
   ``--anti_alias lod_radius --aa_strength 1.0 --lens_flare`` (8
   ``ray_march_aa``), and the 24 frames with ``--disk_model v2`` (24
   ``ray_march_slim``; no texture stage): wall seconds, frames/s end to end, the
   per-frame stage medians, the main thread's wait on the writers, which
   assembler finished the file (with the native one, ``probe_video`` must
   give the frame count and size), the zlib levels' time and size on one
   FHD frame, the default video through the sequential engine and,
   where several cards are visible, on one card beside all of them;
   (e) the golden orbit with ``disk_model="v2"``, structure on: batched
   against sequential within one uint8 step in every frame, a resume after frames 4-7 are removed (4
   launches, 8 of 8 PNGs byte-equal), a changed ``v2_samples`` with
   ``resume`` wipes and renders 8;
8. the interactive session (``interactive.py``) at full width, the FHD
   default scene, with the counts set to 0 just before each part and read
   just after, and no plain trace call allowed: (a) an
   ``InteractiveSession`` with lookahead for 12 steps, then the keys ``d``,
   ``b``, ``l``, ``6``, ``0``, ``+``, ``up`` with 3 steps after each: every
   frame (1080, 1920, 3) uint8 and lit, ``ray_march_slim`` launches = the
   steps with ``d`` off, ``ray_march_aa`` = the steps with it on, the first
   frame shown after a key is the one rendered after it; (b) the fused
   session's first frame against the staged one's (``fused=False``), both
   without lookahead: at most one uint8 step apart, also for the solo view
   of key ``6``; the render ms a frame of a fused session with and without
   lookahead, in turns; (c) a
   ``--disk_model v2`` session: ``ray_march_slim`` only, ``d`` inert
   (``D:n/a``); (d) ``run_http_preview`` in a thread on a port the system
   chose: ``/frame`` fetched over loopback and decoded with Pillow, the
   frame's size, its mean absolute difference from a submitted frame
   (under 8 of 255), ``/key?k=q`` ends the loop; the viewer's (JPEG) ms;
9. the multi-process fleet (``parallel.mesh.initialize_multihost``,
   ``render_video_sharded``'s fleet branches): two child processes, both
   on ``cuda:0``, joined on a free loopback port, each with its output in
   a file and a deadline past which it is killed and the run fails:
   (a) the golden orbit in batches of 6 (the last batch 2 frames and 4
   padding repeats): all 8 PNGs byte-equal to phase 7a's one-process run,
   no other PNG, ``progress.json`` complete and written by process 0
   alone, the video file assembled by process 0, each process's
   ``ray_march_slim`` launches (their sum = frames + padding) and plain
   trace calls (0); a second pass with ``resume`` renders nothing; the
   same with the V2 disk against a one-process run made here; (b) the
   CLI's guard: ``--interactive`` with ``--coordinator_address`` ends both
   with exit code 2 and "sharded orbit video"; (c) a failure injected
   into process 1's second batch ends it with exit code 1 and "aborting
   the fleet", and process 0 ends non-zero; (d) the FHD default video, 24
   frames, through ``cli.main`` in both processes: frames/s end to end
   beside phase 7d's one-process figures; where several cards are
   visible, also one process per card (``CUDA_VISIBLE_DEVICES=k``) beside
   one process over all cards;
10. the static disk of ``--disk_texture auto``, with the texture cache
   in a fresh directory under ``output/`` (removed at the end): (a) the
   random bits of ``ops/random.py`` made on the card bit-equal to the
   CPU's (the FHD pixel-noise draw, its uniform floats, a batched draw);
   the texture generated on the card at the golden scene's size (336x128)
   and at the FHD CLI size (2912x416, generation scale 2), each within
   1e-4 of the CPU port's texture and generated twice (cold, then warm:
   equal), with the ms of each generator (CUDA events at
   ``generate_component_fields``' ``on_stage`` marks), the device
   timeline and wall ms, the peak memory, the device's busy share and
   kernel count of one FHD generation (torch.profiler), and the 4K
   (5824x832) generation's time and peak memory; (b) the golden scene with
   ``disk_texture="auto"`` on the card against the CPU port's render
   (max 5e-2 / mean 5e-4), exactly one ``ray_march_slim`` launch, no
   plain trace call, a bright ring and a dark shadow; (c) ``-r fhd
   --disk_texture auto`` through ``cli.main`` cold (generated and saved)
   and warm (loaded: the cache file is not rewritten), and with the AA +
   flare flags (one ``ray_march_aa``), each with the counts set to 0
   just before it and read just after and no plain trace call; the cache
   file's size and load time; the warm frame's stage medians (trace,
   shade, post: no texture stage), host ms to enqueue and busy share; the
   still in 4 bands (4 ``ray_march_slim`` launches) within 2e-5 of the
   whole frame;
11. (a) the native PNG encoder (``csrc/fastpng.cpp``): it must build;
   its deflate backend; phase 5's FHD default frame encoded 5 times at
   level 2 and 5 times by the standard library's zlib at level 6, the
   median ms and the bytes of each, both decoded by ``decode_png_rgb8`` to
   the frame exactly; (b) the FHD V2 and the FHD default videos (24
   frames each, through ``cli.main``) each rendered twice, in turns, with
   the native encoder and with the zlib path (``native.png_available``
   patched to False, so ``save_image`` takes it): frames/s end to end,
   PNG median ms, the main thread's wait on the writers, 24
   ``ray_march_slim`` launches a video, the last frames equal; (c)
   ``bhr_tpu``'s nine extreme scenes (``EXTREME_SCENES``): each 96x64
   frame through the kernel (one ``ray_march_slim`` or ``ray_march_aa``
   launch, no plain trace) meets ``test_extreme_configs.py``'s conditions
   (finite, in [0, 1 + 1e-6], not constant; the fov 1 frame black) and
   lies within mean 5e-4 of the CPU port's frame, and the kernel against
   its plain version at 1920x1080 meets the FHD rule of phase 5 (AA with
   its negative control); (d) every tool of ``bhr_tpu_torch.tools`` at
   its default size on the card: exit code 0, its PNGs decoded and not
   black, its launches (``compare_aa``: one ``ray_march_slim`` and one
   ``ray_march_aa``; ``profile_pipeline``: 14 ``ray_march_slim``, and its
   stage lines), each with the counts set to 0 just before and read just
   after;
12. ``bhr_tpu_torch.bench``, short, with the counts set to 0 just
   before each measurement and read just after: ``time_trace`` slim and
   AA (the bench scene at FHD: kernel ms, Mray-steps/s, the FP32- and
   issue-bound shares, each in (0, 1.05]), ``time_resolution("sd", 4)``
   (median and spread of 5 batches), ``time_gather`` (no kernel of the
   port), each value a finite number and the launches what each
   measurement says it made;
13. the NaN trap of ``--debug_nans`` and the build cache (``[nans ...]``
   lines): (a) with the trap off and on in turns (off, on, on, off), the
   FHD CLI-default still (slim kernel), the FHD AA + flare still (AA
   kernel) and the FHD V2 still (each a frame of ``modes.render_image``'s
   renderer, its set-up outside the timed frame), one 4-frame batch of
   the FHD orbit video and one FHD session step: all four outputs
   bit-equal, no trap fired, the launches counted from 0 around each
   run, the host time to a synchronise with the trap on and off and the
   checks a frame, beside the card's name and power limit; (b) negative
   controls that must raise ``FloatingPointError`` naming their stage: a
   NaN skybox in a renderer made before the trap was on (``shade``), a
   NaN disk texture (``mips``), and the ``ray_march_slim`` kernel's
   outputs at 320x180 with one value made NaN after the launch
   (``trace[ray_march_slim]``); a NaN camera position there must leave
   the trap quiet: the kernel writes no NaN for it (every ray neither
   captured nor escaped, no hit), as its plain version does; (c) ``python -m bhr_tpu_torch.cli
   --no_compile_cache --debug_nans --width 320 --height 180`` in a
   process of its own exits 0 and builds ``ray_march`` afresh (its nvcc
   seconds) into a private directory that is gone after it, with
   ``bhr_tpu_torch/_build/`` holding the same files with the same
   mtimes; (d) ``bhr_tpu``'s three flags (``--debug_nans
   --compile_cache --no_compile_cache``) on a 4-frame ``--video
   --orbit`` exit 0 the same way;
14. a JSON line describing every instantiation at FHD (kernel, plain
   version, FP32-operation bound and issue bound times; ``launches`` sums
   the paths of phases 5, 6c, 6d, 7d, 8, 9, 10c, 11, 12 and 13a) and of
   the background-noise kernel at phase 2b's FHD frame (its ``launches``
   summed over the same paths; its issue bound null, not worked out; no
   pass on the card may have run the plain version) and of the bloom
   kernel at phase 2c's FHD frame (its ``launches`` summed over the same
   paths), then the result line ``{"ok": true, "device": {...}}`` as the
   last line.

Every path counted from 0 around it checks the background-noise and
bloom kernels' launches beside the ray march's (``KernelLaunches``): a
noise pass a lifecycle still or session step, one a card a lifecycle
video batch (the batches counted by ``counted_batches``; a fleet's
worker counts its own), none for the V2 disk or a static disk texture;
two bloom launches a frame posted with bloom (a tiled still once, a
session step only with B on).

Imports torch, numpy and bhr_tpu_torch only.
"""

from __future__ import annotations

import collections.abc
import contextlib
import io
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# The op model of the trace, the golden tables and golden_diff live in
# bhr_tpu_torch.bench (one place for the tools and this script).
from bhr_tpu_torch.bench import (  # noqa: E402
    GOLDEN,
    GOLDEN_VIDEO,
    ISSUE_LANES_PER_SM,
    MUFU_LANES_PER_SM,
    POV,
    SCENES,
    V2_SCENES,
    bound,
    device_busy_share,
    golden_diff,
    issue_bounds,
    sass_loop_counts,
    terminated,
)

V2_FLAGS = {"v2": ["--disk_model", "v2"],
            "v2sci": ["--disk_model", "v2", "--v2_structure", "--v2_palette",
                      "scientific"]}
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
# Kernel launches before a timed run: the first kernels after a
# host-bound phase ran up to ~18% slower than later ones at FHD.
WARMUP = 2
TOL_TILED = 2e-5  # tiled vs whole frame (test_sharded_frames.py's bound)
TRAP_TURNS = 3  # (off, on, on, off) turns of each path of phase 13a
FHD_VIDEOS = (("default", 24, [], "ray_march_slim"),
              ("aa_flare", 8, AA_FLAGS, "ray_march_aa"),
              ("v2", 24, V2_FLAGS["v2"], "ray_march_slim"))

# The extreme but legal scenes of tests/unit/test_extreme_configs.py
# (copied: that test imports JAX), each on its 96x64 frame with a 256x128
# sky of 200 stars (seed 5) and a random 24x64 disk (default_rng(2)):
# tag -> SceneConfig changes from fov 60, pov (6, 0, 0.5), disk 2-3.5.
EXTREME_SCENES = {
    "tilt 89": dict(disk_tilt=89.0),
    "fov 170": dict(fov=170.0),
    "fov 1": dict(fov=1.0),  # sees only the shadow: an all-black frame
    "camera r 2.2": dict(pov=(2.2, 0.0, 0.1)),
    "camera r 40": dict(pov=(40.0, 0.0, 5.0), r_max=50.0),
    "disk 1.05-1.2": dict(disk_inner_radius=1.05, disk_outer_radius=1.2),
    "step 1.0": dict(step_size=1.0),
    "aa strength 2": dict(anti_alias="lod_radius", aa_strength=2.0),
    "lens flare": dict(lens_flare=True),
}
EXTREME_FRAME = (96, 64)

def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAIL: {msg}")


def cuda_ms(fn, reps: int = 1):
    """(result of the last call, mean device ms per call) via CUDA events.
    Each call's result is dropped before the next call allocates its own,
    so the caching allocator hands back the same blocks and no timed call
    waits for a new device allocation."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = None
    for _ in range(reps):
        out = None
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def camera_tensor(w, h, fov, device="cuda", pov=POV):
    """The 14 camera floats of the camera at ``pov`` on ``device``."""
    from bhr_tpu_torch.camera import build_camera
    from bhr_tpu_torch.ops.geodesic_cuda import camera_params

    return torch.as_tensor(camera_params(build_camera(pov, fov, w, h)),
                           device=device)


def trace_pair(name, w, h, fov, tilt, h_base, r_escape, r_inner, r_outer, reps,
               pov=POV):
    """Kernel ``name`` and its plain version on the same camera tensor on
    the card -> (kernel, plain, kernel ms, plain ms)."""
    from bhr_tpu_torch.ops.geodesic import (
        primary_differentials_from_params,
        primary_rays_from_params,
        trace_geodesics,
    )
    from bhr_tpu_torch.ops.geodesic_cuda import trace_geodesics_cuda

    cam = camera_tensor(w, h, fov, pov=pov)
    kw = dict(h_base=h_base, r_escape=r_escape, tilt_deg=tilt, r_inner=r_inner,
              r_outer=r_outer, **VARIANTS[name])
    for _ in range(WARMUP):
        trace_geodesics_cuda(cam, width=w, height=h, **kw)
    kernel, k_ms = cuda_ms(lambda: trace_geodesics_cuda(cam, width=w, height=h, **kw),
                           reps)

    def plain_fn():
        dirs = primary_rays_from_params(cam, w, h)
        ddx, ddy = primary_differentials_from_params(cam, w, h)
        return trace_geodesics(cam[0:3], dirs, d_dir_dx0=ddx, d_dir_dy0=ddy, **kw)

    plain, p_ms = cuda_ms(plain_fn)
    return kernel, plain, k_ms, p_ms


def n_feat_of(name):
    """Hit features a kernel shares with its plain version: the slim
    kernel leaves t_frac (feature 11) zero, its plain version writes it."""
    return 11 if name.startswith("ray_march_slim") else 12


def check_diff(what, name, d, exact, outliers_allowed):
    """Print a TraceDiff and fail on what it breaks of the tolerances."""
    from bhr_tpu_torch.ops.trace_compare import failures

    say(f"[{what}] {name}: flipped rays {d.flips}, step-count mismatches "
        f"{d.steps_differ}, agreeing rays over a float tolerance {d.over} "
        f"({(d.flips + d.steps_differ + d.over) / d.n_rays:.4%} of {d.n_rays}); "
        f"largest escape dir / features 0..4 diff {d.float_err:.3e}, "
        f"differentials {d.diff_err:.3e} (p99 relative {d.diff_rel_p99:.3e}), "
        f"t_frac {d.tfrac_err:.3e}")
    bad = failures(d, exact=exact, outliers_allowed=outliers_allowed)
    check(not bad, f"{what} {name}: {'; '.join(bad)}")


def check_control(what, kernel, plain):
    """The negative control: the kernel's AA trace with its x and y
    differentials swapped must fail the differential checks."""
    from bhr_tpu_torch.ops.trace_compare import (
        compare_traces,
        failures,
        swap_differentials,
    )

    d = compare_traces(swap_differentials(kernel), plain)
    bad = failures(d, exact=False, outliers_allowed=True)
    say(f"[{what}] negative control (x, y differentials swapped): {d.over} "
        f"rays over an absolute tolerance, p99 relative difference of the "
        f"others {d.diff_rel_p99:.3e}, largest {d.diff_err:.3e} -> "
        f"{'rejected' if bad else 'ACCEPTED'}")
    check(bool(bad), f"{what}: swapped differentials pass the checks")


def initial_differentials_f64(cam, w, h, row_start, rows):
    """The one-pixel direction deltas normalize(ray through (col + 1.5,
    row + 0.5)) - normalize(ray through the pixel's center), and likewise
    in y, in float64 from the 14 camera floats: the reference for the
    float32 initial differentials' own rounding error."""
    c = cam.to(torch.float64)
    centre, right, up, fwd = c[0:3], c[3:6], c[6:9], c[9:12]
    pw, ph = c[12], c[13]
    top_left = centre + fwd - right * (pw * w / 2) + up * (ph * h / 2)
    col = torch.arange(w, dtype=torch.float64, device=c.device)[None, :, None]
    row = torch.arange(row_start, row_start + rows, dtype=torch.float64,
                       device=c.device)[:, None, None]

    def unit(ox, oy):
        v = top_left + (col + ox) * pw * right - (row + oy) * ph * up - centre
        return (v / v.norm(dim=-1, keepdim=True)).reshape(-1, 3)

    v = unit(0.5, 0.5)
    return unit(1.5, 0.5) - v, unit(0.5, 1.5) - v


def differential_error_causes(what, kernel, plain, cam, w, h, row_start=0,
                              rows=None):
    """Where the AA differentials' relative difference (kernel vs plain)
    comes from, printed: its p99 over the inlier rays split by the ray's
    impact parameter b = |dir x pos| (near the photon ring, |b/b_c - 1| <
    2%, or away from it) and by the slot's size against its 3-vector
    (components under 1e-3 of the vector's norm, where a rounding error
    of the vector is large against the component); and the plain
    version's initial differentials against the same deltas in float64."""
    from bhr_tpu_torch.constants import RS
    from bhr_tpu_torch.ops.geodesic import (
        primary_differentials_from_params,
        primary_rays_from_params,
    )
    from bhr_tpu_torch.ops.trace_compare import (
        DIFF_FLOOR,
        diff_rel_p99,
        inlier_rays,
        p99,
    )

    rows = h if rows is None else rows
    dirs = primary_rays_from_params(cam, w, h, row_start, rows)
    b = torch.linalg.cross(dirs, cam[0:3].expand_as(dirs)).norm(dim=1)
    near_ring = ((b / (1.5 * 3 ** 0.5 * RS) - 1).abs() < 0.02)[None, None]
    k = kernel.hits.shape[0]
    inliers = inlier_rays(kernel, plain)[None, None].expand(k, 6, -1)
    ref = plain.hits[:, 5:11]
    norm = ref.reshape(k, 2, 3, -1).norm(dim=2).repeat_interleave(3, dim=1)
    small = ref.abs() < 1e-3 * norm
    parts = {"all": inliers, "near the photon ring": inliers & near_ring,
             "away from it": inliers & ~near_ring,
             "components under 1e-3 of their vector": inliers & small,
             "the other components": inliers & ~small}
    say(f"[{what}] differentials' p99 relative difference over slots > "
        f"{DIFF_FLOOR:g}: " + "; ".join(
            f"{part} {diff_rel_p99(kernel, plain, sel):.3e} "
            f"({int((sel & (ref.abs() > DIFF_FLOOR)).sum())} slots)"
            for part, sel in parts.items()))
    got = primary_differentials_from_params(cam, w, h, row_start, rows)
    exact = initial_differentials_f64(cam, w, h, row_start, rows)
    err = torch.cat([(g.double() - e).abs() for g, e in zip(got, exact)], 1)
    size = torch.cat(exact, 1).abs()
    sel = size > DIFF_FLOOR
    say(f"[{what}] plain initial differentials vs float64: largest "
        f"{float(err.max()):.3e} (values up to {float(size.max()):.3e}), "
        f"p99 relative {p99(err[sel] / size[sel]):.3e}")


def check_pair(tag, name, result, exact, outliers_allowed):
    from bhr_tpu_torch.ops.trace_compare import compare_traces

    kernel, plain, k_ms, p_ms = result
    say(f"[kernel-vs-plain {tag}] {name}: kernel {k_ms:.3f} ms plain {p_ms:.3f} ms")
    d = compare_traces(kernel, plain, n_feat_of(name))
    check_diff(f"kernel-vs-plain {tag}", name, d, exact, outliers_allowed)
    if name.startswith("ray_march_aa"):
        check_control(f"kernel-vs-plain {tag} {name}", kernel, plain)
    if "nodisk" in name:
        check(not bool(kernel.hits.any()) and not bool(kernel.hit_count.any()),
              f"{tag} {name}: hits recorded without a disk")
    check((kernel.steps is not None) == name.endswith("_steps"),
          f"{tag} {name}: steps output")
    return d


BACKGROUND = "background_noise"  # the background-noise kernel's count
BLOOM = "bloom"  # the bloom kernel's count: two launches a frame posted with bloom


class KernelLaunches(collections.abc.Mapping):
    """The launches of every hand-written kernel since the last
    ``reset()``: each ray-march instantiation's
    (``trace_geodesics_cuda.launches``), under ``BACKGROUND`` the
    background-noise kernel's (``generate_background_components.launches``)
    and under ``BLOOM`` the bloom kernel's (``bloom_composite.launches``).
    A check that no other kernel ran thus covers the noise and the bloom
    too: a path states how many noise passes it makes (one a lifecycle
    still or session step, one a card a video batch, none for V2 or a
    static disk) and how many frames it posts with bloom (two launches
    each: every frame of a still, a video or a session with B on; a
    tiled still once, over the whole frame)."""

    def __init__(self):
        from bhr_tpu_torch.ops.background import generate_background_components
        from bhr_tpu_torch.ops.bloom import bloom_composite
        from bhr_tpu_torch.ops.geodesic_cuda import trace_geodesics_cuda

        self._trace = trace_geodesics_cuda.launches  # per instantiation
        self._counted = {BACKGROUND: generate_background_components, BLOOM: bloom_composite}

    def __getitem__(self, name):
        return self._counted[name].launches if name in self._counted else self._trace[name]

    def __iter__(self):
        return iter((*self._trace, *self._counted))

    def __len__(self):
        return len(self._trace) + len(self._counted)

    def reset(self):
        self._trace.update(dict.fromkeys(self._trace, 0))
        for fn in self._counted.values():
            fn.launches = 0


def expect_launches(counts: dict, name: str, what: str, background: int = 0) -> None:
    """One still frame: ``name`` once, the noise ``background`` times, one
    bloom (two launches), nothing else."""
    others = {k: v for k, v in counts.items() if k not in (name, BACKGROUND, BLOOM) and v}
    check(counts[name] == 1 and counts[BACKGROUND] == background
          and counts[BLOOM] == 2 and not others,
          f"{what} launched {counts}, expected {name} exactly once, "
          f"{BACKGROUND} {background} times and {BLOOM} twice")


@contextlib.contextmanager
def counted_calls(module, name):
    """Counts the calls of ``module.<name>`` made while the block runs ->
    a one-element list holding the count."""
    calls = [0]
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def counted_batches():
    """The batched video engine's batches (``render_video_frames_sharded``
    calls), counted as ``counted_calls``. A lifecycle batch makes one
    background-noise pass on each card."""
    from bhr_tpu_torch.parallel import video

    return counted_calls(video, "render_video_frames_sharded")


def counted_plain_traces():
    """The plain trace's calls made through the kernel's wrapper, counted
    as ``counted_calls``."""
    from bhr_tpu_torch.ops import geodesic_cuda

    return counted_calls(geodesic_cuda, "trace_geodesics")


def static_stage_times(cfg, frames: int = 4):
    """The stages of a frame without a texture stage (a V2 frame, or one
    with the static ``--disk_texture auto`` disk): median ms over frames
    1.. (frame 0 warms up) with CUDA events, the median host ms to
    enqueue a frame, the device's busy share of one more frame and the
    kernels and copies it ran (``device_busy_share``), and the last
    frame."""
    from bhr_tpu_torch.config import escape_radius
    from bhr_tpu_torch.modes import _make_renderer

    renderer, dynamic = _make_renderer(cfg)
    check(dynamic is None and (renderer.disk_mips is None) == (cfg.disk_model == "v2"),
          "a scene without a texture stage made a lifecycle system, or its "
          "disk texture is missing or unexpected")
    r_escape = escape_radius(cfg.r_max, cfg.pov)
    stages = {"trace": [], "shade": [], "post": []}
    host, frame = [], None
    for i in range(frames):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        camera = renderer.camera(cfg.pov, cfg.fov)
        trace = renderer.trace(camera, r_escape, cfg.use_ray_differentials)
        ev[1].record()
        bg, disk = renderer.shade(trace, camera, 0, cfg.use_ray_differentials)
        ev[2].record()
        frame = renderer.post(bg, disk, True, cfg.lens_flare)[0]
        ev[3].record()
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        if i:
            host.append(enqueued * 1e3)
            for j, name in enumerate(stages):
                stages[name].append(ev[j].elapsed_time(ev[j + 1]))
    busy = device_busy_share(lambda: renderer.render_device(cfg.pov, cfg.fov))
    return ({k: statistics.median(v) for k, v in stages.items()},
            statistics.median(host), *busy, frame)


def v2_shade_split(cfg, tag):
    """The V2 shade of ``cfg``'s frame, split per hit slot, on one kernel
    trace: the masked full-frame pass slot by slot (CUDA events at
    ``on_slot``), each slot's own hits alone, all hits in one pass (what
    the renderer runs), the rays per slot and the peak memory of the
    masked and the one-pass shade; the two must agree."""
    from bhr_tpu_torch.config import escape_radius
    from bhr_tpu_torch.modes import _make_renderer
    from bhr_tpu_torch.pipeline import (
        _shade_frame_v2_masked, shade_frame_v2, v2_shade_args)

    renderer, _ = _make_renderer(cfg)
    camera = renderer.camera(cfg.pov, cfg.fov)
    trace = renderer.trace(camera, escape_radius(cfg.r_max, cfg.pov), False)
    cam_pos = torch.as_tensor(camera.pos, device="cuda")
    args = dict(v2_shade_args(cfg), t_offset=0.0)
    n = trace.hit_count.numel()

    def shade(tr, masked=False, **kw):
        fn = _shade_frame_v2_masked if masked else shade_frame_v2
        return fn(tr, renderer.skybox, cam_pos, **args, **kw)

    counts = []
    shade(trace, on_slot=lambda k, m: counts.append(m))  # also warms up
    shade(trace, masked=True)
    marks = []

    def mark(k, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    peaks = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    masked = shade(trace, masked=True, on_slot=mark)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    peaks["masked"] = torch.cuda.max_memory_allocated()
    masked_ms = [a.elapsed_time(b) for a, b in zip([start, *marks], marks)]
    sky_ms = marks[-1].elapsed_time(end)
    masked_total = start.elapsed_time(end)
    torch.cuda.reset_peak_memory_stats()
    merged, merged_ms = cuda_ms(lambda: shade(trace), 3)
    peaks["one pass"] = torch.cuda.max_memory_allocated()
    alone_ms = []
    for k in range(len(counts)):
        only_k = trace._replace(hits=trace.hits[k:k + 1],
                                hit_count=(trace.hit_count > k).to(torch.int32))
        shade(only_k)
        alone_ms.append(cuda_ms(lambda: shade(only_k), 3)[1] - sky_ms)
    err = max(float((a - b).abs().max()) for a, b in zip(masked, merged))
    say(f"[fhd-v2 shade {tag}] rays per slot {counts} of {n} "
        f"({', '.join(f'{c / n:.2%}' for c in counts)}); masked full-frame pass "
        f"per slot ms {', '.join(f'{t:.3f}' for t in masked_ms)} + sky "
        f"{sky_ms:.3f} = {masked_total:.3f}; each slot's own hits alone ms "
        f"{', '.join(f'{t:.3f}' for t in alone_ms)} (sky taken off); all hits in "
        f"one pass, sky included: {merged_ms:.3f} ms; one pass vs masked max "
        f"{err:.3e}; peak memory masked {peaks['masked'] / 2**30:.3f} GiB, one "
        f"pass {peaks['one pass'] / 2**30:.3f} GiB")
    check(len(counts) == len(masked_ms) and counts[0] > 0.05 * n,
          f"V2 shade {tag}: slots {counts}")
    check(err <= 1e-5, f"V2 shade {tag}: one pass vs masked {err}")


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
               row_start, rows, reps, device="cuda"):
    """Kernel ``name``'s row band [row_start, row_start + rows) against
    those rows of ``full``, the full-frame kernel trace of the same
    camera (the same per-ray code: must be equal; None skips this), and
    against the plain band (the full frame's tolerances; for AA, where
    its differences come from is printed first). -> band kernel ms (the
    plain band's ms is printed)."""
    from bhr_tpu_torch.ops.geodesic import (
        primary_differentials_from_params,
        primary_rays_from_params,
        trace_geodesics,
    )
    from bhr_tpu_torch.ops.geodesic_cuda import trace_geodesics_cuda
    from bhr_tpu_torch.ops.trace_compare import compare_traces

    cam = camera_tensor(w, h, fov, device)
    kw = dict(h_base=h_base, r_escape=r_escape, tilt_deg=tilt, r_inner=r_inner,
              r_outer=r_outer, **VARIANTS[name])

    def band_fn():
        return trace_geodesics_cuda(cam, row_start, row_count=rows, width=w,
                                    height=h, **kw)

    def plain_fn():
        dirs = primary_rays_from_params(cam, w, h, row_start, rows)
        ddx, ddy = primary_differentials_from_params(cam, w, h, row_start, rows)
        return trace_geodesics(cam[0:3], dirs, d_dir_dx0=ddx, d_dir_dy0=ddy, **kw)

    for _ in range(WARMUP):
        band_fn()
    band, ms = cuda_ms(band_fn, reps)
    plain, p_ms = cuda_ms(plain_fn)
    what = f"tile-band {w}x{h} rows {row_start}-{row_start + rows - 1}"
    if full is not None:
        sel = slice(row_start * w, (row_start + rows) * w)
        rows_of_full = full._replace(
            **{f: getattr(full, f)[sel] for f in ("captured", "escaped",
                                                   "escape_dir", "hit_count")},
            hits=full.hits[:, :, sel],
            steps=None if full.steps is None else full.steps[sel])
        for field in ("captured", "escaped", "escape_dir", "hit_count", "hits",
                      "steps"):
            got, ref = getattr(band, field), getattr(rows_of_full, field)
            check(got is None and ref is None or torch.equal(got, ref),
                  f"{what} {name}: {field} differs from the full-frame kernel's rows")
        say(f"[{what}] {name} vs full-frame kernel rows: equal")
    if name == "ray_march_aa":
        differential_error_causes(f"{what} vs plain band {name}", band, plain,
                                  cam, w, h, row_start, rows)
    check_diff(f"{what} vs plain band", name,
               compare_traces(band, plain, n_feat_of(name)), exact=False,
               outliers_allowed=True)
    if name.startswith("ray_march_aa"):
        check_control(f"{what} vs plain band {name}", band, plain)
    check(band.captured.shape == (rows * w,), f"{name} band shape")
    say(f"[tile-band {w}x{h}] {name}: band kernel {ms:.3f} ms plain {p_ms:.3f} ms "
        f"({rows} of {h} rows)")
    return ms


def tile_phase(launches, reset_counts) -> dict:
    """Phases 6b and 6c on cuda:0..TILES-1 where that many cards are
    visible, else on cuda:0 alone, then phase 6d; -> {kernel: launches of
    the 4K path (ray_march_aa, its one background pass) and of the V2
    stills (their ray_march_slim bands)}. A tiled lifecycle still makes
    its background noise once, for all its bands."""
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
    bloom_launches = 0
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
            f"{expected} launches {launched[expected]}, {BACKGROUND} "
            f"{launched[BACKGROUND]}")
        check(img.shape == (180, 320, 3) and np.isfinite(img).all(),
              f"tiled golden {scene} shape/finite")
        check(diff.max() <= 5e-2 and diff.mean() <= 5e-4,
              f"tiled golden {scene} outside bounds")
        others = {k: v for k, v in launched.items()
                  if k not in (expected, BACKGROUND, BLOOM) and v}
        check(launched[expected] == TILES and launched[BACKGROUND] == 1
              and launched[BLOOM] == 2 and not others,
              f"tiled golden {scene} launched {launched}, expected {expected} "
              f"{TILES} times, {BACKGROUND} once and {BLOOM} twice")
        bloom_launches += launched[BLOOM]

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
    others = {k: v for k, v in launched.items()
              if k not in ("ray_march_aa", BACKGROUND, BLOOM) and v}
    say(f"[tiles 4k] {' '.join(flags_4k)} --tile_shards {TILES}: "
        f"{t_tiled:.2f} s; ray_march_aa launches {launched['ray_march_aa']}, "
        f"{BACKGROUND} {launched[BACKGROUND]}, {BLOOM} {launched[BLOOM]}")
    check(launched["ray_march_aa"] == TILES and launched[BACKGROUND] == 1
          and launched[BLOOM] == 2 and not others, f"4K tiled frame launched "
          f"{launched}, expected ray_march_aa {TILES} times, {BACKGROUND} once "
          f"and {BLOOM} twice")
    bloom_launches += launched[BLOOM]
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
    v2_slim, v2_bloom = v2_tile_phase(launches, reset_counts, tile_devs)
    return {"ray_march_aa": launched["ray_march_aa"],
            BACKGROUND: launched[BACKGROUND],
            "ray_march_slim": v2_slim, BLOOM: bloom_launches + v2_bloom}


def v2_tile_phase(launches, reset_counts, tile_devs) -> tuple:
    """Phase 6d: the V2 disk in TILES row bands -> the ray_march_slim band
    launches and the bloom launches of the FHD and 4K V2 stills."""
    import bhr_tpu_torch.cli as cli
    from bhr_tpu_torch.config import SceneConfig
    from bhr_tpu_torch.modes import render_image
    from bhr_tpu_torch.parallel.frames import render_image_tiled

    def tiled_vs_whole(what, tiled_cfg, whole_cfg, shape):
        with counted_plain_traces() as plain_calls:
            reset_counts()
            tiled = render_image_tiled(tiled_cfg, devices=tile_devs)
            launched = dict(launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        whole = render_image(whole_cfg)
        peak = torch.cuda.max_memory_allocated()
        diff = np.abs(tiled - whole)
        say(f"[tiles {what}] {TILES} bands vs the whole frame: max "
            f"{diff.max():.3e}, {int((diff > 0).any(axis=-1).sum())} of "
            f"{diff.shape[0] * diff.shape[1]} pixels differ; ray_march_slim band "
            f"launches {launched['ray_march_slim']}, plain trace calls "
            f"{plain_calls[0]}; whole frame's peak memory {peak / 2**30:.3f} GiB")
        check(tiled.shape == shape and np.isfinite(tiled).all()
              and tiled.max() > 0.5, f"tiled {what}: shape, finite or dark")
        check(diff.max() <= TOL_TILED, f"tiled {what} vs whole {diff.max()}")
        others = {k: v for k, v in launched.items()
                  if k not in ("ray_march_slim", BLOOM) and v}
        check(launched["ray_march_slim"] == TILES and launched[BLOOM] == 2
              and not others and not plain_calls[0],
              f"tiled {what} launched {launched}, plain {plain_calls[0]}")
        return tiled, launched

    golden = {**GOLDEN, **V2_SCENES["v2"]}
    img, launched = tiled_vs_whole(
        "golden v2", SceneConfig(device="cuda", tile_shards=TILES, **golden),
        SceneConfig(device="cuda", **golden), (180, 320, 3))
    n_bloom = launched[BLOOM]
    d_max, d_mean = golden_diff(img, "e2e_cpu_v2")
    say(f"[tiles golden v2] vs e2e_cpu_v2.npz max {d_max:.3e} mean {d_mean:.3e}")
    check(d_max <= 5e-2 and d_mean <= 5e-4, "tiled golden v2 outside bounds")
    n_launched = 0
    for res, shape in (("fhd", (1080, 1920, 3)), ("4k", (2160, 3840, 3))):
        flags = ["-r", res, *V2_FLAGS["v2sci"]]
        parse = cli.build_parser().parse_args
        _, launched = tiled_vs_whole(
            f"{res} v2sci",
            cli.config_from_args(parse([*flags, "--tile_shards", str(TILES)])),
            cli.config_from_args(parse(flags)), shape)
        n_launched += launched["ray_march_slim"]
        n_bloom += launched[BLOOM]
    return n_launched, n_bloom


class _Tee(io.StringIO):
    """Keeps what is printed while passing it on."""

    def write(self, text):
        sys.__stdout__.write(text)
        sys.__stdout__.flush()
        return super().write(text)


def expect_video_launches(counts, name, n, background, plain_calls, what):
    """``n`` frames traced (padding included), each posted with bloom."""
    others = {k: v for k, v in counts.items()
              if k not in (name, BACKGROUND, BLOOM) and v}
    check(counts[name] == n and counts[BACKGROUND] == background
          and counts[BLOOM] == 2 * n and not others and not plain_calls[0],
          f"{what} launched {counts} and ran the plain trace {plain_calls[0]} "
          f"times, expected {name} {n} times, {BACKGROUND} {background} times, "
          f"{BLOOM} {2 * n} times and nothing else")


def cli_video(argv, reset, launches):
    """``cli.main(argv)`` of a video, with the counts set to 0 just before
    (``reset``) and read just after -> (its "Video stats:" line as a
    dict, the launches, the batched engine's batches)."""
    import bhr_tpu_torch.cli as cli

    tee = _Tee()
    reset()
    with contextlib.redirect_stdout(tee), counted_batches() as batches:
        check(cli.main(argv) == 0, "CLI exit code")
    launched = dict(launches)
    lines = [ln for ln in tee.getvalue().splitlines()
             if ln.startswith("Video stats: ")]
    check(len(lines) == 1, f"{' '.join(argv)}: no stats line")
    return json.loads(lines[0][len("Video stats: "):]), launched, batches[0]


def video_phase(launches, reset_counts) -> tuple:
    """Phase 7; -> ({kernel: launches of the full-width video paths},
    {tag: the statistics of each full-width video})."""
    import dataclasses

    import bhr_tpu_torch.cli as cli
    from bhr_tpu_torch import native
    from bhr_tpu_torch.config import SceneConfig
    from bhr_tpu_torch.modes import render_video, video_temp_paths
    from bhr_tpu_torch.parallel.video import render_video_sharded
    from bhr_tpu_torch.utils.io import (
        decode_png_rgb8,
        encode_png_rgb8,
        load_png_rgb8,
        write_json_atomic,
    )

    # Every call of the plain trace, and every batch of the batched
    # engine, is counted while the videos render. The golden videos run on
    # one card (frame_shards 1): a lifecycle batch is one background pass,
    # a sequential frame one, a V2 frame none.
    counting = contextlib.ExitStack()
    plain_calls = counting.enter_context(counted_plain_traces())
    batches = counting.enter_context(counted_batches())

    def reset():
        reset_counts()
        plain_calls[0] = 0
        batches[0] = 0

    def frame_files(cfg):
        temp_dir, progress_file = video_temp_paths(cfg.output)
        return [os.path.join(temp_dir, f"frame_{f:04d}.png")
                for f in range(cfg.n_frames)], progress_file

    def read_bytes(paths):
        out = []
        for path in paths:
            with open(path, "rb") as f:
                out.append(f.read())
        return out

    def video_cfg(name, **changes):
        return SceneConfig(device="cuda", output=os.path.join(
            "output", "torch_video", f"{name}.mp4"), **{**GOLDEN_VIDEO, **changes})

    # The batched engine makes the background noise of a batch's frames in
    # one pass over a leading frame axis: at the FHD video's texture size
    # it must equal the per-frame calls bit for bit.
    from bhr_tpu_torch.config import compute_disk_texture_resolution
    from bhr_tpu_torch.ops.background import generate_background_components

    n_phi, n_r = compute_disk_texture_resolution(1920, 1080, POV, 90.0, 2.0, 15.0)
    times = np.asarray([f * 0.1 for f in (20, 21, 22, 23)], np.float32)
    bg_args = (n_r, n_phi, 3.0, 2.7, 2.0, 15.0)
    bg_kw = dict(generation_scale=2, device="cuda")
    generate_background_components(*bg_args, times, **bg_kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = generate_background_components(*bg_args, times, **bg_kw)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [generate_background_components(*bg_args, float(t), **bg_kw)
               for t in times]
    torch.cuda.synchronize()
    t_singles = time.perf_counter() - t0
    equal = [bool(torch.equal(batch[i], one)) for i, one in enumerate(singles)]
    say(f"[video background] {n_phi}x{n_r} noise of 4 frames: one pass "
        f"{t_batch * 1e3:.1f} ms, 4 per-frame calls {t_singles * 1e3:.1f} ms "
        f"(host clock, synchronized); bit-equal {equal}")
    check(all(equal), "the batch's background differs from the per-frame calls")
    del batch, singles

    try:
        # 7a. the golden video through the batched engine
        cfg = video_cfg("golden")
        reset()
        stats = render_video_sharded(cfg)
        launched = dict(launches)
        paths, _ = frame_files(cfg)
        img = np.concatenate([load_png_rgb8(paths[f]).astype(np.float32) / 255.0
                              for f in (0, 4)], axis=0)
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      "e2e_cpu_video.npz"))["image"]
        check(img.shape == golden.shape == (360, 320, 3), f"golden video {img.shape}")
        diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
        say(f"[video golden] PNG frames 0 and 4 vs e2e_cpu_video.npz max "
            f"{diff.max():.3e} mean {diff.mean():.3e}; ray_march_slim launches "
            f"{launched['ray_march_slim']}; assembler {stats['assembler']}")
        check(diff.max() <= 5e-2 and diff.mean() <= 5e-4,
              "golden video outside bounds")
        check(stats["frames"] == 8 and stats["padded"] == 0, f"golden video {stats}")
        check(batches[0] == 1, f"golden video: {batches[0]} batches")
        expect_video_launches(launched, "ray_march_slim", 8, 1, plain_calls,
                              "golden video")
        one_batch = read_bytes(paths)

        # 7b. resume: batches of 4, the second batch lost, then a changed seed
        cfg = video_cfg("resume", frames_per_dispatch=4)
        reset()
        render_video_sharded(cfg)
        check(batches[0] == 2, f"video in batches of 4: {batches[0]} batches")
        expect_video_launches(dict(launches), "ray_march_slim", 8, 2, plain_calls,
                              "video in batches of 4")
        paths, progress_file = frame_files(cfg)
        whole = read_bytes(paths)
        check(whole == one_batch, "frames differ between batches of 8 and of 4")
        for path in paths[4:]:
            os.remove(path)
        with open(progress_file) as f:
            progress = json.load(f)
        check(progress["completed"] == list(range(8)), f"progress {progress}")
        write_json_atomic(progress_file, dict(progress, completed=[0, 1, 2, 3]))
        reset()
        stats = render_video_sharded(dataclasses.replace(cfg, resume=True))
        launched = dict(launches)
        resumed = read_bytes(paths)
        say(f"[video resume] frames 4-7 rendered again: ray_march_slim launches "
            f"{launched['ray_march_slim']}; {sum(a == b for a, b in zip(whole, resumed))} "
            f"of 8 PNGs byte-equal to the uninterrupted run's; assembler "
            f"{stats['assembler']}")
        check(stats["frames"] == 4, f"resume rendered {stats['frames']} frames")
        expect_video_launches(launched, "ray_march_slim", 4, 1, plain_calls,
                              "resume")
        check(resumed == whole, "resumed PNGs differ from the uninterrupted run's")
        reset()
        stats = render_video_sharded(dataclasses.replace(cfg, resume=True, seed=7))
        launched = dict(launches)
        say(f"[video resume] changed seed with resume: wiped, "
            f"{stats['frames']} frames, ray_march_slim launches "
            f"{launched['ray_march_slim']}")
        expect_video_launches(launched, "ray_march_slim", 8, 2, plain_calls,
                              "resume with a changed seed")
        check(stats["frames"] == 8 and read_bytes(paths)[0] != whole[0],
              "a changed seed did not render the video anew")

        # 7c. the sequential engine on the same scene
        cfg = video_cfg("sequential")
        reset()
        stats = render_video(cfg)
        launched = dict(launches)
        paths, _ = frame_files(cfg)
        a = load_png_rgb8(paths[0]).astype(np.int32)
        b = decode_png_rgb8(one_batch[0]).astype(np.int32)
        say(f"[video engines] sequential vs batched frame 0: "
            f"{(a != b).mean():.4%} of values differ, largest step "
            f"{np.abs(a - b).max()}; ray_march_slim launches "
            f"{launched['ray_march_slim']}")
        check(np.abs(a - b).max() <= 1, "engines differ by more than one uint8 step")
        expect_video_launches(launched, "ray_march_slim", 8, 8, plain_calls,
                              "sequential video")

        # 7e. the golden orbit with the V2 disk, structure on
        v2 = dict(V2_SCENES["v2sci"])
        cfg = video_cfg("v2_golden", frames_per_dispatch=4, **v2)
        reset()
        stats = render_video_sharded(cfg)
        expect_video_launches(dict(launches), "ray_march_slim", 8, 0, plain_calls,
                              "V2 golden video")
        check("texture" not in stats["stage_ms"], f"V2 video stages {stats}")
        paths, progress_file = frame_files(cfg)
        whole = read_bytes(paths)
        frames = [decode_png_rgb8(b).astype(np.int32) for b in whole]
        moved = np.abs(frames[0] - frames[4]).max()
        say(f"[video v2] golden orbit, V2 disk: 8 ray_march_slim launches; PNG "
            f"frames 0 and 4 differ by up to {moved} uint8 steps")
        check(all(f.shape == (180, 320, 3) and f.max() > 128 for f in frames)
              and moved > 16, "V2 video frames dark or standing still")
        seq_cfg = video_cfg("v2_sequential", **v2)
        reset()
        render_video(seq_cfg)
        expect_video_launches(dict(launches), "ray_march_slim", 8, 0, plain_calls,
                              "sequential V2 video")
        steps = [np.abs(load_png_rgb8(p).astype(np.int32) - f)
                 for p, f in zip(frame_files(seq_cfg)[0], frames)]
        say(f"[video v2] sequential vs batched: frame 0 "
            f"{(steps[0] != 0).mean():.4%} of values differ, largest step "
            f"{steps[0].max()}; over all 8 frames largest step "
            f"{max(s.max() for s in steps)}")
        check(max(s.max() for s in steps) <= 1,
              "V2 engines differ by more than one uint8 step")
        for path in paths[4:]:
            os.remove(path)
        with open(progress_file) as f:
            progress = json.load(f)
        check(progress["completed"] == list(range(8)) and len(
            progress["params"]["v2"]) == 18, f"V2 progress {progress}")
        write_json_atomic(progress_file, dict(progress, completed=[0, 1, 2, 3]))
        reset()
        stats = render_video_sharded(dataclasses.replace(cfg, resume=True))
        launched = dict(launches)
        resumed = read_bytes(paths)
        say(f"[video v2 resume] frames 4-7 rendered again: ray_march_slim launches "
            f"{launched['ray_march_slim']}; "
            f"{sum(a == b for a, b in zip(whole, resumed))} of 8 PNGs byte-equal "
            f"to the uninterrupted run's")
        check(stats["frames"] == 4, f"V2 resume rendered {stats['frames']} frames")
        expect_video_launches(launched, "ray_march_slim", 4, 0, plain_calls,
                              "V2 resume")
        check(resumed == whole, "resumed V2 PNGs differ from the uninterrupted run's")
        reset()
        stats = render_video_sharded(dataclasses.replace(cfg, resume=True,
                                                         v2_samples=4))
        launched = dict(launches)
        say(f"[video v2 resume] changed v2_samples with resume: wiped, "
            f"{stats['frames']} frames, ray_march_slim launches "
            f"{launched['ray_march_slim']}")
        expect_video_launches(launched, "ray_march_slim", 8, 0, plain_calls,
                              "V2 resume with a changed v2_samples")
        check(stats["frames"] == 8 and read_bytes(paths)[0] != whole[0],
              "a changed v2_samples did not render the video anew")

        # 7d. full width, through the CLI
        path_launches, fhd_stats = {}, {}
        n_cards = torch.cuda.device_count()
        for tag, n_frames, flags, expected in FHD_VIDEOS:
            out = os.path.join("output", "torch_video", f"fhd_{tag}.mp4")
            argv = ["--video", "--orbit", "-r", "fhd", "--n_frames", str(n_frames),
                    "--fps", "24", *flags, "-o", out]
            stats, launched, n_batches = cli_video(argv, reset, launches)
            # One background pass a card a batch; none for V2.
            background = 0 if tag == "v2" else n_batches * n_cards
            say(f"[video fhd {tag}] {' '.join(argv[:-2])} on {n_cards} card(s): "
                f"{stats['frames']} frames (+{stats['padded']} padding) in "
                f"{stats['wall_s']:.2f} s, {stats['frames'] / stats['wall_s']:.3f} frames/s end to end; "
                f"per-frame medians ms: "
                + ", ".join(f"{k} {v:.3f}" for k, v in stats["stage_ms"].items()
                            if v is not None)
                + f"; main thread waited on the writers {stats['writer_wait_s']:.3f} s; "
                f"{expected} launches {launched[expected]}, {BACKGROUND} "
                f"{launched[BACKGROUND]} ({n_batches} batches), plain trace calls "
                f"{plain_calls[0]}")
            names = {"native": "native", "ffmpeg": "ffmpeg", "mjpeg": "mjpeg",
                     "none": "none: frames kept"}
            say(f"[video fhd {tag}] assembler: {names[stats['assembler']]}")
            expect_video_launches(launched, expected, n_frames + stats["padded"],
                                  background, plain_calls, f"FHD video {tag}")
            check(n_batches > 0 and (n_frames + stats["padded"]) % n_batches == 0,
                  f"FHD video {tag}: {n_batches} batches")
            check(stats["frames"] == n_frames, f"FHD video {tag}: {stats}")
            fhd_stats[tag] = stats
            cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
            paths, progress_file = frame_files(cfg)
            with open(progress_file) as f:
                check(json.load(f)["completed"] == list(range(n_frames)),
                      f"FHD video {tag}: progress.json incomplete")
            last = load_png_rgb8(paths[-1])
            check(last.shape == (1080, 1920, 3) and last.max() > 128,
                  f"FHD video {tag}: last frame")
            if stats["assembler"] == "native":
                probe = native.probe_video(out)
                say(f"[video fhd {tag}] probe_video: {probe}, "
                    f"{os.path.getsize(out)} bytes")
                check(probe == (n_frames, 1920, 1080), f"probe {probe}")
            for name in (expected, BACKGROUND, BLOOM):
                path_launches[name] = path_launches.get(name, 0) + launched[name]
            if tag == "v2":
                check("texture" not in stats["stage_ms"]
                      and "background" not in stats["stage_ms"],
                      f"V2 video reported a texture stage: {stats['stage_ms']}")
            if tag == "default":
                for level in (1, 2, 6):
                    t0 = time.perf_counter()
                    size = len(encode_png_rgb8(last, level=level))
                    say(f"[video png] one FHD frame at zlib level {level}: "
                        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, {size} bytes")
                # The same video through the sequential engine: what the
                # batched engine's overlap of rendering and writing buys.
                reset()
                seq = render_video(dataclasses.replace(
                    cfg, frame_shards=1, output=out.replace(".mp4", "_sequential.mp4")))
                say(f"[video fhd {tag}] sequential engine (--frame_shards 1): "
                    f"{seq['frames']} frames in {seq['wall_s']:.2f} s, "
                    f"{seq['frames'] / seq['wall_s']:.3f} frames/s end to end "
                    f"(batched: {stats['frames'] / stats['wall_s']:.3f}); ray_march_slim launches "
                    f"{launches['ray_march_slim']}")
                expect_video_launches(dict(launches), expected, n_frames, n_frames,
                                      plain_calls, f"sequential FHD video {tag}")
                if n_cards > 1:
                    # The same video on one card of the several.
                    reset()
                    one = render_video_sharded(
                        dataclasses.replace(cfg, output=out.replace(".mp4", "_1card.mp4")),
                        devices=[torch.device("cuda", 0)])
                    say(f"[video fhd {tag}] on 1 card: {one['frames'] / one['wall_s']:.3f} frames/s end "
                        f"to end (all {n_cards}: {stats['frames'] / stats['wall_s']:.3f})")
                    fhd_stats["default on 1 card"] = one
        return path_launches, fhd_stats
    finally:
        counting.close()


def interactive_phase(launches, reset_counts, smi) -> dict:
    """Phase 8; -> {kernel: launches of the full-width sessions}. A
    lifecycle step makes one background pass, a V2 step none."""
    import bhr_tpu_torch.cli as cli
    import bhr_tpu_torch.interactive as interactive
    from bhr_tpu_torch.interactive import InteractiveSession
    from bhr_tpu_torch.utils.io import quantize_frame

    def parse(flags):
        return cli.config_from_args(cli.build_parser().parse_args(
            ["--interactive", "-r", "fhd", *flags]))

    cfg = parse([])
    path = {"ray_march_slim": 0, "ray_march_aa": 0, BACKGROUND: 0, BLOOM: 0}
    counting = contextlib.ExitStack()
    plain_calls = counting.enter_context(counted_plain_traces())

    def reset():
        reset_counts()
        plain_calls[0] = 0

    def expect(what, slim, aa, background, bloomed=None):
        # bloomed: the frames rendered with B on (by default all of them).
        bloom = 2 * (slim + aa if bloomed is None else bloomed)
        launched = dict(launches)
        others = {k: v for k, v in launched.items() if k not in path and v}
        check(launched["ray_march_slim"] == slim and launched["ray_march_aa"] == aa
              and launched[BACKGROUND] == background and launched[BLOOM] == bloom
              and not others and not plain_calls[0],
              f"{what} launched {launched} and ran the plain trace "
              f"{plain_calls[0]} times, expected slim {slim}, aa {aa}, "
              f"{BACKGROUND} {background}, {BLOOM} {bloom}")
        path["ray_march_slim"] += slim
        path["ray_march_aa"] += aa
        path[BACKGROUND] += background
        path[BLOOM] += bloom

    def lit(frame, what):
        check(isinstance(frame, np.ndarray) and frame.shape == (1080, 1920, 3)
              and frame.dtype == np.uint8 and frame.max() > 64,
              f"{what}: frame {getattr(frame, 'shape', None)} "
              f"{getattr(frame, 'dtype', None)} is the wrong shape or black")

    def apart(a, b):
        return np.abs(a.astype(np.int16) - quantize_frame(b).astype(np.int16))

    try:
        # 8a. the key script, with lookahead
        reset()
        sess = InteractiveSession(cfg)
        check(sess._fused is not None and sess.lookahead, "no fused session")
        made, bloomed = [], []
        real = sess._fused.render_async

        def render_async(*a, **kw):
            bloomed.append(bool(a[5]))  # (cam_pos, fov, t, entities, diff, bloom, ...)
            made.append(real(*a, **kw))
            return made[-1]

        sess._fused.render_async = render_async
        for i in range(12):
            lit(sess.step(0.05), f"interactive step {i}")
        steps = {False: 12, True: 0}  # by the state of the 'd' toggle
        for key in ("d", "b", "l", "6", "0", "+", "up"):
            sess.handle_key(key)
            for i in range(3):
                frame = sess.step(0.05)
                lit(frame, f"interactive frame {i} after key {key}")
                if i == 0:
                    check(np.array_equal(frame, made[-1].cpu().numpy()),
                          f"the first frame shown after key {key} was rendered "
                          f"before it")
                steps[sess.diff] += 1
        check(len(bloomed) == sess.frames and 0 < sum(bloomed) < sess.frames,
              f"key script: bloom on in {sum(bloomed)} of {len(bloomed)} renders, "
              f"{sess.frames} frames")
        expect("the interactive key script", steps[False], steps[True],
               sess.frames, sum(bloomed))
        say(f"[interactive keys] {sess.frames} steps, keys d b l 6 0 + up: "
            f"ray_march_slim launches {steps[False]} (d off), ray_march_aa "
            f"{steps[True]} (d on), {BACKGROUND} {sess.frames}, {BLOOM} "
            f"{2 * sum(bloomed)} (b on in {sum(bloomed)} renders), plain trace "
            f"calls {plain_calls[0]}; every "
            f"first frame after a key was rendered after it; "
            f"{len(sess._fused._renderers)} renderer closures kept; HUD: "
            + sess.hud_text().replace("\n", " | "))
        say(f"[interactive keys] {sess.summary()}")
        del made[:], sess

        # 8b. fused against staged, lookahead off; the solo view of key 6
        ms = {True: [], False: []}  # by lookahead
        for key in (None, "6"):
            reset()
            sessions = [InteractiveSession(cfg, lookahead=False),
                        InteractiveSession(cfg, lookahead=False, fused=False)]
            check(sessions[0]._fused is not None and sessions[1]._fused is None,
                  "fused / staged sessions")
            frames = []
            for s_ in sessions:
                if key:
                    s_.handle_key(key)
                frames.append(s_.step(0.05))
            lit(frames[0], f"fused first frame (key {key})")
            d = apart(frames[0], frames[1])
            say(f"[interactive fused-vs-staged{' solo ' + key if key else ''}] "
                f"first frame at 1920x1080, lookahead off: {(d != 0).mean():.4%} "
                f"of values differ, largest step {d.max()}")
            check(d.max() <= 1, f"fused vs staged (key {key}): {d.max()} uint8 steps")
            n = 2
            if key is None:
                # With and without lookahead, turn about on one fused
                # session: 5 rounds of 6 steps each way; the first round
                # warms up, and so does the first step of every turn
                # (after the switch it has no pending frame to show).
                del sessions[1]
                s_ = sessions[0]
                for round_ in range(5):
                    for lookahead in (True, False):
                        s_.lookahead, s_._pending = lookahead, None
                        for i in range(6):
                            lit(s_.step(0.05), "fused step")
                            if round_ and i:
                                ms[lookahead].append(s_.last_render_ms)
                            n += 1
            expect(f"fused and staged sessions (key {key})", n, 0, n)
            del sessions, frames
        say(f"[interactive fhd] {smi}: median render ms a frame, fused session: "
            f"{statistics.median(ms[True]):.3f} with lookahead, "
            f"{statistics.median(ms[False]):.3f} without (20 frames each, one "
            f"session in turns of 6; host clock around step())")

        # 8c. the V2 session: the slim kernel only, 'd' inert
        v2_ms = {}
        for lookahead in (True, False):
            reset()
            sess = InteractiveSession(parse(["--disk_model", "v2"]),
                                      lookahead=lookahead)
            check(sess._fused is not None and sess.dynamic is None, "V2 session")
            ms = []
            for i in range(8):
                lit(sess.step(0.05), f"V2 interactive step {i}")
                ms.append(sess.last_render_ms)
            sess.handle_key("d")
            for i in range(3):
                lit(sess.step(0.05), f"V2 interactive step {i} after d")
            check("D:n/a" in sess.hud_text(), f"V2 HUD: {sess.hud_text()}")
            expect("the V2 interactive session", 11, 0, 0)
            v2_ms[lookahead] = statistics.median(ms[2:])
        say(f"[interactive v2] {smi}: 2 x 11 steps, ray_march_slim only, d inert "
            f"(HUD says D:n/a); median render ms a frame {v2_ms[True]:.3f} with "
            f"lookahead, {v2_ms[False]:.3f} without; {sess.summary()}")
        del sess

        # 8d. the HTTP preview over loopback
        from PIL import Image

        reset()
        submitted, started = [], threading.Event()
        box = {}

        def on_start(server):
            box["server"] = server
            submit = server.submit
            server.submit = lambda img: (submitted.append(np.array(img)),
                                         submit(img))[1]
            started.set()

        tee = _Tee()

        def serve():
            try:
                with contextlib.redirect_stdout(tee):
                    interactive.run_http_preview(cfg, port=0, max_frames=64,
                                                 on_start=on_start)
            except Exception as exc:  # reported by the main thread
                box["error"] = exc

        thread = threading.Thread(target=serve, daemon=True)
        thread.start()
        check(started.wait(60), "the preview server did not start")
        base = f"http://127.0.0.1:{box['server'].port}"
        jpeg, deadline = None, time.time() + 120
        while jpeg is None and time.time() < deadline and thread.is_alive():
            try:
                jpeg = urllib.request.urlopen(f"{base}/frame", timeout=10).read()
            except urllib.error.HTTPError as exc:
                check(exc.code == 503, f"/frame answered {exc.code}")
                time.sleep(0.05)  # no frame yet
        check(jpeg is not None, f"no /frame within the deadline: {box.get('error')}")
        img = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
        while len(submitted) < 8 and time.time() < deadline and thread.is_alive():
            time.sleep(0.05)  # a few frames, for the viewer's time
        urllib.request.urlopen(f"{base}/key?k=q", timeout=10).read()
        thread.join(60)
        check(not thread.is_alive() and "error" not in box,
              f"the preview loop did not end on q: {box.get('error')}")
        check(img.shape == (1080, 1920, 3), f"/frame decoded to {img.shape}")
        mad = min(float(np.abs(img.astype(np.int16) - f.astype(np.int16)).mean())
                  for f in submitted)
        lines = [ln for ln in tee.getvalue().splitlines()
                 if ln.startswith("interactive: ")]
        check(len(lines) == 1, "the preview loop printed no summary")
        say(f"[interactive http] {smi}: /frame over loopback: {len(jpeg)} bytes, "
            f"decoded {img.shape}, mean absolute difference from the nearest of "
            f"{len(submitted)} submitted frames {mad:.3f} of 255; /key?k=q ended "
            f"the loop; {lines[0]} (viewer = the JPEG encode)")
        check(mad < 8.0, f"/frame is {mad} away from every submitted frame")
        check(8 <= len(submitted) < 64, f"{len(submitted)} frames: q did not end it")
        for frame in submitted:
            lit(frame, "a frame submitted to the preview server")
        expect("the HTTP preview session", len(submitted), 0, len(submitted))
        return path
    finally:
        counting.close()


# One process of a fleet: ``worker.py MODE PID N_PROC PORT OUTDIR``. It
# joins the group (the CLI modes let ``cli.main`` do that), counts its
# kernel launches (the background-noise kernel's under "background", the
# bloom kernel's under "bloom"),
# plain trace calls, batches and progress.json writes, and prints them on
# "FLEET ..." lines.
FLEET_WORKER = r"""
import dataclasses, datetime, json, os, sys
mode, pid, n_proc, port, outdir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4], sys.argv[5])
import torch
import bhr_tpu_torch.parallel.video as V
from bhr_tpu_torch.ops import geodesic_cuda
from bhr_tpu_torch.ops.background import generate_background_components as bg
from bhr_tpu_torch.ops.bloom import bloom_composite
from bhr_tpu_torch.ops.geodesic_cuda import trace_geodesics_cuda
launches = trace_geodesics_cuda.launches
counts = {"plain": 0, "progress_writes": 0, "batches": 0}
real_trace, real_write = geodesic_cuda.trace_geodesics, V.write_json_atomic
real_frames = V.render_video_frames_sharded
def counted_trace(*a, **kw):
    counts["plain"] += 1
    return real_trace(*a, **kw)
def counted_write(*a, **kw):
    counts["progress_writes"] += 1
    return real_write(*a, **kw)
def counted_frames(*a, **kw):
    counts["batches"] += 1
    return real_frames(*a, **kw)
geodesic_cuda.trace_geodesics, V.write_json_atomic = counted_trace, counted_write
V.render_video_frames_sharded = counted_frames
def report(tag, stats):
    print("FLEET " + json.dumps({"tag": tag, "pid": pid, "launches": dict(launches),
                                 "background": bg.launches,
                                 "bloom": bloom_composite.launches, **counts,
                                 "stats": stats}), flush=True)
    launches.update(dict.fromkeys(launches, 0))
    bg.launches = bloom_composite.launches = 0
    counts.update(plain=0, progress_writes=0, batches=0)
address = "127.0.0.1:" + port
if mode.startswith("cli:"):
    import bhr_tpu_torch.cli as cli
    rc = cli.main(json.loads(mode[4:]) + [
        "--coordinator_address", address, "--num_processes", str(n_proc),
        "--process_id", str(pid)])
    report("cli", None)
    sys.exit(rc)
from bhr_tpu_torch.parallel.mesh import initialize_multihost, process_index
n = initialize_multihost(address, n_proc, pid,
                         timeout=datetime.timedelta(seconds=90))
assert n == n_proc and process_index() == pid, (n, process_index())
from bhr_tpu_torch.config import SceneConfig
golden = json.loads(os.environ["FLEET_GOLDEN_VIDEO"])
golden["pov"] = tuple(golden["pov"])
def cfg(name, **changes):
    return SceneConfig(device="cuda", output=os.path.join(outdir, name + ".mp4"),
                       **{**golden, "frame_shards": 0, **changes})
if mode == "golden":
    for name, extra in (("golden", {}), ("v2", json.loads(os.environ["FLEET_V2"]))):
        c = cfg(name, frames_per_dispatch=3, **extra)
        report(name, V.render_video_sharded(c))
        report(name + " resume",
               V.render_video_sharded(dataclasses.replace(c, resume=True)))
elif mode == "abort":
    real_batch, batches = V.render_video_frames_sharded, [0]
    def inject(*a, **kw):
        batches[0] += 1
        if pid == 1 and batches[0] == 2:
            raise RuntimeError("injected-batch-failure")
        return real_batch(*a, **kw)
    V.render_video_frames_sharded = inject
    V.render_video_sharded(cfg("abort", n_frames=16, frames_per_dispatch=1))
    print("UNREACHABLE", pid, flush=True)
"""


def first_card() -> str:
    """The first visible card, as a ``CUDA_VISIBLE_DEVICES`` value."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    return visible or "0"


def run_fleet(mode, n_proc, outdir, deadline_s, envs=None):
    """Start ``n_proc`` fleet workers in ``mode`` on a free loopback port
    -> [(exit code, output)] in rank order. ``envs`` gives each worker's
    own environment variables; by default every worker sees the first
    card only, so all share it. Output goes to files; a worker still
    running at the common deadline is killed, with all the others, and
    the run fails."""
    if envs is None:
        envs = [{"CUDA_VISIBLE_DEVICES": first_card()}] * n_proc
    os.makedirs(outdir, exist_ok=True)
    script = os.path.join(outdir, "worker.py")
    with open(script, "w") as f:
        f.write(FLEET_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), FLEET_GOLDEN_VIDEO=json.dumps(GOLDEN_VIDEO),
        FLEET_V2=json.dumps(V2_SCENES["v2sci"]))
    logs = [os.path.join(outdir, f"{mode.split(':')[0]}_{pid}.log")
            for pid in range(n_proc)]
    procs = []
    for pid in range(n_proc):
        with open(logs[pid], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, script, mode, str(pid), str(n_proc), port, outdir],
                env=dict(env, **envs[pid]), stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.time() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(1, deadline - time.time()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(
            f"FAIL: a fleet worker ({mode.split(':')[0]}) outlived its "
            f"{deadline_s} s deadline")
    finally:
        for p in procs:  # nothing this script started is left running
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def fleet_reports(results, what):
    """The workers' "FLEET" lines -> {tag: [report of process 0, 1, ...]};
    every worker must have exited with code 0."""
    reports = {}
    for pid, (rc, out) in enumerate(results):
        check(rc == 0, f"{what}: process {pid} exited with {rc}:\n{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith("FLEET "):
                r = json.loads(line[len("FLEET "):])
                reports.setdefault(r["tag"], []).append(r)
    return reports


def fleet_phase(fhd_video_stats, smi) -> dict:
    """Phase 9; -> {kernel: launches of the full-width fleet video, summed
    over its processes}."""
    from bhr_tpu_torch.config import SceneConfig
    from bhr_tpu_torch.modes import video_temp_paths
    from bhr_tpu_torch.parallel.video import render_video_sharded

    outdir = os.path.join("output", "torch_fleet")

    def png_bytes(output, n):
        temp_dir, progress_file = video_temp_paths(output)
        names = sorted(f for f in os.listdir(temp_dir) if f.endswith(".png"))
        check(names == [f"frame_{f:04d}.png" for f in range(n)],
              f"{output}: PNG files {names}")
        out = []
        for name in names:
            with open(os.path.join(temp_dir, name), "rb") as f:
                out.append(f.read())
        with open(progress_file) as f:
            return out, json.load(f)

    # 9a. the golden orbit, texture model and V2, two processes on cuda:0
    t0 = time.perf_counter()
    reports = fleet_reports(run_fleet("golden", 2, outdir, 300), "fleet golden")
    took = time.perf_counter() - t0
    v2_ref = SceneConfig(device="cuda", output=os.path.join(outdir, "v2_one.mp4"),
                         **{**GOLDEN_VIDEO, **V2_SCENES["v2sci"]})
    render_video_sharded(v2_ref)
    refs = {"golden": os.path.join("output", "torch_video", "golden.mp4"),
            "v2": v2_ref.output}
    for name, ref in refs.items():
        ours, progress = png_bytes(os.path.join(outdir, f"{name}.mp4"), 8)
        theirs, _ = png_bytes(ref, 8)
        run, again = reports[name], reports[name + " resume"]
        slim = [r["launches"]["ray_march_slim"] for r in run]
        stats = [r["stats"] for r in run]
        say(f"[fleet {name}] 2 processes on cuda:0, 8 frames in batches of 6: "
            f"{sum(a == b for a, b in zip(ours, theirs))} of 8 PNGs byte-equal to "
            f"the one-process run's; ray_march_slim launches {slim} (frames "
            f"written {[s['own_frames'] for s in stats]}, padding "
            f"{stats[0]['padded']}), plain trace calls {[r['plain'] for r in run]}; "
            f"progress.json written {[r['progress_writes'] for r in run]} times; "
            f"assembler {[s['assembler'] for s in stats]}; {BACKGROUND} "
            f"launches {[r['background'] for r in run]} in "
            f"{[r['batches'] for r in run]} batches; resume pass: launches "
            f"{[r['launches']['ray_march_slim'] for r in again]}, frames "
            f"{[r['stats']['frames'] for r in again]}")
        check(ours == theirs, f"fleet {name}: PNGs differ from one process's")
        check(progress["completed"] == list(range(8)), f"fleet {name}: {progress}")
        check(len(run) == 2 and sum(slim) == 8 + stats[0]["padded"] == 12
              and all(slim), f"fleet {name}: launches {slim}")
        check(sum(s["own_frames"] for s in stats) == 8, f"fleet {name}: {stats}")
        for r in run + again:
            others = {k: v for k, v in r["launches"].items()
                      if k != "ray_march_slim" and v}
            check(not others and not r["plain"], f"fleet {name}: {r}")
            check(r["bloom"] == 2 * r["launches"]["ray_march_slim"],
                  f"fleet {name}: {BLOOM} {r['bloom']}, a frame posts once")
            # Each process's card: one background pass a lifecycle batch.
            check(r["background"] == (r["batches"] if name == "golden" else 0),
                  f"fleet {name}: {BACKGROUND} {r['background']} in "
                  f"{r['batches']} batches")
        check([r["batches"] for r in run] == [(8 + stats[0]["padded"]) // 6] * 2
              and not any(r["batches"] for r in again),
              f"fleet {name}: batches {[r['batches'] for r in run + again]}")
        check([r["progress_writes"] for r in run] == [2, 0],
              f"fleet {name}: progress.json writers")
        check(stats[0]["assembler"] in ("native", "ffmpeg", "mjpeg")
              and stats[1]["assembler"] is None, f"fleet {name}: assemblers")
        video = os.path.join(outdir, f"{name}.mp4")
        if stats[0]["assembler"] == "mjpeg":
            video = video.replace(".mp4", ".avi")
        check(os.path.getsize(video) > 0, f"fleet {name}: no video file")
        check(all(r["launches"]["ray_march_slim"] == 0 and r["stats"]["frames"] == 0
                  for r in again), f"fleet {name}: the resume pass rendered")
    say(f"[fleet golden] both workers (2 videos, 2 resume passes) took {took:.1f} s")

    # 9b. the CLI's guard
    results = run_fleet("cli:" + json.dumps(["--interactive", "-r", "sd", "-o",
                                             os.path.join(outdir, "x.png")]),
                        2, outdir, 180)
    say(f"[fleet guard] --interactive --coordinator_address: exit codes "
        f"{[rc for rc, _ in results]}")
    for pid, (rc, out) in enumerate(results):
        check(rc == 2 and "sharded orbit video" in out,
              f"fleet guard: process {pid} exited with {rc}:\n{out[-2000:]}")
    check("multi-host: 2 processes, 2 devices total" in results[0][1],
          "fleet guard: process 0 did not announce the fleet")

    # 9c. the abort
    t0 = time.perf_counter()
    results = run_fleet("abort", 2, outdir, 240)
    say(f"[fleet abort] a failure in process 1's second batch: exit codes "
        f"{[rc for rc, _ in results]}, both gone after "
        f"{time.perf_counter() - t0:.1f} s")
    check(results[1][0] == 1 and "injected-batch-failure" in results[1][1]
          and "[process 1] fatal error, aborting the fleet:" in results[1][1],
          f"fleet abort: process 1:\n{results[1][1][-2000:]}")
    check(results[0][0] != 0, f"fleet abort: process 0:\n{results[0][1][-2000:]}")
    check(all("UNREACHABLE" not in out for _, out in results),
          "fleet abort: a process went on past the failure")

    # 9d. the FHD default video through the CLI in every process
    def fhd_fleet(tag, n_proc, envs):
        out = os.path.join(outdir, f"fhd_{tag}.mp4")
        argv = ["--video", "--orbit", "-r", "fhd", "--n_frames", "24", "--fps", "24",
                "-o", out]
        results = run_fleet("cli:" + json.dumps(argv), n_proc, outdir, 420, envs)
        reports = fleet_reports(results, f"fleet fhd {tag}")["cli"]
        lines = [ln for ln in results[0][1].splitlines()
                 if ln.startswith("Video stats: ")]
        check(len(lines) == 1, f"fleet fhd {tag}: no stats line")
        stats = json.loads(lines[0][len("Video stats: "):])
        slim = [r["launches"]["ray_march_slim"] for r in reports]
        frames, progress = png_bytes(out, 24)
        check(progress["completed"] == list(range(24)), f"fleet fhd {tag}: progress")
        check(stats["frames"] == 24 and sum(slim) == 24 + stats["padded"]
              and not any(r["plain"] for r in reports),
              f"fleet fhd {tag}: launches {slim}, {stats}")
        for r in reports:
            others = {k: v for k, v in r["launches"].items()
                      if k != "ray_march_slim" and v}
            check(not others, f"fleet fhd {tag}: {r['launches']}")
            check(r["bloom"] == 2 * r["launches"]["ray_march_slim"],
                  f"fleet fhd {tag}: {BLOOM} {r['bloom']}, a frame posts once")
            check(r["background"] == r["batches"] > 0,
                  f"fleet fhd {tag}: {BACKGROUND} {r['background']} in "
                  f"{r['batches']} batches")
        say(f"[fleet fhd {tag}] {smi}: {' '.join(argv[:-2])} in {n_proc} processes: "
            f"24 frames (+{stats['padded']} padding) in {stats['wall_s']:.2f} s, "
            f"{stats['frames'] / stats['wall_s']:.3f} frames/s end to end; process "
            f"0's per-frame medians ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in stats["stage_ms"].items()
                        if v is not None)
            + f"; ray_march_slim launches {slim}, {BACKGROUND} "
            f"{[r['background'] for r in reports]} in "
            f"{[r['batches'] for r in reports]} batches, plain trace calls "
            f"{[r['plain'] for r in reports]}; assembler {stats['assembler']}")
        # Phase 7d's one-process frames of the same video.
        theirs, _ = png_bytes(os.path.join("output", "torch_video",
                                           "fhd_default.mp4"), 24)
        say(f"[fleet fhd {tag}] {sum(a == b for a, b in zip(frames, theirs))} of "
            f"24 PNGs byte-equal to the one-process run's of phase 7d")
        check(frames == theirs, f"fleet fhd {tag}: PNGs differ from one process's")
        return stats, sum(slim), sum(r["background"] for r in reports)

    one = fhd_video_stats["default"]
    n_cards = torch.cuda.device_count()
    _, n_launched, n_background = fhd_fleet("2 on cuda:0", 2, None)

    def rates(stats):
        return f"{stats['frames'] / stats['wall_s']:.3f} frames/s end to end"

    one_card = fhd_video_stats.get("default on 1 card", one)
    say(f"[fleet fhd] one process on one card in this call (phase 7d): "
        f"{rates(one_card)}")
    path = {"ray_march_slim": n_launched, BACKGROUND: n_background, BLOOM: 2 * n_launched}
    if n_cards > 1:
        # Optimisation B's measurement: a process per card beside one
        # process (one host thread) over all cards.
        visible = (os.environ.get("CUDA_VISIBLE_DEVICES")
                   or ",".join(map(str, range(n_cards)))).split(",")
        per_card, n, n_background = fhd_fleet(
            f"{n_cards} processes, a card each", n_cards,
            [{"CUDA_VISIBLE_DEVICES": k} for k in visible])
        path["ray_march_slim"] += n
        path[BACKGROUND] += n_background
        path[BLOOM] += 2 * n
        say(f"[fleet fhd] a process per card: {rates(per_card)}; one process "
            f"over all {n_cards} cards (phase 7d): {rates(one)}; one process on "
            f"one card: {rates(one_card)}")
    return path


def timed_texture(n_phi, n_r, r_inner, r_outer, scale):
    """One generation of the static texture on cuda:0 through the pieces
    of ``generate_disk_texture`` (``generate_component_fields`` with a
    CUDA event at each ``on_stage`` mark, then the stats and the compose)
    -> (texture, ms per stage, device-timeline ms, wall ms, peak bytes)."""
    from bhr_tpu_torch.models.disk_texture import (
        _component_stats,
        compose_from_components,
        generate_component_fields,
    )
    from bhr_tpu_torch.utils.io import compute_edge_alpha

    marks = []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mark("start")
    comp, _ = generate_component_fields(42, n_r, n_phi, r_inner, r_outer, True,
                                        scale, "cuda", on_stage=mark)
    edge = torch.as_tensor(compute_edge_alpha(n_r), device="cuda")
    stats = _component_stats(comp, edge, True)
    mark("stats")
    tex = compose_from_components(comp, edge, *stats, True, torch.tensor(
        6000.0, device="cuda"))
    mark("compose")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ms = {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])}
    return (tex, ms, marks[0][1].elapsed_time(marks[-1][1]), wall,
            torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def fresh_texture_cache():
    """Points the texture cache at a new directory under output/ (so the
    first auto frame of a run is cold) and removes it afterwards."""
    import tempfile

    import bhr_tpu_torch.utils.cache as tcache

    os.makedirs("output", exist_ok=True)
    default = tcache.DEFAULT_CACHE_DIR
    tcache.DEFAULT_CACHE_DIR = tempfile.mkdtemp(prefix="torch_auto_cache_", dir="output")
    try:
        yield tcache.DEFAULT_CACHE_DIR
    finally:
        shutil.rmtree(tcache.DEFAULT_CACHE_DIR, ignore_errors=True)
        tcache.DEFAULT_CACHE_DIR = default


def auto_disk_phase(launches, reset_counts, cache_dir) -> dict:
    """Phase 10: the static disk of ``--disk_texture auto``, its texture
    cache in ``cache_dir`` (empty) -> this path's launches."""
    import bhr_tpu_torch.cli as cli
    from bhr_tpu_torch.config import SceneConfig, compute_disk_texture_resolution
    from bhr_tpu_torch.models.disk_texture import generate_disk_texture
    from bhr_tpu_torch.modes import render_image
    from bhr_tpu_torch.ops import random as trandom
    from bhr_tpu_torch.parallel.frames import render_image_tiled
    from bhr_tpu_torch.utils.cache import texture_cache_key

    fhd_flags = ["-r", "fhd", "--disk_texture", "auto"]
    parse = cli.build_parser().parse_args
    fhd = cli.config_from_args(parse(fhd_flags))
    fhd_size = compute_disk_texture_resolution(
        *fhd.image_size, fhd.pov, fhd.fov, fhd.disk_inner_radius, fhd.disk_outer_radius)
    golden_size = compute_disk_texture_resolution(320, 180, POV, GOLDEN["fov"], 2.0, 3.5)
    scale = fhd.disk_generation_scale

    # 10a. the random bits on the card against the CPU's, at the FHD
    # texture's low-res pixel-noise shape and as tileable_noise batches them.
    keys = trandom.split(trandom.prng_key(fhd.seed), 9)
    shape = (fhd_size[1] // scale, fhd_size[0] // scale)
    for k in keys:
        a, b = (trandom.random_bits(k, shape, device=d) for d in ("cuda", "cpu"))
        check(torch.equal(a.cpu(), b), f"random bits differ on the card for key {k}")
        check(torch.equal(trandom.uniform_from_bits(a, 0.05, 0.95).cpu(),
                          trandom.uniform_from_bits(b, 0.05, 0.95)),
              "uniform draws differ on the card")
        many = [trandom.random_bits_many([*trandom.split(k, 7)], [(60,)] * 7, d)
                for d in ("cuda", "cpu")]
        check(all(torch.equal(x.cpu(), y) for x, y in zip(*many)),
              "batched random bits differ on the card")
    say(f"[auto bits] {len(keys)} keys: the {shape[0]}x{shape[1]} draw, its uniform "
        f"floats and 7 batched draws of 60 bit-equal on cuda and cpu")

    # The texture on the card against the CPU port's, at the golden and
    # the FHD sizes; each generated twice on the card (cold, then warm).
    for tag, (n_phi, n_r), radii in (("golden", golden_size, (2.0, 3.5)),
                                     ("fhd", fhd_size, (fhd.disk_inner_radius,
                                                        fhd.disk_outer_radius))):
        runs = [timed_texture(n_phi, n_r, *radii, scale) for _ in range(2)]
        t0 = time.perf_counter()
        cpu = generate_disk_texture(n_phi=n_phi, n_r=n_r, seed=42, r_inner=radii[0],
                                    r_outer=radii[1], generation_scale=scale,
                                    device="cpu")
        cpu_s = time.perf_counter() - t0
        diff = (runs[0][0].cpu().double() - cpu.double()).abs()
        same = torch.equal(runs[0][0], runs[1][0])
        say(f"[auto texture {tag} {n_phi}x{n_r} scale {scale}] cuda vs cpu max "
            f"{float(diff.max()):.3e} mean {float(diff.mean()):.3e}; two cuda "
            f"generations equal: {same}; cpu generation {cpu_s:.2f} s")
        check(tuple(runs[0][0].shape) == (n_r, n_phi, 4)
              and bool(torch.isfinite(runs[0][0]).all()), f"{tag} texture shape/finite")
        check(float(diff.max()) <= 1e-4 and same, f"{tag} texture cuda vs cpu")
        for which, (_, ms, timeline, wall, peak) in zip(("cold", "warm"), runs):
            say(f"[auto texture {tag} {which}] ms by stage (CUDA events): " + ", ".join(
                f"{k} {v:.3f}" for k, v in ms.items()) + f"; device timeline "
                f"{timeline:.3f}, wall {wall:.3f}; peak memory {peak / 2**30:.3f} GiB")
        del runs, cpu
    busy, n_kernels = device_busy_share(lambda: generate_disk_texture(
        n_phi=fhd_size[0], n_r=fhd_size[1], seed=42, r_inner=fhd.disk_inner_radius,
        r_outer=fhd.disk_outer_radius, generation_scale=scale, device="cuda"))
    say("[auto texture fhd profile] " + (
        "not measured (the profiler reported no device time)" if busy is None else
        f"device busy {busy:.1%} of the generation's wall time, in {n_kernels} "
        f"kernels and copies"))
    size_4k = compute_disk_texture_resolution(3840, 2160, POV, fhd.fov,
                                              fhd.disk_inner_radius, fhd.disk_outer_radius)
    _, ms, timeline, wall, peak = timed_texture(*size_4k, fhd.disk_inner_radius,
                                                fhd.disk_outer_radius, scale)
    say(f"[auto texture 4k {size_4k[0]}x{size_4k[1]} scale {scale}] device timeline "
        f"{timeline:.3f} ms, wall {wall:.3f}; peak memory {peak / 2**30:.3f} GiB")

    # 10b. the golden scene with the static disk, on the card against the
    # CPU port (the CPU render regenerates over the card's cache file).
    golden = {**GOLDEN, "disk_texture": "auto"}
    with counted_plain_traces() as plain_calls:
        reset_counts()
        img = render_image(SceneConfig(device="cuda", **golden))
        launched = dict(launches)
    ref = render_image(SceneConfig(device="cpu", force_regenerate_disk_texture=True,
                                   **golden))
    diff = np.abs(img.astype(np.float64) - ref)
    center = img[90 - 16: 90 + 16, 160 - 16: 160 + 16]
    say(f"[golden auto] vs the CPU port's render max {diff.max():.3e} mean "
        f"{diff.mean():.3e}; ray_march_slim launches {launched['ray_march_slim']}, "
        f"plain trace calls {plain_calls[0]}")
    check(img.shape == (180, 320, 3) and np.isfinite(img).all()
          and diff.max() <= 5e-2 and diff.mean() <= 5e-4, "golden auto outside bounds")
    expect_launches(launched, "ray_march_slim", "golden auto")
    check(not plain_calls[0], "golden auto ran the plain trace")
    check(img.max() > 0.5 and (img.sum(axis=-1) > 0.02).mean() > 0.05
          and (center.sum(axis=-1) < 0.05).mean() > 0.5,
          "golden auto: no bright ring or no dark shadow")

    # 10c. the FHD still through the CLI: cold (the texture generated and
    # saved), warm (loaded from the cache), AA + flare, and in bands.
    path = {"ray_march_slim": 0, "ray_march_aa": 0, BLOOM: 0}
    cache_file = os.path.join(cache_dir, texture_cache_key(
        fhd.disk_inner_radius, fhd.disk_outer_radius, fhd.seed, *fhd_size, scale))
    check(not os.path.exists(cache_file), "the FHD texture is cached before its cold run")
    saved = None
    for tag, flags, expected in (("cold", [], "ray_march_slim"),
                                 ("warm", [], "ray_march_slim"),
                                 ("aa_flare", AA_FLAGS, "ray_march_aa")):
        out_png = os.path.join("output", f"torch_fhd_auto_{tag}.png")
        with counted_plain_traces() as plain_calls:
            reset_counts()
            t0 = time.perf_counter()
            check(cli.main([*fhd_flags, *flags, "-o", out_png]) == 0, "CLI exit code")
            wall = time.perf_counter() - t0
            launched = dict(launches)
        stamp = os.stat(cache_file).st_mtime_ns
        say(f"[fhd-cli auto {tag}] {' '.join(fhd_flags + flags)}: {wall:.2f} s; "
            f"{expected} launches {launched[expected]}, plain trace calls "
            f"{plain_calls[0]}; texture "
            + ("generated and saved" if saved is None else "loaded from the cache"))
        expect_launches(launched, expected, f"FHD auto {tag} frame")
        check(not plain_calls[0], f"FHD auto {tag} ran the plain trace")
        check(saved in (None, stamp), f"FHD auto {tag} regenerated a cached texture")
        saved = stamp
        path[expected] += launched[expected]
        path[BLOOM] += launched[BLOOM]
    t0 = time.perf_counter()
    np.load(cache_file)
    say(f"[auto cache] {os.path.getsize(cache_file)} bytes, np.load "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    med, host_ms, busy, n_kernels, frame = static_stage_times(fhd)
    check(bool(torch.isfinite(frame).all()) and frame.shape == (1080, 1920, 3)
          and float(frame.max()) > 0.5, "FHD auto frame not finite or dark")
    say("[fhd-frame auto] median ms over 3 frames: " + ", ".join(
        f"{k} {v:.3f}" for k, v in med.items())
        + f"; total {sum(med.values()):.3f} (no texture stage); host "
        f"{host_ms:.3f} ms to enqueue a frame; device busy "
        + ("not measured (the profiler reported no device time)"
           if busy is None else f"{busy:.1%} of a frame's wall time, in "
           f"{n_kernels} kernels and copies"))
    del frame

    n_cards = torch.cuda.device_count()
    tile_devs = ([torch.device("cuda", i) for i in range(TILES)] if n_cards >= TILES
                 else [torch.device("cuda", 0)] * TILES)
    with counted_plain_traces() as plain_calls:
        reset_counts()
        tiled = render_image_tiled(cli.config_from_args(parse(
            [*fhd_flags, "--tile_shards", str(TILES)])), devices=tile_devs)
        launched = dict(launches)
    whole = render_image(fhd)
    diff = np.abs(tiled - whole)
    say(f"[tiles fhd auto] {TILES} bands on {', '.join(map(str, tile_devs))} vs the "
        f"whole frame: max {diff.max():.3e}; ray_march_slim band launches "
        f"{launched['ray_march_slim']}, plain trace calls {plain_calls[0]}")
    others = {k: v for k, v in launched.items()
              if k not in ("ray_march_slim", BLOOM) and v}
    check(launched["ray_march_slim"] == TILES and launched[BLOOM] == 2
          and not others and not plain_calls[0],
          f"tiled FHD auto launched {launched}, plain {plain_calls[0]}")
    check(tiled.shape == (1080, 1920, 3) and diff.max() <= TOL_TILED,
          f"tiled FHD auto vs whole {diff.max()}")
    path["ray_march_slim"] += launched["ray_march_slim"]
    path[BLOOM] += launched[BLOOM]
    return path


def png_phase(launches, reset_counts, smi) -> dict:
    """Phases 11a and 11b: the native PNG encoder against the standard
    library's zlib on one FHD frame, and the FHD V2 and default videos
    with each encoder in turns -> the videos' launches."""
    from bhr_tpu_torch import native
    from bhr_tpu_torch.modes import video_temp_paths
    from bhr_tpu_torch.utils import io as tio

    check(native.png_available(), "the native PNG encoder did not build")
    backend = native.png_backend()
    frame = tio.load_png_rgb8(os.path.join("output", "torch_fhd_default.png"))
    check(frame.shape == (1080, 1920, 3) and frame.max() > 128,
          f"phase 5's FHD frame {frame.shape}")
    encoded = {}
    for tag, encode in (
            (f"native ({backend}) level {tio.NATIVE_PNG_LEVEL}",
             lambda: native.encode_png_rgb8(frame, level=tio.NATIVE_PNG_LEVEL)),
            (f"zlib level {tio.PNG_LEVEL}", lambda: tio.encode_png_rgb8(frame))):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            data = encode()
            times.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(tio.decode_png_rgb8(data), frame),
              f"{tag}: the PNG does not decode to the frame")
        encoded[tag] = (statistics.median(times), len(data))
    say(f"[png] {smi}: native encoder linked to {backend}; phase 5's FHD default "
        f"frame encoded 5 times each, medians: " + "; ".join(
            f"{tag} {ms:.3f} ms, {n} bytes" for tag, (ms, n) in encoded.items())
        + "; both decode to the frame exactly (decode_png_rgb8)")

    # The same videos with each encoder, in turns; the zlib runs patch
    # native.png_available, so save_image takes its standard-library path.
    path_launches = {"ray_march_slim": 0, BACKGROUND: 0, BLOOM: 0}
    real = native.png_available
    for tag, flags, order in (("fhd v2", V2_FLAGS["v2"], ("native", "zlib")),
                              ("fhd", [], ("zlib", "native"))):
        stats, last = {}, {}
        for encoder in order:
            out = os.path.join("output", "torch_video",
                               f"png_{tag.replace(' ', '_')}_{encoder}.mp4")
            argv = ["--video", "--orbit", "-r", "fhd", "--n_frames", "24", "--fps",
                    "24", *flags, "-o", out]
            native.png_available = real if encoder == "native" else (lambda: False)
            try:
                stats[encoder], launched, n_batches = cli_video(argv, reset_counts,
                                                                launches)
            finally:
                native.png_available = real
            # One background pass a card a lifecycle batch, none for V2.
            background = 0 if flags else n_batches * torch.cuda.device_count()
            others = {k: v for k, v in launched.items()
                      if k not in ("ray_march_slim", BACKGROUND, BLOOM) and v}
            check(launched["ray_march_slim"] == 24 + stats[encoder]["padded"]
                  and launched[BACKGROUND] == background and n_batches > 0
                  and launched[BLOOM] == 2 * launched["ray_march_slim"]
                  and not others and stats[encoder]["frames"] == 24,
                  f"video {tag} ({encoder}): {launched} in {n_batches} batches, "
                  f"{stats[encoder]}")
            for name in path_launches:
                path_launches[name] += launched[name]
            temp_dir, _ = video_temp_paths(out)
            last[encoder] = tio.load_png_rgb8(os.path.join(temp_dir, "frame_0023.png"))
        check(np.array_equal(last["native"], last["zlib"]),
              f"video {tag}: the encoders' last frames differ")
        say(f"[video {tag} png] {smi}: --video --orbit -r fhd --n_frames 24 "
            f"{' '.join(flags)} twice, in turns ({', '.join(order)}): " + "; ".join(
                f"{enc} {st['frames'] / st['wall_s']:.3f} frames/s end to end, "
                f"PNG median {st['stage_ms']['png']:.3f} ms, main thread "
                f"waited on the writers {st['writer_wait_s']:.3f} s"
                for enc, st in ((e, stats[e]) for e in ("native", "zlib")))
            + "; frame 23 decodes equal")
    return path_launches


def extreme_phase(launches, reset_counts, smi) -> dict:
    """Phase 11c: the kernel at bhr_tpu's extreme scenes -> the frames'
    launches."""
    from bhr_tpu_torch.config import SceneConfig, escape_radius
    from bhr_tpu_torch.models.skybox import generate_skybox
    from bhr_tpu_torch.pipeline import Renderer

    sky = generate_skybox(256, 128, seed=5, n_stars=200)
    disk = np.random.default_rng(2).random((24, 64, 4)).astype(np.float32)
    w, h = EXTREME_FRAME
    path_launches = {"ray_march_slim": 0, "ray_march_aa": 0, BLOOM: 0}
    for tag, changes in EXTREME_SCENES.items():
        kw = dict(dict(fov=60.0, pov=POV, disk_inner_radius=2.0,
                       disk_outer_radius=3.5, n_stars=200), **changes)
        name = "ray_march_aa" if "anti_alias" in kw else "ray_march_slim"
        frames = {}
        with counted_plain_traces() as plain_calls:
            for device in ("cuda", "cpu"):
                cfg = SceneConfig(width=w, height=h, device=device, **kw).validated()
                reset_counts()
                frames[device] = Renderer(cfg, sky, disk).render(cfg.pov, cfg.fov)
                if device == "cuda":
                    launched = dict(launches)
                    expect_launches(launched, name, f"extreme {tag} frame")
                    check(not plain_calls[0], f"extreme {tag}: the card ran the plain trace")
                    path_launches[name] += launched[name]
                    path_launches[BLOOM] += launched[BLOOM]
        img, ref = frames["cuda"], frames["cpu"]
        diff = np.abs(img.astype(np.float64) - ref.astype(np.float64))
        black = tag == "fov 1"
        say(f"[extreme {tag}] {w}x{h} frame through {name} (launches "
            f"{launched[name]}): finite {bool(np.isfinite(img).all())}, range "
            f"{img.min():.4g}..{img.max():.6g}, std {img.std():.4e}; vs the CPU "
            f"port's frame max {diff.max():.3e} mean {diff.mean():.3e}")
        check(img.shape == (h, w, 3) and np.isfinite(img).all(),
              f"extreme {tag}: shape or not finite")
        check(0.0 <= img.min() and img.max() <= 1.0 + 1e-6,
              f"extreme {tag}: values out of [0, 1]")
        check(img.std() <= 1e-4 if black else img.std() > 1e-4,
              f"extreme {tag}: std {img.std()}")
        # A ray flipped by the kernel's rounding moves a pixel by up to 1
        # at this size, so the frame's max is printed, its mean checked.
        check(diff.mean() <= 5e-4, f"extreme {tag}: mean vs the CPU port {diff.mean()}")
        # The kernel against its plain version at FHD, the same scene.
        fhd = (1920, 1080, cfg.fov, cfg.disk_tilt, cfg.step_size,
               escape_radius(cfg.r_max, cfg.pov), cfg.disk_inner_radius,
               cfg.disk_outer_radius)
        res = trace_pair(name, *fhd, 3, pov=cfg.pov)
        check_pair(f"extreme {tag} 1920x1080", name, res, exact=False,
                   outliers_allowed=True)
        del res
    return path_launches


def tools_phase(launches, reset_counts, smi) -> dict:
    """Phase 11d: every tool of ``bhr_tpu_torch.tools`` at its default
    size on the card -> their launches."""
    from bhr_tpu_torch.tools import (
        check_texture,
        compare_aa,
        preview_v2,
        profile_pipeline,
        rotation_experiments,
    )
    from bhr_tpu_torch.utils.io import load_png_rgb8

    out = os.path.join("output", "torch_tools")
    rotation_pngs = ["tex_roll", "tex_keyframe", "tex_dynamic", "comp_00_temp_base",
                     "rot_05_arcs", "ab_turbulence"]
    runs = (
        ("check_texture", check_texture, ["--out", f"{out}/texture"],
         [f"{out}/texture_{p}.png" for p in ("polar", "topview", "density")], {}),
        ("check_texture --dynamic", check_texture, ["--dynamic", "--out", f"{out}/dyn"],
         [f"{out}/dyn_{p}.png" for p in ("polar", "topview", "density")],
         {BACKGROUND: 1}),
        ("preview_v2 --structure", preview_v2, ["--structure", "--out", f"{out}/v2"],
         [f"{out}/v2_{p}.png" for p in ("top", "density", "temperature")], {}),
        ("compare_aa", compare_aa, ["--out", f"{out}/aa_compare.png"],
         [f"{out}/aa_compare.png"],
         {"ray_march_slim": 1, "ray_march_aa": 1, BACKGROUND: 2, BLOOM: 4}),
        ("rotation_experiments --verify", rotation_experiments,
         ["--verify", "--out", f"{out}/rotation"],
         [f"{out}/rotation/{p}.png" for p in rotation_pngs], {BACKGROUND: 4}),
        # A texture stage (one background pass) per trace: 1 + 9 timed by
        # device_time + 4 by the stage timer; the post stage 9 + 4 times.
        ("profile_pipeline", profile_pipeline, [], [],
         {"ray_march_slim": 14, BACKGROUND: 14, BLOOM: 26}),
    )
    path_launches = {}
    for tag, tool, args, pngs, expected in runs:
        tee = _Tee()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = tool.main(args)
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in launches.items() if v}
        check(rc == 0, f"tool {tag} exited {rc}")
        check(launched == expected, f"tool {tag} launched {launched}, expected {expected}")
        shapes = []
        for png in pngs:
            img = load_png_rgb8(png)
            check(img.max() > 0, f"tool {tag}: {png} is black")
            shapes.append("x".join(map(str, img.shape[1::-1])))
        say(f"[tools {tag}] {smi}: exit 0 in {wall:.2f} s; " + (
            f"{len(pngs)} PNGs decoded, not black ({', '.join(shapes)})" if pngs
            else "no PNG") + f"; launches {launched or 'none'}")
        if tool is profile_pipeline:
            for line in tee.getvalue().splitlines():
                say(f"[tools profile_pipeline] {line}")
        for k, v in launched.items():
            path_launches[k] = path_launches.get(k, 0) + v
    return path_launches


def bench_phase(launches, reset_counts, smi, sass, n_sms, clock_mhz) -> dict:
    """Phase 12: ``bhr_tpu_torch.bench``'s measurements, short, on the
    card -> their launches."""
    from bhr_tpu_torch import bench

    path_launches = {}

    def measured(tag, fn, expected):
        """``fn()`` with the counts set to 0 just before and read just
        after; ``expected(result)`` is what the measurement says it launched."""
        reset_counts()
        out = fn()
        launched = {k: v for k, v in launches.items() if v}
        check(launched == expected(out),
              f"bench {tag} launched {launched}, expected {expected(out)}")
        for k, v in launched.items():
            path_launches[k] = path_launches.get(k, 0) + v
        return out

    def numbers(tag, values):
        for k, v in values.items():
            check(isinstance(v, (int, float)) and not isinstance(v, bool)
                  and math.isfinite(v), f"bench {tag}: {k} = {v!r}")

    for aa in (False, True):
        tag = "trace aa" if aa else "trace"
        tr = measured(tag, lambda: bench.time_trace(
            aa, sass=sass, n_sms=n_sms, clock_mhz=clock_mhz), lambda r: r["launches"])
        say(f"[bench {tag}] {smi}: bench scene 1920x1080 tilt 15, kernel "
            f"{tr['trace_ms']:.4f} ms, {tr['mray_steps_per_s']:.1f} Mray-steps/s, "
            f"{tr['steps_per_frame']} ray-steps ({tr['mean_steps_per_ray']:.2f} a ray); "
            f"FP32-bound share {tr['fp32_bound_share']:.4f}, issue-bound share "
            f"{tr['issue_bound_share']:.4f}; launches {tr['launches']}")
        numbers(tag, {k: v for k, v in tr.items() if k != "launches"})
        for k in ("fp32_bound_share", "issue_bound_share"):
            check(0.0 < tr[k] <= 1.05, f"bench {tag}: {k} {tr[k]}")
    # One background pass a batch of 4 frames on the one card.
    sd = measured("sd frame", lambda: bench.time_resolution("sd", 4),
                  lambda r: {"ray_march_slim": r["frames"], BACKGROUND: r["frames"] // 4,
                             BLOOM: 2 * r["frames"]})
    say(f"[bench sd frame] {smi}: bench scene 640x360, batch 4: median "
        f"{sd['frame_ms']:.3f} ms a frame over 5 batches (spread "
        f"{sd['spread'][0]:.3f}-{sd['spread'][1]:.3f}); {sd['frames']} frames, "
        f"ray_march_slim launches {sd['frames']}, {BACKGROUND} {sd['frames'] // 4}")
    numbers("sd frame", {"frame_ms": sd["frame_ms"], "min": sd["spread"][0],
                         "max": sd["spread"][1]})
    ns = measured("gather", bench.time_gather, lambda r: {})
    say(f"[bench gather] {smi}: tab[idx], 1920x1080 int64 indices into 1,048,576 "
        f"rows of 4 float32: {ns:.4f} ns an index")
    numbers("gather", {"ns_per_index": ns})

    return path_launches


def nan_trap_phase(launches, reset_counts, smi) -> dict:
    """Phase 13: the NaN trap of ``--debug_nans`` (``utils/nans.py``) and
    the build cache's ``--no_compile_cache`` -> the launches of the
    full-width paths driven with the trap on and off."""
    import dataclasses
    import tempfile

    import bhr_tpu_torch.cli as cli
    import bhr_tpu_torch.pipeline as pipeline
    from bhr_tpu_torch import _build
    from bhr_tpu_torch.config import (
        SceneConfig,
        compute_disk_texture_resolution,
        escape_radius,
    )
    from bhr_tpu_torch.interactive import InteractiveSession
    from bhr_tpu_torch.models.dynamic_disk import DynamicDiskSystem
    from bhr_tpu_torch.models.skybox import load_or_generate_skybox
    from bhr_tpu_torch.modes import _make_renderer
    from bhr_tpu_torch.parallel.mesh import make_frame_mesh
    from bhr_tpu_torch.parallel.video import (
        pack_frame_params,
        render_video_frames_sharded,
    )
    from bhr_tpu_torch.pipeline import Renderer
    from bhr_tpu_torch.utils import nans

    def parse(flags):
        return cli.config_from_args(cli.build_parser().parse_args(["-r", "fhd", *flags]))

    path_launches = {}
    checks = []
    real_count = nans._count_nans

    def counted(tensors):
        checks.append(len(tensors))
        return real_count(tensors)

    # 13a. one warm-up run with the trap off, then TRAP_TURNS turns of
    # (off, on, on, off): every output bit-equal, no trap fired; the
    # launches counted from 0 around each run.
    def off_and_on(tag, kernel, frames, background, make, run, equal):
        outs, ms, n_checks = [], {False: [], True: []}, {False: [], True: []}
        for i, on in enumerate((False, *(False, True, True, False) * TRAP_TURNS)):
            with nans.debug_nans(on):
                state = make()
                checks.clear()
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(run(state))
                torch.cuda.synchronize()
                if i:  # (not the warm-up)
                    ms[on].append((time.perf_counter() - t0) * 1e3)
                    n_checks[on].append(len(checks))
                launched = {k: v for k, v in launches.items() if v}
            want = {k: v for k, v in ((kernel, frames), (BACKGROUND, background),
                                      (BLOOM, 2 * frames)) if v}
            check(launched == want, f"[nans {tag}] launched {launched}, expected {want}")
            for k, v in want.items():
                path_launches[k] = path_launches.get(k, 0) + v
            del state
        same = all(equal(outs[0], o) for o in outs[1:])
        med = {on: statistics.median(v) for on, v in ms.items()}
        say(f"[nans {tag}] {smi}: median ms of {len(ms[False])} runs (host clock "
            f"to a synchronise, in turns off-on-on-off): trap off {med[False]:.3f} "
            f"[{min(ms[False]):.3f}-{max(ms[False]):.3f}], on {med[True]:.3f} "
            f"[{min(ms[True]):.3f}-{max(ms[True]):.3f}], on - off "
            f"{med[True] - med[False]:+.3f} ms; {n_checks[True][0] / frames:.2f} "
            f"checks a frame on, {max(n_checks[False])} off; all {len(outs)} "
            f"outputs bit-equal {same}; {kernel} launches {frames} a run, "
            f"{BACKGROUND} {background}")
        check(same, f"[nans {tag}] trap on and off differ")
        check(max(n_checks[False]) == 0 and min(n_checks[True]) > 0,
              f"[nans {tag}] checks {n_checks}")

    def images_equal(a, b):
        return a.shape == b.shape and np.array_equal(a, b)

    nans._count_nans = counted
    try:
        # The stills of modes.render_image, its scene set-up (sky, disk
        # system, renderer) outside the timed frame.
        def still(state):
            renderer, dynamic = state
            if dynamic is not None:
                renderer.update_disk_texture(
                    dynamic.advance(t=0.0, dt=0.0, recompute_stats=True))
            return renderer.render(renderer.config.pov, renderer.config.fov)

        for tag, flags, kernel, background in (
                ("fhd default", [], "ray_march_slim", 1),
                ("fhd aa_flare", AA_FLAGS, "ray_march_aa", 1),
                ("fhd v2", V2_FLAGS["v2"], "ray_march_slim", 0)):
            cfg = parse(flags)
            off_and_on(tag, kernel, 1, background,
                       lambda cfg=cfg: _make_renderer(cfg), still, images_equal)

        # One batch of 4 frames of the FHD orbit video, on a one-card grid.
        vcfg = parse(["--video", "--orbit", "--n_frames", "24", "--fps", "24"])
        mesh = make_frame_mesh(1, 1, devices=[torch.device("cuda", 0)])
        w, h = vcfg.image_size
        n_phi, n_r = compute_disk_texture_resolution(
            w, h, vcfg.pov, vcfg.fov, vcfg.disk_inner_radius, vcfg.disk_outer_radius)
        sky, _, _ = load_or_generate_skybox(None, 2048, 1024, vcfg.n_stars,
                                            seed=vcfg.skybox_seed)

        def video_state():
            dyn = DynamicDiskSystem(n_r, n_phi, vcfg.disk_inner_radius,
                                    vcfg.disk_outer_radius, seed=vcfg.seed,
                                    device="cuda")
            return dyn, pack_frame_params(dyn, 4, vcfg.disk_rotation_speed)

        def video_batch(state):
            dyn, packs = state
            out, _ = render_video_frames_sharded(vcfg, mesh, range(4), sky, dyn,
                                                 *packs, defer_fetch=True)
            return out.cpu().numpy()

        off_and_on("fhd video batch of 4", "ray_march_slim", 4, 1, video_state,
                   video_batch, images_equal)

        icfg = parse(["--interactive"])
        off_and_on("fhd session step", "ray_march_slim", 1, 1,
                   lambda: InteractiveSession(icfg, lookahead=False),
                   lambda sess: sess.step(0.05), images_equal)
    finally:
        nans._count_nans = real_count
    check(not nans.debug_nans_enabled(), "the trap was left on")

    # 13b. negative controls on the card: each must raise, naming its stage.
    gcfg = SceneConfig(device="cuda", **GOLDEN).validated()
    rng = np.random.default_rng(0)
    sky = rng.random((256, 512, 3), dtype=np.float32)
    tex = rng.random((64, 256, 4), dtype=np.float32)
    nan_sky = np.full_like(sky, np.nan)
    nan_tex = np.full_like(tex, np.nan)

    def must_raise(what, stage, fn, kernel=None):
        reset_counts()
        raised = None
        with nans.debug_nans():
            try:
                fn()
            except FloatingPointError as exc:
                raised = str(exc)
        launched = {k: v for k, v in launches.items() if v}
        say(f"[nans control {what}] {raised or 'no FloatingPointError'}; "
            f"launches {launched}")
        check(raised is not None and f"encountered in {stage}: " in raised,
              f"[nans control {what}] expected a raise at {stage}, got {raised}")
        if kernel is not None:
            check(launched == {kernel: 1},
                  f"[nans control {what}] launched {launched}")

    late = Renderer(gcfg, nan_sky, tex)  # made before the trap is on
    must_raise("nan skybox", "shade",
               lambda: late.render(gcfg.pov, gcfg.fov), "ray_march_slim")
    must_raise("nan disk texture", "mips", lambda: Renderer(gcfg, sky, nan_tex))
    r = Renderer(gcfg, sky, tex)
    cam = r.camera(gcfg.pov, gcfg.fov)
    r_escape = escape_radius(gcfg.r_max, gcfg.pov)
    # A NaN camera position: the kernel's min/max drop the NaN from the
    # step size, so every ray marches to the iteration cap, neither
    # captured nor escaped, and it writes no NaN (as its plain version
    # and bhr_tpu's tracer): the trap stays quiet, the frame is black.
    bad = dataclasses.replace(cam, pos=np.full(3, np.nan, np.float32))
    reset_counts()
    with nans.debug_nans():
        lost = r.trace(bad, r_escape, False)
    n_rays = gcfg.image_size[0] * gcfg.image_size[1]
    quiet = (not bool(lost.captured.any()) and not bool(lost.escaped.any())
             and int(lost.hit_count.sum()) == 0
             and not bool(lost.escape_dir.isnan().any())
             and not bool(lost.hits.isnan().any()))
    say(f"[nans nan camera 320x180] ray_march_slim launches "
        f"{launches['ray_march_slim']}: {n_rays} rays neither captured nor "
        f"escaped, no hit and no NaN in the outputs {quiet}; the trap stays "
        f"quiet")
    check(quiet and launches["ray_march_slim"] == 1,
          "the kernel's outputs of a NaN camera")
    # The trace stage reads the kernel's own outputs: one of their values
    # made NaN after the launch must raise there.
    real_trace = pipeline.trace_geodesics_cuda

    def poisoned(*args, **kw):
        out = real_trace(*args, **kw)
        out.escape_dir[1234, 1] = float("nan")
        return out

    pipeline.trace_geodesics_cuda = poisoned
    try:
        must_raise("kernel output with one NaN 320x180", "trace[ray_march_slim]",
                   lambda: r.trace(cam, r_escape, False), "ray_march_slim")
    finally:
        pipeline.trace_geodesics_cuda = real_trace
    del late, r, lost

    # 13c. --no_compile_cache in a process of its own: ray_march (and the
    # PNG encoder) built afresh into a private directory that is gone
    # after it, the persistent build directory untouched.
    def listing():
        return {name: os.stat(os.path.join(_build.BUILD_DIR, name)).st_mtime_ns
                for name in sorted(os.listdir(_build.BUILD_DIR))}

    def cli_process(tag, argv, tmp):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "bhr_tpu_torch.cli", *argv], cwd=ROOT,
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "TMPDIR": tmp})
        wall = time.perf_counter() - t0
        # "built <dir>/lib<name>_<16 hex digits>.so in <s> s (set-up)"
        built = {name: (os.path.dirname(path), float(s)) for path, name, s in
                 re.findall(r"^built (\S*/lib(\w+?)_[0-9a-f]{16}\.so) in "
                            r"([0-9.]+) s", proc.stdout, re.M)}
        say(f"[nans {tag}] {smi}: exit {proc.returncode} in {wall:.1f} s "
            f"(process start and build included); built "
            + ", ".join(f"{k} in {v[1]:.2f} s" for k, v in sorted(built.items())))
        check(proc.returncode == 0,
              f"[nans {tag}] exit {proc.returncode}: {proc.stderr[-2000:]}")
        check("ray_march" in built, f"[nans {tag}] ray_march was not built afresh")
        private = built["ray_march"][0]
        check(os.path.dirname(private) == tmp
              and os.path.basename(private).startswith("bhr_tpu_torch_build_"),
              f"[nans {tag}] ray_march built into {private}, not a private "
              f"directory in {tmp}")
        check(all(d == private for d, _ in built.values()),
              f"[nans {tag}] built {built}")
        check(not os.path.exists(private),
              f"[nans {tag}] {private} left behind")
        check(listing() == before, f"[nans {tag}] _build/ changed")
        return built

    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    before = listing()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "output")) as tmp:
        out = os.path.join(tmp, "still.png")
        built = cli_process(
            "--no_compile_cache still",
            ["--no_compile_cache", "--debug_nans", "--width", "320", "--height",
             "180", "-o", out], tmp)
        say(f"[nans --no_compile_cache still] {smi}: ray_march's nvcc "
            f"{built['ray_march'][1]:.2f} s into a private directory under "
            f"{os.path.relpath(tmp, ROOT)}/, gone after the run; "
            f"bhr_tpu_torch/_build/ holds the same {len(before)} files with the "
            f"same mtimes; {os.path.getsize(out)} bytes of PNG")
        check(os.listdir(tmp) == ["still.png"], f"left in {tmp}: {os.listdir(tmp)}")

        # 13d. bhr_tpu's three flags together on a short orbit video.
        cli_process(
            "three flags video",
            ["--debug_nans", "--compile_cache", "--no_compile_cache", "--video",
             "--orbit", "--n_frames", "4", "--fps", "2", "--width", "320",
             "--height", "180", "-o", os.path.join(tmp, "orbit.mp4")], tmp)
    return path_launches


BG_SCALARS = (3.0, 2.7, 2.0, 15.0)  # az_freq, az_shear, r_inner, r_outer
BG_BATCH = np.asarray([f * 0.1 for f in (20, 21, 22, 23)], np.float32)
# The plain version's element-wise operations with a float32 result that
# do arithmetic: each takes an FP32 lane for at least a clock in the
# kernel, which fuses none of them into an FMA (it keeps their rounding).
BG_FP32_OPS = {"add", "sub", "rsub", "mul", "div", "floor", "clamp", "sqrt",
               "reciprocal", "sin", "cos", "pow"}
# Its int32 arithmetic (the lattice hash, the gradient pick, the corner
# offsets). The kernel fuses some of it (a multiply and an add in one
# IMAD, an xor and an and in one LOP3), so the count is no lower bound.
BG_INT_OPS = {"add", "sub", "mul", "bitwise_and", "bitwise_xor", "__rshift__",
              "bitwise_right_shift"}
INT32_LANES_PER_SM = 64  # H100: half the FP32 lanes


def plain_background_ops(*args, **kw):
    """(aten calls of one plain background pass on the card, the FP32
    operations in it: the elements each ``BG_FP32_OPS`` call writes,
    summed; the int32 operations, the same for ``BG_INT_OPS``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from bhr_tpu_torch.ops.background import generate_background_components_plain

    class Count(TorchDispatchMode):
        calls = fp32 = int32 = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            Count.calls += 1
            name = func.overloadpacket.__name__
            for o in tree_leaves(out):
                if isinstance(o, torch.Tensor):
                    if name in BG_FP32_OPS and o.dtype == torch.float32:
                        Count.fp32 += o.numel()
                    elif name in BG_INT_OPS and o.dtype == torch.int32:
                        Count.int32 += o.numel()
            return out

    with Count():
        generate_background_components_plain(*args, **kw)
    torch.cuda.synchronize()
    return Count.calls, Count.fp32, Count.int32


def background_phase(smi, n_sms, clock_mhz) -> dict:
    """Phase 2b: the background-noise kernel (``csrc/background_noise.cu``)
    against its plain version on the card, at the FHD (2912x416, s = 2)
    and 4K (5824x832, s = 4) textures of the default scene, for one frame
    at t = 0 and 7.3 and for a video batch's four frames in one pass:
    the unequal values of each plane (0 expected), the max |diff| (1e-5 at
    most, ``test_torch_texture.py``'s field bound), one launch a pass,
    the kernel's ms (CUDA events over 20 passes through the wrapper)
    beside its bound (the plain version's FP32 operations, one a lane and
    a clock, over the SMs at the maximum clock; the output's bytes at
    3.35 TB/s), the plain pass's ms (host clock, synchronized) and its
    aten calls. Returns the kernel's numbers for phase 14's JSON row."""
    from bhr_tpu_torch import _build
    from bhr_tpu_torch.config import compute_disk_texture_resolution
    from bhr_tpu_torch.models.dynamic_disk import adaptive_generation_scale
    from bhr_tpu_torch.ops.background import (
        generate_background_components as bg,
        generate_background_components_plain as plain,
    )

    t0 = time.perf_counter()
    built = _build.build("background_noise")
    say(f"[build] background_noise: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {built.seconds:.2f} s) -> {os.path.relpath(built.path, ROOT)}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] ptxas background_noise: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            check(not spills or spills.groups() == ("0", "0"), f"ptxas spills: {line}")
    lane_rate = n_sms * ISSUE_LANES_PER_SM * clock_mhz * 1e6
    row = dict(max_abs_err=0.0)
    for tag, (w, h) in (("fhd", (1920, 1080)), ("4k", (3840, 2160))):
        n_phi, n_r = compute_disk_texture_resolution(w, h, POV, 90.0, 2.0, 15.0)
        s = adaptive_generation_scale(n_r, n_phi)
        for t in (0.0, 7.3, BG_BATCH):
            frames = np.size(t)
            what = (f"[background {tag} {n_phi}x{n_r} s={s}] F={frames} "
                    f"t={np.round(np.atleast_1d(t), 2).tolist()}")
            before = bg.launches
            got = bg(n_r, n_phi, *BG_SCALARS, t, generation_scale=s, device="cuda")
            launched = bg.launches - before
            want = plain(n_r, n_phi, *BG_SCALARS, t, s, "cuda")
            torch.cuda.synchronize()
            check(got.shape == want.shape, f"{what} shape {tuple(got.shape)} "
                  f"!= {tuple(want.shape)}")
            unequal = [int((got[..., q, :, :] != want[..., q, :, :]).sum())
                       for q in range(got.shape[-3])]
            err = float((got - want).abs().max())
            say(f"{what}: unequal values by plane {unequal} of "
                f"{got[..., 0, :, :].numel()} each; max |diff| {err:.3e}; "
                f"kernel launches {launched}")
            check(launched == 1, f"{what}: {launched} launches")
            check(err <= 1e-5, f"{what}: max |diff| {err} above 1e-5")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            del got, want
            if frames == 1 and t != 0.0:
                continue  # timed at t = 0 and over the batch
            reps = 20
            bg(n_r, n_phi, *BG_SCALARS, t, generation_scale=s, device="cuda")
            _, ms = cuda_ms(lambda: bg(n_r, n_phi, *BG_SCALARS, t,
                                       generation_scale=s, device="cuda"), reps)
            t1 = time.perf_counter()
            for _ in range(reps):
                bg(n_r, n_phi, *BG_SCALARS, t, generation_scale=s, device="cuda")
            host_us = (time.perf_counter() - t1) / reps * 1e6
            torch.cuda.synchronize()
            plain_ms = []
            for _ in range(3):
                t1 = time.perf_counter()
                plain(n_r, n_phi, *BG_SCALARS, t, s, "cuda")
                torch.cuda.synchronize()
                plain_ms.append((time.perf_counter() - t1) * 1e3)
            calls, fp32, int32 = plain_background_ops(n_r, n_phi, *BG_SCALARS, t, s,
                                                      "cuda")
            ops_ms = fp32 / lane_rate * 1e3
            int_ms = int32 / (n_sms * INT32_LANES_PER_SM * clock_mhz * 1e6) * 1e3
            points = frames * (n_r // s) * (n_phi // s)
            bytes_ms = frames * 7 * n_r * n_phi * 4 / 3.35e12 * 1e3
            bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
            say(f"{what} {smi}: kernel {ms:.4f} ms a pass ({ms / frames:.4f} a "
                f"frame; host {host_us:.1f} us a call); bound {bound_ms:.4f} ms "
                f"by {bound_by} ({fp32 / points:.1f} "
                f"FP32 operations a point, {fp32:.4e} a pass, at {lane_rate:.4e}/s; "
                f"output {bytes_ms:.4f} ms at 3.35 TB/s), the kernel at "
                f"{bound_ms / ms:.1%} of it; beside it, not a bound: the plain "
                f"version's int32 operations, {int32 / points:.1f} a point, "
                f"{int_ms:.4f} ms at {INT32_LANES_PER_SM} INT32 lanes an SM "
                f"({int_ms / ms:.1%} of the kernel's time); plain pass "
                f"{min(plain_ms):.1f}-{max(plain_ms):.1f} ms, {calls} aten calls")
            if tag == "fhd" and frames == 1:
                row.update(ms=ms, plain_ms=min(plain_ms), bound_ms=bound_ms,
                           bound_by=bound_by)
    return row


def bloom_phase(smi, n_sms, clock_mhz) -> dict:
    """Phase 2c: the bloom kernel (``csrc/bloom.cu``) against its plain
    version on the card, on the bg and disk layers of a rendered frame:
    the FHD default scene and the 4K AA + flare scene of the benchmark's
    cells. Unequal values (0 expected; NaN where the plain version has
    it), two launches a call, the kernel's ms (CUDA events, the mean of
    20 calls after 3 warm-ups) beside its bound (the blur's FP32
    operations, one a lane and a clock, or the layers read once and the
    frame written once at 3.35 TB/s) and the plain pass's ms (host clock,
    synchronized) and aten calls, and what each pass launched on the card
    (torch.profiler). Returns the FHD numbers for phase 14's
    JSON row, with the largest |kernel - plain| of both frames."""
    from torch.utils._python_dispatch import TorchDispatchMode

    import bhr_tpu_torch.cli as cli
    from bhr_tpu_torch import _build
    from bhr_tpu_torch.modes import _make_renderer
    from bhr_tpu_torch.ops.bloom import bloom_composite, bloom_composite_plain, bloom_tables

    t0 = time.perf_counter()
    built = _build.build("bloom")
    say(f"[build] bloom: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {built.seconds:.2f} s) -> {os.path.relpath(built.path, ROOT)}")
    for line in built.log.splitlines():
        entry = re.search(r"entry function '.*(bloom_rows|bloom_cols)", line)
        if entry:
            say(f"[build] ptxas bloom: {entry.group(1)}")
        elif "registers" in line or "spill" in line:
            say(f"[build] ptxas bloom: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            check(not spills or spills.groups() == ("0", "0"), f"ptxas spills: {line}")

    class Calls(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Calls.n += 1
            return func(*args, **(kwargs or {}))

    def on_card(fn):
        """(launch calls, host-to-device or other copy calls, {kernel: count})
        of one call of ``fn``, from torch.profiler; launches counted as the
        benchmark's device trace counts them (``devtrace.LAUNCH_CALLS``)."""
        from torch.profiler import ProfilerActivity, profile

        from benchmark.devtrace import LAUNCH_CALLS, short_name

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        kernels = collections.Counter()
        for e in rows:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = short_name(e.key)
                # The innermost functor names the op (BinaryFunctor<..., MulFunctor>).
                functor = re.findall(r"\w+Functor\w*|\w+_kernel_impl\w*", name.split("(")[0])
                kernels[functor[-1] if functor else name[:60]] += e.count
        return (sum(e.count for e in rows if e.key in LAUNCH_CALLS),
                sum(e.count for e in rows if e.key.startswith("cudaMemcpy")),
                dict(kernels.most_common()))

    lane_rate = n_sms * ISSUE_LANES_PER_SM * clock_mhz * 1e6
    row = {}
    for tag, flags in (("fhd", ["-r", "fhd"]), ("4k", ["-r", "4k", *AA_FLAGS])):
        cfg = cli.config_from_args(cli.build_parser().parse_args(flags))
        renderer, dynamic = _make_renderer(cfg)
        renderer.update_disk_texture(dynamic.advance(t=0.0, dt=0.0, recompute_stats=True))
        bg, disk = renderer.render_layers(cfg.pov, cfg.fov)
        del renderer, dynamic
        (w, h), radius = cfg.image_size, bloom_tables(*cfg.image_size[::-1])[0]
        what = f"[bloom {tag} {w}x{h} R={radius}]"
        before = bloom_composite.launches
        got = bloom_composite(bg, disk)
        launched = bloom_composite.launches - before
        want = bloom_composite_plain(bg, disk)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        unequal = int((got[~nan] != want[~nan]).sum()) + int((torch.isnan(got) != nan).sum())
        err = float((got[~nan] - want[~nan]).abs().max())
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
        say(f"{what}: {unequal} unequal values of {got.numel()}, max |kernel - "
            f"plain| {err:.3e} off NaN; disk layer "
            f"max {float(disk.max()):.4f}, {float((disk.sum(-1) > 0).float().mean()):.1%} "
            f"of pixels lit; kernel launches {launched}")
        check(launched == 2, f"{what}: {launched} launches")
        check(unequal == 0, f"{what}: {unequal} values differ from the plain version")
        del got, want
        for _ in range(3):
            bloom_composite(bg, disk)
        _, ms = cuda_ms(lambda: bloom_composite(bg, disk), 20)
        plain_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bloom_composite_plain(bg, disk)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t1) * 1e3)
        Calls.n = 0
        with Calls():
            bloom_composite_plain(bg, disk)
        for route, fn in (("kernel", bloom_composite), ("plain", bloom_composite_plain)):
            n_launch, n_copy, kernels = on_card(lambda: fn(bg, disk))
            say(f"{what} {route} pass on the card: {n_launch} kernel launches, "
                f"{n_copy} copy calls; kernels {kernels}")
            if route == "kernel":
                check(n_copy == 0, f"{what}: a warm kernel pass made {n_copy} copies")
        ops = 2 * (2 * radius + 1) * 2 * h * w * 3  # 2 passes, a multiply and an add a tap
        ops_ms = ops / lane_rate * 1e3
        bytes_ms = 3 * h * w * 3 * 4 / 3.35e12 * 1e3  # bg and disk read, the frame written
        bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
        say(f"{what} {smi}: kernel {ms:.4f} ms a frame; bound {bound_ms:.4f} ms by "
            f"{bound_by} ({ops:.4e} FP32 operations at {lane_rate:.4e}/s; bytes "
            f"{bytes_ms:.4f} ms at 3.35 TB/s), the kernel at {bound_ms / ms:.1%} of "
            f"it; plain pass {min(plain_ms):.2f}-{max(plain_ms):.2f} ms, "
            f"{Calls.n} aten calls")
        if tag == "fhd":
            row.update(ms=ms, plain_ms=min(plain_ms), bound_ms=bound_ms,
                       bound_by=bound_by)
        del bg, disk
    return row


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
    from bhr_tpu_torch.ops.geodesic_cuda import KERNELS, kernel_name
    from bhr_tpu_torch.pipeline import Renderer

    launches = KernelLaunches()
    reset_counts = launches.reset

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
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            check(not spills or spills.groups() == ("0", "0"), f"ptxas spills: {line}")
    sass = sass_loop_counts(built.path)
    check(sorted(sass) == sorted(KERNELS), f"SASS functions {sorted(sass)}")
    for name in KERNELS:
        c = sass[name]
        check(c["total"] > 0, f"{name}: no loop found in the SASS")
        say(f"[build] SASS {name}: loop body {c['total']} instructions, "
            f"{c['mufu']} MUFU, {c['fp32']} FFMA/FADD/FMUL; a surviving step "
            f"issues at least {c['step']} ({c['step_mufu']} MUFU), a "
            f"terminating one {c['last']} ({c['last_mufu']} MUFU)")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"[build] {n_sms} SMs at max SM clock {clock_mhz:.0f} MHz: issue "
        f"{n_sms * ISSUE_LANES_PER_SM * clock_mhz * 1e6:.4e} thread-instructions/s, "
        f"MUFU {n_sms * MUFU_LANES_PER_SM * clock_mhz * 1e6:.4e}/s")

    # 2b. the background-noise kernel vs its plain version
    bg_row = background_phase(smi, n_sms, clock_mhz)

    # 2c. the bloom kernel vs its plain version, on rendered frames
    bloom_row = bloom_phase(smi, n_sms, clock_mhz)

    # 3. kernel vs plain at the small shapes
    for tag, args, reps in (
        ("128x32", (128, 32, 60.0, 15.0, 0.2, 12.04, 2.0, 3.5), 20),
        ("320x180", (320, 180, 60.0, 15.0, 0.1, escape_radius(10.0, POV), 2.0, 3.5), 20),
    ):
        for name in KERNELS:
            # Categories and step counts exact at the parity scene.
            check_pair(tag, name, trace_pair(name, *args, reps),
                       exact=tag == "128x32", outliers_allowed=False)

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
            f"mean {diff.mean():.3e}; {expected} launches {launched[expected]}, "
            f"{BACKGROUND} {launched[BACKGROUND]}")
        check(img.shape == (180, 320, 3) and np.isfinite(img).all(),
              f"golden {scene} shape/finite")
        check(diff.max() <= 5e-2 and diff.mean() <= 5e-4,
              f"golden {scene} outside bounds")
        expect_launches(launched, expected, f"golden {scene}", background=1)
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

    # 4 (V2). the volume disk's goldens: the slim kernel once, hits
    # recorded, and never the no-disk kernel or the plain trace.
    for scene, extra in {**V2_SCENES, "v2 + anti_alias": dict(
            V2_SCENES["v2"], anti_alias="lod_radius")}.items():
        with counted_plain_traces() as plain_calls:
            reset_counts()
            img = render_image(SceneConfig(device="cuda", **{**GOLDEN, **extra}))
            launched = dict(launches)
        family = scene.split()[0]
        d_max, d_mean = golden_diff(img, f"e2e_cpu_{family}")
        center = img[90 - 16: 90 + 16, 160 - 16: 160 + 16]
        say(f"[golden {scene}] vs e2e_cpu_{family}.npz max {d_max:.3e} mean "
            f"{d_mean:.3e}; ray_march_slim launches {launched['ray_march_slim']}, "
            f"ray_march_nodisk {launched['ray_march_nodisk']}, plain trace calls "
            f"{plain_calls[0]}")
        check(np.isfinite(img).all() and d_max <= 5e-2 and d_mean <= 5e-4,
              f"golden {scene} outside bounds")
        expect_launches(launched, "ray_march_slim", f"golden {scene}")
        check(not plain_calls[0], f"golden {scene} ran the plain trace")
        check(img.max() > 0.5 and (center.sum(axis=-1) < 0.05).mean() > 0.5,
              f"golden {scene}: no bright disk or no dark shadow")
        if family != scene:
            check(np.array_equal(img, images[family]),
                  "V2 with anti_alias differs from V2 without")
        images[scene] = img

    # 5. the main paths at full width
    path_launches = {BACKGROUND: 0, BLOOM: 0}

    def cli_frame(tag, flags, expected, background=0):
        out_png = os.path.join("output", f"torch_fhd_{tag}.png")
        reset_counts()
        t0 = time.perf_counter()
        check(cli.main(["-r", "fhd", *flags, "-o", out_png]) == 0, "CLI exit code")
        launched = dict(launches)
        say(f"[fhd-cli {tag}] {' '.join(flags) or '(defaults)'}: wrote {out_png} "
            f"({os.path.getsize(out_png)} bytes) in {time.perf_counter() - t0:.2f} s; "
            f"{expected} launches {launched[expected]}, {BACKGROUND} "
            f"{launched[BACKGROUND]}")
        expect_launches(launched, expected, f"FHD {tag} frame", background)
        path_launches[expected] = path_launches.get(expected, 0) + launched[expected]
        path_launches[BACKGROUND] += background
        path_launches[BLOOM] += launched[BLOOM]

    cli_frame("default", [], "ray_march_slim", background=1)
    cli_frame("aa_flare", AA_FLAGS, "ray_march_aa", background=1)
    # This slice's path: the V2 volume disk, plain and with the structure
    # flags and the scientific palette.
    with counted_plain_traces() as plain_calls:
        for tag, flags in V2_FLAGS.items():
            cli_frame(tag, flags, "ray_march_slim")
    check(not plain_calls[0], "an FHD V2 frame ran the plain trace")
    for tag, flags in V2_FLAGS.items():
        v2_cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["-r", "fhd", *flags]))
        med, host_ms, busy, n_kernels, frame = static_stage_times(v2_cfg)
        check(bool(torch.isfinite(frame).all()) and frame.shape == (1080, 1920, 3)
              and float(frame.max()) > 0.5, f"FHD {tag} frame not finite or dark")
        say(f"[fhd-frame {tag}] median ms over 3 frames: " + ", ".join(
            f"{k} {v:.3f}" for k, v in med.items())
            + f"; total {sum(med.values()):.3f} (no texture stage); host "
            f"{host_ms:.3f} ms to enqueue a frame; device busy "
            + ("not measured (the profiler reported no device time)"
               if busy is None else f"{busy:.1%} of a frame's wall time, in "
               f"{n_kernels} kernels and copies"))
        v2_shade_split(v2_cfg, tag)
        del frame

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
    path_launches[BLOOM] += launched[BLOOM]

    # Every instantiation vs its plain version at FHD. The step-count
    # instantiations run on no frame's path: their path is this
    # diagnostic, counted over its kernel runs (WARMUP + 3 timed).
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
        if name == "ray_march_aa":
            differential_error_causes(f"kernel-vs-plain 1920x1080 {name}", res[0],
                                      res[1], camera_tensor(1920, 1080, cfg.fov),
                                      1920, 1080)
        d = check_pair("1920x1080", name, res, exact=False, outliers_allowed=True)
        others = {k: v for k, v in launched.items() if k != name and v}
        check(launched[name] == WARMUP + 3 and not others,
              f"FHD {name} pair launched {launched}, expected {name} "
              f"{WARMUP + 3} times")
        fhd[name] = (res[2], res[3], d)
        traces[name] = res[0]
        if name.endswith("_steps"):
            path_launches[name] = launched[name]
            steps[name] = res[0].steps.to(torch.float64)
        band_ms[name] = check_band(name, res[0], *fhd_args, 2 * band_rows,
                                   band_rows, 3)
        del res

    # The AA kernels' 4K band 2 of 4 (the shape of each of phase 6c's
    # launches) against the plain band, with FHD's tolerances; 6c holds
    # the tiled 4K frame against the whole one.
    cfg_4k = cli.config_from_args(cli.build_parser().parse_args(
        ["-r", "4k", *AA_FLAGS]))
    w_4k, h_4k = cfg_4k.image_size
    check(tuple(cfg_4k.pov) == POV, f"4K camera {cfg_4k.pov}")
    for name in ("ray_march_aa", "ray_march_aa_steps"):
        check_band(name, None, w_4k, h_4k, cfg_4k.fov, cfg_4k.disk_tilt,
                   cfg_4k.step_size, escape_radius(cfg_4k.r_max, cfg_4k.pov),
                   cfg_4k.disk_inner_radius, cfg_4k.disk_outer_radius,
                   2 * h_4k // TILES, h_4k // TILES, 3)

    # The V2 4K still's launches of phase 6d, with the V2 scene's escape
    # radius, disk radii and tilt and FHD's tolerances: ray_march_slim's
    # band 2 of 4 against the plain band and the whole-frame kernel's
    # rows, and the whole frame against its plain version.
    v2_4k = cli.config_from_args(cli.build_parser().parse_args(
        ["-r", "4k", *V2_FLAGS["v2sci"]]))
    check(tuple(v2_4k.image_size) == (w_4k, h_4k) and not v2_4k.use_ray_differentials,
          f"4K V2 scene {v2_4k.image_size}")
    v2_4k_args = (w_4k, h_4k, v2_4k.fov, v2_4k.disk_tilt, v2_4k.step_size,
                  escape_radius(v2_4k.r_max, v2_4k.pov),
                  v2_4k.disk_inner_radius, v2_4k.disk_outer_radius)
    res = trace_pair("ray_march_slim", *v2_4k_args, 3)
    check_pair("3840x2160 v2", "ray_march_slim", res, exact=False,
               outliers_allowed=True)
    check_band("ray_march_slim", res[0], *v2_4k_args, 2 * h_4k // TILES,
               h_4k // TILES, 3)
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

    # The bounds of each instantiation on this run's FHD data, over the
    # step counts of its _steps twin: the same per-ray code, plus the
    # counter.
    bounds, issue = {}, {}
    sel = slice(2 * band_rows * 1920, 3 * band_rows * 1920)
    for name in KERNELS:
        twin = name if name.endswith("_steps") else name + "_steps"
        band_trace = traces[name]._replace(
            captured=traces[name].captured[sel], escaped=traces[name].escaped[sel],
            hit_count=traces[name].hit_count[sel])
        bounds[name] = bound(name, steps[twin], traces[name])
        band_bound = bound(name, steps[twin][sel], band_trace)
        issue[name] = issue_bounds(sass[name], float(steps[twin].sum()),
                                   terminated(traces[name]), n_sms, clock_mhz)
        band_issue = issue_bounds(sass[name], float(steps[twin][sel].sum()),
                                  terminated(band_trace), n_sms, clock_mhz)
        say(f"[bound 1920x1080] {name}: {bounds[name][0]:.4f} ms by "
            f"{bounds[name][1]}; kernel {fhd[name][0]:.3f} ms "
            f"({bounds[name][0] / fhd[name][0]:.1%} of the bound's rate); "
            f"issue bound {issue[name][0]:.4f} ms "
            f"({issue[name][0] / fhd[name][0]:.1%}), MUFU bound "
            f"{issue[name][1]:.4f} ms ({issue[name][1] / fhd[name][0]:.1%}); "
            f"band 2 of {TILES}: {band_bound[0]:.4f} ms by "
            f"{band_bound[1]}, kernel {band_ms[name]:.3f} ms "
            f"({band_bound[0] / band_ms[name]:.1%}; issue bound "
            f"{band_issue[0]:.4f} ms, {band_issue[0] / band_ms[name]:.1%}; "
            f"MUFU {band_issue[1] / band_ms[name]:.1%})")
    del traces

    # 6b, 6c. the tile path
    for name, n in tile_phase(launches, reset_counts).items():
        path_launches[name] += n

    # 7. the orbit video
    video_launches, fhd_video_stats = video_phase(launches, reset_counts)
    for name, n in video_launches.items():
        path_launches[name] += n

    # 8. the interactive session
    for name, n in interactive_phase(launches, reset_counts, smi).items():
        path_launches[name] += n

    # 9. the multi-process fleet
    for name, n in fleet_phase(fhd_video_stats, smi).items():
        path_launches[name] += n

    # 10. the static disk of --disk_texture auto
    with fresh_texture_cache() as cache_dir:
        for name, n in auto_disk_phase(launches, reset_counts, cache_dir).items():
            path_launches[name] += n

    # 11. the native PNG encoder, the kernel at the extreme scenes, the tools
    for phase in (png_phase, extreme_phase, tools_phase):
        for name, n in phase(launches, reset_counts, smi).items():
            path_launches[name] += n

    # 12. bhr_tpu_torch.bench's measurements, short
    for name, n in bench_phase(launches, reset_counts, smi, sass, n_sms,
                               clock_mhz).items():
        path_launches[name] += n

    # 13. the NaN trap and the build cache
    for name, n in nan_trap_phase(launches, reset_counts, smi).items():
        path_launches[name] += n

    # 14. results
    from bhr_tpu_torch.ops.background import generate_background_components

    check(generate_background_components.plain_passes == 0,
          f"{generate_background_components.plain_passes} background passes "
          "on the card ran the plain version")
    check(path_launches[BACKGROUND] > 0, "no main path launched the background kernel")
    check(path_launches[BLOOM] > 0, "no main path launched the bloom kernel")
    say(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "bhr_tpu_torch/csrc/ray_march.cu",
        "replaces": REPLACES,
        "launches": path_launches[name],
        "max_abs_err": max(fhd[name][2].float_err, fhd[name][2].diff_err,
                           fhd[name][2].tfrac_err),
        "ms": fhd[name][0],
        "plain_ms": fhd[name][1],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "issue_bound_ms": issue[name][0],
        "library_ms": None,  # no PyTorch call computes a ray march
    } for name in KERNELS] + [{
        "name": "background_noise",
        "route": "cuda",
        "source": "bhr_tpu_torch/csrc/background_noise.cu",
        "replaces": None,  # XLA fused this graph on the TPU
        "launches": path_launches[BACKGROUND],
        "max_abs_err": bg_row["max_abs_err"],
        "ms": bg_row["ms"],
        "plain_ms": bg_row["plain_ms"],
        "bound_ms": bg_row["bound_ms"],
        "bound_by": bg_row["bound_by"],
        # Not worked out: a point's instructions depend on each field's
        # octave count, read at run time by a rolled loop, so the SASS
        # alone gives no count a point (phase 2b prints the plain
        # version's int32 work beside the FP32 bound instead).
        "issue_bound_ms": None,
        "library_ms": None,  # no PyTorch call computes the noise
    }, {
        "name": "bloom",
        "route": "cuda",
        "source": "bhr_tpu_torch/csrc/bloom.cu",
        "replaces": None,  # XLA fused the bloom on the TPU
        "launches": path_launches[BLOOM],
        "max_abs_err": bloom_row["max_abs_err"],
        "ms": bloom_row["ms"],
        "plain_ms": bloom_row["plain_ms"],
        "bound_ms": bloom_row["bound_ms"],
        "bound_by": bloom_row["bound_by"],
        "issue_bound_ms": None,  # not worked out
        "library_ms": None,  # the port calls no library blur
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
