#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line (or a few) each; any failure raises and the script
exits non-zero without printing a result:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build the ray-march kernel from ``bhr_tpu_torch/csrc`` and time it;
3. kernel vs its plain PyTorch version on the card, at 128x32 and at the
   320x180 golden scene: rays whose captured/escaped/hit_count differ
   (pass at <= 0.1%) and the largest escape-direction / hit difference
   on agreeing rays (pass at <= 2e-3);
4. the golden scene through ``bhr_tpu_torch.modes.render_image`` on
   CUDA, within max 5e-2 / mean 5e-4 of ``tests/goldens/e2e_cpu.npz``,
   with exactly one kernel launch and the scene's sanity checks;
5. the main path at full width: the default 1920x1080 frame through
   ``bhr_tpu_torch.cli.main``; then one Renderer for 1 warm-up and 3
   timed frames (median ms per stage with CUDA events), one plain trace
   at FHD, and the kernel's agreement with it;
6. a JSON line describing the kernel, then the result line
   ``{"ok": true, "device": {...}}`` as the last line.

Imports torch, numpy and bhr_tpu_torch only.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

TOL_FLIP_FRAC = 1e-3  # rays allowed to change category
TOL_FLOAT = 2e-3  # escape direction / hit xy on agreeing rays
POV = (6.0, 0.0, 0.5)
GOLDEN = dict(width=320, height=180, pov=POV, fov=60.0, step_size=0.1,
              r_max=10.0, n_stars=100, disk_inner_radius=2.0,
              disk_outer_radius=3.5, disk_tilt=15.0, anti_alias="disabled",
              seed=42)


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


def compare(kernel, plain):
    """(category flips, their fraction, largest float diff on agreeing
    rays over escape_dir and hit features 0..4)."""
    flip = ((kernel.captured != plain.captured) | (kernel.escaped != plain.escaped)
            | (kernel.hit_count != plain.hit_count))
    n_flip = int(flip.sum())
    agree = ~flip
    err = float((kernel.escape_dir - plain.escape_dir).abs()[agree].max())
    for k in range(kernel.hits.shape[0]):
        sel = agree & (plain.hit_count > k)
        if bool(sel.any()):
            err = max(err, float((kernel.hits[k, :5][:, sel]
                                  - plain.hits[k, :5][:, sel]).abs().max()))
    return n_flip, n_flip / flip.numel(), err


def trace_pair(w, h, fov, tilt, h_base, r_escape, r_inner, r_outer, reps):
    """Kernel and plain version on the same camera tensor on the card."""
    from bhr_tpu_torch.camera import build_camera
    from bhr_tpu_torch.ops.geodesic import primary_rays_from_params, trace_geodesics
    from bhr_tpu_torch.ops.geodesic_cuda import camera_params, trace_geodesics_cuda

    cam = torch.as_tensor(camera_params(build_camera(POV, fov, w, h)), device="cuda")
    kw = dict(h_base=h_base, r_escape=r_escape, tilt_deg=tilt, r_inner=r_inner,
              r_outer=r_outer)
    trace_geodesics_cuda(cam, width=w, height=h, **kw)  # warm-up
    kernel, k_ms = cuda_ms(lambda: trace_geodesics_cuda(cam, width=w, height=h, **kw), reps)
    plain, p_ms = cuda_ms(lambda: trace_geodesics(
        cam[0:3], primary_rays_from_params(cam, w, h), **kw))
    return kernel, plain, k_ms, p_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import bhr_tpu_torch.cli as cli
    from bhr_tpu_torch import _build
    from bhr_tpu_torch.config import SceneConfig, escape_radius
    from bhr_tpu_torch.modes import _make_renderer, render_image
    from bhr_tpu_torch.ops.geodesic_cuda import trace_geodesics_cuda

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
        if "registers" in line or "spill" in line:
            say(f"[build] ptxas: {line.strip()}")

    # 3. kernel vs plain at the small shapes
    small = {}
    for name, args, reps in (
        ("128x32", (128, 32, 60.0, 15.0, 0.2, 12.04, 2.0, 3.5), 20),
        ("320x180", (320, 180, 60.0, 15.0, 0.1, escape_radius(10.0, POV), 2.0, 3.5), 20),
    ):
        kernel, plain, k_ms, p_ms = trace_pair(*args, reps)
        n_flip, frac, err = compare(kernel, plain)
        small[name] = (k_ms, p_ms)
        say(f"[kernel-vs-plain {name}] flipped rays {n_flip} ({frac:.3%}) "
            f"max float diff {err:.3e}; kernel {k_ms:.3f} ms plain {p_ms:.3f} ms")
        check(frac <= TOL_FLIP_FRAC, f"{name}: {n_flip} rays change category")
        check(err <= TOL_FLOAT, f"{name}: float diff {err} > {TOL_FLOAT}")

    # 4. the golden scene on CUDA through the main path's entry point
    trace_geodesics_cuda.launches = 0
    img = render_image(SceneConfig(device="cuda", **GOLDEN))
    golden_launches = trace_geodesics_cuda.launches
    golden = np.load(os.path.join(ROOT, "tests", "goldens", "e2e_cpu.npz"))["image"]
    diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
    h, w = 180, 320
    center = img[h // 2 - 16: h // 2 + 16, w // 2 - 16: w // 2 + 16]
    say(f"[golden] vs e2e_cpu.npz max {diff.max():.3e} mean {diff.mean():.3e}; "
        f"kernel launches {golden_launches}")
    check(img.shape == (180, 320, 3) and np.isfinite(img).all(), "golden shape/finite")
    check(diff.max() <= 5e-2 and diff.mean() <= 5e-4, "golden outside bounds")
    check(golden_launches == 1, f"golden frame launched the kernel {golden_launches}x")
    check((center.sum(axis=-1) < 0.05).mean() > 0.5, "golden: no dark shadow")
    check(img.max() > 0.5 and (img.sum(axis=-1) > 0.02).mean() > 0.05,
          "golden: no bright ring")

    # 5. the main path at full width: the default FHD frame via the CLI
    out_png = os.path.join("output", "torch_fhd.png")
    trace_geodesics_cuda.launches = 0
    t0 = time.perf_counter()
    check(cli.main(["-r", "fhd", "-o", out_png]) == 0, "CLI exit code")
    main_launches = trace_geodesics_cuda.launches
    say(f"[fhd-cli] wrote {out_png} ({os.path.getsize(out_png)} bytes) in "
        f"{time.perf_counter() - t0:.2f} s; kernel launches {main_launches}")
    check(main_launches == 1, f"FHD frame launched the kernel {main_launches}x")

    cfg = SceneConfig(resolution="fhd", device="cuda").validated()
    renderer, dynamic = _make_renderer(cfg)
    r_escape = escape_radius(cfg.r_max, cfg.pov)
    stages = {"disk_texture": [], "trace": [], "shade": [], "post": []}
    frame = None
    for i in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        ev[0].record()
        renderer.update_disk_texture(dynamic.advance(t=0.0, dt=0.0, recompute_stats=True))
        ev[1].record()
        camera = renderer.camera(cfg.pov, cfg.fov)
        trace = renderer.trace(camera, r_escape)
        ev[2].record()
        bg, disk = renderer.shade(trace, camera)
        ev[3].record()
        frame = renderer.post(bg, disk)[0]
        ev[4].record()
        torch.cuda.synchronize()
        if i:  # frame 0 is the warm-up
            for j, name in enumerate(stages):
                stages[name].append(ev[j].elapsed_time(ev[j + 1]))
    med = {k: statistics.median(v) for k, v in stages.items()}
    check(bool(torch.isfinite(frame).all()) and frame.shape == (1080, 1920, 3),
          "FHD frame not finite or wrong shape")
    say("[fhd-frame] median ms over 3 frames: " + ", ".join(
        f"{k} {v:.3f}" for k, v in med.items()) + f"; total {sum(med.values()):.3f}")

    kernel, plain, k_ms, p_ms = trace_pair(
        1920, 1080, cfg.fov, cfg.disk_tilt, cfg.step_size, r_escape,
        cfg.disk_inner_radius, cfg.disk_outer_radius, 3)
    n_flip, frac, fhd_err = compare(kernel, plain)
    say(f"[kernel-vs-plain 1920x1080] flipped rays {n_flip} ({frac:.3%}) max "
        f"float diff {fhd_err:.3e}; kernel {k_ms:.3f} ms plain {p_ms:.3f} ms")
    check(frac <= TOL_FLIP_FRAC, f"FHD: {n_flip} rays change category")
    check(fhd_err <= TOL_FLOAT, f"FHD: float diff {fhd_err} > {TOL_FLOAT}")

    # 6. results
    say(json.dumps({"kernels": [{
        "name": "ray_march_slim",
        "route": "cuda",
        "source": "bhr_tpu_torch/csrc/ray_march.cu",
        "replaces": "bhr_tpu/ops/geodesic_pallas.py:582",
        "launches": main_launches,
        "max_abs_err": fhd_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
