"""Whole-frame stage ablation: ms a frame with one stage knocked out.

The port of ``tools/ablate_pipeline.py``. Per-stage timers mislead when
stages overlap or share launches, so this measures the number that
counts, ``bench.time_resolution``'s frame time, with one stage of the
batched renderer knocked out, and gives the difference to that stage:

- ``base``: the frame as the bench renders it (the reference);
- ``nosky``: ``sample_skybox`` returns a constant 0.1 grey;
- ``nodisk``: ``sample_disk`` and ``sample_disk_mip`` return their hit
  coordinates scaled (no texture gather);
- ``nobloom``: the renderer built with ``use_bloom=False``.

``nosky`` and ``nodisk`` replace the samplers in ``pipeline``'s globals,
where ``shade_frame`` looks them up at each call, and put them back
after the stage. All stages are measured in one call.

Usage:
    python -m bhr_tpu_torch.tools.ablate_pipeline [--resolution 4k] [--aa]
        [--stages base,nosky,nodisk,nobloom] [--batch N] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from ..config import DEVICES, RESOLUTIONS

BATCHES = {"sd": 32, "hd": 32, "fhd": 16, "4k": 8}
STAGES = ("base", "nosky", "nodisk", "nobloom")


@contextlib.contextmanager
def knocked_out(stage: str):
    """``pipeline``'s samplers replaced for ``stage`` while the block
    runs -> the ``use_bloom`` the renderer is built with."""
    from .. import pipeline

    if stage not in STAGES:
        raise SystemExit(f"unknown stage {stage!r}; choose from {STAGES}")
    saved = {k: getattr(pipeline, k)
             for k in ("sample_skybox", "sample_disk", "sample_disk_mip")}
    if stage == "nosky":
        pipeline.sample_skybox = lambda tex, d: torch.full(
            (*d.shape[:-1], 3), 0.1, dtype=torch.float32, device=d.device)
    elif stage == "nodisk":
        pipeline.sample_disk = lambda tex, x, y, *a, **kw: torch.stack(
            [x, y, x, y], -1) * 0.1
        pipeline.sample_disk_mip = lambda mips, n, x, y, ri, ro, t, lod: torch.stack(
            [x, y, x, lod], -1) * 0.1
    try:
        yield stage != "nobloom"
    finally:
        for k, v in saved.items():
            setattr(pipeline, k, v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resolution", default="4k", choices=sorted(RESOLUTIONS))
    ap.add_argument("--aa", action="store_true")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--batch", type=int, default=0,
                    help="frames a timed batch (0: the preset's)")
    ap.add_argument("--repeats", type=int, default=5, help="timed batches")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--size", default=None, help="WxH in place of the preset's")
    args = ap.parse_args(argv)

    from .. import bench

    size = tuple(int(v) for v in args.size.split("x")) if args.size else None
    skybox = bench.build_skybox(args.device)
    batch = args.batch or BATCHES[args.resolution]
    aa = "lod_radius" if args.aa else "disabled"
    base_ms = None
    for stage in args.stages.split(","):
        with knocked_out(stage) as use_bloom, contextlib.redirect_stdout(sys.stderr):
            r = bench.time_resolution(args.resolution, batch, skybox, anti_alias=aa,
                                      device=args.device, repeats=args.repeats,
                                      size=size, use_bloom=use_bloom)
        ms = r["frame_ms"]
        delta = "" if base_ms is None else f"   (stage ~{base_ms - ms:+.1f})"
        if stage == "base":
            base_ms = ms
        print(f"{args.resolution}{' aa' if args.aa else ''} {stage:8s} "
              f"{ms:8.2f} ms/frame{delta}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
