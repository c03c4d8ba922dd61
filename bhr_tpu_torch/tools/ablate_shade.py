"""Ablation of the FHD deferred shade on one recorded trace.

The port of ``tools/ablate_shade.py``: shade variants timed on one
trace of the diagnostic scene (``_diag_scene``) to attribute the stage's
cost: the full shade, the texture gathers alone, the sky gather alone
and the full shade with the sky sample stubbed. Each is timed with
``utils/profiling.device_time`` (CUDA events around 20 enqueued calls).

``bhr_tpu``'s "disk layer only" variant relied on XLA dropping the
unused sky gather; eager torch drops nothing, so its counterpart here
replaces ``pipeline.sample_skybox`` with a constant for the call.

Usage:
    python -m bhr_tpu_torch.tools.ablate_shade [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..config import DEVICES


def variants(inputs) -> list:
    """[(name, fn)] of the shade variants on ``_diag_scene``'s inputs;
    each fn returns its per-pixel result."""
    from .. import pipeline
    from ..ops.sampling import sample_disk, sample_skybox
    from ._diag_scene import DISK_R_INNER, DISK_R_OUTER, shade_kwargs

    _, _, cam, skybox, mips, trace = inputs
    slot0 = trace.hits[0]

    def full():
        bg, disk, _ = pipeline.shade_frame(trace, skybox, mips, cam[0:3],
                                           **shade_kwargs())
        return bg + disk

    def disk_gather():
        return sample_disk(mips[0], slot0[0], slot0[1], DISK_R_INNER,
                           DISK_R_OUTER, 0.0)

    def sky_gather():
        return sample_skybox(skybox, trace.escape_dir)

    def gathers():
        return disk_gather().sum() + sky_gather().sum()

    def no_sky():
        real = pipeline.sample_skybox
        pipeline.sample_skybox = lambda tex, d: torch.full(
            (*d.shape[:-1], 3), 0.1, dtype=torch.float32, device=d.device)
        try:
            return full()
        finally:
            pipeline.sample_skybox = real

    return [("full shade", full), ("disk+sky gathers only", gathers),
            ("disk slot0 gather only", disk_gather), ("sky gather only", sky_gather),
            ("full, sky sample stubbed", no_sky)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--size", default="1920x1080", help="WxH of the scene")
    ap.add_argument("--tex", default="416x2912", help="n_r x n_phi of the disk")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    from ..utils.profiling import device_time
    from ._diag_scene import build_fhd_shade_inputs

    inputs = build_fhd_shade_inputs(
        args.device, tuple(int(v) for v in args.size.split("x")),
        tuple(int(v) for v in args.tex.split("x")))
    trace = inputs[5]
    hc = trace.hit_count
    print(f"hit_count: 0:{float((hc == 0).float().mean()):.2%} "
          f"1:{float((hc == 1).float().mean()):.2%} "
          f"2+:{float((hc >= 2).float().mean()):.2%}  "
          f"escaped:{float(trace.escaped.float().mean()):.2%}  on {args.device}")
    for name, fn in variants(inputs):
        ms = device_time(fn, iters=args.iters) * 1e3
        print(f"{name:28s} {ms:7.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
