"""The FHD shade's cost beyond its gathers, variant by variant.

The port of ``tools/bench_shade_variants.py``. Slot-0 shading is rebuilt
from the port's building blocks (``ops/sampling.py``,
``ops/shading.py``) with stages added one at a time: gather, then the
g-factor, then the alpha compose; the sky gather alone and masked to the
escaped rays; and the anchor, the production ``pipeline.shade_frame``
(every slot and the sky). Each variant is timed with CUDA events around
20 enqueued runs (``utils/profiling.device_time``), so differences
between variants are device time. ``bhr_tpu`` made the anchor optional
because XLA took minutes to compile it in a loop; nothing is compiled
here, so it always runs. The last line is one JSON object of ms a run.

Usage:
    python -m bhr_tpu_torch.tools.bench_shade_variants [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..config import DEVICES

ITERS = 20


def variants(inputs) -> list:
    """[(name, fn)] on ``_diag_scene``'s inputs; each fn returns its
    per-pixel result. The last is the anchor: ``bg + disk`` of
    ``pipeline.shade_frame``."""
    from ..constants import DISK_ALPHA_GAIN, DISK_COLOR_TEMPERATURE
    from ..ops.sampling import sample_disk, sample_skybox
    from ..ops.shading import apply_g_factor, pow_const
    from ..pipeline import shade_frame
    from ._diag_scene import DISK_R_INNER, DISK_R_OUTER, TILT_DEG, shade_kwargs

    _, _, cam, skybox, mips, trace = inputs
    cam_pos = cam[0:3]
    tilt_rad = math.radians(TILT_DEG)
    feat = trace.hits[0]

    def gathered():
        hit_x, hit_y = feat[0], feat[1]
        rgba = sample_disk(mips[0], hit_x, hit_y, DISK_R_INNER, DISK_R_OUTER, 0.0)
        return rgba, hit_x, hit_y

    def g_factor(rgba, hit_x, hit_y):
        hit_pos = torch.stack([hit_x, hit_y, hit_y * math.tan(tilt_rad)], dim=-1)
        hit_r = torch.sqrt(hit_x * hit_x + hit_y * hit_y)
        return apply_g_factor(rgba[:, :3], hit_pos, hit_r, -feat[2:5].T, cam_pos,
                              DISK_R_INNER, DISK_R_OUTER, tilt_rad,
                              DISK_COLOR_TEMPERATURE)

    def slot0_gather():
        return gathered()[0]

    def slot0_gfactor():
        return g_factor(*gathered())

    def slot0_alpha():
        rgba, hit_x, hit_y = gathered()
        shaded = g_factor(rgba, hit_x, hit_y)
        base_alpha = torch.clamp(rgba[:, 3], max=0.999)
        alpha = 1.0 - pow_const(1.0 - base_alpha, DISK_ALPHA_GAIN)
        alpha = torch.where(0 < trace.hit_count, alpha, 0.0)
        return shaded * alpha[:, None]

    def sky():
        return sample_skybox(skybox, trace.escape_dir)

    def sky_masked():
        return torch.where(trace.escaped[:, None], sky(), 0.0)

    def anchor():
        bg, disk, _ = shade_frame(trace, skybox, mips, cam_pos, **shade_kwargs())
        return bg + disk

    return [("slot0 gather+decode", slot0_gather),
            ("slot0 gather+g-factor", slot0_gfactor),
            ("slot0 gather+g+alpha", slot0_alpha),
            ("sky gather+decode", sky),
            ("sky masked+decode", sky_masked),
            ("full shade_frame (anchor)", anchor)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--size", default="1920x1080", help="WxH of the scene")
    ap.add_argument("--tex", default="416x2912", help="n_r x n_phi of the disk")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)

    from ..utils.profiling import device_time
    from ._diag_scene import build_fhd_shade_inputs

    inputs = build_fhd_shade_inputs(
        args.device, tuple(int(v) for v in args.size.split("x")),
        tuple(int(v) for v in args.tex.split("x")))
    results = {}
    for name, fn in variants(inputs):
        results[name] = device_time(fn, iters=args.iters) * 1e3
        print(f"{name:28s} {results[name]:7.3f} ms/run on {args.device}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
