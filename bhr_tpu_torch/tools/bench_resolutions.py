"""Frame time of the bench scene over the resolution presets.

The port of ``tools/bench_resolutions.py``: a loop over
``bhr_tpu_torch.bench.time_resolution`` (the batched renderer on one
device, a warm batch, then the median of timed batches), so that a
scaling table and ``chip_smoke.py``'s bench frame cannot drift onto
different methods. One line a preset.

Usage:
    python -m bhr_tpu_torch.tools.bench_resolutions [--device cuda]
        [--resolutions sd,hd,fhd,4k] [--batch N] [--repeats 5]
"""

from __future__ import annotations

import argparse
import sys

from ..config import DEVICES, RESOLUTIONS

# Frames a batch at each preset, as bhr_tpu's tool times them.
BATCHES = {"sd": 32, "hd": 32, "fhd": 16, "4k": 8}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--resolutions", default="sd,hd,fhd,4k")
    ap.add_argument("--batch", type=int, default=0,
                    help="frames a timed batch (0: the preset's)")
    ap.add_argument("--repeats", type=int, default=5, help="timed batches")
    ap.add_argument("--size", default=None,
                    help="WxH in place of every preset's pixels (tests)")
    args = ap.parse_args(argv)

    import contextlib

    from .. import bench

    size = tuple(int(v) for v in args.size.split("x")) if args.size else None
    skybox = bench.build_skybox(args.device)
    for res in args.resolutions.split(","):
        with contextlib.redirect_stdout(sys.stderr):
            r = bench.time_resolution(res, args.batch or BATCHES[res], skybox,
                                      device=args.device, repeats=args.repeats,
                                      size=size)
        width, height = size or RESOLUTIONS[res]
        print(f"{res:4s} {width}x{height}: {r['frame_ms']:8.2f} ms/frame "
              f"(median of {args.repeats}, spread {r['spread'][0]:.2f}-"
              f"{r['spread'][1]:.2f}) on {args.device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
