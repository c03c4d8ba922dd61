"""Disk V2 field preview tool.

The port of ``tools/preview_v2.py``: the V2 model's diagnostic views
without ray tracing, as PNGs:
  * top view:       face-on midplane emissivity through the palette;
  * cross-section:  (r, z) slice of density and temperature.

Usage:
    python -m bhr_tpu_torch.tools.preview_v2 [--size 512]
        [--palette cinematic] [--r_in 2.0] [--r_out 15.0] [--seed 42]
        [--t 0.0] [--structure] [--out output/v2_preview] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import DEVICES, torch_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--palette", default="cinematic",
                    choices=["cinematic", "scientific"])
    ap.add_argument("--r_in", type=float, default=2.0)
    ap.add_argument("--r_out", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--t", type=float, default=0.0)
    ap.add_argument("--structure", action="store_true",
                    help="apply the default structure modulations")
    ap.add_argument("--out", default="output/v2_preview")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    args = ap.parse_args(argv)

    from ..models.disk_v2 import (
        DiskV2Params,
        DiskV2StructureParams,
        render_cross_section,
        render_top_view,
    )
    from ..utils.io import save_image

    device = torch_device(args.device)
    params = DiskV2Params(r_in=args.r_in, r_out=args.r_out)
    structure = DiskV2StructureParams() if args.structure else None
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    top = render_top_view(params, structure, size=args.size, seed=args.seed,
                          t=args.t, palette=args.palette, device=device).cpu().numpy()
    save_image(top, f"{args.out}_top.png")
    print(f"wrote {args.out}_top.png  "
          f"(mean {top.mean():.4f}, max {top.max():.4f})")

    for field in ("density", "temperature"):
        cs = render_cross_section(params, size_r=args.size,
                                  size_z=max(args.size // 4, 32), field=field,
                                  device=device).cpu().numpy()
        save_image(np.repeat(cs[:, :, None], 3, axis=2), f"{args.out}_{field}.png")
        print(f"wrote {args.out}_{field}.png  "
              f"(mean {cs.mean():.4f}, max {cs.max():.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
