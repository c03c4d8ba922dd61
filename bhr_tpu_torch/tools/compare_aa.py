"""Anti-aliasing A/B comparison tool.

The port of ``tools/compare_aa.py``: the same scene rendered with AA
disabled and with ray-differential mipmap-LOD AA (through
``modes.render_image``: one ``ray_march_slim`` launch, then one
``ray_march_aa`` on a GPU), both centre-cropped and written side by side.

Usage:
    python -m bhr_tpu_torch.tools.compare_aa [--resolution sd] [--crop 0.5]
        [--aa_strength 1.0] [--out output/aa_compare.png] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from ..config import DEVICES


def center_crop(img: np.ndarray, frac: float) -> np.ndarray:
    h, w = img.shape[:2]
    ch, cw = int(h * frac), int(w * frac)
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    return img[y0: y0 + ch, x0: x0 + cw]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resolution", type=str, default="sd")
    ap.add_argument("--crop", type=float, default=0.5)
    ap.add_argument("--aa_strength", type=float, default=1.0)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--disk_outer_radius", type=float, default=3.5)
    ap.add_argument("--disk_tilt", type=float, default=15.0)
    ap.add_argument("--out", type=str, default="output/aa_compare.png")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    args = ap.parse_args(argv)

    from ..config import SceneConfig
    from ..modes import render_image
    from ..utils.io import save_image

    base = SceneConfig(
        resolution=args.resolution,
        fov=args.fov,
        disk_outer_radius=args.disk_outer_radius,
        disk_tilt=args.disk_tilt,
        aa_strength=args.aa_strength,
        device=args.device,
    ).validated()

    img_off = render_image(dataclasses.replace(base, anti_alias="disabled"))
    img_on = render_image(dataclasses.replace(base, anti_alias="lod_radius"))

    crop_off = center_crop(img_off, args.crop)
    crop_on = center_crop(img_on, args.crop)
    sep = np.ones((crop_off.shape[0], 4, 3), np.float32)
    save_image(np.concatenate([crop_off, sep, crop_on], axis=1), args.out)

    diff = np.abs(img_on - img_off)
    print(f"AA off | AA on composite -> {args.out}")
    print(f"mean |diff| = {diff.mean():.5f}, max = {diff.max():.4f}, "
          f"changed pixels (>1%) = {(diff.max(-1) > 0.01).mean():.2%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
