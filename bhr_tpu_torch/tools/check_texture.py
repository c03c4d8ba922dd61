"""Disk-texture inspection tool.

The port of ``tools/check_texture.py``: the procedural disk texture as
the raw polar map, a cartesian top view and a density (alpha) grayscale.

Usage:
    python -m bhr_tpu_torch.tools.check_texture [--n_phi 1024] [--n_r 256]
        [--seed 42] [--r_inner 2.0] [--r_outer 3.5] [--t 0.0] [--dynamic]
        [--out output/texture] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import DEVICES, torch_device


def polar_to_cartesian(tex: np.ndarray, size: int, r_inner: float,
                       r_outer: float) -> np.ndarray:
    """Warp an (n_r, n_phi, C) polar texture to a face-on (size, size, C)."""
    n_r, n_phi = tex.shape[:2]
    extent = r_outer * 1.05
    xs = np.linspace(-extent, extent, size)
    x, y = np.meshgrid(xs, -xs)
    r = np.hypot(x, y)
    phi = np.mod(np.arctan2(y, x), 2 * np.pi)

    v = (r - r_inner) / (r_outer - r_inner) * (n_r - 1)
    u = phi / (2 * np.pi) * n_phi
    v0 = np.clip(np.floor(v).astype(int), 0, n_r - 1)
    u0 = np.floor(u).astype(int) % n_phi
    out = tex[v0, u0]
    out[(r < r_inner) | (r > r_outer)] = 0.0
    return out


def texture(args, device) -> np.ndarray:
    """The (n_r, n_phi, 4) texture the arguments ask for, on the host."""
    if args.dynamic:
        from ..models.dynamic_disk import DynamicDiskSystem

        dyn = DynamicDiskSystem(args.n_r, args.n_phi, args.r_inner,
                                args.r_outer, seed=args.seed, device=device)
        tex = dyn.advance(args.t, 0.0, recompute_stats=True)
    else:
        from ..models.disk_texture import build_parametric_state, compose_from_state

        state = build_parametric_state(
            n_phi=args.n_phi, n_r=args.n_r, seed=args.seed,
            r_inner=args.r_inner, r_outer=args.r_outer, device=device)
        tex = compose_from_state(state, args.t)
    return tex.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_phi", type=int, default=1024)
    ap.add_argument("--n_r", type=int, default=256)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--r_inner", type=float, default=2.0)
    ap.add_argument("--r_outer", type=float, default=3.5)
    ap.add_argument("--t", type=float, default=0.0, help="rotation time offset")
    ap.add_argument("--dynamic", action="store_true",
                    help="use the lifecycle dynamic texture instead of the "
                         "static parametric generator")
    ap.add_argument("--out", type=str, default="output/texture")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    args = ap.parse_args(argv)

    from ..utils.io import save_image

    tex = texture(args, torch_device(args.device))
    premult = tex[..., :3] * tex[..., 3:4]
    save_image(premult, f"{args.out}_polar.png")
    save_image(polar_to_cartesian(premult, 768, args.r_inner, args.r_outer),
               f"{args.out}_topview.png")
    save_image(np.repeat(tex[..., 3:4], 3, axis=-1), f"{args.out}_density.png")
    print(f"Wrote {args.out}_{{polar,topview,density}}.png "
          f"({args.n_r}x{args.n_phi}, seed {args.seed}, t={args.t})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
