"""Fast transcendental approximations for the texture samplers.

The port of ``bhr_tpu/ops/fastmath.py``. The renderer's samplers use
these polynomials instead of exact atan2/acos, so the port keeps them
to shade the same texel coordinates as the JAX package (~1e-5 rad
error: a 0.05-texel coordinate error at a 2912-texel azimuth).
"""

from __future__ import annotations

import torch

_PI = 3.14159265358979
_HALF_PI = 1.5707963267948966


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 via a degree-11 odd polynomial on [0, 1] + octant folding.

    Max error ~1e-5 rad; same quadrant conventions as torch.atan2
    (result in (-pi, pi]).
    """
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    a = mn / torch.clamp(mx, min=1e-30)
    s = a * a
    # Horner polynomial for atan(a), a in [0, 1].
    r = a * (
        0.99997726
        + s * (-0.33262347
               + s * (0.19354346
                      + s * (-0.11643287
                             + s * (0.05265332 + s * -0.01172120))))
    )
    r = torch.where(ay > ax, _HALF_PI - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    return torch.where(y < 0.0, -r, r)


def fast_arccos(z: torch.Tensor) -> torch.Tensor:
    """arccos(z) = atan2(sqrt(1 - z^2), z), using the fast atan2."""
    z = torch.clamp(z, -1.0, 1.0)
    return fast_atan2(torch.sqrt(torch.clamp(1.0 - z * z, min=0.0)), z)
