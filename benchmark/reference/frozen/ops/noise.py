"""Procedural noise (torch, vectorized): 3-D simplex noise and FBM, which
the lifecycle disk's background draws.

The port of ``bhr_tpu/ops/noise.py``. The simplex lattice hash is integer
ALU work and is reproduced bit for bit: int32 throughout, with wrapping
multiplies and arithmetic right shifts, exactly as XLA evaluates it (no
promotion to int64). The static texture's arc, pixel and FBM noise are
not copied: no cell of the benchmark renders a static texture.
"""

from __future__ import annotations

import torch



def _grad3_dot(h, x, y, z):
    """Dot of an edge-gradient direction (selected by hash) with the
    offset vector — Perlin's h & 15 gradient table in branchless form."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    r1 = torch.where((h & 1) == 0, u, -u)
    r2 = torch.where((h & 2) == 0, v, -v)
    return r1 + r2


def _hash3(i, j, k):
    """Computational lattice hash (int32 multiply-xorshift mix)."""
    h = i * 374761393 + j * 668265263 + k * 1440662683
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return h & 0x7FFFFFFF


def simplex_noise_3d(x, y, z):
    """Gustavson 3D simplex noise, fully vectorized. Output ~[-1, 1]."""
    f3 = 1.0 / 3.0
    g3 = 1.0 / 6.0

    s = (x + y + z) * f3
    i = torch.floor(x + s).to(torch.int32)
    j = torch.floor(y + s).to(torch.int32)
    k = torch.floor(z + s).to(torch.int32)

    t = (i + j + k).to(x.dtype) * g3
    x0 = x - (i.to(x.dtype) - t)
    y0 = y - (j.to(x.dtype) - t)
    z0 = z - (k.to(x.dtype) - t)

    # Simplex corner offsets: Gustavson's 6-case ordering as boolean
    # algebra over the three pairwise comparisons.
    a = x0 >= y0
    b = y0 >= z0
    c = x0 >= z0

    b_i1 = a & (b | c)
    b_j1 = (~a) & b
    b_k1 = (~b) & ~(a & c)
    b_i2 = a | (b & c)
    b_j2 = (~a) | b
    b_k2 = (~b) | ((~a) & (~c))

    x1 = x0 - b_i1.to(x.dtype) + g3
    y1 = y0 - b_j1.to(x.dtype) + g3
    z1 = z0 - b_k1.to(x.dtype) + g3
    x2 = x0 - b_i2.to(x.dtype) + 2.0 * g3
    y2 = y0 - b_j2.to(x.dtype) + 2.0 * g3
    z2 = z0 - b_k2.to(x.dtype) + 2.0 * g3
    x3 = x0 - 1.0 + 3.0 * g3
    y3 = y0 - 1.0 + 3.0 * g3
    z3 = z0 - 1.0 + 3.0 * g3

    i32 = torch.int32
    gi0 = _hash3(i, j, k)
    gi1 = _hash3(i + b_i1.to(i32), j + b_j1.to(i32), k + b_k1.to(i32))
    gi2 = _hash3(i + b_i2.to(i32), j + b_j2.to(i32), k + b_k2.to(i32))
    gi3 = _hash3(i + 1, j + 1, k + 1)

    def corner(t, gi, cx, cy, cz):
        t = torch.clamp(t, min=0.0)
        t2 = t * t
        return t2 * t2 * _grad3_dot(gi, cx, cy, cz)

    n0 = corner(0.6 - x0 * x0 - y0 * y0 - z0 * z0, gi0, x0, y0, z0)
    n1 = corner(0.6 - x1 * x1 - y1 * y1 - z1 * z1, gi1, x1, y1, z1)
    n2 = corner(0.6 - x2 * x2 - y2 * y2 - z2 * z2, gi2, x2, y2, z2)
    n3 = corner(0.6 - x3 * x3 - y3 * y3 - z3 * z3, gi3, x3, y3, z3)
    return 32.0 * (n0 + n1 + n2 + n3)


def fbm_3d(x, y, z, octaves: int = 4, persistence: float = 0.5,
           lacunarity: float = 2.0):
    """Fractal Brownian motion over 3D simplex noise (unrolled octaves)."""
    value = 0.0
    amplitude = 1.0
    freq = 1.0
    for _ in range(octaves):
        value = value + amplitude * simplex_noise_3d(x * freq, y * freq, z * freq)
        amplitude *= persistence
        freq *= lacunarity
    return value


# ---------------------------------------------------------------------------
# Arc and pixel noise of the static texture generator (bhr_tpu/ops/noise.py:
# tileable_noise, periodic_pixel_noise, _bilinear_resize, fbm_noise), drawn
# from ops.random's port of jax.random: the same key gives the same field.
# ---------------------------------------------------------------------------


