"""The static texture generator's arc, pixel and FBM noise: a frozen copy
of the part of the port's ``ops/noise.py`` that ``models/static_disk.py``
draws (tileable arc noise, periodic pixel noise, the bilinear pyramid and
FBM), from ``ops/random.py``'s port of ``jax.random``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .random import (
    randint_from_bits,
    random_bits_rows,
    split,
    uniform,
    uniform_from_bits,
)


def linspace0(stop: float, num: int, endpoint: bool, device) -> torch.Tensor:
    """float32 ``jnp.linspace(0.0, stop, num, endpoint)`` as XLA evaluates
    it: the division by the constant becomes a multiply by its float32
    reciprocal, folded into ``stop``, so sample i is ``(stop * (1/div)) * i``
    (``torch.linspace`` differs in the last bit)."""
    div = num - 1 if endpoint else num
    step = float(np.float32(stop) * (np.float32(1.0) / np.float32(div)))
    out = torch.arange(div, dtype=torch.float32, device=device) * step
    if endpoint:
        out = torch.cat([out, torch.full((1,), float(np.float32(stop)),
                                         dtype=torch.float32, device=device)])
    return out


def polar_axes(n_r: int, n_phi: int, device):
    """(phi (1, n_phi), r (n_r, 1)): the two axes of ``jnp.meshgrid(phi,
    r)`` over [0, 2 pi) x [0, 1], kept apart so that a profile in phi
    alone or r alone is evaluated once per column or row."""
    phi = linspace0(2.0 * math.pi, n_phi, False, device)
    r = linspace0(1.0, n_r, True, device)
    return phi[None, :], r[:, None]


def tileable_noise_many(keys, shape: Tuple[int, int], max_arcs: int = 60, *,
                        device) -> torch.Tensor:
    """``tileable_noise`` of each key -> (len(keys), h, w), the draws of
    all keys made in one hash.

    Cloudy arc noise, seamless in the phi (second) axis: 30-60 soft arcs,
    a von-Mises-like azimuthal profile exp(kappa (cos(phi - phi_0) - 1))
    x a radial Gaussian, summed and clipped to [0, 1]. The azimuthal
    profile depends on phi alone and the radial one on r alone, so the
    sum over arcs is a float32 matrix product (radial x intensity)^T @
    azimuthal: no (arcs, h, w) temporaries.
    """
    h, w = shape
    rows = []
    for key in keys:
        k = split(key, 6)
        rows += [*split(k[0]), *k[1:]]  # randint's two draws, five uniforms
    bits = random_bits_rows(rows, max_arcs, device).view(len(keys), 7, max_arcs)
    n_arcs = randint_from_bits(bits[:, 0, :1], bits[:, 1, :1], 30, 60)
    arc_phi = uniform_from_bits(bits[:, 2], maxval=2.0 * math.pi)[..., None]
    arc_r = torch.sqrt(uniform_from_bits(bits[:, 3]))[..., None]
    arc_phi_width = uniform_from_bits(bits[:, 4], 0.15, 0.5)[..., None]
    arc_r_width = uniform_from_bits(bits[:, 5], 0.03, 0.08)[..., None]
    alive = torch.arange(max_arcs, device=device) < n_arcs
    arc_intensity = torch.where(alive, uniform_from_bits(bits[:, 6], 0.03, 0.12), 0.0)

    phi, r = polar_axes(h, w, device)
    kappa = 0.6 / (arc_phi_width ** 2)
    az = torch.exp(kappa * (torch.cos(phi - arc_phi) - 1.0))  # (K, A, w)
    rad = torch.exp(-0.5 * ((r.T - arc_r) / arc_r_width) ** 2)  # (K, A, h)
    cloud = torch.bmm((rad * arc_intensity[..., None]).transpose(1, 2), az)
    return torch.clamp(cloud, 0.0, 1.0)


def tileable_noise(key, shape: Tuple[int, int], max_arcs: int = 60, *,
                   device) -> torch.Tensor:
    """Cloudy arc noise of one key (:func:`tileable_noise_many`)."""
    return tileable_noise_many([key], shape, max_arcs, device=device)[0]


def periodic_pixel_noise(key, shape: Tuple[int, int], *, device) -> torch.Tensor:
    """White pixel noise in [-1, 1], periodic in phi (last column = first)."""
    noise = uniform(key, shape, device=device)
    noise[:, -1] = noise[:, 0]
    return noise * 2.0 - 1.0


def _bilinear_resize(small: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear upscale of an (h, w) array (align-centers convention)."""
    h, w = small.shape
    dev = small.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * h / out_h - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * w / out_w - 0.5
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    fy = torch.clamp(ys - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xs - x0, 0.0, 1.0)[None, :]
    top = small[y0][:, x0] * (1 - fx) + small[y0][:, x1] * fx
    bot = small[y1][:, x0] * (1 - fx) + small[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def fbm_noise(key, shape: Tuple[int, int], octaves: int = 4,
              persistence: float = 0.5, base_scale: int = 1,
              wrap_u: bool = False, *, device) -> torch.Tensor:
    """2D FBM field in [0, ~1]: ``wrap_u`` sums tileable arc-noise octaves
    (phi-seamless) and normalizes by the max; otherwise it sums
    bilinear-upscaled random grids (an image pyramid)."""
    h, w = shape
    keys = split(key, octaves)
    if wrap_u:
        result = None
        for idx, field in enumerate(tileable_noise_many(list(keys), shape, device=device)):
            octave = field * (persistence ** idx)
            result = octave if result is None else result + octave
        return result / (torch.max(result) + 1e-6)
    result = None
    amplitude = 1.0
    total = 0.0
    for idx in range(octaves):
        scale = base_scale * (2 ** idx)
        small = uniform(keys[idx], (max(h // scale, 2), max(w // scale, 2)),
                        device=device)
        layer = _bilinear_resize(small, h, w) * amplitude
        result = layer if result is None else result + layer
        total += amplitude
        amplitude *= persistence
    return result / total
