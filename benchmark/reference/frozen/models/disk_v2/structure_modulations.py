"""Disk V2 static structure modulations (multiplicative factors ~ 1).

The port of ``bhr_tpu/models/disk_v2/structure_modulations.py``
(reference disk_v2/structure_modulations.py): three layers, weak
m=1/m=2 modes with log-r phase coupling, a seeded random-Fourier shear
texture in (phi, log r), and sparse difference-of-Gaussian hotspots
biased toward the inner disk; composed multiplicatively and neutral
(= 1) outside the disk.

Advection: every layer takes an optional time ``t``; coordinates advect
as phi_adv = phi - Omega(r) * t, giving differential rotation of the
static pattern.

The shear and hotspot fields are normalized by the pattern's max over a
fixed dense lattice, not over the evaluated batch, so a ray's modulation
does not depend on which other rays share the call (a row band equals
the whole frame, a frame equals the next). Under ``jax.jit`` that max is
a constant of the compiled program; eager PyTorch would evaluate the
lattice on every call, so each normalizer is computed once per (params,
structure params, seed), on the CPU, and kept as a Python float by the
``functools.lru_cache`` of ``shear_normalizer`` / ``hotspot_normalizer``:
every device divides by the same value (``lattice_evaluations`` counts
the computations).

The seeded draws are NumPy's (``np.random.default_rng``), in the order
``bhr_tpu`` makes them, so the shear terms and the hotspots are the same
in both packages (``shear_terms``, ``hotspot_spots``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from .geometry import as_tensors, disk_radial_weight
from .params import DiskV2Params, DiskV2StructureParams
from .physical_fields import angular_velocity_field


# Fixed normalization lattice: the raw shear/hotspot patterns are
# functions of (phi_adv, log r) only, so their global max over full phi
# coverage is advection-invariant. 512 phi x 128 log-r samples resolve
# every shear component (m <= 10, n <= 5.5 by construction -> >= 50
# samples/period). Hotspot sigmas are user-set and can be arbitrarily
# narrow, so the hotspot max is additionally probed at sigma-scaled
# offsets around every spot center: the lattice alone would miss
# sub-lattice Gaussian cores, and the resulting over-normalization would
# saturate the clip to [-1, 1] into hard-edged binary blobs.
_LATTICE_PHI = 512
_LATTICE_LOGR = 128

# Probe offsets in units of sigma; the extrema of a difference-of-
# Gaussians sum lie at/near the cores and halo rings these cover.
_PROBE_OFFSETS = np.array([-3.0, -2.0, -1.5, -1.0, -0.5, 0.0,
                           0.5, 1.0, 1.5, 2.0, 3.0])

_HALO_PHI, _HALO_LOGR, _HALO_W = 1.8, 1.8, 0.6

# How many times a normalizer was computed on its lattice.
lattice_evaluations = 0


def _lattice_max_abs(raw_fn, log_span: float, probe_phi=None,
                     probe_logr=None) -> float:
    """max |raw_fn(phi, log_r)| over the fixed (phi, log r) lattice,
    optionally augmented with exact probe points. The lattice points are
    ``jnp.linspace``'s in float32: phi = 2 pi * (i / 512) without the
    endpoint, log r = span * (i / 127) with the endpoint appended."""
    global lattice_evaluations
    lattice_evaluations += 1
    f32 = dict(dtype=torch.float32, device="cpu")
    two_pi = torch.tensor(2.0 * np.pi, **f32)
    phi_l = two_pi * (torch.arange(_LATTICE_PHI, **f32) / _LATTICE_PHI)
    span = torch.tensor(max(log_span, 1e-6), **f32)
    last = _LATTICE_LOGR - 1
    logr_l = torch.cat([span * (torch.arange(last, **f32) / last), span[None]])
    m = torch.max(torch.abs(raw_fn(phi_l[None, :], logr_l[:, None])))
    if probe_phi is not None:
        m = torch.maximum(m, torch.max(torch.abs(raw_fn(probe_phi, probe_logr))))
    return max(float(m), 1e-15)


def _wrapped_delta_phi(phi: torch.Tensor, center: float) -> torch.Tensor:
    """Shortest signed angular difference in [-pi, pi]."""
    return torch.atan2(torch.sin(phi - center), torch.cos(phi - center))


def _log_radius(r: torch.Tensor, params: DiskV2Params) -> torch.Tensor:
    return torch.log(torch.clamp(r, min=params.r_in) / params.r_in)


def _advected_phi(r, phi, params: DiskV2Params, t) -> torch.Tensor:
    """phi_adv = phi - Omega(r) * t: unified differential advection."""
    return phi - angular_velocity_field(r, params) * t


def _log_span(params: DiskV2Params) -> float:
    return float(np.log(params.r_out / params.r_in))


def shear_terms(sp: DiskV2StructureParams, seed: int) -> Tuple[tuple, ...]:
    """The shear components (m, n, psi, amplitude) of a seed: three draws
    per component, integers(2, 10), integers(1, 6), uniform(0, 2 pi)."""
    rng = np.random.default_rng(seed)
    terms = []
    for idx in range(sp.shear_components):
        m = int(rng.integers(2, 10))
        n = int(rng.integers(1, 6))
        psi = float(rng.uniform(0.0, 2.0 * np.pi))
        terms.append((m, n, psi, 0.5**idx))
    return tuple(terms)


def hotspot_spots(params: DiskV2Params, sp: DiskV2StructureParams,
                  seed: int) -> Tuple[tuple, ...]:
    """The hotspots (center_phi, center_logr, weight) of a seed: three
    uniform draws per spot, the radial one inner-biased by u^bias."""
    rng = np.random.default_rng(seed)
    log_span = _log_span(params)
    spots = []
    for _ in range(sp.hotspot_count):
        center_phi = float(rng.uniform(0.0, 2.0 * np.pi))
        center_logr = float(
            (rng.uniform(0.0, 1.0) ** sp.hotspot_inner_bias) * log_span
        )
        weight = float(rng.uniform(0.6, 1.0))
        spots.append((center_phi, center_logr, weight))
    return tuple(spots)


def _shear_raw(terms, phi_a, log_r_a) -> torch.Tensor:
    raw = 0.0
    for m, n, psi, amp in terms:
        raw = raw + amp * torch.cos(m * phi_a + n * log_r_a + psi)
        raw = raw + 0.6 * amp * torch.sin(
            (m + 1) * phi_a - (n + 0.5) * log_r_a + 0.7 * psi
        )
    return raw


def _hotspot_raw(spots, sp: DiskV2StructureParams, phi_a, log_r_a) -> torch.Tensor:
    raw = 0.0
    for center_phi, center_logr, weight in spots:
        d_phi = _wrapped_delta_phi(phi_a, center_phi)
        d_logr = (log_r_a - center_logr) / sp.hotspot_logr_sigma
        core = torch.exp(
            -0.5 * (d_phi / sp.hotspot_phi_sigma) ** 2 - 0.5 * d_logr**2
        )
        halo = torch.exp(
            -0.5 * (d_phi / (_HALO_PHI * sp.hotspot_phi_sigma)) ** 2
            - 0.5 * ((log_r_a - center_logr)
                     / (_HALO_LOGR * sp.hotspot_logr_sigma)) ** 2
        )
        raw = raw + weight * (core - _HALO_W * halo)
    return raw


# A sweep of a knob makes a key per value; 64 keeps the scenes in use.
@lru_cache(maxsize=64)
def shear_normalizer(params: DiskV2Params, sp: DiskV2StructureParams,
                     seed: int) -> float:
    """max |raw shear| over the lattice, computed once per argument set."""
    terms = shear_terms(sp, seed)
    return _lattice_max_abs(
        lambda p, l: _shear_raw(terms, p, l), _log_span(params))


@lru_cache(maxsize=64)
def hotspot_normalizer(params: DiskV2Params, sp: DiskV2StructureParams,
                       seed: int) -> float:
    """max |raw hotspots| over the lattice and a sigma-scaled probe grid
    around each spot center (so that narrow, sub-lattice cores still
    normalize by their true peak), computed once per argument set."""
    spots = hotspot_spots(params, sp, seed)
    pp, pl = [], []
    for center_phi, center_logr, _ in spots:
        gp, gl = np.meshgrid(
            center_phi + _PROBE_OFFSETS * sp.hotspot_phi_sigma,
            center_logr + _PROBE_OFFSETS * sp.hotspot_logr_sigma,
        )
        pp.append(gp.ravel())
        pl.append(gl.ravel())
    probe_phi, probe_logr = (
        torch.as_tensor(np.concatenate(a), dtype=torch.float32) for a in (pp, pl))
    return _lattice_max_abs(
        lambda p, l: _hotspot_raw(spots, sp, p, l), _log_span(params),
        probe_phi, probe_logr)


# The layers on coordinates already advected: structure_modulation shares
# phi_adv, log r and the radial window between the three (XLA merges the
# repeats in bhr_tpu's program; eager PyTorch would launch them again).

def _mode_layer(phi_adv, log_r, window, sp) -> torch.Tensor:
    raw = sp.mode1_strength * torch.cos(phi_adv + 0.35 * log_r) + (
        sp.mode2_strength * torch.cos(2.0 * phi_adv - 0.65 * log_r))
    return torch.where(window > 0.0, 1.0 + raw, 1.0)


def _shear_layer(phi_adv, log_r, window, params, sp, seed) -> torch.Tensor:
    norm = shear_normalizer(params, sp, seed)
    signed = torch.clamp(
        _shear_raw(shear_terms(sp, seed), phi_adv, log_r) / norm, -1.0, 1.0)
    return torch.where(window > 0.0, 1.0 + sp.shear_strength * signed, 1.0)


def _hotspot_layer(phi_adv, log_r, window, params, sp, seed) -> torch.Tensor:
    norm = hotspot_normalizer(params, sp, seed)
    signed = torch.clamp(
        _hotspot_raw(hotspot_spots(params, sp, seed), sp, phi_adv, log_r) / norm,
        -1.0, 1.0)
    return torch.where(window > 0.0, 1.0 + sp.hotspot_strength * signed, 1.0)


def _coordinates(r, phi, params: DiskV2Params, t):
    """(phi_adv, log r, radial window) of the points (r, phi) at time t."""
    r, phi = as_tensors(r, phi)
    return (_advected_phi(r, phi, params, t), _log_radius(r, params),
            disk_radial_weight(r, params))


def structure_modulation(
    r, phi, params: DiskV2Params,
    structure_params: Optional[DiskV2StructureParams] = None,
    seed: int = 42,
    t: float = 0.0,
) -> torch.Tensor:
    """Composite F_struct = F_mode * F_shear * F_hotspot, neutral outside.
    The hotspots draw from ``seed + 1``."""
    sp = structure_params or DiskV2StructureParams()
    phi_adv, log_r, window = _coordinates(r, phi, params, t)
    combined = (
        _mode_layer(phi_adv, log_r, window, sp)
        * _shear_layer(phi_adv, log_r, window, params, sp, seed)
        * _hotspot_layer(phi_adv, log_r, window, params, sp, seed + 1)
    )
    return torch.where(window > 0.0, combined, 1.0)
