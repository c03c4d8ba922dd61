"""Entity lifecycle system: spawn/age/die dynamics for the disk texture.

The port of ``bhr_tpu/models/lifecycle.py`` (reference render.py:
493-792, 1667-1866, 3564-3653, 4079-4153). Three entity families live in
the disk: filaments (Gaussian blobs sheared into arcs by differential
Keplerian rotation, fading by shear dilution x cooling) and hotspots /
RT spikes (fixed-timer entities with linear fade-in/out).

The control plane (spawn, death, spawn debt) is host-side NumPy seeded
by ``np.random.default_rng`` and is a copy of the JAX package's, so both
produce the same entities bit for bit. The data plane packs alive
entities into fixed-size parameter rows and evaluates their (r, phi)
profiles on the torch device in :func:`accumulate_entity_layer`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..constants import (
    FILAMENT_BIRTH_FADE_DUR,
    FILAMENT_DEATH_THRESHOLD,
    FILAMENT_MAX_LIFETIME,
    FILAMENT_SHEAR_ALPHA,
    FILAMENT_TAU_COOL,
)
from ..ops.shading import keplerian_omega

# Static padding capacities for the device evaluation (target counts are
# 200/30/15; generous headroom for spawn-debt overshoot).
# Filament radial sigma draw range (r_norm units).
FILAMENT_SIGMA_R_RANGE = (0.005, 0.015)

MAX_FILAMENTS = 288
MAX_HOTSPOTS = 64
MAX_RT_SPIKES = 32


@dataclass
class Entity:
    """One alive entity (host-side bookkeeping only)."""

    entity_type: str  # 'filament' | 'hotspot' | 'rt_spike'
    birth_time: float
    lifetime: float
    fade_in: float
    fade_out: float
    omega: float
    # Shared analytic profile parameters:
    phi_center: float  # azimuthal center at birth (rad)
    # Filament blob parameters:
    base_r: float = 0.0
    sigma_r: float = 0.0
    sigma_phi0: float = 0.0
    peak_density: float = 0.0
    peak_temp: float = 0.0
    alpha_shear: float = 0.0
    tau_cool: float = FILAMENT_TAU_COOL
    # Timer-entity profile parameters:
    phi_width: float = 0.0
    r_center: float = 0.0
    r_width: float = 0.0
    r_length: float = 0.0
    intensity: float = 0.0
    delta_t: float = 0.0

    @property
    def total_duration(self) -> float:
        return self.fade_in + self.lifetime + self.fade_out

    def density_factor(self, age: float) -> float:
        """Filament decay: shear dilution x radiative cooling."""
        s0 = max(self.sigma_phi0, 1e-6)
        sigma_t = s0 + self.alpha_shear * age
        cool = math.exp(-age / self.tau_cool) if self.tau_cool > 0 else 1.0
        return (s0 / sigma_t) * cool

    def is_dead(self, now: float) -> bool:
        age = now - self.birth_time
        if self.entity_type == "filament":
            if age >= FILAMENT_MAX_LIFETIME:
                return True
            return age >= 0 and self.density_factor(age) < FILAMENT_DEATH_THRESHOLD
        return age >= self.total_duration

    def fade_factor(self, now: float) -> float:
        """Timer-entity alpha: linear fade-in, hold, linear fade-out."""
        age = now - self.birth_time
        if age < 0:
            return 0.0
        if age < self.fade_in:
            return age / self.fade_in if self.fade_in > 0 else 1.0
        after = age - self.fade_in
        if after < self.lifetime:
            return 1.0
        out = after - self.lifetime
        if out < self.fade_out:
            return 1.0 - out / self.fade_out if self.fade_out > 0 else 0.0
        return 0.0


def spawn_filament(rng: np.random.Generator, r_norm: np.ndarray,
                   omega_rows: np.ndarray, now: float, lifetime: float) -> Entity:
    """Magnetic-reconnection blob: compact Gaussian, inner-biased radius."""
    r_pos = float(rng.uniform(0.05, 0.95))
    base_r = 0.05 + r_pos**0.6 * 0.9
    peak_density = float(rng.uniform(0.5, 1.0))
    center_idx = int(np.argmin(np.abs(r_norm - base_r)))
    omega = float(omega_rows[center_idx])
    return Entity(
        entity_type="filament",
        birth_time=now,
        lifetime=lifetime,
        fade_in=0.0,
        fade_out=0.0,
        omega=omega,
        phi_center=float(rng.uniform(0.0, 2.0 * np.pi)),
        base_r=base_r,
        sigma_r=float(rng.uniform(*FILAMENT_SIGMA_R_RANGE)),
        sigma_phi0=float(rng.uniform(0.04, 0.10)),
        peak_density=peak_density,
        peak_temp=peak_density * float(rng.uniform(0.15, 0.35)),
        alpha_shear=FILAMENT_SHEAR_ALPHA * omega,
    )


def spawn_hotspot(rng: np.random.Generator, r_norm: np.ndarray,
                  omega_rows: np.ndarray, now: float, lifetime: float) -> Entity:
    """Circular bright patch, statistics matching the static generator."""
    h_r = 0.1 + float(rng.uniform(0.0, 1.0)) ** 0.6 * 0.85
    center_idx = int(np.argmin(np.abs(r_norm - h_r)))
    return Entity(
        entity_type="hotspot",
        birth_time=now,
        lifetime=lifetime,
        fade_in=4.0,
        fade_out=4.0,
        omega=float(omega_rows[center_idx]),
        phi_center=float(rng.uniform(0.0, 2.0 * np.pi)),
        phi_width=float(rng.uniform(0.08, 0.20)),
        r_center=h_r,
        r_width=0.02 + float(rng.uniform(0.0, 0.03)),
        intensity=0.3 + (1.0 - h_r) * 0.6 + float(rng.uniform(0.0, 0.1)),
        delta_t=0.12,
    )


def spawn_rt_spike(rng: np.random.Generator, r_norm: np.ndarray,
                   omega_rows: np.ndarray, now: float, lifetime: float) -> Entity:
    """Inner-edge Rayleigh-Taylor finger with outward radial fade."""
    rt_r_base = float(np.power(rng.uniform(0.01, 0.15), 1.5))
    rt_r_length = float(rng.uniform(0.08, 0.20))
    center_r = rt_r_base + rt_r_length * 0.5
    center_idx = int(np.argmin(np.abs(r_norm - center_r)))
    return Entity(
        entity_type="rt_spike",
        birth_time=now,
        lifetime=lifetime,
        fade_in=3.0,
        fade_out=3.0,
        omega=float(omega_rows[center_idx]),
        phi_center=float(rng.uniform(0.0, 2.0 * np.pi)),
        phi_width=float(rng.uniform(0.08, 0.20)),
        r_center=rt_r_base,
        r_length=rt_r_length,
        intensity=float(rng.uniform(0.8, 1.0)),
        delta_t=float(rng.uniform(0.5, 1.2)),
    )


class EntityFactory:
    """Maintains a steady-state population of one entity type.

    Spawn-debt rate control keeps ~target_count alive: dead entities are
    culled each tick and replacements spawn at target_count/avg_lifetime
    per second (reference render.py:767-787).
    """

    def __init__(
        self,
        spawn_fn: Callable[..., Entity],
        target_count: int,
        lifetime_range: Tuple[float, float],
        r_norm: np.ndarray,
        omega_rows: np.ndarray,
        seed: int = 0,
    ):
        self.spawn_fn = spawn_fn
        self.target_count = target_count
        self.lifetime_range = lifetime_range
        self.r_norm = r_norm
        self.omega_rows = omega_rows
        self.rng = np.random.default_rng(seed)
        self.entities: List[Entity] = []
        self._spawn_debt = 0.0

    def _spawn_one(self, now: float) -> Entity:
        lifetime = float(self.rng.uniform(*self.lifetime_range))
        return self.spawn_fn(self.rng, self.r_norm, self.omega_rows, now, lifetime)

    def _filament_death_age(self, e: Entity) -> float:
        for t in range(1, int(FILAMENT_MAX_LIFETIME) + 1):
            if e.density_factor(float(t)) < FILAMENT_DEATH_THRESHOLD:
                return float(t)
        return FILAMENT_MAX_LIFETIME

    def seed_initial(self, now: float) -> None:
        """Pre-populate at staggered ages so t=0 is already steady-state."""
        for i in range(self.target_count):
            e = self._spawn_one(now)
            if e.entity_type == "filament":
                death_age = self._filament_death_age(e)
                min_age = FILAMENT_BIRTH_FADE_DUR
                stagger = min_age + max(death_age - min_age, 1.0) * (
                    i / max(self.target_count, 1)
                )
            else:
                stagger = (e.fade_in + e.lifetime) * (i / max(self.target_count, 1))
            e.birth_time = now - stagger
            self.entities.append(e)

    def tick(self, now: float, dt: float) -> None:
        self.entities = [e for e in self.entities if not e.is_dead(now)]
        deficit = self.target_count - len(self.entities)
        if deficit <= 0:
            return
        avg_lifetime = sum(self.lifetime_range) / 2.0
        self._spawn_debt += (self.target_count / avg_lifetime) * dt
        n_spawn = min(int(self._spawn_debt), deficit)
        self._spawn_debt -= n_spawn
        for _ in range(n_spawn):
            self.entities.append(self._spawn_one(now))

    @property
    def alive_entities(self) -> List[Entity]:
        return self.entities


def radial_omega_rows(n_r: int, r_inner: float, r_outer: float):
    """(r_norm, omega_rows) on the texture's radial grid — the ONE
    source for entity spawn omegas and device advection omegas (three
    sites used to inline this recipe; a dtype or formula drift between
    them would desynchronize entity phases across engines)."""
    r_norm = np.linspace(0.0, 1.0, n_r)
    r_vals = r_inner + (r_outer - r_inner) * r_norm
    omega_rows = keplerian_omega(
        torch.as_tensor(r_vals, dtype=torch.float32)
    ).numpy()
    return r_norm, omega_rows


def make_factories(n_r: int, r_inner: float, r_outer: float,
                   seed: int = 42,
                   enable_rt: bool = True) -> Dict[str, EntityFactory]:
    """Standard factory set: 200 filaments, 30 hotspots, 15 RT spikes.

    ``enable_rt=False`` sets the RT-spike target count to zero (no
    seeding, no spawn debt), so the RT comp planes stay exactly zero —
    the same meaning "RT disabled" has in the parametric/static path
    (reference generate_disk_texture's enable_rt)."""
    r_norm, omega_rows = radial_omega_rows(n_r, r_inner, r_outer)
    return {
        "filament": EntityFactory(
            spawn_filament, 200, (15.0, 60.0), r_norm, omega_rows, seed + 100
        ),
        "hotspot": EntityFactory(
            spawn_hotspot, 30, (15.0, 30.0), r_norm, omega_rows, seed + 200
        ),
        "rt_spike": EntityFactory(
            spawn_rt_spike, 15 if enable_rt else 0, (15.0, 30.0), r_norm,
            omega_rows, seed + 300
        ),
    }




# ---------------------------------------------------------------------------
# Host packing: alive entities -> fixed-size parameter rows.
# ---------------------------------------------------------------------------

_FIL_PARAMS = 8   # phi_center, base_r, sigma_r, sigma_phi_t, amp_d, amp_t, age, _
_TIMER_PARAMS = 8  # phi_center, phi_width, r_center, r_w_or_len, amp_d, amp_t, age, pad


def pack_filaments(factory: EntityFactory, now: float) -> np.ndarray:
    """(MAX_FILAMENTS, 8) float32 parameter rows; zero-amplitude padding.

    Pre-folds the time-dependent scalars (shear-widened sigma, birth
    fade, cooling) on host so the device pass is pure profile math
    (reference accumulation loop, render.py:3608-3638).
    """
    out = np.zeros((MAX_FILAMENTS, _FIL_PARAMS), np.float32)
    i = 0
    for e in factory.alive_entities:
        if i >= MAX_FILAMENTS:
            break
        age = now - e.birth_time
        if age < 0:
            continue
        decay = e.density_factor(age)
        if decay < FILAMENT_DEATH_THRESHOLD:
            continue
        s0 = max(e.sigma_phi0, 1e-6)
        sigma_t = s0 + e.alpha_shear * age
        birth_alpha = min(age / FILAMENT_BIRTH_FADE_DUR, 1.0)
        cool = math.exp(-age / e.tau_cool) if e.tau_cool > 0 else 1.0
        amp_d = e.peak_density * (s0 / sigma_t) * birth_alpha * cool
        amp_t = e.peak_temp * (s0 / sigma_t) * birth_alpha * cool
        out[i] = (e.phi_center, e.base_r, max(e.sigma_r, 1e-6), sigma_t,
                  amp_d, amp_t, age, 0.0)
        i += 1
    return out


def pack_timer_entities(factory: EntityFactory, now: float,
                        max_count: int) -> np.ndarray:
    """(max_count, 8) rows for hotspot / rt_spike entities. The profile
    shape (hotspot Gaussian vs RT radial finger) is selected per family
    in accumulate_entity_layer, not per row; slot 7 is padding."""
    out = np.zeros((max_count, _TIMER_PARAMS), np.float32)
    i = 0
    for e in factory.alive_entities:
        if i >= max_count:
            break
        alpha = e.fade_factor(now)
        if alpha <= 0:
            continue
        age = now - e.birth_time
        amp = e.intensity * alpha
        r_scale = e.r_width if e.entity_type == "hotspot" else e.r_length
        out[i] = (e.phi_center, e.phi_width, e.r_center, max(r_scale, 1e-6),
                  amp, amp * e.delta_t, age, 0.0)
        i += 1
    return out


# ---------------------------------------------------------------------------
# Device accumulation: packed rows -> (6, n_r, n_phi) staging planes.
# ---------------------------------------------------------------------------


def _linspace_f32(start: float, stop: float, num: int, endpoint: bool,
                  device) -> torch.Tensor:
    """float32 ``jnp.linspace``: start * (1 - s) + stop * s with
    s = iota / div, the last point set to ``stop`` when ``endpoint``.
    ``torch.linspace`` evaluates its grid another way and can differ in
    the last bit, which would shift every entity profile sample."""
    div = num - 1 if endpoint else num
    s = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - s) + stop * s
    if endpoint:
        out = torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                         device=device)])
    return out


def accumulate_entity_layer(
    fil_params: torch.Tensor,
    hs_params: torch.Tensor,
    rt_params: torch.Tensor,
    omega_rows: torch.Tensor,
    n_r: int,
    n_phi: int,
    phi_scale: int = 1,
) -> torch.Tensor:
    """Evaluate all alive entities -> staging (6, n_r, n_phi).

    Staging layout (maps to comp[5..10], reference render.py:3455-3473):
      0 filaments density  1 filaments temp
      2 rt density         3 rt temp
      4 hotspot density    5 hotspot temp

    Each entity's azimuthal center advects by -omega(r) * age per row;
    profiles are evaluated analytically in chunks over the padded
    entity axis. ``phi_scale`` (1, 2 or 4) evaluates on an
    n_phi/phi_scale azimuthal grid and upsamples linearly (periodic).
    """
    if n_phi % phi_scale:
        raise ValueError(
            f"phi_scale={phi_scale} must divide n_phi={n_phi}")
    dev = omega_rows.device
    n_phi_lo = n_phi // phi_scale
    phi = _linspace_f32(0.0, 2.0 * math.pi, n_phi_lo, False, dev)
    r_norm = _linspace_f32(0.0, 1.0, n_r, True, dev)
    two_pi = 2.0 * math.pi

    def filament_planes(params, chunk=32):
        dens = torch.zeros((n_r, n_phi_lo), device=dev)
        temp = torch.zeros((n_r, n_phi_lo), device=dev)
        for c0 in range(0, params.shape[0], chunk):
            p = params[c0: c0 + chunk]
            # clamp guards: zero-amplitude padding rows have zero
            # sigmas, which would otherwise produce 0/0 = NaN.
            sigma_r = torch.clamp(p[:, 2:3], min=1e-6)
            sigma_phi = torch.clamp(p[:, 3:4, None], min=1e-6)
            z = (r_norm[None, :] - p[:, 1:2]) / sigma_r
            r_w = torch.exp(-0.5 * (z * z))  # (C, n_r)
            # Row-wise advected center: source_phi - omega(r) * age.
            center = p[:, 0:1] - omega_rows[None, :] * p[:, 6:7]  # (C, n_r)
            d_phi = phi[None, None, :] - center[:, :, None]
            d_phi = d_phi - two_pi * torch.round(d_phi / two_pi)
            zp = d_phi / sigma_phi
            prof = torch.exp(-0.5 * (zp * zp))  # (C, n_r, n_phi)
            w = r_w[:, :, None] * prof
            dens = dens + torch.sum(w * p[:, 4:5, None], dim=0)
            temp = temp + torch.sum(w * p[:, 5:6, None], dim=0)
        return dens, temp

    def timer_planes(params, is_rt: bool, chunk=16):
        dens = torch.zeros((n_r, n_phi_lo), device=dev)
        temp = torch.zeros((n_r, n_phi_lo), device=dev)
        for c0 in range(0, params.shape[0], chunk):
            p = params[c0: c0 + chunk]
            width = torch.clamp(p[:, 1:2], min=1e-6)
            kappa = 1.5 / (width * width)  # (C, 1)
            # von-Mises azimuthal profile, advected per-row by -omega*age.
            shift = omega_rows[None, :] * p[:, 6:7]  # (C, n_r)
            ang = phi[None, None, :] - (p[:, 0:1, None] - shift[:, :, None])
            prof = torch.exp(kappa[:, :, None] * (torch.cos(ang) - 1.0))
            r_diff = r_norm[None, :] - p[:, 2:3]  # (C, n_r)
            r_scale = torch.clamp(p[:, 3:4], min=1e-6)  # padding-row guard
            if is_rt:
                fade_out = torch.clamp(r_scale * 2.0 - r_diff, 0.0, 1.0)
                fade_in = torch.clamp(r_diff / (r_scale * 0.3), 0.0, 1.0)
                z = r_diff / (r_scale * 0.4)
                r_prof = torch.exp(-0.5 * (z * z)) * fade_out * fade_in
            else:
                z = r_diff / r_scale
                r_prof = torch.exp(-0.5 * (z * z))
            w = prof * r_prof[:, :, None]
            dens = dens + torch.sum(w * p[:, 4:5, None], dim=0)
            temp = temp + torch.sum(w * p[:, 5:6, None], dim=0)
        return dens, temp

    fil_d, fil_t = filament_planes(fil_params)
    rt_d, rt_t = timer_planes(rt_params, is_rt=True)
    hs_d, hs_t = timer_planes(hs_params, is_rt=False)
    staging = torch.stack([fil_d, fil_t, rt_d, rt_t, hs_d, hs_t], dim=0)
    if n_phi_lo != n_phi:
        # Linear upsample along phi (periodic): lerp between each
        # low-res column and its wrapped neighbor.
        nxt = torch.roll(staging, -1, dims=2)
        f = phi_scale
        w = torch.arange(f, dtype=staging.dtype, device=dev)[None, None, None, :] / f
        fine = staging[..., None] * (1.0 - w) + nxt[..., None] * w
        staging = fine.reshape(staging.shape[0], n_r, n_phi)
    return staging
