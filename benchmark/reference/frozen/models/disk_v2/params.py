"""Disk V2 parameter objects (frozen, validated at construction).

The copy of ``bhr_tpu/models/disk_v2/params.py`` (reference
disk_v2/params.py:12-144): the same fields, defaults and validation
rules (radius ordering, positivity, modulation-strength bounds that keep
every multiplicative factor > 0). Host only.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DiskV2Params:
    """Base disk body: geometric bounds + base physical-field scales.

    Attributes:
        r_in / r_out: hard radial bounds (r_out > r_in > 0).
        h0: thickness fraction at r ~ r_in.
        beta_h: power-law index of the slow thickness growth with r.
        rho_power: radial decay exponent of the midplane density.
        temp_scale / omega_scale: overall field scalings.
        edge_softness: smooth-edge width as a fraction of (r_out - r_in),
            in [0, 0.5).
    """

    r_in: float = 2.0
    r_out: float = 10.0
    h0: float = 0.05
    beta_h: float = 0.05
    rho_power: float = 1.0
    temp_scale: float = 1.0
    omega_scale: float = 1.0
    edge_softness: float = 0.1

    def __post_init__(self) -> None:
        if self.r_in <= 0.0:
            raise ValueError("r_in must be positive")
        if self.r_out <= self.r_in:
            raise ValueError("r_out must be greater than r_in")
        if self.h0 <= 0.0:
            raise ValueError("h0 must be positive")
        if self.rho_power <= 0.0:
            raise ValueError("rho_power must be positive")
        if self.temp_scale <= 0.0:
            raise ValueError("temp_scale must be positive")
        if self.omega_scale <= 0.0:
            raise ValueError("omega_scale must be positive")
        if not 0.0 <= self.edge_softness < 0.5:
            raise ValueError("edge_softness must be in [0, 0.5)")


@dataclass(frozen=True)
class DiskV2StructureParams:
    """Static structure modulation layer strengths and scales.

    Multiplicative-safety constraints: mode1 + mode2 < 1, shear < 1,
    hotspot < 1 so that 1 + strength * signed_component stays positive.
    """

    mode1_strength: float = 0.03
    mode2_strength: float = 0.05
    shear_strength: float = 0.22
    shear_components: int = 8
    hotspot_strength: float = 0.16
    hotspot_count: int = 8
    hotspot_phi_sigma: float = 0.18
    hotspot_logr_sigma: float = 0.12
    hotspot_inner_bias: float = 2.0

    def __post_init__(self) -> None:
        if self.mode1_strength < 0.0:
            raise ValueError("mode1_strength must be non-negative")
        if self.mode2_strength < 0.0:
            raise ValueError("mode2_strength must be non-negative")
        if self.mode1_strength + self.mode2_strength >= 1.0:
            raise ValueError("mode1_strength + mode2_strength must be < 1")
        if self.shear_strength < 0.0:
            raise ValueError("shear_strength must be non-negative")
        if self.shear_strength >= 1.0:
            raise ValueError("shear_strength must be < 1")
        if self.shear_components <= 0:
            raise ValueError("shear_components must be positive")
        if self.hotspot_strength < 0.0:
            raise ValueError("hotspot_strength must be non-negative")
        if self.hotspot_strength >= 1.0:
            raise ValueError("hotspot_strength must be < 1")
        if self.hotspot_count <= 0:
            raise ValueError("hotspot_count must be positive")
        if self.hotspot_phi_sigma <= 0.0:
            raise ValueError("hotspot_phi_sigma must be positive")
        if self.hotspot_logr_sigma <= 0.0:
            raise ValueError("hotspot_logr_sigma must be positive")
        if self.hotspot_inner_bias <= 0.0:
            raise ValueError("hotspot_inner_bias must be positive")
