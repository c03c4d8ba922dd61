"""Dynamic disk: background noise + entity lifecycle -> per-frame texture.

The port of ``bhr_tpu/models/dynamic_disk.py`` (reference
``_init_lifecycle_system`` / ``_advance_lifecycle_frame``, render.py:
4079-4153): a time-evolving noise background (comp slices 0-4, 11, 12)
plus the entity lifecycle layer (slices 5-10), composed through the
13-component contract with periodically recomputed normalization stats.
Factory bookkeeping and parameter packing stay on the host (NumPy); the
noise, entity evaluation, stats and compose run on the torch device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import torch_device
from ..constants import DISK_COLOR_TEMPERATURE
from ..ops.background import generate_background_components
from ..ops.stats import approx_quantile, approx_quantile_rows
from ..utils.io import compute_edge_alpha
from ..utils.nans import check_nans
from .disk_texture import (
    compose_from_components,
    density_from_comp,
    temp_struct_from_comp,
)
from .lifecycle import (
    MAX_HOTSPOTS,
    MAX_RT_SPIKES,
    accumulate_entity_layer,
    make_factories,
    pack_filaments,
    pack_timer_entities,
    radial_omega_rows,
)


def assemble_comp(bg: torch.Tensor, staging: torch.Tensor) -> torch.Tensor:
    """The 13-component field from background + entity planes:
    [tb, sp, sp_t, turb, turb_t, fil_d, fil_t, rt_d, rt_t, hs_d, hs_t,
    az, dm] — the 6 entity staging planes are comp slices 5-10."""
    return torch.cat([bg[0:5], staging, bg[5:7]], dim=0)


def _recompute_stats(comp, edge, enable_rt: bool = True, stage_prefix: str = ""):
    """Normalization stats from the live comp field, with temp-base
    floors so sparse entity rows don't over-clamp the background
    (reference recompute_interactive_stats, render.py:3655-3712).
    Quantiles are the histogram approximation of ops/stats.py. The NaN
    trap checks the stats as stage ``stage_prefix + "disk_stats"``."""
    density = density_from_comp(comp, edge, enable_rt)
    density_p98 = torch.clamp(approx_quantile(density, 0.98), min=0.01)

    temp_struct = temp_struct_from_comp(comp)
    pos = temp_struct > 0
    struct_scale = torch.where(
        torch.any(pos),
        approx_quantile(temp_struct, 0.95, mask=pos),
        1.0,
    )
    struct_scale = torch.clamp(struct_scale, min=0.01)

    ts_scaled = torch.clamp(temp_struct / (struct_scale + 1e-6) * 0.8, 0.0, 1.2)
    struct_max = torch.amax(ts_scaled, dim=1)
    struct_p70 = approx_quantile_rows(ts_scaled, 0.7, lo=0.0, hi=1.2)

    tb_max = torch.amax(comp[0], dim=1)
    struct_max = torch.maximum(struct_max, tb_max)
    struct_p70 = torch.maximum(struct_p70, tb_max * 0.8)
    stats = density_p98, struct_scale, torch.stack([struct_max, struct_p70], dim=1)
    check_nans(stage_prefix + "disk_stats", stats)
    return stats


# Solo-component debug pairs (density slice <-> its temperature slice),
# reference compose_interactive_texture (render.py:3728-3753).
_SOLO_PAIRS = {
    0: [], 1: [2], 2: [1], 3: [4], 4: [3], 5: [6], 6: [5],
    7: [8], 8: [7], 9: [10], 10: [9], 11: [], 12: [],
}


def solo_comp(comp: torch.Tensor, solo_idx: int) -> torch.Tensor:
    """Zero all components except the soloed density/temp pair;
    disturb_mod (slice 12) becomes the neutral multiplier 1. One masked
    select. Module-level so that the batched engine (``parallel/video.py``,
    which the interactive session renders through) and
    ``DynamicDiskSystem.advance`` share the same mask."""
    keep = {solo_idx} | set(_SOLO_PAIRS.get(solo_idx, []))
    mask = torch.tensor([i in keep for i in range(13)], dtype=torch.bool,
                        device=comp.device)[:, None, None]
    fill = torch.zeros(13, dtype=comp.dtype, device=comp.device)
    fill[12] = 1.0
    return torch.where(mask, comp, fill[:, None, None])


def frame_texture(fil, hs, rt, omega_rows, edge, t: float, *, n_r: int,
                  n_phi: int, az_freq: float, az_shear: float, r_inner: float,
                  r_outer: float, generation_scale: int, color_temp: float,
                  enable_rt: bool = True, stats=None, background=None,
                  solo_idx: int = -1, stage_prefix: str = ""):
    """One frame's disk texture from packed entity rows, as tensors on
    one device: ``fil`` (MF, 8), ``hs`` (MH, 8), ``rt`` (MR, 8) float32
    (``pack_filaments`` / ``pack_timer_entities``), the per-row
    ``omega_rows`` and ``edge``, at time ``t``.

    ``stats`` is the (density_p98, struct_scale, row_stats) to normalize
    with; None recomputes them from this frame's component field.
    ``background`` is this frame's (7, n_r, n_phi) background stack where
    the caller made it already (the video engine makes a batch's in one
    pass of ``generate_background_components``); None makes it here. Both
    ``DynamicDiskSystem.advance`` and the batched video engine
    (``parallel/video.py``) make their textures here.

    ``solo_idx`` >= 0 composes the solo-component debug view: the field
    is masked by :func:`solo_comp` before the stats (``stats=None`` then
    normalizes the view with its own) and the compose.

    The NaN trap (``utils/nans.py``) checks the texture and the field as
    stage ``stage_prefix + "disk_texture"`` and recomputed stats as
    ``stage_prefix + "disk_stats"`` (the video engine's prefix is
    ``"video/"``).

    Returns ((n_r, n_phi, 4) RGBA texture, the whole (13, n_r, n_phi)
    component field (never the masked one), the stats used).
    """
    device = omega_rows.device
    bg = background
    if bg is None:
        bg = generate_background_components(
            n_r, n_phi, az_freq, az_shear, r_inner, r_outer, t,
            generation_scale=generation_scale, device=device,
        )
    staging = accumulate_entity_layer(
        fil, hs, rt, omega_rows, n_r, n_phi, phi_scale=generation_scale,
    )
    comp = assemble_comp(bg, staging)
    shown = solo_comp(comp, solo_idx) if solo_idx >= 0 else comp
    if stats is None:
        stats = _recompute_stats(shown, edge, enable_rt, stage_prefix)
    tex = compose_from_components(
        shown, edge, *stats, enable_rt,
        torch.tensor(color_temp, dtype=torch.float32, device=device),
    )
    check_nans(stage_prefix + "disk_texture", tex, comp)
    return tex, comp, stats


def adaptive_generation_scale(n_r: int, n_phi: int) -> int:
    """Low-res generation factor by texture size: 4 for 4K-class
    textures (n_phi >= 4096), else 2, from the reference's choice set
    {1, 2, 4} (render.py:78-87); falls back while not divisible."""
    scale = 4 if n_phi >= 4096 else 2
    while scale > 1 and (n_r % scale or n_phi % scale):
        scale //= 2
    return scale


class DynamicDiskSystem:
    """Per-frame dynamic texture generator (lifecycle + background).

    Usage:
        dyn = DynamicDiskSystem(n_r, n_phi, r_inner, r_outer, seed=42)
        tex = dyn.advance(t=0.0, dt=0.0, recompute_stats=True)

    ``device`` is a ``SceneConfig.device`` name (default ``"cuda"``,
    which raises on a host without a GPU, as ``SceneConfig`` does) or a
    ``torch.device``.
    """

    def __init__(
        self,
        n_r: int,
        n_phi: int,
        r_inner: float,
        r_outer: float,
        seed: int = 42,
        enable_rt: bool = True,
        color_temp: Optional[float] = None,
        generation_scale: Optional[int] = None,
        device="cuda",
    ):
        self.n_r = n_r
        self.n_phi = n_phi
        if generation_scale is None:
            self.generation_scale = adaptive_generation_scale(n_r, n_phi)
        else:
            self.generation_scale = (
                generation_scale if (n_r % generation_scale == 0 and
                                     n_phi % generation_scale == 0) else 1
            )
        self.r_inner = float(r_inner)
        self.r_outer = float(r_outer)
        self.enable_rt = enable_rt
        self.color_temp = float(
            DISK_COLOR_TEMPERATURE if color_temp is None else color_temp
        )
        self.device = (torch_device(device) if isinstance(device, str)
                       else torch.device(device))

        rng = np.random.default_rng(seed)
        self.az_freq = float(rng.integers(2, 5))
        self.az_shear = float(rng.uniform(2.0, 4.0))

        self.factories: Dict = make_factories(
            n_r, r_inner, r_outer, seed, enable_rt=enable_rt
        )
        for f in self.factories.values():
            f.seed_initial(now=0.0)

        r_norm, omega_np = radial_omega_rows(n_r, r_inner, r_outer)
        # Initial permissive stats (reference init_background_layer,
        # render.py:3532-3542) — replaced by the first recompute.
        tb_init = np.clip(1.0 - r_norm, 0.0, 1.0) ** 1.3 * 0.25
        row_stats = np.stack(
            [np.maximum(tb_init, 0.25), np.maximum(tb_init * 0.8, 0.10)],
            axis=1,
        ).astype(np.float32)
        self.set_field_state(omega_np, compute_edge_alpha(n_r), 0.5, 0.5,
                             row_stats)
        self.comp: Optional[torch.Tensor] = None

    def set_field_state(self, omega_rows, edge, density_p98, struct_scale,
                        row_stats) -> None:
        """Place the per-row advection omegas, edge alpha and the
        normalization stats on the device (float32)."""
        def dev(a):
            return torch.tensor(np.asarray(a, np.float32), device=self.device)

        self.omega_rows = dev(omega_rows)
        self.edge = dev(edge)
        self.density_p98 = dev(density_p98)
        self.struct_scale = dev(struct_scale)
        self.row_stats = dev(row_stats)

    def _pack(self, now: float):
        """Packed (filament, hotspot, rt_spike) parameter rows at ``now``."""
        return (
            pack_filaments(self.factories["filament"], now),
            pack_timer_entities(self.factories["hotspot"], now, MAX_HOTSPOTS),
            pack_timer_entities(self.factories["rt_spike"], now, MAX_RT_SPIKES),
        )

    @property
    def entity_count(self) -> int:
        return sum(len(f.entities) for f in self.factories.values())

    def _frame_texture(self, t: float, stats, solo_idx: int = -1):
        """``frame_texture`` of this system's current entities at ``t``."""
        fil, hs, rt = (torch.as_tensor(a, device=self.device)
                       for a in self._pack(t))
        return frame_texture(
            fil, hs, rt, self.omega_rows, self.edge, t,
            n_r=self.n_r, n_phi=self.n_phi, az_freq=self.az_freq,
            az_shear=self.az_shear, r_inner=self.r_inner,
            r_outer=self.r_outer, generation_scale=self.generation_scale,
            color_temp=self.color_temp, enable_rt=self.enable_rt, stats=stats,
            solo_idx=solo_idx,
        )

    def advance(self, t: float, dt: float, recompute_stats: bool = False,
                solo_idx: int = -1) -> torch.Tensor:
        """Tick factories, regenerate the comp field, compose the texture.

        Returns the (n_r, n_phi, 4) RGBA texture for time ``t`` on the
        system's device. ``solo_idx`` >= 0 returns the solo-component
        debug view, normalized with stats of the masked field that are
        for this display only: the stats the system keeps always come
        from the whole field (as in ``bhr_tpu``, whose deviation from the
        reference this is: un-soloing resumes at once with the whole
        field's stats).
        """
        for f in self.factories.values():
            f.tick(now=t, dt=dt)
        if solo_idx >= 0:
            tex, self.comp, _ = self._frame_texture(t, None, solo_idx)
            if recompute_stats:
                self.density_p98, self.struct_scale, self.row_stats = (
                    _recompute_stats(self.comp, self.edge, self.enable_rt))
            return tex
        stats = None if recompute_stats else (
            self.density_p98, self.struct_scale, self.row_stats)
        tex, self.comp, stats = self._frame_texture(t, stats)
        self.density_p98, self.struct_scale, self.row_stats = stats
        return tex

    def refresh_stats(self, t: float) -> None:
        """Recompute the normalization stats from the current factory
        state at time ``t`` without ticking the factories.

        Video resume uses it: the replay loop ticks the factories frame
        by frame and calls this at the frame where an uninterrupted run
        last recomputed its stats, so the resumed frames normalize as
        that run's did.
        """
        _, self.comp, stats = self._frame_texture(t, None)
        self.density_p98, self.struct_scale, self.row_stats = stats
