"""Carry the JAX package's state into the port, and results back out.

For a renderer the "weights" are the scene state: textures, the disk's
entity parameters and normalization stats, a trace's hit buffers. These
functions take that state as NumPy arrays (the caller converts JAX
arrays with ``np.asarray``) and build the port's objects, so both
packages can be fed the same inputs and compared. No JAX is imported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import SceneConfig
from .models.disk_v2.params import DiskV2Params, DiskV2StructureParams
from .models.dynamic_disk import DynamicDiskSystem
from .ops.geodesic import TraceResult
from .pipeline import Renderer


def trace_result_from_numpy(captured, escaped, escape_dir, hit_count, hits,
                            steps=None, device="cpu") -> TraceResult:
    """TraceResult from arrays in ``bhr_tpu``'s layout: (N,) bool flags,
    (N, 3) escape directions, (N,) int32 counts, (K, 12, N) hits and,
    optionally, (N,) int32 step counts."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return TraceResult(
        captured=t(captured, torch.bool),
        escaped=t(escaped, torch.bool),
        escape_dir=t(escape_dir, torch.float32),
        hit_count=t(hit_count, torch.int32),
        hits=t(hits, torch.float32),
        steps=None if steps is None else t(steps, torch.int32),
    )


def trace_result_to_numpy(trace: TraceResult) -> Tuple[np.ndarray, ...]:
    """(captured, escaped, escape_dir, hit_count, hits, steps) as NumPy
    arrays; steps is None when the trace did not count them."""
    return tuple(None if x is None else x.detach().cpu().numpy()
                 for x in trace)


class _ImportedDiskSystem(DynamicDiskSystem):
    """A DynamicDiskSystem whose entity layer is a fixed set of packed
    parameter rows exported from another system, not live factories."""

    def __init__(self, packs, **kwargs):
        self._packs = tuple(np.array(p, np.float32) for p in packs)
        super().__init__(**kwargs)
        self.factories = {}  # nothing to tick: the entities come packed

    def _pack(self, now: float):
        return self._packs


def dynamic_disk_from_state(
    *,
    n_r: int,
    n_phi: int,
    r_inner: float,
    r_outer: float,
    az_freq: float,
    az_shear: float,
    fil_params,
    hs_params,
    rt_params,
    omega_rows,
    edge,
    density_p98,
    struct_scale,
    row_stats,
    enable_rt: bool = True,
    color_temp=None,
    generation_scale=None,
    device="cpu",
) -> DynamicDiskSystem:
    """A DynamicDiskSystem carrying the JAX system's exported state:
    its background parameters (``az_freq``, ``az_shear``), the packed
    entity rows (as ``pack_filaments`` / ``pack_timer_entities`` return
    them), the per-row ``omega_rows`` and ``edge``, and the current
    normalization stats. ``advance(t, ...)`` then evaluates that exact
    entity state."""
    system = _ImportedDiskSystem(
        (fil_params, hs_params, rt_params),
        n_r=n_r, n_phi=n_phi, r_inner=r_inner, r_outer=r_outer,
        enable_rt=enable_rt, color_temp=color_temp,
        generation_scale=generation_scale, device=device,
    )
    system.az_freq = float(az_freq)
    system.az_shear = float(az_shear)
    system.set_field_state(omega_rows, edge, density_p98, struct_scale,
                           row_stats)
    return system


def disk_v2_params_from_dicts(params: dict, structure: Optional[dict] = None
                              ) -> Tuple[DiskV2Params,
                                         Optional[DiskV2StructureParams]]:
    """The port's (DiskV2Params, DiskV2StructureParams or None) from
    ``bhr_tpu``'s V2 dataclasses given as plain dicts of Python numbers
    (``dataclasses.asdict`` on the caller's side); ``structure`` None
    stays None. The fields are validated as at construction."""
    return (DiskV2Params(**params),
            None if structure is None else DiskV2StructureParams(**structure))


def renderer_from_numpy(config: SceneConfig, skybox: np.ndarray,
                        disk_tex, device="cpu") -> Renderer:
    """A Renderer over NumPy assets: the (H, W, 3) skybox and the
    (n_r, n_phi, 4) disk texture, or None for a scene without a disk
    and for a ``disk_model="v2"`` config, which shades by volume
    integration and takes no texture."""
    if config.disk_model == "v2" and disk_tex is not None:
        raise ValueError("a disk_model='v2' config takes no disk texture")
    return Renderer(config, np.asarray(skybox, np.float32),
                    None if disk_tex is None else np.asarray(disk_tex, np.float32),
                    device=device)
