"""The static disk texture's ``.npy`` cache (``--disk_texture auto``).

The port of ``bhr_tpu/utils/cache.py``'s texture cache (reference
``load_cached_disk_texture``, render.py:1152-1187): the same directory,
key and file format ((n_r, n_phi, 4) float32 ``.npy``), and the same
texture for a key (``models/disk_texture.py`` draws ``bhr_tpu``'s
streams), so either package may load what the other saved.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

DEFAULT_CACHE_DIR = "output/.disk_texture_cache"


def texture_cache_key(r_inner: float, r_outer: float, seed: int,
                      n_phi: int, n_r: int, generation_scale: int) -> str:
    return (f"disk_{r_inner:.2f}_{r_outer:.2f}_{seed}_{n_phi}x{n_r}"
            f"_scale{generation_scale}.npy")


def load_cached_disk_texture(
    width: Optional[int] = None,
    height: Optional[int] = None,
    cam_pos: Optional[List[float]] = None,
    fov: Optional[float] = None,
    seed: int = 42,
    r_inner: float = 2.0,
    r_outer: float = 3.5,
    force: bool = False,
    generation_scale: int = 2,
    cache_dir: Optional[str] = None,
    device="cuda",
) -> np.ndarray:
    """Load, or generate on ``device`` and save, the static disk texture.

    Resolution is camera-dependent when width/height/cam_pos/fov are all
    given, else 1024x512. ``force`` regenerates over a cached file.
    Returns (n_r, n_phi, 4) float32 on the host.
    """
    from ..config import compute_disk_texture_resolution
    from ..models.disk_texture import generate_disk_texture

    if (
        width is not None and height is not None
        and cam_pos is not None and fov is not None
    ):
        n_phi, n_r = compute_disk_texture_resolution(
            width, height, tuple(cam_pos), fov, r_inner, r_outer
        )
    else:
        n_phi, n_r = 1024, 512

    if cache_dir is None:
        # Resolved at call time so tests (and embedders) can repoint
        # DEFAULT_CACHE_DIR.
        cache_dir = DEFAULT_CACHE_DIR
    path = os.path.join(cache_dir, texture_cache_key(
        r_inner, r_outer, seed, n_phi, n_r, generation_scale))
    if not force and os.path.exists(path):
        return np.load(path)

    tex = generate_disk_texture(
        n_phi=n_phi, n_r=n_r, seed=seed, r_inner=r_inner, r_outer=r_outer,
        generation_scale=generation_scale, device=device,
    ).cpu().numpy()
    os.makedirs(cache_dir, exist_ok=True)
    np.save(path, tex)
    return tex
