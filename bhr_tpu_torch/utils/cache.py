"""Caching: the static disk texture's ``.npy`` cache (``--disk_texture
auto``) and the build cache of the compiled ``csrc/`` libraries.

The port of ``bhr_tpu/utils/cache.py``. The texture cache (reference
``load_cached_disk_texture``, render.py:1152-1187) has the same
directory, key and file format ((n_r, n_phi, 4) float32 ``.npy``), and
the same texture for a key (``models/disk_texture.py`` draws
``bhr_tpu``'s streams), so either package may load what the other saved.

Where ``bhr_tpu`` keeps XLA's persistent compilation cache, the port's
persistent compiled artifacts are the libraries ``_build.py`` builds
from ``csrc/`` into ``bhr_tpu_torch/_build/``, which it reads through
:func:`compile_cache_dir`. The cache is on unless
:func:`disable_compile_cache` (the CLI's ``--no_compile_cache``) gives
this process a private directory instead.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import List, Optional

import numpy as np

from .. import _build

DEFAULT_CACHE_DIR = "output/.disk_texture_cache"

_compile_cache_dir = _build.BUILD_DIR


def compile_cache_dir() -> str:
    """The directory ``_build`` reads and writes its libraries in."""
    return _compile_cache_dir


def enable_compile_cache(path: str = _build.BUILD_DIR) -> None:
    """Build into, and load from, the persistent directory ``path`` (the
    default; idempotent). As every switch of this cache, it acts only on
    builds that have not happened yet: a library already loaded (e.g.
    the ray-march kernel's, ``ops/geodesic_cuda._kernel_lib``) stays."""
    global _compile_cache_dir
    _compile_cache_dir = path


def disable_compile_cache() -> str:
    """Build every library this process loads from now on afresh, into a
    private temporary directory that is removed when the process exits:
    nothing is read from or written to the persistent directory. The
    counterpart of compiling without XLA's persistent cache; it proves
    that the sources build on this host. Returns the directory."""
    global _compile_cache_dir
    path = tempfile.mkdtemp(prefix="bhr_tpu_torch_build_")
    atexit.register(shutil.rmtree, path, True)
    _compile_cache_dir = path
    return path


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
