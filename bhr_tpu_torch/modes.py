"""Run modes: the single still frame, whole or in row bands.

The port of the still-frame mode of ``bhr_tpu/modes.py`` (reference
``render_image``, render.py:4031-4076). Video and interactive modes are
not ported yet; ``SceneConfig.validated`` refuses them.
"""

from __future__ import annotations

import time

import numpy as np

from .config import SceneConfig, compute_disk_texture_resolution, torch_device
from .models.dynamic_disk import DynamicDiskSystem
from .models.skybox import load_or_generate_skybox
from .pipeline import Renderer
from .utils.io import load_disk_texture


def _scene_assets(config: SceneConfig, device) -> tuple:
    """(skybox, disk_tex, dynamic_or_None) for a config.

    An explicit ``disk_texture`` path is loaded or fails loudly;
    otherwise the disk comes from the lifecycle system (a zero
    placeholder texture until it advances).
    """
    width, height = config.image_size
    skybox, _, _ = load_or_generate_skybox(
        config.texture, 2048, 1024, config.n_stars, seed=config.skybox_seed
    )
    disk_tex = load_disk_texture(config.disk_texture)
    if config.disk_texture is not None and disk_tex is None:
        # A path typo must not render the procedural disk instead.
        raise FileNotFoundError(
            f"--disk_texture not found or unreadable: {config.disk_texture}"
        )
    dynamic = None
    if disk_tex is None:
        n_phi, n_r = compute_disk_texture_resolution(
            width, height, config.pov, config.fov,
            config.disk_inner_radius, config.disk_outer_radius,
        )
        dynamic = DynamicDiskSystem(
            n_r, n_phi, config.disk_inner_radius, config.disk_outer_radius,
            seed=config.seed, device=device,
        )
        disk_tex = np.zeros((n_r, n_phi, 4), np.float32)
    return skybox, disk_tex, dynamic


def _make_renderer(config: SceneConfig) -> tuple:
    """Renderer + (optional) dynamic disk system for a config, both on
    ``config.device``."""
    device = torch_device(config.device)
    skybox, disk_tex, dynamic = _scene_assets(config, device)
    return Renderer(config, skybox, disk_tex, device=device), dynamic


def render_image(config: SceneConfig) -> np.ndarray:
    """Render one frame -> (H, W, 3) float32 in [0, 1]; the disk texture
    is generated by the lifecycle system at t=0 unless an external disk
    texture is given. With ``tile_shards > 1`` the frame's pixel rows
    shard over the visible devices (``parallel.frames.render_image_tiled``):
    the same image, traced band by band."""
    config = config.validated()
    if config.tile_shards > 1:
        from .parallel.frames import render_image_tiled

        t0 = time.time()
        img = render_image_tiled(config)
        print(f"Rendered {config.image_size[0]}x{config.image_size[1]} "
              f"({config.tile_shards} tile shards) in {time.time() - t0:.2f}s")
        return img
    renderer, dynamic = _make_renderer(config)
    if dynamic is not None:
        tex = dynamic.advance(t=0.0, dt=0.0, recompute_stats=True)
        renderer.update_disk_texture(tex)

    t0 = time.time()
    img = renderer.render(config.pov, config.fov, frame=0)
    print(f"Rendered {config.image_size[0]}x{config.image_size[1]} "
          f"on {renderer.device} in {time.time() - t0:.2f}s")
    return img
