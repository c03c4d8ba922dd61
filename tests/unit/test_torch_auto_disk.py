"""``--disk_texture auto`` in the port: the ``.npy`` texture cache
(``bhr_tpu_torch/utils/cache.py``) and the still rendered with it, on
the CPU, against ``bhr_tpu``.

* Both packages name a texture with the same cache key, and a file that
  ``bhr_tpu`` saved loads in the port unchanged and lies within 1e-4 of
  the port's own generation: the cache they share is safe.
* A 64x36 auto still through ``render_image`` is within the goldens'
  cross-backend bounds (``tests/e2e_render.py``: max 5e-2, mean 5e-4) of
  ``bhr_tpu``'s; the same still in 2 row bands within 2e-5 of the whole
  frame (``test_sharded_frames.py``'s bound).
* The new CLI flags parse to ``bhr_tpu``'s values.

Every cache directory is under ``tmp_path``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import bhr_tpu.cli as jcli
import bhr_tpu.utils.cache as jcache
from bhr_tpu.modes import render_image as j_render_image

import bhr_tpu_torch.utils.cache as tcache
from bhr_tpu_torch import cli as tcli
from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.modes import render_image
from bhr_tpu_torch.parallel.frames import render_image_tiled

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402

CPU = torch.device("cpu")
SCENE = dict(width=64, height=36, pov=(6.0, 0.0, 0.5), fov=60.0, n_stars=100,
             disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
             seed=42, disk_texture="auto")
# compute_disk_texture_resolution's floors at this size: 256 x 128.
KEY = "disk_2.00_3.50_42_256x128_scale2.npy"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cache_dirs(tmp_path, monkeypatch):
    """Both packages' DEFAULT_CACHE_DIR, each under tmp_path."""
    dirs = tmp_path / "torch", tmp_path / "jax"
    monkeypatch.setattr(tcache, "DEFAULT_CACHE_DIR", str(dirs[0]))
    monkeypatch.setattr(jcache, "DEFAULT_CACHE_DIR", str(dirs[1]))
    return dirs


@pytest.mark.parametrize("args", [(2.0, 3.5, 42, 256, 128, 2),
                                  (2.0, 15.0, 7, 2912, 416, 2),
                                  (1.234, 9.876, 0, 1024, 512, 4)])
def test_cache_key_matches(args):
    assert tcache.texture_cache_key(*args) == jcache.texture_cache_key(*args)


def test_generate_save_load_and_force(cache_dirs):
    kw = dict(width=64, height=36, cam_pos=[6.0, 0.0, 0.5], fov=60.0,
              r_inner=2.0, r_outer=3.5, device="cpu")
    tex = tcache.load_cached_disk_texture(**kw)
    path = cache_dirs[0] / KEY
    assert tex.shape == (128, 256, 4) and tex.dtype == np.float32
    np.testing.assert_array_equal(np.load(path), tex)
    # A later call loads the file: what is on disk is what it returns.
    np.save(path, np.zeros_like(tex))
    assert not tcache.load_cached_disk_texture(**kw).any()
    regenerated = tcache.load_cached_disk_texture(**kw, force=True)
    np.testing.assert_array_equal(regenerated, tex)
    np.testing.assert_array_equal(np.load(path), tex)
    other = tcache.load_cached_disk_texture(**kw, generation_scale=4)
    assert sorted(os.listdir(cache_dirs[0])) == [KEY, KEY.replace("scale2", "scale4")]
    assert not np.array_equal(other, tex)


def test_bhr_tpu_cache_file_loads_in_the_port(cache_dirs):
    kw = dict(width=64, height=36, cam_pos=[6.0, 0.0, 0.5], fov=60.0,
              r_inner=2.0, r_outer=3.5)
    saved = jcache.load_cached_disk_texture(**kw)
    port_own = tcache.load_cached_disk_texture(**kw, device="cpu")
    loaded = tcache.load_cached_disk_texture(**kw, cache_dir=str(cache_dirs[1]),
                                             device="cpu")
    np.testing.assert_array_equal(loaded, np.load(cache_dirs[1] / KEY))
    np.testing.assert_array_equal(loaded, saved)
    d = np.abs(port_own.astype(np.float64) - saved)
    assert d.max() <= 1e-4 and d.mean() <= 1e-6, (d.max(), d.mean())


@pytest.fixture
def auto_stills(cache_dirs):
    """(port's whole frame, bhr_tpu's) of the 64x36 auto scene."""
    import bhr_tpu.config as jcfg

    port = render_image(SceneConfig(device="cpu", **SCENE))
    ref = np.asarray(j_render_image(jcfg.SceneConfig(**SCENE)))
    return port, ref


def test_auto_still_matches_bhr_tpu(auto_stills):
    port, ref = auto_stills
    assert port.shape == ref.shape == (36, 64, 3) and np.isfinite(port).all()
    d = np.abs(port.astype(np.float64) - ref)
    assert d.max() <= XB_MAX_ABS_TOL and d.mean() <= XB_MEAN_ABS_TOL, (d.max(), d.mean())
    assert port.max() > 0.5  # the disk is lit


def test_auto_still_in_two_bands_equals_whole(auto_stills, cache_dirs):
    tiled = render_image_tiled(SceneConfig(device="cpu", tile_shards=2, **SCENE),
                               devices=[CPU] * 2)
    np.testing.assert_allclose(tiled, auto_stills[0], rtol=0, atol=2e-5)
    assert os.listdir(cache_dirs[0]) == [KEY]


@pytest.mark.parametrize("flags", [
    [],
    ["--disk_texture", "auto", "--disk_generation_scale", "4",
     "--force_regenerate_disk_texture"],
    ["--disk_rotation_algorithm", "keyframes", "--keyframes_count", "3",
     "--ignore_taichi_cache", "--disk_generation_scale", "1"],
])
def test_new_flags_parse_as_in_bhr_tpu(flags):
    t_args = tcli.build_parser().parse_args(flags)
    j_args = jcli.build_parser().parse_args(flags)
    for name in ("disk_generation_scale", "force_regenerate_disk_texture",
                 "disk_rotation_algorithm", "keyframes_count", "ignore_taichi_cache",
                 "disk_texture"):
        assert getattr(t_args, name) == getattr(j_args, name), name
    t_cfg = tcli.config_from_args(t_args)
    j_cfg = jcli.config_from_args(j_args)
    for name in ("disk_generation_scale", "force_regenerate_disk_texture",
                 "disk_texture"):
        assert getattr(t_cfg, name) == getattr(j_cfg, name), name


def test_config_accepts_auto_and_checks_the_scale():
    cfg = SceneConfig(disk_texture="auto").validated()
    assert cfg.disk_texture == "auto" and cfg.disk_generation_scale == 2
    with pytest.raises(ValueError, match="disk_generation_scale"):
        SceneConfig(disk_generation_scale=3).validated()
    with pytest.raises(ValueError, match="static single-frame"):
        SceneConfig(disk_texture="auto", video=True).validated()
