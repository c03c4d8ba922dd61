"""The port's row band, frame grid and tiled still vs bhr_tpu, on the CPU.

* The plain band trace (``trace_geodesics_cuda`` on a CPU camera with
  ``row_start``/``row_count``) against ``bhr_tpu``'s Pallas band in
  interpret mode: categories and step counts equal, escape direction and
  hit features 0..4 within 2e-3, the AA differentials (5..10) within
  5e-3 (``test_torch_trace.py``'s bounds). A band equals the same rows
  of the full-frame trace exactly, in every variant.
* ``pack_cameras(cameras_for_orbit(...))`` equals ``bhr_tpu``'s.
* The frames renderer on a (4, 2) grid of CPU devices against
  ``bhr_tpu``'s on ``make_frame_mesh(4, 2)`` (8 virtual CPU devices,
  ``tests/conftest.py``), and the port's tiled still against
  ``bhr_tpu``'s: within the cross-backend bounds of
  ``tests/e2e_render.py`` (max 5e-2, mean 5e-4), since on the CPU
  ``bhr_tpu``'s tiled path traces ``primary_rays_from_arrays``' rays and
  the port the Pallas kernel's image-plane rays.
* Within the port, a grid equals one device and a tiled still equals the
  whole frame within ``test_sharded_frames.py``'s 2e-5: a band whose
  largest hit count is below the frame's skips slots the frame runs with
  alpha 0, which rounds the background by an ulp.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu.config as jcfg
from bhr_tpu.modes import render_image as j_render_image
from bhr_tpu.ops.geodesic_pallas import trace_geodesics_pallas
from bhr_tpu.ops.sampling import build_mipmaps as j_build_mipmaps
from bhr_tpu.ops.sampling import pack_quad, pack_quad_mips
from bhr_tpu.parallel import frames as jframes
from bhr_tpu.parallel.mesh import make_frame_mesh as j_make_frame_mesh
from bhr_tpu.utils.io import compute_edge_alpha

from bhr_tpu_torch.camera import build_camera
from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.modes import render_image
from bhr_tpu_torch.ops.geodesic_cuda import camera_params, trace_geodesics_cuda
from bhr_tpu_torch.ops.sampling import build_mipmaps
from bhr_tpu_torch.parallel.frames import (
    build_sharded_frame_renderer,
    cameras_for_orbit,
    pack_cameras,
    render_image_tiled,
)
from bhr_tpu_torch.parallel.mesh import make_frame_mesh

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402

CPU = torch.device("cpu")
W, H = 48, 24  # test_sharded_frames.py's row-band scene
TRACE_KW = dict(h_base=0.3, r_escape=12.04, tilt_deg=15.0, r_inner=2.0,
                r_outer=3.5)
VARIANTS = {"slim": {}, "aa": {"with_differentials": True},
            "nodisk": {"record_hits": False}}
STILL = dict(width=64, height=32, fov=60.0, step_size=0.3, n_stars=100,
             disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cam():
    return build_camera([6.0, 0.0, 0.5], 60.0, W, H)


def _port_band(row_start, row_count, **kw):
    return trace_geodesics_cuda(torch.as_tensor(camera_params(_cam())),
                                row_start, width=W, height=H,
                                row_count=row_count, **TRACE_KW, **kw)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_band_matches_pallas_band(variant):
    kw = dict(VARIANTS[variant], record_step_counts=True)
    band = _port_band(8, 8, **kw)
    ref = trace_geodesics_pallas(jnp.asarray(camera_params(_cam())), 8,
                                 row_count=8, width=W, height=H,
                                 interpret=True, block_rows=8, block_cols=16,
                                 **TRACE_KW, **kw)
    for name in ("captured", "escaped", "hit_count", "steps"):
        np.testing.assert_array_equal(getattr(band, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(band.escape_dir.numpy(),
                               np.asarray(ref.escape_dir), rtol=0, atol=2e-3)
    count = band.hit_count.numpy()
    hits_t, hits_j = band.hits.numpy(), np.asarray(ref.hits)
    assert hits_t.shape == hits_j.shape == (4, 12, 8 * W)
    assert (count.sum() > 0) == (variant != "nodisk")
    for k in range(4):
        sel = count > k
        np.testing.assert_allclose(hits_t[k, :5][:, sel], hits_j[k, :5][:, sel],
                                   rtol=0, atol=2e-3)
        if variant == "aa":
            np.testing.assert_allclose(hits_t[k, 5:11][:, sel],
                                       hits_j[k, 5:11][:, sel], rtol=0, atol=5e-3)
        np.testing.assert_array_equal(hits_t[k, :, ~sel], 0.0)


@pytest.fixture(scope="module")
def full_frames():
    """Plain full-frame traces, by (variant, step counts)."""
    return {(v, s): _port_band(0, None, **VARIANTS[v], record_step_counts=s)
            for v in VARIANTS for s in (False, True)}


@pytest.mark.parametrize("row_start", [8, 16])  # 16: the last band
@pytest.mark.parametrize("steps", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_band_equals_full_frame_rows(full_frames, variant, steps,
                                           row_start):
    band = _port_band(row_start, 8, **VARIANTS[variant],
                      record_step_counts=steps)
    full = full_frames[(variant, steps)]
    sel = slice(row_start * W, (row_start + 8) * W)
    for name in ("captured", "escaped", "escape_dir", "hit_count"):
        assert torch.equal(getattr(band, name), getattr(full, name)[sel]), name
    assert torch.equal(band.hits, full.hits[:, :, sel])
    assert (band.steps is None) == (not steps)
    if steps:
        assert torch.equal(band.steps, full.steps[sel])


@pytest.mark.parametrize("orbit", [True, False])
def test_cameras_match_bhr_tpu(orbit):
    kw = dict(width=32, height=16, fov=60.0, orbit=orbit, n_frames=8,
              orbit_degrees=270.0)
    port = pack_cameras(cameras_for_orbit(SceneConfig(**kw).validated(),
                                          range(8), 32, 16))
    ref = jframes.pack_cameras(jframes.cameras_for_orbit(
        jcfg.SceneConfig(**kw).validated(), range(8), 32, 16))
    assert port.dtype == ref.dtype == np.float32 and port.shape == (8, 14)
    np.testing.assert_array_equal(port, ref)
    assert (len(np.unique(port[:, 0])) > 1) == orbit


TINY = dict(width=32, height=16, fov=60.0, step_size=0.2,
            disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
            orbit=True, n_frames=8)


@pytest.fixture(scope="module")
def tiny_scene():
    """``test_sharded_frames.py``'s scene: NumPy sky and disk textures,
    8 orbit cameras, t_offsets 0.1 f."""
    sky = np.random.default_rng(0).random((32, 64, 3)).astype(np.float32)
    tex = np.random.default_rng(1).random((16, 64, 4)).astype(np.float32)
    tex[..., 3] *= compute_edge_alpha(16)[:, None]
    cfg = SceneConfig(device="cpu", **TINY).validated()
    cam_pack = pack_cameras(cameras_for_orbit(cfg, range(8), 32, 16))
    t_offsets = np.arange(8, dtype=np.float32) * 0.1
    r_escape = max(cfg.r_max, 2.0 * float(np.linalg.norm(cfg.pov)))
    return cfg, sky, tex, cam_pack, t_offsets, r_escape


def _port_frames(scene, mesh, fpd, **kw):
    cfg, sky, tex, cam_pack, t_offsets, r_escape = scene
    has_disk = kw.get("has_disk", True)
    render = build_sharded_frame_renderer(mesh, cfg, 32, 16, fpd,
                                          r_escape=r_escape, **kw)
    mips = build_mipmaps(torch.as_tensor(tex), levels=2) if has_disk else None
    return render(sky, mips, cam_pack, t_offsets).numpy()


@pytest.mark.parametrize("variant", [
    {}, {"has_disk": False}, {"use_diff": True},
], ids=["default", "nodisk", "aa"])
def test_frames_renderer_matches_bhr_tpu(tiny_scene, variant):
    _, sky, tex, cam_pack, t_offsets, r_escape = tiny_scene
    out = _port_frames(tiny_scene, make_frame_mesh(4, 2, devices=[CPU] * 8), 2,
                       **variant)
    has_disk = variant.get("has_disk", True)
    ref_render = jframes.build_sharded_frame_renderer(
        j_make_frame_mesh(4, 2), jcfg.SceneConfig(**TINY).validated(), 32, 16,
        2, r_escape=r_escape, **variant)
    mips = (pack_quad_mips(j_build_mipmaps(jnp.asarray(tex), levels=2))
            if has_disk else None)
    ref = np.asarray(ref_render(pack_quad(jnp.asarray(sky)), mips,
                                jnp.asarray(cam_pack), jnp.asarray(t_offsets)))
    assert out.shape == ref.shape == (8, 16, 32, 3) and np.isfinite(out).all()
    diff = np.abs(out.astype(np.float64) - ref)
    print(f"frames renderer {variant} vs bhr_tpu: max={diff.max():.3e} "
          f"mean={diff.mean():.3e}")
    assert diff.max() <= XB_MAX_ABS_TOL and diff.mean() <= XB_MEAN_ABS_TOL
    assert not np.allclose(out[0], out[4])  # the camera moved


@pytest.mark.parametrize("return_layers", [False, True])
def test_frames_grid_matches_one_device(tiny_scene, return_layers):
    grid = _port_frames(tiny_scene, make_frame_mesh(4, 2, devices=[CPU] * 8),
                        2, return_layers=return_layers)
    one = _port_frames(tiny_scene, make_frame_mesh(1, 1, devices=[CPU]), 8,
                       return_layers=return_layers)
    assert grid.shape == one.shape == ((8, 2, 16, 32, 3) if return_layers
                                       else (8, 16, 32, 3))
    np.testing.assert_allclose(grid, one, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def tiled_default():
    cfg = SceneConfig(device="cpu", tile_shards=4, **STILL).validated()
    return render_image_tiled(cfg, devices=[CPU] * 4)


@pytest.mark.parametrize("extra", [
    {}, {"anti_alias": "lod_radius", "lens_flare": True},
], ids=["default", "aa_flare"])
def test_tiled_still_matches_sequential(tiled_default, extra):
    cfg = SceneConfig(device="cpu", **STILL, **extra).validated()
    tiled = (tiled_default if not extra else render_image_tiled(
        SceneConfig(**{**cfg.__dict__, "tile_shards": 4}), devices=[CPU] * 4))
    seq = render_image(cfg)
    assert tiled.shape == seq.shape == (32, 64, 3) and tiled.dtype == np.float32
    diff = np.abs(tiled - seq)
    print(f"tiled vs whole {extra}: max={diff.max():.3e}")
    np.testing.assert_allclose(tiled, seq, rtol=0, atol=2e-5)


def test_tiled_still_matches_bhr_tpu(tiled_default):
    assert len(jax.devices()) >= 4
    ref = j_render_image(jcfg.SceneConfig(tile_shards=4, **STILL).validated())
    diff = np.abs(tiled_default.astype(np.float64) - ref)
    print(f"tiled vs bhr_tpu tiled: max={diff.max():.3e} mean={diff.mean():.3e}")
    assert diff.max() <= XB_MAX_ABS_TOL and diff.mean() <= XB_MEAN_ABS_TOL


def test_tiled_still_reports_its_stages(tiled_default):
    stages = []
    cfg = SceneConfig(device="cpu", tile_shards=4, **STILL)
    img = render_image_tiled(cfg, devices=[CPU] * 4, on_stage=stages.append)
    assert stages == ["setup", "disk_texture", "replicas", "trace", "shade",
                      "gather", "post"]
    np.testing.assert_array_equal(img, tiled_default)


def test_frames_renderer_reports_each_step(tiny_scene):
    cfg, sky, tex, cam_pack, t_offsets, r_escape = tiny_scene
    render = build_sharded_frame_renderer(
        make_frame_mesh(4, 2, devices=[CPU] * 8), cfg, 32, 16, 2,
        r_escape=r_escape)
    stages = []
    render(sky, build_mipmaps(torch.as_tensor(tex), levels=2), cam_pack,
           t_offsets, on_stage=stages.append)
    assert stages == ["replicas"] + ["trace", "shade", "gather"] * 2


def test_render_image_dispatches_tiles():
    # One CPU device is visible, so two tiles on device="cpu" need two.
    with pytest.raises(ValueError, match="tile_shards=2 but only 1"):
        render_image(SceneConfig(device="cpu", tile_shards=2, **STILL))


def _mesh_grid_mismatch():
    make_frame_mesh(3, 2, devices=[CPU] * 4)


def _frames_renderer_call(**kw):
    def run():
        cfg = SceneConfig(device="cpu", **TINY).validated()
        render = build_sharded_frame_renderer(
            make_frame_mesh(2, 1, devices=[CPU] * 2), cfg, 32, 16, 1,
            r_escape=12.04)
        args = dict(skybox=np.zeros((8, 16, 3), np.float32),
                    disk_mips=torch.zeros((1, 8, 16, 4)),
                    cam_pack=np.zeros((2, 14), np.float32),
                    t_offsets=np.zeros(2, np.float32))
        render(**{**args, **kw})
    return run


@pytest.mark.parametrize("call", [
    lambda: SceneConfig(width=64, height=30, tile_shards=4,
                        device="cpu").validated(),
    lambda: SceneConfig(video=True, tile_shards=4, device="cpu").validated(),
    lambda: render_image_tiled(SceneConfig(tile_shards=4, device="cpu", **STILL),
                               devices=[CPU] * 2),
    lambda: _port_band(-1, 8),
    lambda: _port_band(20, 8),
    lambda: _port_band(0, 0),
    _frames_renderer_call(cam_pack=np.zeros((3, 14), np.float32)),
    _frames_renderer_call(disk_mips=None),
    _mesh_grid_mismatch,
    lambda: build_sharded_frame_renderer(
        make_frame_mesh(1, 3, devices=[CPU] * 3),
        SceneConfig(device="cpu", **TINY), 32, 16, 1, r_escape=12.04),
], ids=["height_not_divisible", "video_with_tiles", "more_tiles_than_devices",
        "negative_row_start", "band_past_last_row", "empty_band",
        "cam_pack_frame_count", "disk_without_mips", "mesh_vs_devices",
        "renderer_height_not_divisible"])
def test_tile_path_rejects_bad_input(call):
    with pytest.raises(ValueError):
        call()


def test_default_mesh_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default mesh is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_frame_mesh()


def test_v2_with_tiles_renders_the_whole_frame():
    """A V2 still in 4 row bands validates, launches a recorded-hits band
    trace per band and equals the whole frame within the tiled bar."""
    cfg = SceneConfig(disk_model="v2", tile_shards=4, device="cpu",
                      **STILL).validated()
    stages = []
    tiled = render_image_tiled(cfg, devices=[CPU] * 4, on_stage=stages.append)
    assert "disk_texture" not in stages and stages.count("trace") == 1
    whole = render_image(SceneConfig(disk_model="v2", device="cpu", **STILL))
    assert tiled.shape == whole.shape and tiled.max() > 0.2
    np.testing.assert_allclose(tiled, whole, rtol=0, atol=2e-5)
