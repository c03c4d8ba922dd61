"""The port's batched video engine vs bhr_tpu, on the CPU.

* ``pack_frame_params`` against ``bhr_tpu``'s on the same seed: rtol 1e-6
  (the host control plane ports bit for bit up to float32 packing).
* ``refresh_stats`` against ``bhr_tpu``'s after the same ticks: the
  bounds of ``test_torch_disk.py`` (one histogram bin of each quantile).
* ``frame_texture`` (the batched engine's texture) equals
  ``DynamicDiskSystem.advance(recompute_stats=True)`` exactly: one
  function makes both.
* The batched renderer against ``bhr_tpu.parallel.video.
  render_video_frames_sharded`` at 32x16, 8 orbit frames, default and AA:
  the uint8 frames, as floats in [0, 1], within the cross-backend bounds
  of ``tests/e2e_render.py`` (max 5e-2, mean 5e-4); the share of values
  one uint8 step apart is printed.
* Frames 0 and 4 of the golden 8-frame orbit through
  ``render_video_frames_sharded([0, 4])`` against
  ``tests/goldens/e2e_cpu_video.npz``: the same bounds.
* The whole ``render_video_sharded`` loop at 32x16: every frame and
  ``progress.json`` written, the padding repeats of the last batch never
  written and not counted as frames, frames handed over in index order
  on a two-slot mesh.
* Sequential vs batched engine: frame 0 within one uint8 step.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu.config as jcfg
from bhr_tpu.models import disk_texture as jtex
from bhr_tpu.models import dynamic_disk as jdyn
from bhr_tpu.ops.sampling import pack_quad, production_tex_dtype, quantize_packed
from bhr_tpu.parallel import video as jvideo
from bhr_tpu.parallel.mesh import make_frame_mesh as j_make_frame_mesh

from bhr_tpu_torch.config import SceneConfig, compute_disk_texture_resolution
from bhr_tpu_torch.models import dynamic_disk as tdyn
from bhr_tpu_torch.models.skybox import load_or_generate_skybox
from bhr_tpu_torch.modes import render_video, video_temp_paths
from bhr_tpu_torch.parallel import video as tvideo
from bhr_tpu_torch.parallel.mesh import make_frame_mesh
from bhr_tpu_torch.utils.io import load_png_rgb8

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import GOLDEN_DIR, XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(width=32, height=16, fov=60.0, step_size=0.3, n_stars=100,
            disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
            video=True, orbit=True, orbit_degrees=45.0, n_frames=8)
GOLDEN_VIDEO = dict(width=320, height=180, pov=(6.0, 0.0, 0.5), fov=60.0,
                    step_size=0.1, r_max=10.0, n_stars=100,
                    disk_inner_radius=2.0, disk_outer_radius=3.5,
                    disk_tilt=15.0, anti_alias="disabled", seed=42, video=True,
                    orbit=True, orbit_degrees=45.0, n_frames=8, fps=24,
                    frame_shards=1, frames_per_dispatch=8)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _systems(cfg, seed=42):
    """(port system, bhr_tpu system) for a config's texture size."""
    w, h = cfg.image_size
    n_phi, n_r = compute_disk_texture_resolution(
        w, h, cfg.pov, cfg.fov, cfg.disk_inner_radius, cfg.disk_outer_radius)
    args = (n_r, n_phi, cfg.disk_inner_radius, cfg.disk_outer_radius)
    return (tdyn.DynamicDiskSystem(*args, seed=seed, device="cpu"),
            jdyn.DynamicDiskSystem(*args, seed=seed))


@pytest.mark.parametrize("seed", [42, 7])
def test_pack_frame_params_match(seed):
    cfg = SceneConfig(device="cpu", **TINY).validated()
    port, ref = _systems(cfg, seed)
    out = tvideo.pack_frame_params(port, 12, 0.1)
    expect = jvideo.pack_frame_params(ref, 12, 0.1)
    for a, b, rows in zip(out, expect, (288, 64, 32)):
        assert a.shape == b.shape == (12, rows, 8) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert port.entity_count == ref.entity_count > 0


def test_refresh_stats_matches():
    port = tdyn.DynamicDiskSystem(128, 256, 2.0, 3.5, seed=3, device="cpu")
    ref = jdyn.DynamicDiskSystem(128, 256, 2.0, 3.5, seed=3)
    p98_init = float(port.density_p98)
    for system in (port, ref):
        for f in range(3):
            for fac in system.factories.values():
                fac.tick(now=f * 0.1, dt=0.1)
        system.refresh_stats(0.2)
    assert float(port.density_p98) != p98_init
    comp, edge = jnp.asarray(ref.comp), jnp.asarray(ref.edge)
    # One histogram bin of each quantile (test_torch_disk.py's bounds).
    np.testing.assert_allclose(
        float(port.density_p98), float(ref.density_p98), rtol=0,
        atol=float(jnp.max(jtex.density_from_comp(comp, edge, True))) / 512)
    np.testing.assert_allclose(
        float(port.struct_scale), float(ref.struct_scale), rtol=0,
        atol=float(jnp.max(jtex.temp_struct_from_comp(comp))) / 512)
    np.testing.assert_allclose(port.row_stats.numpy(), np.asarray(ref.row_stats),
                               rtol=0, atol=1.2 / 64)


def test_frame_texture_is_advance_with_fresh_stats():
    a = tdyn.DynamicDiskSystem(32, 64, 2.0, 3.5, seed=5, device="cpu")
    b = tdyn.DynamicDiskSystem(32, 64, 2.0, 3.5, seed=5, device="cpu")
    fil, hs, rt = tvideo.pack_frame_params(a, 3, 0.1)
    for f in range(3):
        tex = b.advance(f * 0.1, 0.1, recompute_stats=True)
    out, comp, stats = tdyn.frame_texture(
        *(torch.as_tensor(p[2]) for p in (fil, hs, rt)), a.omega_rows, a.edge,
        float(np.float32(2 * 0.1)), n_r=32, n_phi=64, az_freq=a.az_freq,
        az_shear=a.az_shear, r_inner=2.0, r_outer=3.5,
        generation_scale=a.generation_scale, color_temp=a.color_temp)
    assert torch.equal(out, tex) and torch.equal(comp, b.comp)
    assert torch.equal(stats[2], b.row_stats)
    # With stale stats the texture differs: the per-frame stats matter.
    stale = b.advance(0.3, 0.1, recompute_stats=False)
    fresh = tdyn.DynamicDiskSystem(32, 64, 2.0, 3.5, seed=5, device="cpu")
    for f in range(4):
        tex = fresh.advance(f * 0.1, 0.1, recompute_stats=True)
    assert not torch.equal(stale, tex)


@pytest.mark.parametrize("size,scale", [((128, 256), 2), ((48, 80), 1),
                                        ((48, 80), 2)])
@pytest.mark.parametrize("threads", [1, 3])
def test_background_over_frames_is_bit_equal_to_per_frame(size, scale, threads):
    """The batched engine makes a batch's background noise in one pass
    over a leading frame axis: frame i of it must equal the per-frame
    call exactly, whatever the thread count splits."""
    from bhr_tpu_torch.ops.background import generate_background_components

    times = np.asarray([f * 0.1 for f in (0, 1, 5, 60, 61)], np.float32)
    args = (*size, 3.0, 2.7, 2.0, 3.5)
    torch.set_num_threads(threads)
    try:
        batch = generate_background_components(*args, times,
                                               generation_scale=scale)
        assert batch.shape == (5, 7, *size)
        for i, f in enumerate((0, 1, 5, 60, 61)):
            # The sequential engine passes the Python float f * dt.
            one = generate_background_components(*args, f * 0.1,
                                                 generation_scale=scale)
            assert torch.equal(batch[i], one), f
    finally:
        torch.set_num_threads(2)
    assert not torch.equal(batch[0], batch[1])
    with pytest.raises(ValueError, match="one time or a sequence"):
        generate_background_components(*args, times[None])


def _port_frames(cfg, indices, mesh, **kw):
    port, _ = _systems(cfg, cfg.seed)
    packs = tvideo.pack_frame_params(port, cfg.n_frames, cfg.disk_rotation_speed)
    sky, _, _ = load_or_generate_skybox(None, 256, 128, cfg.n_stars,
                                        seed=cfg.skybox_seed)
    return tvideo.render_video_frames_sharded(cfg, mesh, indices, sky, port,
                                              *packs, **kw)


@pytest.mark.parametrize("extra", [{}, {"anti_alias": "lod_radius"}],
                         ids=["default", "aa"])
def test_batched_renderer_matches_bhr_tpu(extra):
    kw = dict(TINY, **extra)
    ref_cfg = jcfg.SceneConfig(**kw).validated()
    cfg = SceneConfig(device="cpu", **kw).validated()
    _, ref_sys = _systems(cfg)
    packs = jvideo.pack_frame_params(ref_sys, 8, ref_cfg.disk_rotation_speed)
    sky, _, _ = load_or_generate_skybox(None, 256, 128, 100, seed=42)
    sky_q = quantize_packed(pack_quad(jnp.asarray(sky, jnp.float32)),
                            production_tex_dtype())
    ref, _ = jvideo.render_video_frames_sharded(
        ref_cfg, j_make_frame_mesh(1, 1, devices=jax.devices()[:1]),
        list(range(8)), sky_q, ref_sys, *packs)
    ref = np.stack([f for _, f in ref])

    # A two-slot mesh: frames go round it and come back in index order.
    out, fn = _port_frames(cfg, list(range(8)),
                           make_frame_mesh(2, 1, devices=[CPU] * 2))
    assert [pos for pos, _ in out] == list(range(8)) and callable(fn)
    out = np.stack([f for _, f in out])
    assert out.shape == ref.shape == (8, 16, 32, 3) and out.dtype == np.uint8
    step = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    diff = step / 255.0
    print(f"port vs bhr_tpu batched frames: max={diff.max():.3e} "
          f"mean={diff.mean():.3e}; one uint8 step apart "
          f"{(step == 1).mean():.4%}, more {(step > 1).mean():.4%}")
    assert diff.max() <= XB_MAX_ABS_TOL and diff.mean() <= XB_MEAN_ABS_TOL
    assert out.max() > 128  # a lit frame, not two black ones agreeing
    assert (out[0] != out[7]).any()  # the orbit moves


def test_mesh_slots_do_not_change_frames():
    cfg = SceneConfig(device="cpu", **TINY).validated()
    one, _ = _port_frames(cfg, [0, 3, 5, 7], make_frame_mesh(1, 1, devices=[CPU]))
    order = []
    four, _ = _port_frames(cfg, [0, 3, 5, 7],
                           make_frame_mesh(4, 1, devices=[CPU] * 4),
                           on_frame=lambda pos, frame: order.append(pos))
    assert order == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(one, four):
        np.testing.assert_array_equal(a, b)


def test_renderer_reports_stages_and_refuses_bad_shapes():
    cfg = SceneConfig(device="cpu", **TINY).validated()
    seen = []
    out, fn = _port_frames(cfg, [0, 1], make_frame_mesh(2, 1, devices=[CPU] * 2),
                           defer_fetch=True,
                           on_stage=lambda stage, pos, dev: seen.append((stage, pos)))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert out.shape == (2, 16, 32, 3)
    # Each slot's background pass first; then every slot's texture and
    # trace are enqueued before any is shaded.
    assert seen == [("start", None), ("background", None)] * 2 + [
                    ("start", 0), ("texture", 0), ("trace", 0),
                    ("start", 1), ("texture", 1), ("trace", 1),
                    ("shade", 0), ("post", 0), ("shade", 1), ("post", 1)]
    with pytest.raises(ValueError, match="do not divide"):
        _port_frames(cfg, [0, 1, 2], make_frame_mesh(2, 1, devices=[CPU] * 2),
                     renderer_fn=fn)
    with pytest.raises(ValueError, match="tile axis must be 1"):
        tvideo.build_sharded_video_renderer(
            make_frame_mesh(1, 2, devices=[CPU] * 2), cfg, 128, 256,
            r_escape=12.0, az_freq=3.0, az_shear=2.5)


def test_golden_video_frames_within_cross_backend_bounds():
    cfg = SceneConfig(device="cpu", **GOLDEN_VIDEO).validated()
    port, _ = _systems(cfg)
    packs = tvideo.pack_frame_params(port, 8, cfg.disk_rotation_speed)
    sky, _, _ = load_or_generate_skybox(None, 2048, 1024, 100, seed=42)
    out, _ = tvideo.render_video_frames_sharded(
        cfg, make_frame_mesh(1, 1, devices=[CPU]), [0, 4], sky, port, *packs)
    img = np.concatenate([f.astype(np.float32) / 255.0 for _, f in out], axis=0)
    golden = np.load(os.path.join(GOLDEN_DIR, "e2e_cpu_video.npz"))["image"]
    assert img.shape == golden.shape == (360, 320, 3)
    diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
    print(f"port vs e2e_cpu_video.npz: max={diff.max():.3e} mean={diff.mean():.3e}")
    assert diff.max() <= XB_MAX_ABS_TOL, diff.max()
    assert diff.mean() <= XB_MEAN_ABS_TOL, diff.mean()


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The whole batched loop on a two-slot CPU mesh: 7 frames in
    batches of 4, so the last batch carries one padding repeat."""
    out = tmp_path_factory.mktemp("video") / "orbit.mp4"
    cfg = SceneConfig(device="cpu", **dict(TINY, n_frames=7, fps=4,
                                           frames_per_dispatch=2),
                      output=str(out)).validated()
    return cfg, tvideo.render_video_sharded(cfg, devices=[CPU] * 2)


def test_sharded_run_writes_frames_progress_and_no_padding(sharded_run):
    cfg, stats = sharded_run
    temp_dir, progress_file = video_temp_paths(cfg.output)
    frames = sorted(os.path.basename(p)
                    for p in glob.glob(os.path.join(temp_dir, "frame_*.png")))
    assert frames == [f"frame_{f:04d}.png" for f in range(7)]  # no frame_0007
    with open(progress_file) as f:
        progress = json.load(f)
    assert progress["completed"] == list(range(7))
    assert progress["params"]["sharded"] is True
    assert (stats["frames"], stats["padded"]) == (7, 1)
    assert load_png_rgb8(os.path.join(temp_dir, frames[6])).shape == (16, 32, 3)
    # What finished the video is named, and the file is where it says.
    assert stats["assembler"] in ("native", "ffmpeg", "mjpeg", "none")
    if stats["assembler"] in ("native", "ffmpeg"):
        assert os.path.getsize(cfg.output) > 0


def test_sharded_run_stats_ignore_padding(sharded_run):
    cfg, stats = sharded_run
    # The rate end to end is the caller's to take: frames over wall_s.
    assert "fps" not in stats
    assert stats["frames"] / stats["wall_s"] == pytest.approx(7 / stats["wall_s"])
    assert set(stats["stage_ms"]) == {"background", "texture", "trace", "shade", "post",
                                      "fetch", "png", "h264", "job_setup", "enqueue", "record", "finish", "hit_sync"}
    for name in ("background", "texture", "trace", "shade", "post", "png",
                 "job_setup", "enqueue", "record", "finish", "hit_sync"):
        assert stats["stage_ms"][name] > 0
    assert stats["stage_ms"]["fetch"] is None  # nothing to fetch from a CPU
    assert stats["writer_wait_s"] >= 0


def test_single_batch_has_no_padding(tmp_path):
    cfg = SceneConfig(device="cpu", **dict(TINY, n_frames=2),
                      output=str(tmp_path / "v.mp4")).validated()
    stats = tvideo.render_video_sharded(cfg, devices=[CPU])
    assert (stats["frames"], stats["padded"]) == (2, 0)


def test_engines_agree_on_frame_zero(sharded_run, tmp_path):
    cfg, _ = sharded_run
    import dataclasses

    seq = dataclasses.replace(cfg, frame_shards=1,
                              output=str(tmp_path / "seq.mp4"))
    stats = render_video(seq)
    assert stats["frames"] == 7
    a = load_png_rgb8(os.path.join(video_temp_paths(cfg.output)[0],
                                   "frame_0000.png")).astype(np.int32)
    b = load_png_rgb8(os.path.join(video_temp_paths(seq.output)[0],
                                   "frame_0000.png")).astype(np.int32)
    print(f"sequential vs batched frame 0: {(a != b).mean():.4%} of values differ")
    # Frame 0 recomputes its stats in both engines (0 % 60 == 0).
    assert np.abs(a - b).max() <= 1
