"""The port's V2 orbit video, on the CPU.

The four conditions of ``tests/unit/test_sharded_video_v2.py`` for the
port, with the structure layer on and a rotation speed that moves it
visibly (a V2 video whose pattern stands still would otherwise pass):

* V2 is eligible for the batched engine (and ``frame_shards=1`` opts
  out), as in ``bhr_tpu``;
* the batched engine (two or three slots on the one CPU) and the
  sequential per-frame loop write the same frames within one uint8 step
  (measured: 0 values differ);
* a resume after frames are removed renders only the missing frames and
  leaves all PNGs byte-equal to an uninterrupted run's, with either
  engine and across engines;
* a changed V2 knob wipes the frame directory and starts over.

Besides: ``video_resume_params`` for a V2 config equals ``bhr_tpu``'s as
a dict and as JSON, and the port reads a ``progress.json`` that
``bhr_tpu``'s parameters wrote; a V2 video frame against ``bhr_tpu``'s
``Renderer.render`` of the same camera and frame index within the
cross-backend bounds of ``tests/e2e_render.py`` (max 5e-2, mean 5e-4)
rather than against its compiled sharded program (a minute of JAX
compile); the engine reports no texture or background stage for V2 and
builds no lifecycle system; the frames renderer on a (2, 2) grid equals
one device.
"""

import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import bhr_tpu.config as jcfg
import bhr_tpu.modes as jmodes
from bhr_tpu import pipeline as jpipe

import bhr_tpu_torch.parallel.video as tvideo
from bhr_tpu_torch.camera import orbit_camera_position
from bhr_tpu_torch.config import SceneConfig, scene_escape_radius
from bhr_tpu_torch.models.skybox import load_or_generate_skybox
from bhr_tpu_torch.modes import (
    load_video_progress,
    render_video,
    sharded_video_eligible,
    video_resume_params,
    video_temp_paths,
)
from bhr_tpu_torch.ops.geodesic_cuda import camera_params
from bhr_tpu_torch.parallel.frames import (
    build_sharded_frame_renderer,
    cameras_for_orbit,
    pack_cameras,
)
from bhr_tpu_torch.parallel.mesh import make_frame_mesh
from bhr_tpu_torch.parallel.video import frame_stages, render_video_sharded
from bhr_tpu_torch.utils.io import load_png_rgb8

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402

CPU = torch.device("cpu")
SCENE = dict(width=32, height=16, fov=60.0, step_size=0.3, n_stars=64,
             disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
             disk_model="v2", v2_structure=True, v2_shear_strength=0.6,
             disk_rotation_speed=0.8, orbit_degrees=90.0, video=True,
             orbit=True, n_frames=6, fps=4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(tmp_path, name, **overrides):
    return SceneConfig(device="cpu", output=str(tmp_path / name),
                       **{**SCENE, **overrides}).validated()


def _frame_paths(cfg):
    return sorted(glob.glob(os.path.join(video_temp_paths(cfg.output)[0],
                                         "frame_*.png")))


def _frame_bytes(cfg):
    out = []
    for path in _frame_paths(cfg):
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def _batched(cfg, slots=3):
    return render_video_sharded(cfg, devices=[CPU] * slots)


@pytest.fixture(scope="module")
def sequential_run(tmp_path_factory):
    """An uninterrupted sequential-engine run: (config, stats, PNG bytes)."""
    cfg = _cfg(tmp_path_factory.mktemp("seq"), "seq.mp4", frame_shards=1)
    stats = render_video(cfg)
    return cfg, stats, _frame_bytes(cfg)


def test_v2_video_is_sharded_eligible():
    assert sharded_video_eligible(
        SceneConfig(disk_model="v2", video=True, frame_shards=4, device="cpu"))
    # frame_shards=1 stays the explicit opt-out, and one CPU is sequential.
    for shards in (0, 1):
        assert not sharded_video_eligible(SceneConfig(
            disk_model="v2", video=True, frame_shards=shards, device="cpu"))
    for shards in (1, 4):
        kw = dict(disk_model="v2", video=True, frame_shards=shards)
        assert sharded_video_eligible(SceneConfig(device="cpu", **kw)) == (
            jmodes.sharded_video_eligible(jcfg.SceneConfig(**kw)))


def test_v2_sharded_video_matches_sequential(sequential_run, tmp_path):
    seq_cfg, seq_stats, seq_frames = sequential_run
    assert seq_stats["frames"] == 6
    sh_cfg = _cfg(tmp_path, "sh.mp4", frame_shards=3, frames_per_dispatch=1)
    stats = _batched(sh_cfg)
    assert stats["frames"] == 6 and stats["padded"] == 0
    differing = 0
    for a, b in zip(_frame_paths(seq_cfg), _frame_paths(sh_cfg), strict=True):
        x = load_png_rgb8(a).astype(np.int16)
        y = load_png_rgb8(b).astype(np.int16)
        assert np.abs(x - y).max() <= 1, os.path.basename(a)
        differing += int((x != y).sum())
    print(f"batched vs sequential: {differing} uint8 values differ")
    assert len(seq_frames) == 6 and os.path.getsize(sh_cfg.output) > 0
    # The structure moves from frame to frame beyond what the camera
    # does: the same camera at another frame index is another image.
    still = _cfg(tmp_path, "still.mp4", frame_shards=1, orbit=False)
    render_video(still)
    a, *_, b = (load_png_rgb8(p).astype(np.int16) for p in _frame_paths(still))
    assert np.abs(a - b).max() > 8


def test_v2_video_has_no_texture_stage_and_no_lifecycle(tmp_path, monkeypatch):
    def no_lifecycle(*args, **kwargs):
        raise AssertionError("a V2 video builds no lifecycle system")

    monkeypatch.setattr(tvideo, "DynamicDiskSystem", no_lifecycle)
    monkeypatch.setattr(tvideo, "generate_background_components", no_lifecycle)
    cfg = _cfg(tmp_path, "stages.mp4", n_frames=2)
    stats = _batched(cfg, slots=2)
    assert set(stats["stage_ms"]) == {"trace", "shade", "post", "fetch", "png",
                                      "h264", "job_setup", "enqueue", "record", "finish", "hit_sync"}
    assert all(stats["stage_ms"][k] > 0 for k in ("trace", "shade", "post"))
    assert frame_stages(cfg) == ("trace", "shade", "post")
    assert frame_stages(dataclasses.replace(cfg, disk_model="texture")) == (
        "texture", "trace", "shade", "post")


@pytest.mark.parametrize("engines", [("batched", "batched"),
                                     ("sequential", "sequential"),
                                     ("batched", "sequential"),
                                     ("sequential", "batched")],
                         ids="-then-".join)
def test_v2_video_resume_renders_only_missing_frames(engines, sequential_run,
                                                     tmp_path):
    _, _, reference = sequential_run

    def run(engine, cfg):
        if engine == "batched":
            return _batched(dataclasses.replace(cfg, frame_shards=3))
        return render_video(dataclasses.replace(cfg, frame_shards=1))

    cfg = _cfg(tmp_path, "resume.mp4", frames_per_dispatch=1)
    assert run(engines[0], cfg)["frames"] == 6
    frames = _frame_paths(cfg)
    _, progress_file = video_temp_paths(cfg.output)
    # Forge an interruption after the first three frames.
    with open(progress_file) as f:
        progress = json.load(f)
    assert progress["completed"] == list(range(6))
    progress["completed"] = [0, 1, 2]
    with open(progress_file, "w") as f:
        json.dump(progress, f)
    for path in frames[3:]:
        os.remove(path)
    os.remove(cfg.output)
    kept = [os.stat(p).st_mtime_ns for p in frames[:3]]

    stats = run(engines[1], dataclasses.replace(cfg, resume=True))
    assert stats["frames"] == 3  # only the missing ones
    assert [os.stat(p).st_mtime_ns for p in frames[:3]] == kept
    assert _frame_bytes(cfg) == reference  # byte-equal to an unbroken run
    assert os.path.getsize(cfg.output) > 0


@pytest.mark.parametrize("change", [
    {"v2_samples": 4}, {"v2_palette": "scientific"}, {"v2_structure": False},
    {"v2_hotspot_count": 3}, {"v2_h0": 0.08}], ids=lambda c: next(iter(c)))
def test_v2_param_change_invalidates_resume(change, tmp_path):
    cfg = _cfg(tmp_path, "inv.mp4", n_frames=3, frames_per_dispatch=1)
    _batched(cfg)
    first = _frame_paths(cfg)[0]
    before = os.stat(first).st_mtime_ns
    # The same parameters resume with nothing left to render ...
    assert _batched(dataclasses.replace(cfg, resume=True))["frames"] == 0
    assert os.stat(first).st_mtime_ns == before
    # ... a changed V2 knob wipes the frames and renders all of them.
    changed = dataclasses.replace(cfg, resume=True, **change)
    assert _batched(changed)["frames"] == 3
    assert os.stat(first).st_mtime_ns != before


@pytest.mark.parametrize("extra", [
    {}, {"v2_structure": False}, {"v2_palette": "scientific", "v2_samples": 3,
                                  "v2_omega_scale": 2.0, "seed": 9}],
    ids=["structure", "plain", "knobs"])
@pytest.mark.parametrize("sharded", [False, True])
def test_v2_video_resume_params_match(extra, sharded, tmp_path):
    kw = {**SCENE, **extra}
    ours = video_resume_params(SceneConfig(device="cpu", **kw), sharded=sharded)
    theirs = jmodes.video_resume_params(jcfg.SceneConfig(**kw), sharded=sharded)
    assert ours == theirs and list(ours) == list(theirs)
    assert list(ours["v2"]) == list(theirs["v2"]) and len(ours["v2"]) == 18
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    assert "generation_scale" not in ours
    # The port resumes a progress file written with bhr_tpu's parameters.
    cfg = _cfg(tmp_path, "theirs.mp4", resume=True, **extra)
    temp_dir, progress_file = video_temp_paths(cfg.output)
    os.makedirs(temp_dir)
    with open(progress_file, "w") as f:
        json.dump({"params": theirs, "completed": [0, 1]}, f)
    completed, _ = load_video_progress(
        cfg, temp_dir, progress_file, video_resume_params(cfg, sharded=True))
    assert completed == {0, 1}


@pytest.mark.parametrize("frame", [0, 4])
def test_v2_video_frame_matches_bhr_tpu_renderer(frame, sequential_run):
    cfg, _, _ = sequential_run
    ours = load_png_rgb8(_frame_paths(cfg)[frame]).astype(np.float64) / 255.0
    kw = {k: v for k, v in dataclasses.asdict(cfg).items()
          if k not in ("device", "output")}
    jconfig = jcfg.SceneConfig(**kw).validated()
    sky, _, _ = load_or_generate_skybox(None, 2048, 1024, cfg.n_stars,
                                        seed=cfg.skybox_seed)
    renderer = jpipe.Renderer(jconfig, sky, None, use_pallas=False,
                              r_escape_override=scene_escape_radius(cfg))
    cam_pos = orbit_camera_position(frame, cfg.n_frames, cfg.orbit_degrees,
                                    cfg.pov)
    theirs = renderer.render(cam_pos, cfg.fov, frame=frame).astype(np.float64)
    diff = np.abs(ours - np.round(theirs * 255.0) / 255.0)
    print(f"V2 video frame {frame} vs bhr_tpu Renderer: max={diff.max():.3e} "
          f"mean={diff.mean():.3e}")
    assert diff.max() <= XB_MAX_ABS_TOL and diff.mean() <= XB_MEAN_ABS_TOL
    assert ours.max() > 0.3


def test_v2_frames_renderer_grid_equals_one_device():
    cfg = SceneConfig(device="cpu", **SCENE).validated()
    w, h = cfg.image_size
    sky = np.random.default_rng(0).random((32, 64, 3)).astype(np.float32)
    cams = pack_cameras(cameras_for_orbit(cfg, range(4), w, h))
    assert cams.shape == (4, 14)
    np.testing.assert_array_equal(
        cams[0], camera_params(cameras_for_orbit(cfg, [0], w, h)[0]))
    t = np.arange(4, dtype=np.float32) * np.float32(cfg.disk_rotation_speed)
    kw = dict(r_escape=scene_escape_radius(cfg))
    grid = build_sharded_frame_renderer(
        make_frame_mesh(2, 2, devices=[CPU] * 4), cfg, w, h, 2, **kw)
    one = build_sharded_frame_renderer(
        make_frame_mesh(1, 1, devices=[CPU]), cfg, w, h, 4, **kw)
    a = grid(sky, None, cams, t).numpy()
    b = one(sky, None, cams, t).numpy()
    assert a.shape == (4, h, w, 3) and a.max() > 0.3
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    assert np.abs(a[0] - a[3]).max() > 1e-2
