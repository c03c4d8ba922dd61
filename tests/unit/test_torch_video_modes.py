"""The port's video mode: resume protocol, engine dispatch and CLI, on
the CPU.

* ``video_temp_paths`` and ``video_resume_params`` equal ``bhr_tpu``'s
  for the same config, texture model or V2 (the dicts compare equal, so
  either package can read the other's ``progress.json``).
* The port's counterparts of the video tests of
  ``tests/unit/test_modes.py``, each for the sequential engine
  (``frame_shards=1``, what ``device="cpu"`` runs by default) and for the
  batched one (``frame_shards=2``: two slots on the one CPU): frames and
  progress written, a resume skips completed frames, a failed PNG write
  is never marked completed, a parameter change and a corrupt
  ``progress.json`` restart; a scene parameter change invalidates, the
  engine marker does not; the sequential engine pins its escape radius;
  ``generation_scale`` is keyed.
* The CLI's video flags have ``bhr_tpu``'s defaults, ``--video`` reaches
  ``modes.render_video``, ``--video --disk_model v2`` renders, the
  multi-host flags join a group (of one here; two processes are in
  ``test_torch_fleet.py``), ``--interactive`` wins over ``--video``, and
  ``--device cuda`` without a GPU raises.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import bhr_tpu.cli as jcli
import bhr_tpu.config as jcfg
import bhr_tpu.modes as jmodes

import bhr_tpu_torch.modes as modes
from bhr_tpu_torch import cli
from bhr_tpu_torch.config import SceneConfig, scene_escape_radius
from bhr_tpu_torch.modes import (
    load_video_progress,
    render_video,
    sharded_video_eligible,
    video_resume_params,
    video_temp_paths,
)
from bhr_tpu_torch.utils import io as tio
from bhr_tpu_torch.utils.io import load_png_rgb8

TINY = dict(width=64, height=36, fov=60.0, step_size=0.3, n_stars=100,
            disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
            n_frames=3, fps=2, orbit=True)
ENGINES = {"sequential": 1, "batched": 2}  # frame_shards


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def tiny_cfg(tmp_path):
    return SceneConfig(device="cpu", output=str(tmp_path / "video.mp4"),
                       **TINY).validated()


@pytest.fixture(params=sorted(ENGINES))
def video_cfg(request, tiny_cfg):
    """A tiny video config for each engine; the batched one renders one
    frame per slot and batch, so 3 frames take two batches."""
    return dataclasses.replace(tiny_cfg, video=True,
                               frame_shards=ENGINES[request.param],
                               frames_per_dispatch=1)


@pytest.fixture(autouse=True)
def _two_cpu_slots(monkeypatch):
    """``frame_shards=2`` on the CPU: the one CPU named twice stands in
    for two devices (torch cannot split it into virtual ones)."""
    import bhr_tpu_torch.parallel.video as tvideo

    real = tvideo.render_video_sharded
    monkeypatch.setattr(
        tvideo, "render_video_sharded",
        lambda config, devices=None: real(
            config, devices=devices or [torch.device("cpu")] * 2))


def _frames(tmp_path):
    return sorted(glob.glob(str(tmp_path / ".frames_*" / "frame_*.png")))


def _progress(tmp_path):
    (path,) = glob.glob(str(tmp_path / ".frames_*" / "progress.json"))
    with open(path) as f:
        return path, json.load(f)


# -- the protocol's files match bhr_tpu's ------------------------------------


@pytest.mark.parametrize("output", ["output/orbit.mp4", "clip.mkv",
                                    "/data/renders/a b.mp4"])
def test_video_temp_paths_match(output):
    assert video_temp_paths(output) == jmodes.video_temp_paths(output)


@pytest.mark.parametrize("extra", [
    {},
    {"anti_alias": "lod_radius", "aa_strength": 1.5, "lens_flare": True},
    {"orbit": False, "seed": 7, "pov": (8, 1, 2), "disk_rotation_speed": 0.05},
    {"resolution": "4k", "width": None, "height": None, "texture": "sky.png"},
    {"disk_model": "v2"},
    {"disk_model": "v2", "v2_palette": "scientific", "v2_structure": True,
     "v2_samples": 4, "v2_h0": 0.08, "v2_hotspot_count": 5, "seed": 3},
], ids=["default", "aa_flare", "static_camera", "4k", "v2", "v2_knobs"])
@pytest.mark.parametrize("sharded", [False, True])
def test_video_resume_params_match(extra, sharded):
    kw = dict(TINY, video=True, **extra)
    ours = video_resume_params(SceneConfig(device="cpu", **kw), sharded=sharded)
    theirs = jmodes.video_resume_params(jcfg.SceneConfig(**kw), sharded=sharded)
    assert ours == theirs
    # Equal as JSON too, types included: what progress.json holds.
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    # The V2 block and the texture's generation scale: one or the other.
    is_v2 = extra.get("disk_model") == "v2"
    assert ("v2" in ours) == is_v2 and ("generation_scale" in ours) != is_v2
    if is_v2:
        assert len(ours["v2"]) == 18


def test_resume_params_key_generation_scale(tiny_cfg):
    assert video_resume_params(tiny_cfg)["generation_scale"] == 2
    ext = dataclasses.replace(tiny_cfg, disk_texture="x.png")
    assert "generation_scale" not in video_resume_params(ext)
    big = dataclasses.replace(tiny_cfg, width=None, height=None, resolution="4k",
                              disk_outer_radius=15.0)
    assert video_resume_params(big)["generation_scale"] == 4


def test_port_resumes_bhr_tpu_progress_file(tiny_cfg):
    """A progress.json as bhr_tpu writes it is taken up, not wiped."""
    cfg = dataclasses.replace(tiny_cfg, video=True, resume=True)
    temp_dir, progress_file = video_temp_paths(cfg.output)
    os.makedirs(temp_dir)
    theirs = jmodes.video_resume_params(
        jcfg.SceneConfig(output=cfg.output, video=True, **TINY), sharded=True)
    with open(progress_file, "w") as f:
        json.dump({"params": theirs, "completed": [0, 1]}, f)
    done, cross = load_video_progress(cfg, temp_dir, progress_file,
                                      video_resume_params(cfg, sharded=False))
    assert done == {0, 1} and cross


# -- both engines ------------------------------------------------------------


def test_video_writes_frames_and_progress(video_cfg, tmp_path, capsys):
    stats = render_video(video_cfg)
    assert len(_frames(tmp_path)) == 3
    _, data = _progress(tmp_path)
    assert sorted(data["completed"]) == [0, 1, 2]
    assert data["params"]["n_frames"] == 3
    assert data["params"]["sharded"] is (video_cfg.frame_shards == 2)
    assert stats["frames"] == 3
    img = load_png_rgb8(_frames(tmp_path)[0])
    assert img.shape == (36, 64, 3) and img.max() > 128
    # What finished the video is reported on a line of its own.
    out = capsys.readouterr().out
    assert ("Video saved" in out) == (stats["assembler"] != "none")
    assert ("frames kept in" in out) == (stats["assembler"] == "none")


def test_video_resume_skips_completed(video_cfg, tmp_path):
    render_video(video_cfg)
    path, data = _progress(tmp_path)
    data["completed"] = [0]
    with open(path, "w") as f:
        json.dump(data, f)
    frame0, frame1, frame2 = _frames(tmp_path)
    with open(frame1, "rb") as f:
        frame1_bytes = f.read()
    st0 = os.stat(frame0)
    os.remove(frame1)
    os.remove(frame2)

    stats = render_video(dataclasses.replace(video_cfg, resume=True))
    assert stats["frames"] == 2
    # Frames 1 and 2 rendered again, byte for byte; frame 0 untouched.
    with open(frame1, "rb") as f:
        assert f.read() == frame1_bytes
    assert os.path.exists(frame2)
    st0b = os.stat(frame0)
    assert (st0b.st_mtime_ns, st0b.st_ino) == (st0.st_mtime_ns, st0.st_ino)
    assert sorted(_progress(tmp_path)[1]["completed"]) == [0, 1, 2]


def test_failed_png_write_never_marked_completed(video_cfg, tmp_path,
                                                 monkeypatch):
    real_save = tio.save_image
    fail_once = {"armed": True}

    def flaky_save(img, path):
        if "frame_0001" in path and fail_once["armed"]:
            fail_once["armed"] = False
            raise OSError("simulated disk-full")
        return real_save(img, path)

    monkeypatch.setattr(tio, "save_image", flaky_save)
    with pytest.raises(OSError, match="disk-full"):
        render_video(video_cfg)
    # Whatever progress exists does not claim the lost frame, and no
    # partial video sits at the output path.
    for progress in glob.glob(str(tmp_path / ".frames_*" / "progress.json")):
        with open(progress) as f:
            assert 1 not in json.load(f).get("completed", [])
    assert not os.path.exists(video_cfg.output)

    render_video(dataclasses.replace(video_cfg, resume=True))
    assert len(_frames(tmp_path)) == 3
    assert sorted(_progress(tmp_path)[1]["completed"]) == [0, 1, 2]


def test_video_param_change_invalidates(video_cfg, tmp_path, capsys):
    render_video(video_cfg)
    stats = render_video(dataclasses.replace(video_cfg, orbit_degrees=180.0,
                                             resume=True))
    assert "Parameters changed; starting over" in capsys.readouterr().out
    assert stats["frames"] == 3
    _, data = _progress(tmp_path)
    assert data["params"]["orbit_degrees"] == 180.0
    assert sorted(data["completed"]) == [0, 1, 2]


def test_corrupt_progress_json_restarts(video_cfg, tmp_path):
    render_video(video_cfg)
    path, _ = _progress(tmp_path)
    with open(path, "w") as f:
        f.write('{"params": {"n_fra')  # truncated mid-write
    stats = render_video(dataclasses.replace(video_cfg, resume=True))
    assert stats["frames"] == 3
    assert sorted(_progress(tmp_path)[1]["completed"]) == [0, 1, 2]


def test_run_without_resume_starts_fresh(video_cfg, tmp_path):
    render_video(video_cfg)
    stale = os.path.join(os.path.dirname(_frames(tmp_path)[0]), "frame_0099.png")
    with open(stale, "wb") as f:
        f.write(b"left over")
    assert render_video(video_cfg)["frames"] == 3
    assert not os.path.exists(stale)


# -- the shared protocol -----------------------------------------------------


@pytest.mark.parametrize("change", [
    {"seed": 7}, {"pov": (8.0, 0.0, 0.5)}, {"disk_tilt": 30.0},
], ids=["seed", "pov", "tilt"])
def test_video_scene_param_change_invalidates(tiny_cfg, change):
    cfg = dataclasses.replace(tiny_cfg, video=True, resume=True)
    temp_dir, progress_file = video_temp_paths(cfg.output)
    os.makedirs(temp_dir, exist_ok=True)
    with open(progress_file, "w") as f:
        json.dump({"params": video_resume_params(cfg), "completed": [0, 1]}, f)
    changed = dataclasses.replace(cfg, **change)
    done, _ = load_video_progress(changed, temp_dir, progress_file,
                                  video_resume_params(changed))
    assert done == set(), f"stale frames kept for {change}"
    assert os.listdir(temp_dir) == []  # wiped


def test_video_cross_engine_resume_not_invalidated(tiny_cfg):
    cfg = dataclasses.replace(tiny_cfg, video=True, resume=True)
    temp_dir, progress_file = video_temp_paths(cfg.output)
    os.makedirs(temp_dir, exist_ok=True)
    with open(progress_file, "w") as f:
        json.dump({"params": video_resume_params(cfg, sharded=True),
                   "completed": [0, 2]}, f)
    done, cross = load_video_progress(
        cfg, temp_dir, progress_file, video_resume_params(cfg, sharded=False))
    assert done == {0, 2} and cross


def test_video_renderer_pins_scene_escape_radius(tiny_cfg, monkeypatch):
    captured = {}
    real = modes._make_renderer

    def spy(config, r_escape_override=None):
        captured["override"] = r_escape_override
        renderer, dynamic = real(config, r_escape_override)
        traced = renderer.trace

        def trace(camera, r_escape, use_diff):
            captured.setdefault("traced", []).append(r_escape)
            return traced(camera, r_escape, use_diff)

        renderer.trace = trace
        return renderer, dynamic

    monkeypatch.setattr(modes, "_make_renderer", spy)
    cfg = dataclasses.replace(tiny_cfg, video=True, n_frames=2, frame_shards=1)
    render_video(cfg)
    assert captured["override"] == scene_escape_radius(cfg)
    assert captured["traced"] == [scene_escape_radius(cfg)] * 2


# -- dispatch, config and CLI --------------------------------------------------


@pytest.mark.parametrize("shards,expect", [(0, False), (1, False), (2, True)])
def test_cpu_dispatch_follows_frame_shards(tiny_cfg, shards, expect):
    cfg = dataclasses.replace(tiny_cfg, video=True, frame_shards=shards)
    assert sharded_video_eligible(cfg) is expect


def test_cuda_video_without_gpu_raises(tiny_cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(tiny_cfg, video=True, device="cuda")
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        sharded_video_eligible(cfg)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        render_video(cfg)
    assert not glob.glob(os.path.join(os.path.dirname(cfg.output), ".frames_*"))


def test_gpu_dispatches_to_the_batched_engine(tiny_cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = dataclasses.replace(tiny_cfg, video=True, device="cuda")
    assert sharded_video_eligible(cfg) is True
    assert sharded_video_eligible(dataclasses.replace(cfg, frame_shards=1)) is False


@pytest.mark.parametrize("bad,error", [
    ({"frame_shards": 2}, "applies to --video only"),
    ({"frame_shards": -1, "video": True}, "frame_shards must be >= 0"),
    ({"frames_per_dispatch": -1}, "frames_per_dispatch must be >= 0"),
    ({"video": True, "tile_shards": 2}, "video shards whole frames"),
    ({"fps": 0}, "fps must be positive"),
    ({"video_crf": 52}, "video_crf must be in"),
    ({"video": True, "disk_texture": "x.png"}, "static single-frame"),
])
def test_video_config_checks_match_bhr_tpu(bad, error):
    with pytest.raises(ValueError, match=error):
        SceneConfig(device="cpu", **bad).validated()
    with pytest.raises(ValueError, match=error):
        jcfg.SceneConfig(**bad).validated()


def test_cli_video_flags_have_bhr_tpu_defaults():
    flags = ["video", "orbit", "orbit_degrees", "n_frames", "fps", "video_crf",
             "resume", "frame_shards", "frames_per_dispatch",
             "coordinator_address", "num_processes", "process_id"]
    ours = cli.build_parser().parse_args([])
    theirs = jcli.build_parser().parse_args([])
    assert {f: getattr(ours, f) for f in flags} == {
        f: getattr(theirs, f) for f in flags}
    argv = ["--video", "--orbit", "--orbit_degrees", "-90", "--n_frames", "12",
            "--fps", "24", "--video_crf", "23", "--resume", "--frame_shards", "1",
            "--frames_per_dispatch", "3", "--ar1", "2.5", "--ar2", "4.0"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    ref = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    for f in ("video", "orbit", "orbit_degrees", "n_frames", "fps", "video_crf",
              "resume", "frame_shards", "frames_per_dispatch",
              "disk_inner_radius", "disk_outer_radius"):
        assert getattr(cfg, f) == getattr(ref, f), f


def test_cli_renders_a_video(tmp_path, capsys):
    out = tmp_path / "clip.mp4"
    args = ["--video", "--orbit", "--orbit_degrees", "30", "--n_frames", "2",
            "--fps", "2", "--width", "32", "--height", "16", "--fov", "60",
            "--step_size", "0.3", "--n_stars", "100", "--ar2", "3.5",
            "--disk_tilt", "15", "--device", "cpu", "-o", str(out)]
    assert cli.main(args) == 0
    assert len(_frames(tmp_path)) == 2
    text = capsys.readouterr().out
    (line,) = [ln for ln in text.splitlines() if ln.startswith("Video stats: ")]
    stats = json.loads(line[len("Video stats: "):])
    assert stats["frames"] == 2 and stats["assembler"] in (
        "native", "ffmpeg", "mjpeg", "none")
    # --resume with everything done renders nothing.
    assert cli.main(args + ["--resume"]) == 0
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("Video stats: ")]
    assert json.loads(line[len("Video stats: "):])["frames"] == 0


# The video switches that used to be refused (the cases keep their ids):
# the fleet flags now join a group, --interactive wins over --video as
# in bhr_tpu's CLI.
@pytest.mark.parametrize("flags,outcome", [
    (["--coordinator_address", "localhost:1234"], "exit 2"),
    (["--video", "--orbit", "--coordinator_address", "127.0.0.1:{port}",
      "--num_processes", "1", "--process_id", "0"], "video"),
    (["--video", "--orbit", "--interactive"], "interactive"),
    (["--video", "--disk_model", "v2", "--interactive"], "interactive"),
], ids=["flags0-item 17", "flags1-item 17", "flags2-item 13", "flags3-item 13"])
def test_cli_refuses_unported_video_features(flags, outcome, tmp_path,
                                             monkeypatch, capsys):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [f.format(port=port) for f in flags] + [
        "--device", "cpu", "--width", "32", "--height", "16", "--n_frames", "2",
        "--n_stars", "50", "-o", str(tmp_path / "x.mp4")]
    if outcome == "exit 2":
        # The address without the fleet's size: argparse's error.
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        assert os.listdir(tmp_path) == []
    elif outcome == "video":
        # A fleet of one: joined, announced, rendered, left again.
        assert cli.main(argv) == 0
        assert "multi-host: 1 processes, 1 devices total" in capsys.readouterr().out
        assert len(_frames(tmp_path)) == 2
        assert not torch.distributed.is_initialized()
    else:
        import bhr_tpu_torch.interactive as tinter

        seen = []
        monkeypatch.setattr(tinter, "run_interactive",
                            lambda config, **kw: seen.append(config))
        assert cli.main(argv) == 0
        assert seen[0].interactive and seen[0].video
        assert os.listdir(tmp_path) == []  # no video was rendered


def test_cli_renders_v2_video(tmp_path, capsys):
    """``--video --disk_model v2`` renders through the sequential engine
    (what ``--device cpu`` runs): no texture stage, frames that move."""
    args = ["--video", "--orbit", "--disk_model", "v2", "--n_frames", "2",
            "--fps", "2", "--width", "32", "--height", "16", "--fov", "60",
            "--step_size", "0.3", "--n_stars", "50", "--ar2", "3.5",
            "--disk_tilt", "15", "--orbit_degrees", "90", "--device", "cpu",
            "-o", str(tmp_path / "x.mp4")]
    assert cli.main(args) == 0
    first, last = (load_png_rgb8(p) for p in _frames(tmp_path))
    assert (first != last).any() and first.max() > 64
    _, progress = _progress(tmp_path)
    assert progress["completed"] == [0, 1]
    assert progress["params"]["v2"]["samples"] == 8


@pytest.mark.parametrize("flags", [["--num_processes", "2"], ["--process_id", "0"]])
def test_cli_multihost_rank_flags_require_coordinator(flags):
    with pytest.raises(SystemExit) as exc:
        cli.main(flags + ["-o", "x.png"])
    assert exc.value.code == 2  # argparse's error exit, as bhr_tpu's CLI


def test_engine_frames_are_the_cli_scene(video_cfg, tmp_path):
    """Both engines place frame 2's camera where the orbit puts it: the
    frame differs from frame 0 and is lit."""
    render_video(video_cfg)
    first, _, last = (load_png_rgb8(p) for p in _frames(tmp_path))
    assert (first != last).any() and last.max() > 128
    assert np.isfinite(last.astype(np.float32)).all()
