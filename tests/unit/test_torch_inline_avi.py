"""The MJPEG AVI written inline from the host frames, on a host with
neither the native H.264 writer nor an ffmpeg CLI (both patched away
here), on the CPU.

* A fresh orbit job of 16:9 frames, on the batched engine (two CPU
  slots) and on the sequential one: the AVI beside the ``.mp4`` asked
  for is byte for byte ``bhr_tpu``'s ``write_mjpeg_avi`` over the job's
  own PNGs, each frame is one ``writers.mjpeg`` span, and the post-pass
  (``video.assemble``) never runs.
* With an ffmpeg CLI on the PATH the inline writer is inert and the
  post-pass chain runs in its order: native H.264, ffmpeg (failing
  here), the MJPEG AVI.
* A job resumed with half its frames from an earlier run catches up from
  their PNGs and writes the same bytes.
* An encode error in mid-job leaves no partial AVI for the post-pass,
  which writes a correct one.
"""

import dataclasses
import json
import os
import shutil
import types

import pytest
import torch

from bhr_tpu.utils.io import write_mjpeg_avi as bhr_tpu_write_mjpeg_avi

import bhr_tpu_torch.modes as modes
from bhr_tpu_torch import native
from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.modes import render_video, video_temp_paths
from bhr_tpu_torch.parallel import video as tvideo
from bhr_tpu_torch.utils import io as tio
from bhr_tpu_torch.utils.profiling import SPANS

pytest.importorskip("PIL.Image")

CPU = torch.device("cpu")
N = 8
SCENE = dict(width=64, height=36, fov=60.0, step_size=0.3, n_stars=100,
             disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
             video=True, orbit=True, orbit_degrees=45.0, n_frames=N, fps=4,
             frames_per_dispatch=2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _host(monkeypatch, ffmpeg: bool, events: list) -> None:
    """A host without the native H.264 writer, with or without an ffmpeg
    CLI; ``events`` records each assembler the program asks for."""
    real_which = shutil.which

    def video_available():
        events.append("native")
        return False

    def which(name, *args, **kwargs):
        if name == "ffmpeg":
            return "/usr/bin/ffmpeg" if ffmpeg else None
        return real_which(name, *args, **kwargs)

    def run(cmd, **kwargs):
        events.append(cmd[0])
        return types.SimpleNamespace(returncode=1)

    real_write = modes.write_mjpeg_avi

    def write_mjpeg_avi(*args, **kwargs):
        events.append("mjpeg")
        return real_write(*args, **kwargs)

    monkeypatch.setattr(native, "video_available", video_available)
    monkeypatch.setattr(shutil, "which", which)
    monkeypatch.setattr(modes.subprocess, "run", run)
    monkeypatch.setattr(modes, "write_mjpeg_avi", write_mjpeg_avi)


def _cfg(tmp_path, **extra) -> SceneConfig:
    return SceneConfig(device="cpu", output=str(tmp_path / "orbit.mp4"),
                       **dict(SCENE, **extra)).validated()


def _pngs(cfg) -> list:
    temp_dir, _ = video_temp_paths(cfg.output)
    return [os.path.join(temp_dir, f"frame_{f:04d}.png") for f in range(N)]


def _avi(cfg) -> str:
    return str(os.path.splitext(cfg.output)[0]) + ".avi"


def _bhr_tpu_bytes(cfg, tmp_path) -> bytes:
    """``bhr_tpu``'s MJPEG AVI of the job's PNGs."""
    path = str(tmp_path / "bhr_tpu.avi")
    bhr_tpu_write_mjpeg_avi(_pngs(cfg), path, cfg.fps)
    with open(path, "rb") as f:
        return f.read()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _batched(cfg) -> dict:
    return tvideo.render_video_sharded(cfg, devices=[CPU] * 2)


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_inline_avi_is_bhr_tpus_mjpeg_of_the_pngs(tmp_path, monkeypatch,
                                                   capsys, engine):
    events = []
    _host(monkeypatch, ffmpeg=False, events=events)
    cfg = _cfg(tmp_path, frame_shards=1 if engine == "sequential" else 0)
    mark = SPANS.mark()
    stats = _batched(cfg) if engine == "batched" else render_video(cfg)
    assert stats["assembler"] == "mjpeg" and stats["frames"] == N
    assert "ffmpeg" not in events and "mjpeg" not in events  # no post-pass
    assert SPANS.count("writers.mjpeg", mark) == N
    assert SPANS.count("video.assemble", mark) == 0
    assert SPANS.count("writers.h264", mark) == 0
    if engine == "batched":  # on the encoder thread, under no other span
        assert SPANS.parents["writers.mjpeg"] is None
    assert not os.path.exists(cfg.output)
    assert _read(_avi(cfg)) == _bhr_tpu_bytes(cfg, tmp_path)
    out = capsys.readouterr().out
    assert f"Video saved (MJPEG AVI fallback): {_avi(cfg)}" in out
    assert f"Re-mux to .mp4 later: ffmpeg -i {_avi(cfg)}" in out


def test_with_ffmpeg_the_post_pass_chain_runs_in_order(tmp_path, monkeypatch):
    events = []
    _host(monkeypatch, ffmpeg=True, events=events)
    cfg = _cfg(tmp_path)
    mark = SPANS.mark()
    stats = _batched(cfg)
    # Asked once at the assembler's birth, then the post-pass's chain.
    assert events == ["native", "native", "ffmpeg", "mjpeg"]
    assert stats["assembler"] == "mjpeg"
    assert SPANS.count("writers.mjpeg", mark) == 0
    assert SPANS.count("video.assemble", mark) == 1
    assert SPANS.parents["video.assemble"] == "video.finish"
    assert _read(_avi(cfg)) == _bhr_tpu_bytes(cfg, tmp_path)


def test_resumed_job_catches_up_from_the_earlier_runs_pngs(tmp_path,
                                                           monkeypatch):
    _host(monkeypatch, ffmpeg=False, events=[])
    cfg = _cfg(tmp_path)
    _batched(cfg)
    # An earlier run that stopped after half the frames: frames 0-3 on
    # disk and in progress.json, no video file.
    _, progress_file = video_temp_paths(cfg.output)
    with open(progress_file) as f:
        progress = json.load(f)
    progress["completed"] = list(range(N // 2))
    with open(progress_file, "w") as f:
        json.dump(progress, f)
    for path in _pngs(cfg)[N // 2:]:
        os.remove(path)
    os.remove(_avi(cfg))
    mark = SPANS.mark()
    stats = _batched(dataclasses.replace(cfg, resume=True))
    assert stats["frames"] == N // 2 and stats["assembler"] == "mjpeg"
    assert SPANS.count("writers.mjpeg", mark) == N // 2
    assert SPANS.count("video.assemble", mark) == 0
    assert _read(_avi(cfg)) == _bhr_tpu_bytes(cfg, tmp_path)


def test_encode_error_leaves_no_partial_avi_for_the_post_pass(
        tmp_path, monkeypatch, capsys):
    events = []
    _host(monkeypatch, ffmpeg=False, events=events)
    cfg = _cfg(tmp_path)
    real_write = tio.MJPEGAVIWriter.write
    calls = [0]

    def write(self, frame):
        calls[0] += 1
        if calls[0] == 3:  # the inline writer's third frame
            raise OSError("simulated encode failure")
        return real_write(self, frame)

    real_assemble = modes._assemble_video

    def assemble(*args, **kwargs):
        assert not os.path.exists(_avi(cfg)), "the partial AVI survived"
        return real_assemble(*args, **kwargs)

    monkeypatch.setattr(tio.MJPEGAVIWriter, "write", write)
    monkeypatch.setattr(modes, "_assemble_video", assemble)
    mark = SPANS.mark()
    stats = _batched(cfg)
    assert "inline MJPEG AVI assembly failed at frame 2" in capsys.readouterr().out
    assert events[-2:] == ["native", "mjpeg"]
    assert stats["assembler"] == "mjpeg"
    assert SPANS.count("video.assemble", mark) == 1
    assert _read(_avi(cfg)) == _bhr_tpu_bytes(cfg, tmp_path)
