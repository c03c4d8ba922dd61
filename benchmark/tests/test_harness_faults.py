"""The comparison catches what a broken timed path would produce: a whole
run on the CPU at a tiny size (the look for a card skipped), with the
port broken underneath, must print ``correct`` false. One fault of each
kind the cells can have: an answer altered where it is produced, half
of a batch left out, a step that returns its state unchanged, the
frames of every card but the first lost on their way to the host, and
one card's frames wrong; for a still, its PNG missing, the wrong disk
seed, and the first still's frame returned for every later one (a tiled
AA + flare still's own faults are in ``test_harness_still_tiled.py``)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness, run
from conftest import tiny


def _line(capsys, workload, driver):
    rc = run.main(["--workload", workload, "--seed", "11", "--seconds", "1",
                   "--trace", "0"], overrides=tiny(driver))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _wrap_renderer(monkeypatch, wrap_on_frame):
    """Make every video renderer hand ``on_frame`` through
    ``wrap_on_frame(on_frame)``."""
    from bhr_tpu_torch.parallel import video

    build = video.build_sharded_video_renderer

    def patched(*a, **k):
        fn = build(*a, **k)

        def render(*args, on_frame=None, **kw):
            if on_frame is not None:
                on_frame = wrap_on_frame(on_frame)
            return fn(*args, on_frame=on_frame, **kw)

        return render

    monkeypatch.setattr(video, "build_sharded_video_renderer", patched)


@pytest.mark.parametrize("workload", ["fhd_lifecycle.video", "fhd_v2.video"])
def test_an_altered_frame(in_workdir, capsys, monkeypatch, workload):
    """A frame changed where the engine produces it (a patch of pixels
    one step brighter in every frame)."""
    from bhr_tpu_torch.parallel import video

    post = video.post_process

    def altered(*a, **k):
        out = post(*a, **k).clone()
        out[4:20, 4:40] = torch.clamp(out[4:20, 4:40] + 1.5 / 255.0, 0.0, 1.0)
        return out

    monkeypatch.setattr(video, "post_process", altered)
    line = _line(capsys, workload, "video")
    assert line["correct"] is False and line["failed"] > 0


def test_half_of_each_batch_left_out(in_workdir, capsys, monkeypatch):
    """Every second frame of a batch is not rendered: the frame before it
    is written in its place."""
    def wrap(on_frame):
        prev = {}

        def on(pos, frame):
            if pos % 2:
                frame = prev.get(pos - 1, frame)
            prev[pos] = frame
            return on_frame(pos, frame)

        return on

    _wrap_renderer(monkeypatch, wrap)
    line = _line(capsys, "fhd_lifecycle.video", "video")
    assert line["correct"] is False and line["failed"] > 0


def test_frames_of_the_other_cards_lost(in_workdir, capsys, monkeypatch):
    """The cell over four cards: the frames rendered on every card but the
    first never reach the host (the exchange between cards left out)."""
    def wrap(on_frame):
        def on(pos, frame):
            if pos % 4 == 0:
                return on_frame(pos, frame)
            return None

        return on

    _wrap_renderer(monkeypatch, wrap)
    line = _line(capsys, "fhd_lifecycle.video_4card", "video")
    assert line["correct"] is False and line["failed"] > 0


def test_a_wrong_frame_on_one_card(in_workdir, capsys, monkeypatch):
    """The cell over four cards: the frames of one card's slot (position
    1 of every 4 in a batch) are the frame before them, the rest right."""
    def wrap(on_frame):
        prev = {}

        def on(pos, frame):
            if pos % 4 == 1:
                frame = prev.get(pos - 1, frame)
            prev[pos] = frame
            return on_frame(pos, frame)

        return on

    _wrap_renderer(monkeypatch, wrap)
    rc = run.main(["--workload", "fhd_lifecycle.video_4card", "--seed", "11",
                   "--seconds", "1", "--trace", "0"],
                  overrides=dict(tiny("video"), traffic=dict(
                      tiny("video")["traffic"], strata=4)))
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False and line["failed"] > 0


def test_a_step_that_returns_its_state_unchanged(in_workdir, capsys, monkeypatch):
    """The session shows the same frame at every step after the first."""
    from bhr_tpu_torch.interactive import InteractiveSession

    step = InteractiveSession.step
    first = {}

    def stale(self, real_dt):
        img = step(self, real_dt)
        return first.setdefault(id(self), img.copy())

    monkeypatch.setattr(InteractiveSession, "step", stale)
    line = _line(capsys, "fhd_lifecycle.session", "session")
    assert line["correct"] is False and line["failed"] > 0


# The still cells: those whose traffic's driver is ``still``.
STILLS = [w["name"] for w in harness.load_benchmark()["workloads"]
          if harness.load_traffic(w["traffic"])["driver"] == "still"]


def _broken_render(monkeypatch, change):
    """Make ``modes.render_image`` return ``change(render_image, config,
    k)``, ``k`` counting its calls."""
    from bhr_tpu_torch import modes

    render = modes.render_image
    calls = [0]

    def patched(config):
        calls[0] += 1
        return change(render, config, calls[0])

    monkeypatch.setattr(modes, "render_image", patched)


@pytest.mark.parametrize("workload", STILLS)
def test_a_still_with_the_wrong_disk_seed(in_workdir, capsys, monkeypatch, workload):
    import dataclasses

    _broken_render(monkeypatch, lambda render, cfg, k: render(
        dataclasses.replace(cfg, seed=cfg.seed + 1)))
    line = _line(capsys, workload, "still")
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("workload", STILLS)
def test_a_still_that_repeats_the_first(in_workdir, capsys, monkeypatch, workload):
    """The renderer's state left as it was: every still is the first one's
    frame again, whatever its camera or seed."""
    first = []

    def stale(render, cfg, k):
        img = render(cfg)
        if not first:
            first.append(img.copy())
        return first[0]

    _broken_render(monkeypatch, stale)
    line = _line(capsys, workload, "still")
    assert line["correct"] is False and line["failed"] > 0


def test_an_altered_still(in_workdir, capsys, monkeypatch):
    """A patch of pixels one step brighter where the still is produced."""
    def brighter(render, cfg, k):
        img = render(cfg).copy()
        img[4:20, 4:40] = (img[4:20, 4:40] + 1.5 / 255.0).clip(0.0, 1.0)
        return img

    _broken_render(monkeypatch, brighter)
    line = _line(capsys, "fhd_lifecycle.still", "still")
    assert line["correct"] is False and line["failed"] > 0


def test_a_still_whose_png_is_missing(in_workdir, capsys, monkeypatch):
    """Every second still's PNG never reaches the disk."""
    from bhr_tpu_torch.utils import io

    save = io.save_image
    calls = [0]

    def lossy(image, path):
        calls[0] += 1
        if calls[0] % 2:
            save(image, path)

    monkeypatch.setattr(io, "save_image", lossy)
    line = _line(capsys, "fhd_static.still", "still")
    assert line["correct"] is False and line["failed"] > 0
