"""The port's span table (``bhr_tpu_torch.utils.profiling``) and the
spans the program opens at its layer boundaries, on the CPU.

* ``StageTimer``: the count, total, median and bounded samples of each
  name, each span's parent, marks, and many threads recording at once.
* A span opens a ``record_function`` range only while a profiler
  records; under ``torch.profiler`` the Chrome trace of two batched
  frames holds ``bhr.frame.*`` ranges that enclose the ``aten::`` ops of
  their stage.
* ``render_video_sharded`` (lifecycle and V2 at 32x16): ``stage_ms``
  holds job_setup, enqueue, record, finish and hit_sync, and the job's
  four top-level spans cover at least 90% of the call's host time.
* ``InteractiveSession.step`` (fused, 64x36): one sample each of
  ``session.lifecycle`` / ``enqueue`` / ``fetch_wait`` a step, and the
  HUD's ``last_render_ms`` is the step's ``session.step`` sample.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bhr_tpu_torch.config import SceneConfig, compute_disk_texture_resolution
from bhr_tpu_torch.interactive import InteractiveSession
from bhr_tpu_torch.models.dynamic_disk import DynamicDiskSystem
from bhr_tpu_torch.models.skybox import load_or_generate_skybox
from bhr_tpu_torch.parallel import video as tvideo
from bhr_tpu_torch.parallel.mesh import make_frame_mesh
from bhr_tpu_torch.utils import profiling as tprof
from bhr_tpu_torch.utils.profiling import SPANS

CPU = torch.device("cpu")
TINY = dict(width=32, height=16, fov=60.0, step_size=0.3, n_stars=100,
            disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
            video=True, orbit=True, orbit_degrees=45.0, n_frames=8, fps=4,
            frames_per_dispatch=2)
TOP = ("job_setup", "enqueue", "record", "finish")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_span_table_counts_totals_medians_and_parents(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(tprof, "_KEEP", 3)
    timer = tprof.StageTimer()
    for i, ms in enumerate((1, 2, 3, 4)):
        if i == 2:
            mark = timer.mark()
        with timer.stage("outer"):
            clock[0] += 1e-3
            with timer.stage("inner"):
                clock[0] += ms * 1e-3
    assert timer.counts["inner"] == timer.count("inner") == 4
    assert timer.total_s("inner") == pytest.approx(10e-3)
    assert timer.samples("inner") == pytest.approx([2e-3, 3e-3, 4e-3])  # the last 3
    assert timer.median_ms("inner") == pytest.approx(3.0)
    assert timer.count("inner", mark) == 2
    assert timer.total_s("outer", mark) == pytest.approx((1 + 3) * 1e-3 + (1 + 4) * 1e-3)
    assert timer.samples("inner", mark) == pytest.approx([3e-3, 4e-3])
    assert timer.median_ms("inner", mark) == pytest.approx(3.5)
    assert timer.parents == {"inner": "outer", "outer": None}
    assert timer.median_ms("never") is None and timer.total_s("never") == 0.0
    assert timer.count("never") == 0 and timer.samples("never") == []
    lines = timer.summary().splitlines()
    assert lines[0].startswith("outer ") and lines[0].endswith("avg)")
    assert lines[1].startswith("inner ") and lines[1].endswith(" in outer")


def test_span_seconds_and_a_span_that_raises():
    timer = tprof.StageTimer()
    with timer.stage("a") as s:
        time.sleep(0.001)
    assert s.seconds == timer.samples("a")[0] >= 0.001
    with pytest.raises(ValueError):
        with timer.stage("b"):
            with timer.stage("c"):
                raise ValueError("inside")
    assert timer.count("b") == timer.count("c") == 1
    with timer.stage("d"):
        pass
    assert timer.parents["d"] is None  # the raise left no span open


def test_span_table_is_safe_across_threads():
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # threads switch between any two bytecodes
    timer = tprof.StageTimer()
    n, per = 2 * (os.cpu_count() or 8), 800

    def work(i):
        for _ in range(per):
            with timer.stage("t"):
                with timer.stage(f"child{i}"):
                    pass

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert timer.count("t") == n * per
    assert len(timer.samples("t")) == min(n * per, tprof._KEEP)
    for i in range(n):
        name = f"child{i}"
        assert timer.count(name) == len(timer.samples(name)) == per
        assert timer.total_s(name) == pytest.approx(sum(timer.samples(name)))
    assert timer.parents == {"t": None, **{f"child{i}": "t" for i in range(n)}}


def test_a_span_opens_a_range_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    class Spy(real):
        def __init__(self, name, *args, **kwargs):
            opened.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    with tprof.span("frame.texture"):
        torch.ones(4).sum()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tprof.span("frame.texture"):
            torch.ones(4).sum()
    assert opened == ["bhr.frame.texture"]
    with tprof.span("frame.texture"):
        torch.ones(4).sum()
    assert opened == ["bhr.frame.texture"]


def test_the_device_trace_holds_the_frame_ranges(tmp_path):
    cfg = SceneConfig(device="cpu", **TINY).validated()
    w, h = cfg.image_size
    n_phi, n_r = compute_disk_texture_resolution(
        w, h, cfg.pov, cfg.fov, cfg.disk_inner_radius, cfg.disk_outer_radius)
    dyn = DynamicDiskSystem(n_r, n_phi, cfg.disk_inner_radius,
                            cfg.disk_outer_radius, seed=42, device="cpu")
    packs = tvideo.pack_frame_params(dyn, 2, cfg.disk_rotation_speed)
    sky, _, _ = load_or_generate_skybox(None, 64, 32, 100, seed=42, cache_dir=None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tvideo.render_video_frames_sharded(
            cfg, make_frame_mesh(1, 1, devices=[CPU]), [0, 1], sky, dyn, *packs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("bhr."):
            ranges.setdefault(e["name"], []).append(e)
    assert {n: len(v) for n, v in ranges.items()} == {
        "bhr.frame.background": 1, "bhr.frame.texture": 2, "bhr.frame.trace": 2,
        "bhr.frame.shade": 2, "bhr.frame.hit_sync": 2, "bhr.frame.post": 2}
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]

    def inside(r):
        a, b = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        return [e for e in ops if e["tid"] == r["tid"]
                and a <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b]

    for name in ("bhr.frame.texture", "bhr.frame.shade", "bhr.frame.post"):
        for r in ranges[name]:
            assert len(inside(r)) > 10, name
    # The hit count's read is inside its frame's shade.
    for sync in ranges["bhr.frame.hit_sync"]:
        assert any(float(s["ts"]) <= float(sync["ts"])
                   and float(sync["ts"]) + float(sync["dur"])
                   <= float(s["ts"]) + float(s["dur"])
                   for s in ranges["bhr.frame.shade"])
        assert any(e["name"] in ("aten::max", "aten::item") for e in inside(sync))


@pytest.mark.parametrize("disk_model", ["texture", "v2"])
def test_video_job_spans_cover_the_call(tmp_path, disk_model):
    cfg = SceneConfig(device="cpu", disk_model=disk_model,
                      output=str(tmp_path / "v.mp4"), **TINY).validated()
    mark = SPANS.mark()
    t0 = time.perf_counter()
    stats = tvideo.render_video_sharded(cfg, devices=[CPU] * 2)
    call_ms = (time.perf_counter() - t0) * 1e3
    sm = stats["stage_ms"]
    assert stats["frames"] == 8
    for key in (*TOP, "hit_sync"):
        assert sm[key] > 0, key
    for key in TOP:
        assert sm[key] == pytest.approx(
            SPANS.total_s(f"video.{key}", mark) * 1e3 / 8)
    assert sm["hit_sync"] == SPANS.median_ms("frame.hit_sync", mark)
    assert SPANS.count("frame.hit_sync", mark) == 8
    top = sum(sm[k] for k in TOP) * stats["frames"]
    print(f"{disk_model}: top-level spans {top:.1f} ms of the call's {call_ms:.1f} ms")
    assert 0.9 * call_ms <= top <= call_ms
    # Two batches of 4 (2 slots x 2 frames): one enqueue and one record each.
    assert SPANS.count("video.enqueue", mark) == SPANS.count("video.record", mark) == 2
    assert SPANS.count("video.job_setup", mark) == SPANS.count("video.finish", mark) == 1
    assert SPANS.count("writers.png", mark) == 8
    assert {n: SPANS.parents[n] for n in ("frame.trace", "frame.shade", "frame.post")} \
        == dict.fromkeys(("frame.trace", "frame.shade", "frame.post"), "video.enqueue")
    assert SPANS.parents["frame.hit_sync"] == "frame.shade"
    assert all(SPANS.parents[f"video.{k}"] is None for k in TOP)
    if disk_model == "texture":
        assert SPANS.count("lifecycle.pack", mark) == 1
        assert SPANS.parents["lifecycle.pack"] == "video.job_setup"
        assert SPANS.count("frame.texture", mark) == 8
    else:
        assert SPANS.count("frame.texture", mark) == SPANS.count("lifecycle.pack", mark) == 0
    if stats["assembler"] == "mjpeg" and SPANS.count("writers.mjpeg", mark):
        # The AVI written inline: one span a frame, no post-pass.
        assert SPANS.count("writers.mjpeg", mark) == 8
        assert SPANS.count("video.assemble", mark) == 0
    elif stats["assembler"] == "mjpeg":
        # The post-pass wrote it, inside the job's finish.
        assert SPANS.count("video.assemble", mark) == 1
        assert SPANS.parents["video.assemble"] == "video.finish"


def test_session_step_spans_and_the_hud():
    cfg = SceneConfig(device="cpu", width=64, height=36, fov=60.0, step_size=0.3,
                      n_stars=100, disk_inner_radius=2.0, disk_outer_radius=3.5,
                      disk_tilt=15.0).validated()
    sess = InteractiveSession(cfg)
    assert sess._fused is not None
    mark = SPANS.mark()
    n = 4
    for _ in range(n):
        img = sess.step(0.05)
        assert sess.last_render_ms == SPANS.samples("session.step")[-1] * 1e3
    assert isinstance(img, np.ndarray) and img.shape == (36, 64, 3)
    for name in ("session.step", "session.lifecycle", "session.enqueue",
                 "session.fetch_wait"):
        assert SPANS.count(name, mark) == n, name
    assert SPANS.parents["session.step"] is None
    assert all(SPANS.parents[f"session.{k}"] == "session.step"
               for k in ("lifecycle", "enqueue", "fetch_wait"))
    assert SPANS.parents["frame.shade"] == "session.enqueue"
    assert sess.render_s == pytest.approx(SPANS.total_s("session.step", mark))
    parts = sum(SPANS.total_s(f"session.{k}", mark)
                for k in ("lifecycle", "enqueue", "fetch_wait"))
    assert parts <= SPANS.total_s("session.step", mark)
    assert f"(render {sess.last_render_ms:.0f} ms / " in sess.hud_text()
