"""The benchmark's nine per-layer metrics that read the port's spans, on
the CPU: each gives a number in a ``--trace 1`` run of every cell it
lists, shrunk to a tiny frame (``benchmark.run.main``'s ``overrides``
path), and None on a record it does not apply to (a cell of another traffic
driver, a program whose stats or span table lack it)."""

import json
import math
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from bhr_tpu_torch.utils import profiling  # noqa: E402

VIDEO = ("video.job_setup_ms_per_frame.video", "video.enqueue_ms_per_frame.video",
         "video.finish_ms_per_frame.video", "video.unspanned_ms_per_frame.video",
         "frame.hit_sync_ms_per_frame.video")
SESSION = ("session.lifecycle_ms", "session.enqueue_ms", "session.fetch_wait_ms")
NEW = VIDEO + SESSION + ("setup.skybox_s",)
# A 64 x 36 frame, as the benchmark's own CPU tests cut a cell.
SCENE = {"width": 64, "height": 36, "n_frames": 8}
TRAFFIC = {
    "video": {"warm_frames": 4, "traced_frames": 4, "strata": 2, "frame_shards": 2},
    "session": {"warm_steps": 3, "traced_steps": 2, "key_steps": 2, "sample_steps": 2},
}


def _listed(workload):
    spec = harness.load_benchmark()
    return {m["name"] for m in harness.cell_metrics(spec, "per_layer", workload)} & set(NEW)


def test_the_new_metrics_list_their_cells():
    spec = harness.load_benchmark()
    entries = {m["name"]: m for m in spec["per_layer"]}
    video = [c["name"] for c in spec["workloads"] if c["traffic"].startswith("video")]
    session = [c["name"] for c in spec["workloads"] if c["traffic"] == "session_script"]
    for name in NEW:
        assert entries[name]["source"] == "program_span" and entries[name]["better"] == "lower"
    assert all(entries[n]["workloads"] == video for n in VIDEO)
    assert all(entries[n]["workloads"] == session for n in SESSION)
    assert entries["setup.skybox_s"]["workloads"] == [c["name"] for c in spec["workloads"]]


@pytest.mark.parametrize("workload,driver", [
    ("fhd_lifecycle.video", "video"),
    ("fhd_v2.video", "video"),
    ("fhd_lifecycle.session", "session"),
    ("fhd_lifecycle.video_4card", "video"),
])
def test_each_metric_reads_a_number_in_a_traced_run(tmp_path, workload, driver):
    # A process of its own, as the benchmark runs: this one has loaded
    # JAX, which a run refuses, and the session's readers read the
    # process's span table.
    overrides = {"device": "cpu", "scene": dict(SCENE), "traffic": dict(TRAFFIC[driver])}
    code = ("import json, sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from benchmark import run\n"
            f"sys.exit(run.main(sys.argv[1:], overrides={overrides!r}))")
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    p = subprocess.run(
        [sys.executable, "-c", code, "--workload", workload, "--seed", "3000000123",
         "--seconds", "1", "--trace", "1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    listed = _listed(workload)
    assert listed == (set(SESSION) | {"setup.skybox_s"} if driver == "session"
                      else set(VIDEO) | {"setup.skybox_s"})
    for name in listed:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value), name
        assert value > 0 or name == "video.unspanned_ms_per_frame.video", (name, value)
    # The four top-level spans leave little of a job unspanned.
    if driver == "video":
        frame_ms = sum(line["metrics"][f"video.{k}_ms_per_frame.video"]["value"]
                       for k in ("job_setup", "enqueue", "finish"))
        assert line["metrics"]["video.unspanned_ms_per_frame.video"]["value"] < 0.1 * frame_ms


def _video_job(**stage_ms):
    base = {"background": 1.0, "texture": 2.0, "trace": 0.5, "shade": 1.0,
            "post": 0.5, "fetch": None, "png": 3.0, "h264": None}
    return {"t0": 0.0, "t1": 1.0, "frames": 8, "stage_ms": dict(base, **stage_ms)}


def test_each_metric_is_none_where_it_does_not_apply(monkeypatch):
    read = {name: harness.load_metric(name) for name in NEW}
    assert all(read[name]({}) is None for name in NEW)  # not a run's record
    session = {"driver": "session", "jobs": [], "steps_ms": [10.0]}
    # A video job of a program without the job's spans in its stats.
    parent_video = {"driver": "video", "jobs": [_video_job()]}
    for name in VIDEO:
        assert read[name](session) is None, name
        assert read[name](parent_video) is None, name
    video = {"driver": "video", "jobs": [_video_job(
        job_setup=10.0, enqueue=90.0, record=5.0, finish=15.0, hit_sync=0.5)]}
    assert read["video.unspanned_ms_per_frame.video"](video) == pytest.approx(5.0)
    assert read["frame.hit_sync_ms_per_frame.video"](video) == 0.5
    for name in SESSION:
        assert read[name](video) is None, name
    # A span table with nothing recorded, then a program without one.
    monkeypatch.setattr(profiling, "SPANS", profiling.StageTimer())
    assert read["setup.skybox_s"](video) is None
    for name in SESSION:
        assert read[name](session) is None, name
    monkeypatch.delattr(profiling, "SPANS")
    assert read["setup.skybox_s"](video) is None
    for name in SESSION:
        assert read[name](session) is None, name


@pytest.mark.parametrize("name", SESSION)
def test_the_session_metrics_take_the_window_steps_alone(monkeypatch, name):
    # Warm steps, the window, profiled steps and key steps, in that order,
    # each recorded as the span the metric reads.
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    timer = profiling.StageTimer()
    span = name[:-len("_ms")]
    for ms in [900.0] * 3 + [10.0, 30.0, 20.0, 40.0, 50.0] + [700.0] * 2 + [800.0] * 4:
        with timer.stage(span):
            clock[0] += ms * 1e-3
    monkeypatch.setattr(profiling, "SPANS", timer)
    rec = {"driver": "session", "steps_ms": [1.0] * 5, "profile": {"frames": 2},
           "key_steps_ms": [2.0] * 4}
    assert harness.load_metric(name)(rec) == pytest.approx(30.0)
