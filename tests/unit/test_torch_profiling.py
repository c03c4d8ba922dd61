"""``bhr_tpu_torch.utils.profiling`` vs ``bhr_tpu.utils.profiling``, and the
``profile_pipeline`` tool, on the CPU.

* ``StageTimer`` under one script of stages, with the clock replaced by
  a counter: the same totals, counts and summary text as ``bhr_tpu``'s.
* ``device_time``: seconds per call, positive, after ``warmup`` + ``iters``
  calls; on the CPU it reads the host clock (the CUDA-event path runs in
  ``chip_smoke.py``'s ``[tools profile_pipeline]``).
* ``profiler_trace`` writes a Chrome trace holding the block's operators,
  and nothing when disabled.
* ``profile_pipeline --device cpu`` at 64x36 (the ``"sd"`` resolution set
  to that size for the test) prints one ``device_time`` line per stage
  and the ``StageTimer`` summary of the same four stages.
"""

import json
import os
import re
import sys
import time

import pytest
import torch

from bhr_tpu.utils import profiling as jprof

import bhr_tpu_torch.config
from bhr_tpu_torch.utils import profiling as tprof

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_tools import _few_threads, run_port  # noqa: E402,F401

STAGES = ("texture", "trace", "shade", "texture", "post", "trace", "texture")


def _scripted(module, monkeypatch):
    """A StageTimer of ``module`` after STAGES, stage i taking i + 1 ms of
    a fake clock that moves only between stages."""
    ticks = iter(range(10_000))
    clock = [0.0]

    def fake_clock():
        return clock[0]

    monkeypatch.setattr(time, "perf_counter", fake_clock)
    timer = module.StageTimer()
    for i, name in enumerate(STAGES):
        with timer.stage(name):
            clock[0] += (i + 1) * 1e-3
        clock[0] += next(ticks) * 1e-6  # between stages: not counted
    monkeypatch.undo()
    return timer


def test_stage_timer_matches_bhr_tpu(monkeypatch):
    ours = _scripted(tprof, monkeypatch)
    theirs = _scripted(jprof, monkeypatch)
    assert dict(ours.counts) == dict(theirs.counts) == {
        "texture": 3, "trace": 2, "shade": 1, "post": 1}
    assert dict(ours.totals) == pytest.approx(dict(theirs.totals), abs=0)
    assert ours.totals["texture"] == pytest.approx((1 + 4 + 7) * 1e-3)
    assert ours.summary() == theirs.summary()
    lines = ours.summary().splitlines()
    assert [ln.split()[0] for ln in lines] == ["texture", "trace", "post", "shade"]
    assert lines[0].endswith("(3 calls,    4.00 ms avg)")


def test_stage_timer_counts_a_stage_that_raises():
    timer = tprof.StageTimer()
    with pytest.raises(ValueError):
        with timer.stage("boom"):
            raise ValueError("stage failed")
    assert timer.counts["boom"] == 1 and timer.totals["boom"] >= 0.0


@pytest.mark.parametrize("iters, warmup", [(1, 1), (5, 0), (3, 2)])
def test_device_time_on_cpu(iters, warmup):
    calls = []
    x = torch.ones(256, 256)

    def fn():
        calls.append(1)
        return x @ x

    seconds = tprof.device_time(fn, iters=iters, warmup=warmup)
    assert seconds > 0.0
    # At least one warm-up call: its result says where fn runs.
    assert len(calls) == iters + max(warmup, 1)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.profiler_trace(str(log_dir)) as prof:
        torch.ones(64, 64).mm(torch.ones(64, 64)).sum()
    assert prof is not None
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with tprof.profiler_trace(str(tmp_path / "off"), enabled=False) as prof:
        torch.ones(2).sum()
    assert prof is None and not (tmp_path / "off").exists()


def test_profile_pipeline_on_cpu(monkeypatch):
    monkeypatch.setitem(bhr_tpu_torch.config.RESOLUTIONS, "sd", (64, 36))
    rc, out = run_port("profile_pipeline", ["--resolution", "sd"])
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("scene: 64x36, texture ") and lines[0].endswith("on cpu")
    stages = ["dynamic texture (all)", "trace", "shade (sky + 2 slots + g)",
              "bloom + final + u8"]
    for label, line in zip(stages, lines[1:5]):
        assert line.startswith(label) and line.endswith(" ms")
        assert float(line[36:].split()[0]) > 0.0
    summary = lines[lines.index(
        "wall time per stage, 4 frames, each stage synchronised:") + 1:]
    assert sorted(re.match(r"(.*?)\s+[\d.]+ ms \(", ln).group(1)
                  for ln in summary) == sorted(stages)
    assert all("(4 calls," in ln for ln in summary)
