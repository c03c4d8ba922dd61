"""A cell on the card for ten seconds: the real command, end to end.
Skips where there is no CUDA card (decided inside the test)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_a_cell_runs_for_ten_seconds(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fhd_v2.video", "--seed", "2718281828", "--seconds", "10",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]["video_fps"]["value"] > 0
