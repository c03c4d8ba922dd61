"""Shared settings of the benchmark's CPU tests: a cell cut to a tiny
frame on the CPU (the harness's test path), run from a scratch working
directory."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# A 64 x 36 frame; the batched engine on the CPU (frame_shards 2 makes
# the port take it there, with its one CPU device).
TINY_SCENE = {"width": 64, "height": 36, "n_frames": 8}
TINY_TRAFFIC = {
    "video": {"warm_frames": 4, "traced_frames": 4, "strata": 2,
              "frame_shards": 2},
    "session": {"warm_steps": 3, "traced_steps": 2, "key_steps": 2,
                "sample_steps": 2},
    "video_aa": {"warm_frames": 4, "traced_frames": 4, "strata": 2,
                 "frame_shards": 2},
    "still": {"warm_stills": 1, "traced_stills": 2, "sample_stills": 2},
}


def tiny(driver: str) -> dict:
    """The harness's overrides of a tiny CPU run of a ``driver`` cell."""
    return {"device": "cpu", "scene": dict(TINY_SCENE),
            "traffic": dict(TINY_TRAFFIC[driver])}


@pytest.fixture(scope="session")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cwd"))


@pytest.fixture
def in_workdir(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("TMPDIR", workdir)
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    return workdir
