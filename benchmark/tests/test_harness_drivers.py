"""Each driver through a whole run on the CPU at a tiny size (the
harness's test path), the shape of the last line, and the real command's
refusal of a host without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, run
from conftest import ROOT, tiny

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(capsys, workload, driver, trace=0, seed=3_000_000_019, seconds=1.0):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], overrides=tiny(driver))
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("workload,driver,trace", [
    ("fhd_lifecycle.video", "video", 0),
    ("fhd_lifecycle.video", "video", 1),
    ("fhd_v2.video", "video", 1),
    ("fhd_lifecycle.session", "session", 0),
    ("fhd_lifecycle.session", "session", 1),
    ("fhd_lifecycle.video_4card", "video", 0),
])
def test_a_tiny_run_is_correct(in_workdir, capsys, workload, driver, trace):
    rc, line, err = _run(capsys, workload, driver, trace)
    assert rc == 0
    assert set(line) - {"breakdown", "check"} == RESULT_KEYS
    assert list(line)[-1] == "check"  # the numbers compared come last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    spec = harness.load_benchmark()
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(spec, kind, workload)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert "breakdown" in line and {"busy_s", "window_s"} <= set(line["device"])
    for name, c in line["check"].items():
        assert c["value"] <= c["limit"]
        assert f"check {name} " in err.strip().splitlines()[-3 + list(line["check"]).index(name)]
    assert line["device"]["platform"] == "cpu"  # never a device metric's name
    assert harness.forbidden_modules() == []


def test_the_command_refuses_a_host_without_a_card(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fhd_lifecycle.video", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA cards" in p.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    exits with an error and prints no result (here through the CPU test
    path, which skips the look for a card: the port's import fails)."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'benchmark/tests')\n"
            "from conftest import tiny\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', 'fhd_lifecycle.video', '--seed',"
            " '1', '--seconds', '1', '--trace', '0'], overrides=tiny('video')))\n")
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "bhr_tpu_torch" in p.stderr


def test_no_jax_in_a_whole_run(tmp_path):
    """A run in a fresh process loads no module of JAX or the JAX
    package (top-level names compared whole: bhr_tpu_torch passes)."""
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny\n"
        "from benchmark import run, harness\n"
        "rc = run.main(['--workload', 'fhd_lifecycle.session', '--seed', '4',"
        " '--seconds', '1', '--trace', '0'], overrides=tiny('session'))\n"
        "print(json.dumps({'rc': rc, 'bad': harness.forbidden_modules(),"
        " 'port': 'bhr_tpu_torch' in sys.modules}))\n"
    ) % (ROOT, os.path.join(ROOT, "benchmark", "tests"))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=dict(os.environ, TMPDIR=str(tmp_path)),
                       capture_output=True, text=True, timeout=600)
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "bad": [], "port": True}


@pytest.mark.parametrize("strata", [4, 16])
def test_the_video_sample_covers_every_place_of_a_batch(strata):
    """One frame for each place of a batch (each card, each slot on it),
    drawn from the seed, and the last frame."""
    from benchmark.drivers.video import sample_frames

    for seed in (1, 3_000_000_019, 2 ** 31 + 5):
        got = sample_frames(96, strata, seed)
        assert {f % strata for f in got} == set(range(strata))
        assert 95 in got and all(0 <= f < 96 for f in got)
        assert got == sample_frames(96, strata, seed)
    assert len({tuple(sample_frames(96, strata, s)) for s in range(8)}) > 1


@pytest.mark.parametrize("seen,chips,want", [
    (None, 1, "0"), (None, 4, "0,1,2,3"), ("3,5,7", 1, "3"),
    ("GPU-a,GPU-b,GPU-c,GPU-d,GPU-e", 4, "GPU-a,GPU-b,GPU-c,GPU-d"),
])
def test_cuda_sees_only_the_cells_cards(monkeypatch, seen, chips, want):
    if seen is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", seen)
    run._visible_cards(chips)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == want


def test_a_run_leaves_nothing_in_its_working_directory(tmp_path, monkeypatch, capsys):
    """The port's skybox cache lands in the run's own scratch directory,
    which goes with the run: every run makes its skybox afresh."""
    import tempfile

    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(scratch))
    monkeypatch.setattr(tempfile, "tempdir", None)
    rc, line, err = _run(capsys, "fhd_lifecycle.video", "video")
    assert rc == 0 and line["correct"] is True
    assert "skybox cache: miss" in err
    assert sorted(os.listdir(tmp_path)) == ["tmp"]
    assert os.listdir(scratch) == []
    assert os.getcwd() == str(tmp_path)


def test_the_session_records_each_steps_time_and_times_key_steps(in_workdir, capsys):
    """A traced session run reports its key steps apart and compares the
    last one's frame, its own (the lookahead dropped)."""
    rc, line, err = _run(capsys, "fhd_lifecycle.session", "session", trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["session.state_key_step_ms"]["value"] > 0
    assert "key steps: 2" in err


def test_the_script_shows_a_key_steps_own_frame():
    from benchmark.drivers.session import CLAMP_DT, Script

    s = Script(harness.load_traffic("session_script"), 7)
    s.keys[5] = ["+"]
    s.dts[3] = 0.04
    assert [s.shown(i) for i in range(7)] == [0, 0, 1, 2, 3, 5, 5]
    assert s[3][2] == 0.04 and s[4][2] == CLAMP_DT
    assert s[5][0] == ["+"] and s[4][0] == []
    assert Script(harness.load_traffic("session_script"), 7)[6][1] == s[6][1]
