"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery of configurations, mixes, drivers and metrics by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert SPEC["command"] == ["python3", "-m", "benchmark.run"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    per_run = SPEC["run_seconds"] + 60
    total = (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_have_their_files():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert set(c["reduced"]) == set(cfg["reduced"])
        if "n_frames" in cfg["reduced"]:
            assert cfg["scene"]["n_frames"] == cfg["reduced"]["n_frames"][1]
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert _line(w["why"])
        harness.load_traffic(w["traffic"])
    assert {w["config"] for w in SPEC["workloads"]} == configs
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        for c in m["workloads"]:
            assert c in cells
            assert "workloads" not in e2e[m["moves"]] or c in e2e[m["moves"]]["workloads"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(SPEC, "end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(SPEC, "per_layer", w["name"])


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader(name):
    read = harness.load_metric(name)
    assert read({}) is None  # nothing to read: nothing returned


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    cfg = harness.load_config(w["config"])
    assert set(cfg["limits"]) == {"frame_mean_abs", "frame_off1_share",
                                  "frame_far_share"}
    driver = harness.load_driver(harness.load_traffic(w["traffic"])["driver"])
    for fn in ("setup", "window", "end_to_end", "traced", "release", "check"):
        assert callable(getattr(driver, fn))


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A scene, a mix and a metric added as files (and entries) are found
    with no edit of the harness."""
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    cfg = harness.load_config("fhd_lifecycle")
    cfg["scene"]["fov"] = 60.0
    (tmp_path / "configs" / "new_scene.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "new_mix.json").write_text(
        json.dumps(dict(harness.load_traffic("video_orbit"), warm_frames=8)))
    (tmp_path / "metrics" / "new.metric.video.py").write_text(
        "def read(rec):\n    return len(rec.get('jobs', ())) or None\n")
    monkeypatch.setattr(harness, "BENCH_DIR", str(tmp_path))
    assert harness.load_config("new_scene")["scene"]["fov"] == 60.0
    assert harness.load_traffic("new_mix")["warm_frames"] == 8
    assert harness.load_metric("new.metric.video")({"jobs": [1, 2]}) == 2
    spec = dict(SPEC, workloads=SPEC["workloads"] + [
        {"name": "new_scene.new_mix", "config": "new_scene", "traffic": "new_mix",
         "chips": 1, "why": "a test cell"}])
    run = harness.Run("new_scene.new_mix", 5, 1.0, False,
                      overrides={"device": "cpu"}, spec=spec)
    try:
        assert run.scene["fov"] == 60.0 and run.traffic["warm_frames"] == 8
        assert run.scene["seed"] == run.scene["skybox_seed"] == 5
    finally:
        run.close()


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["bhr_tpu_torch", "bhr_tpu_torch.modes", "jaxtyping", "flaxen",
            "jax", "jax.numpy", "jaxlib.xla", "bhr_tpu", "bhr_tpu.ops", "flax.nn"]
    assert harness.forbidden_modules(mods) == [
        "bhr_tpu", "bhr_tpu.ops", "flax.nn", "jax", "jax.numpy", "jaxlib.xla"]


def test_scene_seed_takes_large_and_negative_seeds():
    assert harness.scene_seed(3_100_000_001) == 3_100_000_001
    assert 0 <= harness.scene_seed(-7) < 2 ** 63
