"""``bhr_tpu_torch.bench``'s round-over-round regression gate.

The eight cases of ``test_bench_gate.py`` rewritten against the port's
gate (the port's shares in place of ``vpu_*``), and a case for each of
the two faults of ``bench.py``'s gate that the port fixes: a retry that
raises or reads no number dropped the first reading and its flag
(``bench.py:752``), and a run could compare against its own round's
artifact, or the TPU's root ``BENCH_r*.json`` (``bench.py:671``). No
device is touched.
"""

import json

import pytest
import torch

from bhr_tpu_torch import bench


def _write(path, obj):
    path.write_text(json.dumps(obj))


def _line(value, **metrics):
    return {"metric": "fhd_dynamic_frame_ms", "value": value, **metrics}


def test_metric_directions():
    assert bench._metric_direction("value") == "lower"
    assert bench._metric_direction("fhd_trace_ms") == "lower"
    assert bench._metric_direction("gather_ns_per_index") == "lower"
    assert bench._metric_direction("sd_video_fps") == "higher"
    assert bench._metric_direction("sd_video_steady_fps") == "higher"
    assert bench._metric_direction("mray_steps_per_s_aa") == "higher"
    assert bench._metric_direction("fp32_bound_share") == "higher"
    assert bench._metric_direction("issue_bound_share_aa") == "higher"
    assert bench._metric_direction("vs_baseline") == "higher"
    # The host's and the card's state, not the program's: not gated.
    assert bench._metric_direction("launch_us") is None
    assert bench._metric_direction("fhd_device_busy_share") is None
    assert bench._metric_direction("e2e_golden") is None
    assert bench._metric_direction("metric") is None


def test_regression_check_flags_and_skips(monkeypatch):
    monkeypatch.setattr(bench, "REDEFINED_IN_ROUND", 5)
    monkeypatch.setitem(bench.REDEFINED_METRICS, "issue_bound_share", "recalibrated")
    prev = {"round": 4, "metrics": {  # an artifact from before the redefinition
        "value": 50.0,                # ms, lower-better
        "fhd_trace_ms": 16.0,
        "sd_video_fps": 14.0,         # higher-better
        "issue_bound_share": 0.70,    # redefined -> skipped against round 4
        "sd_frame_ms": "error: x",    # not a number -> skipped
        "e2e_golden": {"aa": True},
    }}
    result = {
        "value": 56.0,                # 12% worse -> flagged
        "fhd_trace_ms": 16.4,         # 2.5% -> within the tolerance
        "sd_video_fps": 10.0,         # 29% worse -> flagged
        "issue_bound_share": 0.40,    # worse, but redefined
        "sd_frame_ms": 7.0,
    }
    bench.regression_check(result, prev)
    assert result["vs_prev_round"] == 4
    assert set(result["regressions"]) == {"value", "sd_video_fps"}
    assert result["regressions"]["value"]["worse_pct"] == 12.0
    assert result["metric_notes"]["issue_bound_share"] == "recalibrated"


def test_redefined_skip_expires_after_recalibration_round(monkeypatch):
    # Against an artifact of the redefining round itself, a real drop is
    # flagged again: a permanent skip would hide drift for good.
    monkeypatch.setattr(bench, "REDEFINED_IN_ROUND", 5)
    monkeypatch.setitem(bench.REDEFINED_METRICS, "issue_bound_share", "recalibrated")
    result = {"issue_bound_share": 0.50}
    bench.regression_check(result, {"round": 5, "metrics": {"issue_bound_share": 0.61}})
    assert "issue_bound_share" in result.get("regressions", {})
    assert "metric_notes" not in result


def test_regression_check_improvements_silent():
    result = {"value": 55.0, "sd_video_fps": 14.0}
    bench.regression_check(result, {"round": 3, "metrics": {"value": 60.0,
                                                            "sd_video_fps": 10.0}})
    assert result["vs_prev_round"] == 3
    assert "regressions" not in result


def test_load_prev_artifact_picks_latest(tmp_path):
    _write(tmp_path / "BENCH_TORCH_r03.json", {"parsed": _line(60.0)})
    _write(tmp_path / "BENCH_TORCH_r04.json", _line(58.0))  # the bench's own line
    (tmp_path / "BENCH_TORCH_rXX.json").write_text("not json")
    (tmp_path / "BENCH_TORCH_r02.json").write_text("{broken")
    prev = bench.load_prev_artifact(str(tmp_path), 9)
    assert prev["round"] == 4
    assert prev["metrics"]["value"] == 58.0


def _rerun(result):
    def rerun(key, fn):
        result[key] = fn()
    return rerun


def test_retry_flagged_self_heals_glitch():
    prev = {"round": 7, "metrics": {"v2_frame_ms": 49.0, "sd_frame_ms": 7.3}}
    result = {"v2_frame_ms": 62.0, "sd_frame_ms": 7.4}
    bench.regression_check(result, prev)
    assert "v2_frame_ms" in result["regressions"]
    bench.retry_flagged(result, {"v2_frame_ms": lambda: 49.2}, _rerun(result), prev)
    assert result["retried"] == ["v2_frame_ms"]
    assert "regressions" not in result
    assert result["v2_frame_ms"] == 49.2


def test_retry_flagged_true_regression_stays():
    prev = {"round": 7, "metrics": {"v2_frame_ms": 49.0}}
    result = {"v2_frame_ms": 62.0}
    bench.regression_check(result, prev)
    bench.retry_flagged(result, {"v2_frame_ms": lambda: 61.5}, _rerun(result), prev)
    assert result["retried"] == ["v2_frame_ms"]
    assert result["regressions"]["v2_frame_ms"]["now"] == 61.5


def test_retry_flagged_maps_submetrics_to_parent_aux():
    # The shares and the step rate re-run their trace measurement once,
    # not once per flagged key; the headline (no function) stays flagged.
    prev = {"round": 7, "metrics": {"value": 50.0, "mray_steps_per_s": 9200.0,
                                    "fp32_bound_share": 0.47}}
    result = {"value": 60.0, "mray_steps_per_s": 8000.0, "fp32_bound_share": 0.40}
    bench.regression_check(result, prev)
    assert set(result["regressions"]) == {"value", "mray_steps_per_s",
                                          "fp32_bound_share"}
    calls = []

    def trace_fn():
        result["mray_steps_per_s"] = 9250.0
        result["fp32_bound_share"] = 0.472
        return 16.2

    def rerun(key, fn):
        calls.append(key)
        result[key] = fn()

    bench.retry_flagged(result, {"fhd_trace_ms": trace_fn}, rerun, prev)
    assert calls == ["fhd_trace_ms"]
    assert set(result["regressions"]) == {"value"}


@pytest.mark.parametrize("failure", ["raises", "error string", "no number"])
def test_failed_retry_keeps_the_reading_and_its_flag(failure):
    # bench.py:752 let a failed re-measure replace the reading with an
    # error string, which the gate then skipped: the flag vanished.
    prev = {"round": 7, "metrics": {"fhd_trace_ms": 1.0, "mray_steps_per_s": 150.0}}
    result = {"fhd_trace_ms": 1.2, "mray_steps_per_s": 125.0}
    bench.regression_check(result, prev)

    def rerun(key, fn):
        if failure == "raises":
            raise RuntimeError("device lost")
        result["mray_steps_per_s"] = None
        result[key] = "error: RuntimeError: device lost" if failure == "error string" else None

    bench.retry_flagged(result, {"fhd_trace_ms": lambda: 1.0}, rerun, prev)
    assert result["fhd_trace_ms"] == 1.2 and result["mray_steps_per_s"] == 125.0
    assert set(result["regressions"]) == {"fhd_trace_ms", "mray_steps_per_s"}
    assert "fhd_trace_ms" in result["retry_failed"]


def test_current_and_later_rounds_are_never_previous(tmp_path):
    # bench.py:671 took the newest artifact, which is this round's own
    # once it has been written (a re-run of a round compared with itself).
    for n, ms in ((2, 60.0), (5, 58.0), (7, 40.0)):
        _write(tmp_path / f"BENCH_TORCH_r{n:02d}.json", _line(ms))
    assert bench.load_prev_artifact(str(tmp_path), 5) == {
        "round": 2, "metrics": _line(60.0)}
    assert bench.load_prev_artifact(str(tmp_path), 2)["round"] == -1
    result = {"value": 80.0}
    bench.regression_check(result, bench.load_prev_artifact(str(tmp_path), 2))
    assert result["vs_prev_round"] is None and "regressions" not in result


def test_root_style_artifacts_are_never_read(tmp_path):
    # The repository's BENCH_r*.json are a TPU's: never a baseline here.
    _write(tmp_path / "BENCH_r09.json", {"parsed": _line(5.0)})
    _write(tmp_path / "BENCH_r10.json", _line(5.0))
    assert bench.load_prev_artifact(str(tmp_path), 11) == {"round": -1, "metrics": {}}


def test_main_gates_against_its_directory_and_writes_its_round(tmp_path, monkeypatch,
                                                               capsys):
    # main's flow with every measurement replaced: the previous round is
    # read from --artifacts, the line is printed and written for --round.
    _write(tmp_path / "BENCH_TORCH_r02.json", _line(100.0, sd_frame_ms=30.0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a test card")
    monkeypatch.setattr(bench, "gpu_query", lambda field: "700.00")
    monkeypatch.setattr(bench, "_start_stall_watchdog", lambda *a: None)

    def run_bench(result, state, log):
        result.update(_line(120.0, sd_frame_ms=30.5))
        return {}

    monkeypatch.setattr(bench, "run_bench", run_bench)
    assert bench.main(["--round", "3", "--artifacts", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["vs_prev_round"] == 2 and set(line["regressions"]) == {"value"}
    assert line["device"] == "a test card" and line["power_limit_w"] == 700.0
    written = json.loads((tmp_path / "BENCH_TORCH_r03.json").read_text())
    assert written == line
