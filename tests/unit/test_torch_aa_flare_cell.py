"""The benchmark's 4K anti-aliased, lens-flared orbit video
(``uhd_aa_flare``) and the V2 session cell, on the CPU at 64 x 36.

* The batched video engine's ``mips`` and ``flare`` stages: a scene with
  AA and the flare reports ``texture, mips, trace, shade, post, flare``
  (``frame_stages``, ``stage_ms``, the spans ``frame.mips`` and
  ``frame.flare`` once a frame), and its PNG frames are bit-equal to
  ``pipeline.post_process(use_flare=True)`` of the same shaded layers;
  the benchmark's other scenes keep their stages and keys.
* The AA reference (``benchmark/reference/frame_aa.py``) agrees with the
  port's plain path within the configuration's limits, and each control
  of ``benchmark/calibrate_aa.py`` (bfloat16, mip level 0, no flare)
  fails at least one of them.
* One process a new cell runs the harness (``benchmark.run.main``'s
  ``overrides``) with ``--trace 0`` and ``--trace 1``: both come out
  correct and report what ``cell_metrics`` lists (a CPU run has no
  device trace, so the metrics read from one are absent).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import calibrate_aa, compare, harness  # noqa: E402
from benchmark.drivers.video import _frames_dir  # noqa: E402
from benchmark.reference import frame, frame_aa  # noqa: E402
from bhr_tpu_torch import pipeline  # noqa: E402
from bhr_tpu_torch.config import SceneConfig  # noqa: E402
from bhr_tpu_torch.parallel import video as tvideo  # noqa: E402
from bhr_tpu_torch.utils.profiling import SPANS  # noqa: E402

CPU = torch.device("cpu")
SIZE = {"width": 64, "height": 36, "n_frames": 4}
SEED = 3000000123
AA_STAGES = ("texture", "mips", "trace", "shade", "post", "flare")
TOP = ("job_setup", "enqueue", "record", "finish")


def _scene(config: str, **changes) -> dict:
    scene = dict(harness.load_config(config)["scene"], **SIZE, **changes)
    scene["seed"] = scene["skybox_seed"] = harness.scene_seed(SEED)
    return scene


def _config(scene: dict, output: str) -> SceneConfig:
    return SceneConfig(**dict(scene, pov=tuple(scene["pov"]), device="cpu",
                              video=True, orbit=True, output=output)).validated()


def _render(tmp: str, config: str) -> tuple:
    """A tiny orbit job of ``config``'s scene on two CPU slots, in ``tmp``
    (the port caches its skybox under the working directory): (scene,
    stats, PNG frames, span mark, [(bg, disk)] of each shade)."""
    scene = _scene(config)
    output = os.path.join(tmp, "orbit.mp4")
    layers = []

    def shade(*args, **kwargs):
        out = shade_frame(*args, **kwargs)
        layers.append(out[:2])
        return out

    shade_frame = tvideo.shade_frame
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvideo, "shade_frame", shade)
        os.chdir(tmp)
        try:
            mark = SPANS.mark()
            stats = tvideo.render_video_sharded(_config(scene, output),
                                                devices=[CPU] * 2)
        finally:
            os.chdir(cwd)
    pngs = []
    for f in range(SIZE["n_frames"]):
        path = os.path.join(_frames_dir(output), f"frame_{f:04d}.png")
        with Image.open(path) as im:
            pngs.append(np.asarray(im.convert("RGB")))
    return scene, stats, pngs, mark, layers


@pytest.fixture(scope="module")
def aa_job(tmp_path_factory):
    return _render(str(tmp_path_factory.mktemp("aa_job")), "uhd_aa_flare")


@pytest.mark.parametrize("config,stages", [
    ("fhd_lifecycle", ("texture", "trace", "shade", "post")),
    ("fhd_v2", ("trace", "shade", "post")),
    ("uhd_aa_flare", AA_STAGES),
])
def test_each_configuration_keeps_its_stages_and_keys(request, tmp_path, config,
                                                      stages):
    scene = _scene(config)
    assert tvideo.frame_stages(_config(scene, "v.mp4")) == stages
    _, stats, _, _, _ = (request.getfixturevalue("aa_job") if config == "uhd_aa_flare"
                         else _render(str(tmp_path), config))
    background = () if scene["disk_model"] == "v2" else ("background",)
    assert set(stats["stage_ms"]) == {*background, *stages, "fetch", "png", "h264",
                                      "hit_sync", *TOP}
    assert all(stats["stage_ms"][s] > 0 for s in stages)


def test_the_flare_and_mips_stages_are_spans_once_a_frame(aa_job):
    _, stats, _, mark, _ = aa_job
    n = SIZE["n_frames"]
    assert stats["frames"] == n
    for stage in AA_STAGES:
        assert SPANS.count(f"frame.{stage}", mark) == n, stage
        assert SPANS.parents[f"frame.{stage}"] == "video.enqueue"


def test_split_stages_give_post_process_with_the_flare_bit_for_bit(aa_job):
    scene, _, pngs, _, layers = aa_job
    assert len(layers) == len(pngs)
    shape = (scene["height"], scene["width"], 3)
    for png, (bg, disk) in zip(pngs, layers):
        final = pipeline.post_process(bg.reshape(shape), disk.reshape(shape),
                                      True, True)
        want = torch.round(final * 255.0).to(torch.uint8).numpy()
        np.testing.assert_array_equal(png, want)
    # The flare is in the frames: without it they differ.
    bg, disk = layers[0]
    plain = pipeline.post_process(bg.reshape(shape), disk.reshape(shape), True, False)
    assert not np.array_equal(pngs[0], torch.round(plain * 255.0).to(torch.uint8).numpy())


def test_the_aa_reference_agrees_with_the_plain_path(aa_job):
    scene, _, pngs, _, _ = aa_job
    n = SIZE["n_frames"]
    ref = frame.video_frames(frame_aa.Scene(scene, CPU), n, range(n))
    failed, numbers = compare.judge(
        ((f, pngs[f], ref[f].numpy()) for f in range(n)),
        harness.load_config("uhd_aa_flare")["limits"])
    assert failed == []
    assert all(value <= limit for _, value, limit in numbers), numbers


@pytest.fixture(scope="module")
def controls():
    over = {"device": "cpu", "scene": dict(SIZE), "traffic": {"strata": 2}}
    lines = calibrate_aa.control_numbers(
        "uhd_aa_flare.video", SEED, tuple(calibrate_aa.CONTROLS), overrides=over)
    return {line["control"]: line for line in lines}


@pytest.mark.parametrize("control", ["bf16", "level0", "noflare"])
def test_each_control_fails_a_limit(controls, control):
    limits = harness.load_config("uhd_aa_flare")["limits"]
    line = controls[control]
    assert line["failed"] > 0
    assert any(line[n] > limits[n] for n in compare.NUMBERS), line


def test_the_aa_reference_refuses_a_scene_without_aa():
    with pytest.raises(ValueError):
        frame_aa.Scene(_scene("fhd_lifecycle"), CPU)
    with pytest.raises(ValueError):
        frame_aa.Scene(_scene("fhd_v2", anti_alias="lod_radius"), CPU)


def test_the_video_metrics_read_the_aa_drivers_record(monkeypatch):
    from benchmark.drivers import video, video_aa

    monkeypatch.setattr(video, "setup", lambda run: None)
    run = harness.Run("uhd_aa_flare.video", SEED, 1.0, True,
                      overrides={"device": "cpu"})
    try:
        video_aa.setup(run)
        run.rec["profile"] = {"launches": 400, "frames": 4, "busy_s": {0: 3.0},
                              "wall_s": 4.0}
        assert harness.load_metric("engine.launches_per_frame.video")(run.rec) == 100
        assert harness.load_metric("device.idle_share.video")(run.rec) == pytest.approx(25)
    finally:
        run.close()


TRAFFIC = {
    "uhd_aa_flare.video": {"warm_frames": 2, "traced_frames": 2, "strata": 2,
                           "frame_shards": 2},
    "fhd_v2.session": {"warm_steps": 3, "traced_steps": 2, "key_steps": 2,
                       "sample_steps": 2},
}


@pytest.mark.parametrize("workload", sorted(TRAFFIC))
def test_a_tiny_run_of_each_new_cell_is_correct_and_complete(tmp_path, workload):
    # A process of its own, as the benchmark runs (this one has loaded
    # JAX, which a run refuses): both runs of the cell, --trace 0 then 1.
    overrides = {"device": "cpu", "scene": dict(SIZE), "traffic": TRAFFIC[workload]}
    args = ["--workload", workload, "--seed", str(SEED), "--seconds", "1"]
    code = ("import sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from benchmark import run\n"
            f"for trace in ('0', '1'):\n"
            f"    rc = run.main({args!r} + ['--trace', trace], overrides={overrides!r})\n"
            "    if rc:\n"
            "        sys.exit(rc)\n")
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 2
    spec = harness.load_benchmark()
    e2e = {m["name"] for m in harness.cell_metrics(spec, "end_to_end", workload)}
    # A CPU run has no device trace: the metrics read from one are absent.
    layer = {m["name"] for m in harness.cell_metrics(spec, "per_layer", workload)
             if m["source"] != "device_trace"}
    for line, want in zip(lines, (e2e, layer)):
        assert line["correct"] is True
        assert set(line["metrics"]) == want
        assert all(np.isfinite(v["value"]) for v in line["metrics"].values())
    if workload == "uhd_aa_flare.video":
        assert {"mips.ms_per_frame.video", "flare.ms_per_frame.video"} <= layer


def test_the_new_cells_are_listed_where_they_report():
    spec = harness.load_benchmark()
    by_name = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for name in ("video_fps", "ray_march_roofline", "texture.ms_per_frame.video",
                 "shade.ms_per_frame.video", "post.ms_per_frame.video",
                 "mips.ms_per_frame.video", "flare.ms_per_frame.video"):
        assert "uhd_aa_flare.video" in by_name[name]["workloads"], name
    assert "uhd_aa_flare.video" not in by_name["shade_v2.ms_per_frame.video"]["workloads"]
    for name in ("session_fps", "session_frame_ms_p90", "session.enqueue_ms",
                 "device.idle_share.session"):
        assert "fhd_v2.session" in by_name[name]["workloads"], name
    cfg = dataclasses.asdict(_config(_scene("uhd_aa_flare"), "v.mp4"))
    assert cfg["anti_alias"] == "lod_radius" and cfg["lens_flare"] is True
