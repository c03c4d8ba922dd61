"""The still route over every still the CLI renders for a texture-model
scene, on the CPU at a tiny size: an extra cell, built here and absent
from ``BENCHMARK.json``, of ``uhd_aa_flare`` (AA and the lens flare)
under ``still_orbit`` with ``tile_shards`` 4 over four cards, as
``python -m bhr_tpu_torch.cli -r 4k --anti_alias lod_radius --lens_flare
--tile_shards 4`` renders it. The port's ``render_image_tiled`` is given
four CPU replicas in place of the four cards (inside these tests only).

A traced and an untraced run are correct and complete; the tiled still
is the untiled one within the limits; the faults a tiled AA + flare
still can have (the flare left out, every hit at mip level 0, one band
from another camera, one band black) and its controls fail the
comparison; the still reference's choice of scene."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import calibrate, calibrate_aa, compare, harness, run
from benchmark.drivers.still import expected_layers
from benchmark.reference import frame, frame_aa
from benchmark.reference.still import frames_of, reference_scene
from conftest import tiny

CELL = "uhd_aa_flare.tiled_4card"
TILES = 4
SEED = 3_000_000_029
LIMITS = harness.load_config("uhd_aa_flare")["limits"]


def _spec() -> dict:
    """``BENCHMARK.json`` with the extra cell, which reports what the
    still cells report."""
    spec = copy.deepcopy(harness.load_benchmark())
    spec["workloads"].append({
        "name": CELL, "config": "uhd_aa_flare", "traffic": "still_orbit",
        "chips": 4, "why": "4K AA + flare stills in four row bands over four cards"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "fhd_lifecycle.still" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    return spec


def _overrides(**traffic) -> dict:
    over = tiny("still")
    over["traffic"].update(tile_shards=TILES, **traffic)
    return over


@pytest.fixture
def tiled(in_workdir, monkeypatch):
    """The extra cell in ``BENCHMARK.json``, and ``render_image_tiled``
    on four CPU replicas; yields the count of tiled stills rendered."""
    from bhr_tpu_torch.parallel import frames

    spec = _spec()
    monkeypatch.setattr(harness, "load_benchmark", lambda root=harness.ROOT: spec)
    render = frames.render_image_tiled
    calls = [0]

    def on_four(config, devices=None, on_stage=None):
        calls[0] += 1
        return render(config, devices or [torch.device("cpu")] * TILES, on_stage)

    monkeypatch.setattr(frames, "render_image_tiled", on_four)
    return calls


def _line(capsys, trace=0, seed=SEED, overrides=None):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1",
                   "--trace", str(trace)], overrides=overrides or _overrides())
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiled_aa_flare_still_is_correct_and_complete(tiled, capsys, trace):
    line = _line(capsys, trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and tiled[0] >= line["attempted"]
    spec = harness.load_benchmark()
    kind = "per_layer" if trace else "end_to_end"
    # No device trace on the CPU; no Renderer.render in a tiled still.
    want = {m["name"] for m in harness.cell_metrics(spec, kind, CELL)
            if not trace or m["source"] != "device_trace"} - {"still.render_ms"}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    if trace:
        assert "still.lifecycle_ms" in line["metrics"]
    assert line["device"]["platform"] == "cpu"
    assert harness.forbidden_modules() == []


def test_a_tiled_still_expects_no_render_layer():
    scene = harness.load_config("uhd_aa_flare")["scene"]
    static = harness.load_config("fhd_static")["scene"]
    tiles = {"tile_shards": TILES}
    assert expected_layers(scene, tiles) == ("lifecycle",)
    assert expected_layers(scene, {"tile_shards": 1}) == ("render", "lifecycle")
    assert expected_layers(static, tiles) == ("generate",)
    assert expected_layers(scene, {}) == ("render", "lifecycle")


def test_the_tiled_still_is_the_untiled_one(tiled):
    from bhr_tpu_torch import modes
    from bhr_tpu_torch.config import SceneConfig
    from bhr_tpu_torch.utils.io import quantize_frame

    r = harness.Run(CELL, SEED, 1.0, False, overrides=_overrides())
    try:
        scene = dict(r.scene, pov=tuple(r.scene["pov"]))
    finally:
        r.close()
    whole = modes.render_image(SceneConfig(**scene))
    bands = modes.render_image(SceneConfig(**dict(scene, tile_shards=TILES)))
    assert tiled[0] == 1
    failed, numbers = compare.judge(
        [(0, quantize_frame(bands), quantize_frame(whole))], LIMITS)
    assert failed == [], numbers


def test_more_bands_than_chips_are_refused(in_workdir):
    with pytest.raises(ValueError, match="tile_shards 2"):
        run.main(["--workload", "fhd_lifecycle.still", "--seed", "5", "--seconds",
                  "1", "--trace", "0"],
                 overrides=dict(tiny("still"), traffic=dict(
                     tiny("still")["traffic"], tile_shards=2)))


# -- the faults a tiled AA + flare still can have ---------------------------


def _fails(capsys):
    line = _line(capsys)
    assert line["correct"] is False and line["failed"] > 0, line["check"]


def test_the_flare_left_out(tiled, capsys, monkeypatch):
    from bhr_tpu_torch.parallel import frames

    post = frames.post_process
    monkeypatch.setattr(frames, "post_process",
                        lambda bg, disk, bloom, flare: post(bg, disk, bloom, False))
    _fails(capsys)


def test_every_hit_at_mip_level_0(tiled, capsys, monkeypatch):
    from bhr_tpu_torch.parallel import frames

    shade = frames.shade_frame
    monkeypatch.setattr(frames, "shade_frame",
                        lambda *a, **k: shade(*a, **dict(k, aa_strength=0.0)))
    _fails(capsys)


def _wrap_bands(monkeypatch, change):
    """Make the tiled renderer's (1, 2, H, W, 3) layers ``change(layers,
    rows, render, args, config)``."""
    from bhr_tpu_torch.parallel import frames

    build = frames.build_sharded_frame_renderer

    def patched(mesh, config, width, height, *a, **k):
        render = build(mesh, config, width, height, *a, **k)
        rows = height // mesh.shape["tile"]

        def wrapped(*args):
            return change(render(*args), rows, render, args, config)

        return wrapped

    monkeypatch.setattr(frames, "build_sharded_frame_renderer", patched)


def test_one_band_from_another_camera(tiled, capsys, monkeypatch):
    """The second band's rows come from the camera one orbit step on."""
    from bhr_tpu_torch.camera import build_camera, orbit_camera_position
    from bhr_tpu_torch.parallel.frames import pack_cameras

    def other(layers, rows, render, args, config):
        width, height = config.image_size
        pos = orbit_camera_position(1, config.n_frames, config.orbit_degrees,
                                    config.pov)
        cams = pack_cameras([build_camera(pos, config.fov, width, height)])
        moved = render(args[0], args[1], cams, *args[3:])
        layers[:, :, rows:2 * rows] = moved[:, :, rows:2 * rows]
        return layers

    _wrap_bands(monkeypatch, other)
    _fails(capsys)


def test_one_band_left_black(tiled, capsys, monkeypatch):
    def black(layers, rows, render, args, config):
        layers[:, :, 2 * rows:3 * rows] = 0.0
        return layers

    _wrap_bands(monkeypatch, black)
    _fails(capsys)


# -- the controls -----------------------------------------------------------


@pytest.fixture(scope="module")
def controls(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("controls")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        lines = calibrate_aa.control_numbers(
            CELL, 23, tuple(calibrate_aa.CONTROLS), overrides=_overrides(),
            spec=_spec())
    return {line["control"]: line for line in lines}


@pytest.mark.parametrize("control", ["bf16", "level0", "noflare"])
def test_each_control_of_the_aa_still_fails_a_limit(controls, control):
    line = controls[control]
    assert line["failed"] > 0
    assert any(line[n] > LIMITS[n] for n in compare.NUMBERS), line


def test_calibrate_gives_the_aa_stills_bf16_control(in_workdir, controls):
    got = calibrate.control_numbers(CELL, 23, overrides=_overrides(), spec=_spec())
    assert {n: got[n] for n in compare.NUMBERS} == {
        n: controls["bf16"][n] for n in compare.NUMBERS}


def test_calibrate_aa_refuses_a_cell_without_aa(in_workdir, monkeypatch):
    with pytest.raises(ValueError, match="anti-aliased"):
        calibrate_aa.control_numbers("fhd_lifecycle.still", 23, overrides=tiny("still"))
    real = harness.load_traffic
    monkeypatch.setattr(harness, "load_traffic",
                        lambda name: dict(real(name), driver="unknown"))
    with pytest.raises(ValueError, match="unknown"):
        calibrate_aa.control_numbers(CELL, 23, overrides=_overrides(), spec=_spec())


# -- the still reference's choice of scene ----------------------------------


def _scene(config, **changes):
    return dict(harness.load_config(config)["scene"], width=64, height=36,
                **changes)


def test_the_reference_scene_of_a_still():
    cpu = torch.device("cpu")
    assert type(reference_scene(_scene("uhd_aa_flare"), cpu)) is frame_aa.Scene
    assert type(reference_scene(_scene("fhd_lifecycle"), cpu)) is frame.Scene
    assert type(reference_scene(_scene("fhd_static"), cpu)) is frame.Scene
    assert reference_scene(_scene("uhd_aa_flare"), cpu, lowp=True).lowp
    with pytest.raises(ValueError, match="texture-model"):
        reference_scene(_scene("fhd_v2"), cpu)
    with pytest.raises(ValueError, match="from a file"):
        reference_scene(_scene("fhd_lifecycle", disk_texture="disk.npy"), cpu)


@pytest.mark.parametrize("changes", [
    {"anti_alias": "disabled", "lens_flare": True},
    {"disk_texture": "auto", "disk_generation_scale": 2},
], ids=["flare_without_aa", "static_aa_flare"])
def test_the_port_matches_the_chosen_reference(in_workdir, changes):
    """A still the CLI renders that no cell has (the flare without AA; the
    static disk with AA and the flare) against the reference that
    ``reference_scene`` chooses for it."""
    from bhr_tpu_torch import modes
    from bhr_tpu_torch.config import SceneConfig
    from bhr_tpu_torch.utils.io import quantize_frame

    scene = _scene("uhd_aa_flare", device="cpu", seed=77, **changes)
    img = modes.render_image(SceneConfig(**dict(scene, pov=tuple(scene["pov"]))))
    ref = frames_of(reference_scene(scene, torch.device("cpu")),
                    {0: (tuple(scene["pov"]), 77)})[0].numpy()
    failed, numbers = compare.judge([(0, quantize_frame(img), ref)], LIMITS)
    assert failed == [], numbers
    assert not np.array_equal(quantize_frame(img), np.zeros_like(ref))
