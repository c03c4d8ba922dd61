"""The still driver on the CPU at a tiny size (the harness's test path):
a whole run of each still cell (the cells whose traffic's driver is
``still``), traced and not; the stills' cameras, seeds, sample, timed
layers and reference frames as they stood before the still route took
AA, the flare and row bands; the still metrics' readers; and the frozen
static generator held to the port's. The faults a still can have are in
``test_harness_faults.py``, the control in ``test_harness_control.py``,
the route's AA + flare still in row bands in
``test_harness_still_tiled.py``."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from benchmark import harness, run
from benchmark.drivers.still import expected_layers, sample_stills, still_plan
from conftest import TINY_SCENE, tiny

SPEC = harness.load_benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]
         if harness.load_traffic(w["traffic"])["driver"] == "still"]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
# The metric that reads each layer the driver's timers time.
LAYER_METRICS = {"render": "still.render_ms", "lifecycle": "still.lifecycle_ms",
                 "generate": "static.generate_ms"}


def _line(capsys, workload, trace=0, seed=3_000_000_019):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   "1", "--trace", str(trace)], overrides=tiny("still"))
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_is_correct_and_complete(in_workdir, capsys, workload, trace):
    line, err = _line(capsys, workload, trace)
    assert set(line) - {"breakdown", "check"} == RESULT_KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    spec = harness.load_benchmark()
    kind = "per_layer" if trace else "end_to_end"
    # A CPU run has no device trace: the metrics read from one are absent.
    want = {m["name"] for m in harness.cell_metrics(spec, kind, workload)
            if not trace or m["source"] != "device_trace"}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    if trace:
        cell = harness.find_cell(spec, workload)
        layers = expected_layers(harness.load_config(cell["config"])["scene"],
                                 harness.load_traffic(cell["traffic"]))
        assert layers
        for layer in layers:
            if LAYER_METRICS[layer] in want:
                assert LAYER_METRICS[layer] in line["metrics"]
        assert "breakdown" in line and {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["platform"] == "cpu"
    assert harness.forbidden_modules() == []


def test_a_layer_the_timers_miss_fails_the_traced_run(in_workdir, monkeypatch):
    """The program reaching the generator by a name the driver's timer
    does not patch (its import moved to the module's top) fails the
    traced run, where ``static.generate_ms`` would otherwise go unread."""
    from bhr_tpu_torch.models import disk_texture
    from bhr_tpu_torch.utils import cache

    generate, load = disk_texture.generate_disk_texture, cache.load_cached_disk_texture

    def untimed(*args, **kwargs):
        timed = disk_texture.generate_disk_texture
        disk_texture.generate_disk_texture = generate
        try:
            return load(*args, **kwargs)
        finally:
            disk_texture.generate_disk_texture = timed

    monkeypatch.setattr(cache, "load_cached_disk_texture", untimed)
    with pytest.raises(RuntimeError, match="layer timers"):
        run.main(["--workload", "fhd_static.still", "--seed", "3000000021",
                  "--seconds", "1", "--trace", "1"], overrides=tiny("still"))


def test_the_stills_cameras_and_seeds():
    spec = harness.load_benchmark()
    orbit = harness.Run("fhd_lifecycle.still", 5, 1.0, False,
                        overrides={"device": "cpu"}, spec=spec)
    seeds = harness.Run("fhd_static.still", 5, 1.0, False,
                        overrides={"device": "cpu"}, spec=spec)
    try:
        n = int(orbit.scene["n_frames"])
        plans = [still_plan(orbit.scene, orbit.traffic, 5, k) for k in range(2 * n)]
        assert {s for _, s in plans} == {orbit.scene["seed"]} == {5}
        assert plans[3] == plans[n + 3] and plans[0][0] != plans[1][0]
        radius = [sum(c * c for c in pos) for pos, _ in plans]
        assert max(radius) - min(radius) < 1e-9  # one orbit, one distance
        got = [still_plan(seeds.scene, seeds.traffic, 2 ** 31 + 7, k) for k in range(50)]
        assert {pos for pos, _ in got} == {tuple(seeds.scene["pov"])}
        assert len({s for _, s in got}) == 50
        assert got == [still_plan(seeds.scene, seeds.traffic, 2 ** 31 + 7, k)
                       for k in range(50)]
        assert got != [still_plan(seeds.scene, seeds.traffic, 8, k) for k in range(50)]
    finally:
        orbit.close()
        seeds.close()


def test_the_sample_is_drawn_from_the_seed():
    for seed in (1, 3_000_000_019, 2 ** 31 + 5):
        got = sample_stills(500, 4, seed)
        assert len(set(got)) == 4 and all(0 <= i < 500 for i in got)
        assert got == sample_stills(500, 4, seed)
    assert sample_stills(3, 4, 9) == [0, 1, 2]
    assert len({tuple(sample_stills(500, 4, s)) for s in range(8)}) > 1


def test_the_still_metrics_read_only_a_still_run():
    names = ("still.launches_per_still", "device.idle_share.still",
             "still.render_ms", "still.write_ms", "still.lifecycle_ms",
             "static.generate_ms")
    video = {"driver": "video", "jobs": [], "profile": {"launches": 8, "frames": 2,
                                                        "busy_s": {0: 1.0}, "wall_s": 2.0}}
    still = {"driver": "still", "n_devices": 1,
             "stills": [{"write_ms": 3.0}, {"write_ms": 5.0}, {"write_ms": 4.0}],
             "profile": {"launches": 8, "frames": 2, "busy_s": {0: 1.0}, "wall_s": 4.0},
             "layers": {"render": [2.0, 6.0, 4.0], "lifecycle": [], "generate": [7.0]}}
    for name in names:
        read = harness.load_metric(name)
        assert read({}) is None and read(video) is None, name
    read = {n: harness.load_metric(n)(still) for n in names}
    assert read == {"still.launches_per_still": 4.0, "device.idle_share.still": 75.0,
                    "still.render_ms": 4.0, "still.write_ms": 4.0,
                    "still.lifecycle_ms": None, "static.generate_ms": 7.0}


# -- the two still cells as they stood, and the reference's frames ----------

# Read at the commit before the still route took AA, the flare and row
# bands, at the tests' tiny size, seed 3000000019, one CPU thread:
# {cell: (plans of stills 0, 1, 5 and 9, the sample of 4 of 40 stills,
# the timed layers, the first 16 hex digits of the SHA-256 of each
# reference frame's bytes, of the control's frame of still 1)}.
BEFORE = {
    "fhd_lifecycle.still": (
        {0: ((6.020797289396148, 0.0, 0.5), 3000000019),
         1: ((4.257346591481601, 4.2573465914816, 0.5), 3000000019),
         5: ((-4.2573465914816015, -4.2573465914816, 0.5), 3000000019),
         9: ((4.257346591481601, 4.2573465914816, 0.5), 3000000019)},
        [20, 23, 26, 38], ("render", "lifecycle"),
        {0: "6e8d5003903ffd8d", 1: "e9b3b8a1ee5c794a", 5: "56494ccd8698290b",
         9: "e9b3b8a1ee5c794a"}, "7327fcb1ad305500"),
    "fhd_static.still": (
        {0: ((6.0, 0.0, 0.5), 3085169222), 1: ((6.0, 0.0, 0.5), 3249636620),
         5: ((6.0, 0.0, 0.5), 1833463066), 9: ((6.0, 0.0, 0.5), 921007422)},
        [20, 23, 26, 38], ("render", "generate"),
        {0: "1bfad33f19d38d66", 1: "7e231da4b566aad7", 5: "96f3e895fbc0a40e",
         9: "564bc410a1c7ff21"}, "3b18647caaddc95b"),
}
# The same of the videos' reference frames 0 and 5 and the control's 3
# (the plain and the AA reference share their stages with the stills').
VIDEOS_BEFORE = {
    "fhd_lifecycle.video": ({0: "6e8d5003903ffd8d", 5: "33bf92ec249a738b"},
                            "59191c15be5df806"),
    "fhd_v2.video": ({0: "da126db848798506", 5: "4165107fc7708719"},
                     "78064bb81bc75c3e"),
    "uhd_aa_flare.video": ({0: "04a45fc4d8d35e94", 5: "511b63b8bd55e4dc"},
                           "0ab5223984003785"),
}
GOLDEN_SEED = 3_000_000_019


def _digests(frames):
    return {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()[:16]
            for k, v in frames.items()}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_run(cell):
    return harness.Run(cell, GOLDEN_SEED, 1.0, False,
                       overrides={"device": "cpu", "scene": dict(TINY_SCENE)})


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_the_still_cells_read_as_before(in_workdir, one_thread, cell):
    from benchmark.reference.still import frames_of, reference_scene

    plans, sample, layers, frames, lowp = BEFORE[cell]
    r = _tiny_run(cell)
    try:
        got = {k: still_plan(r.scene, r.traffic, GOLDEN_SEED, k) for k in plans}
        assert got == plans
        assert sample_stills(40, 4, GOLDEN_SEED) == sample
        assert expected_layers(r.scene, r.traffic) == layers
        assert _digests(frames_of(reference_scene(r.scene, "cpu"), got)) == frames
        ctl = frames_of(reference_scene(r.scene, "cpu", lowp=True), {1: got[1]})
        assert _digests(ctl) == {1: lowp}
    finally:
        r.close()


@pytest.mark.parametrize("cell", sorted(VIDEOS_BEFORE))
def test_the_video_reference_frames_are_as_before(in_workdir, one_thread, cell):
    from benchmark.reference import frame, frame_aa

    frames, lowp = VIDEOS_BEFORE[cell]
    r = _tiny_run(cell)
    try:
        make = frame_aa.Scene if r.traffic["driver"] == "video_aa" else frame.Scene
        n = int(r.scene["n_frames"])
        got = frame.video_frames(make(r.scene, "cpu"), n, [0, 5])
        assert _digests(got) == frames
        ctl = frame.video_frames(make(r.scene, "cpu", lowp=True), n, [3])
        assert _digests(ctl) == {3: lowp}
    finally:
        r.close()


# -- the frozen static generator against the port's ------------------------


def test_the_frozen_draws_are_the_ports_bit_for_bit():
    from benchmark.reference.frozen.ops import random as frozen
    from bhr_tpu_torch.ops import random as port

    for seed in (0, 42, 2 ** 32 + 5):
        fk, pk = frozen.prng_key(seed), port.prng_key(seed)
        assert torch.equal(fk, pk)
        assert torch.equal(frozen.split(fk, 5), port.split(pk, 5))
        assert torch.equal(frozen.random_bits(fk, (3, 7), device="cpu"),
                           port.random_bits(pk, (3, 7), device="cpu"))
        assert torch.equal(frozen.uniform(fk, (64,), 0.2, 0.7, device="cpu"),
                           port.uniform(pk, (64,), 0.2, 0.7, device="cpu"))
        assert torch.equal(frozen.randint(fk, (64,), 2, 9, device="cpu"),
                           port.randint(pk, (64,), 2, 9, device="cpu"))
        assert torch.equal(frozen.beta(fk, 0.3, 1.0, (40,), device="cpu"),
                           port.beta(pk, 0.3, 1.0, (40,), device="cpu"))


@pytest.mark.parametrize("n_phi,n_r,scale", [(128, 32, 2), (256, 64, 1), (256, 64, 4)])
def test_the_frozen_static_texture_is_the_ports(n_phi, n_r, scale):
    from benchmark.reference.frozen.models import static_disk as frozen
    from bhr_tpu_torch.models import disk_texture as port

    args = dict(seed=1234, n_r=n_r, n_phi=n_phi, r_inner=2.0, r_outer=15.0,
                generation_scale=scale, device="cpu")
    fc, fo = frozen.generate_component_fields(**args)
    pc, po = port.generate_component_fields(**args)
    assert (fc - pc).abs().max().item() <= 1e-5
    assert (fo - po).abs().max().item() <= 1e-5
    kw = {k: v for k, v in args.items() if k != "n_r"}
    ft = frozen.generate_disk_texture(n_r=n_r, **kw)
    pt = port.generate_disk_texture(n_r=n_r, **kw)
    assert ft.shape == pt.shape == (n_r, n_phi, 4)
    assert (ft - pt).abs().max().item() <= 1e-5
