"""``bhr_tpu_torch.bench`` on the CPU: the bench scene against
``bench.py``'s, each measurement at a tiny size, the op model's bounds
against hand-computed values and against the benchmark's frozen copy
(``benchmark/opmodel.py``), and the golden helpers.

The measurements' numbers here are the CPU's and only show that each
function runs end to end and returns finite numbers under the keys its
callers read; the trace's bound shares, which are the H100's, read
"not measured" on the CPU.
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from bhr_tpu_torch import bench
from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.models.skybox import generate_skybox
from bhr_tpu_torch.ops.geodesic import TraceResult
from test_torch_smoke import SASS

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)
import bench as jax_bench  # noqa: E402  (the repository's bench.py)
from benchmark import opmodel  # noqa: E402

SIZE = (32, 16)
_SHARED = [f.name for f in dataclasses.fields(SceneConfig) if f.name != "device"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sky():
    return torch.as_tensor(generate_skybox(256, 128, seed=42, n_stars=200))


def _finite(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)


@pytest.mark.parametrize("args", [("sd",), ("hd",), ("fhd",), ("4k",),
                                  ("fhd", "lod_radius"), ("fhd", "disabled", True),
                                  ("4k", "lod_radius")])
def test_bench_scene_config_matches_bench_py(args):
    ours = bench.bench_scene_config(*args, device="cpu")
    theirs = jax_bench.bench_scene_config(*args)
    assert {k: getattr(ours, k) for k in _SHARED} == {k: getattr(theirs, k)
                                                      for k in _SHARED}
    assert ours.image_size == theirs.image_size
    assert bench.bench_scene_config(*args).device == "cuda"


@pytest.mark.parametrize("kw", [{}, {"anti_alias": "lod_radius", "lens_flare": True,
                                     "use_bloom": False}])
def test_time_resolution_on_cpu(sky, kw):
    r = bench.time_resolution("sd", 1, sky, device=torch.device("cpu"), repeats=2,
                              size=SIZE, **kw)
    assert _finite(r["frame_ms"]) and r["frame_ms"] > 0
    assert r["spread"][0] <= r["frame_ms"] <= r["spread"][1]
    assert r["frames"] == 3


@pytest.mark.parametrize("aa", [False, True])
def test_time_trace_on_cpu(aa):
    r = bench.time_trace(aa, device="cpu", size=SIZE, iters=1)
    for key in ("trace_ms", "mray_steps_per_s", "mean_steps_per_ray"):
        assert _finite(r[key]) and r[key] > 0, key
    assert r["steps_per_frame"] == round(r["mean_steps_per_ray"] * SIZE[0] * SIZE[1])
    # The bounds are the H100's: never a CPU number under their names.
    assert r["fp32_bound_share"] == r["issue_bound_share"] == "not measured"
    assert r["launches"] == {}


def test_time_gather_on_cpu():
    assert _finite(bench.time_gather(4096, 3, device="cpu"))


def test_measurements_refuse_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: bench.time_trace(False, size=SIZE),
               lambda: bench.time_gather(16, 1),
               lambda: bench.time_resolution("sd", 1, size=SIZE)):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()


def _rays(captured, escaped, hit_count):
    n = len(captured)
    return TraceResult(
        captured=torch.tensor(captured), escaped=torch.tensor(escaped),
        escape_dir=torch.zeros((n, 3)), hit_count=torch.tensor(hit_count),
        hits=torch.zeros((4, 12, n)), steps=None)


def _trace():
    """Four rays: captured, escaped, escaped, neither; 0, 1, 2, 0 hits."""
    return _rays([True, False, False, False], [False, True, True, False], [0, 1, 2, 0])


def test_bound_reproduces_the_op_model_by_hand():
    steps = torch.tensor([10.0, 20.0, 30.0, 40.0], dtype=torch.float64)
    trace = _trace()
    assert bench.terminated(trace) == 3
    # slim: 170 a step, 63 a ray, 10 an escaped ray, 13 a hit; its 4 x 210
    # bytes written (+ the 56 of the camera) bound it.
    ops = 170 * 100 + 63 * 4 + 10 * 2 + 13 * 3
    assert ops / 67e12 * 1e3 < (56 + 4 * 210) / 3.35e12 * 1e3
    assert bench.bound("ray_march_slim", steps, trace) == pytest.approx(
        ((56 + 4 * 210) / 3.35e12 * 1e3, "bytes"))
    # AA: the differentials on the 97 steps that survive, 127 a ray, 31 a hit.
    ops = 170 * 100 + 336 * 97 + 127 * 4 + 10 * 2 + 31 * 3
    assert bench.bound("ray_march_aa_steps", steps, trace) == pytest.approx(
        (ops / 67e12 * 1e3, "operations"))
    assert bench.bound("ray_march_nodisk", steps, trace)[1] == "bytes"


def _synthetic_traces():
    """(steps, trace) of three kinds: operations-bound, with AA steps that
    survive, escapes and hits; every ray captured; no step at all, which
    only the bytes bound."""
    no, yes = [False] * 4, [True] * 4
    f64 = dict(dtype=torch.float64)
    return {"operations": (torch.tensor([100.0, 200.0, 300.0, 400.0], **f64),
                           _rays([True, False, False, False], [False, True, True, False],
                                 [1, 0, 2, 3])),
            "captured": (torch.tensor([50.0, 60.0, 70.0, 80.0], **f64),
                         _rays(yes, no, [0, 1, 0, 2])),
            "bytes": (torch.zeros(4, **f64), _rays(no, no, [0, 0, 0, 0]))}


@pytest.mark.parametrize("kind", ["operations", "captured", "bytes"])
@pytest.mark.parametrize("name", [f"ray_march_{v}{s}" for v in ("slim", "aa", "nodisk")
                                  for s in ("", "_steps")])
def test_bound_matches_the_benchmarks_frozen_op_model(name, kind):
    # benchmark/opmodel.py is the benchmark's frozen copy of this op model
    # (its roofline metric reads it): the two must give the same bound. A
    # _steps instantiation also writes its 4-byte step count a ray.
    steps, trace = _synthetic_traces()[kind]
    base = name.removeprefix("ray_march_").removesuffix("_steps")
    ms, limit = opmodel.bound_ms(base, opmodel.trace_work(
        steps, trace.captured, trace.escaped, trace.hit_count))
    if kind != "captured":
        assert limit == kind
    if name.endswith("_steps") and limit == "bytes":
        ms = (opmodel.CAMERA_BYTES + steps.numel() * (opmodel.RAY_BYTES + 4)) \
            / opmodel.PEAK_BYTES * 1e3
    assert bench.bound(name, steps, trace) == (ms, limit)


def test_issue_bounds_reproduce_the_sass_counts_by_hand():
    counts = bench.parse_sass_loops(SASS)["ray_march_slim"]
    issue, mufu = bench.issue_bounds(counts, 100.0, 3, n_sms=132, clock_mhz=1980.0)
    # 97 surviving steps of 9 instructions (1 MUFU), 3 terminating of 3 (1).
    assert issue == pytest.approx((9 * 97 + 3 * 3) / (128 * 132 * 1980e3))
    assert mufu == pytest.approx((1 * 97 + 1 * 3) / (16 * 132 * 1980e3))


def test_chip_smoke_uses_the_one_op_model_and_golden_table():
    for name in ("bound", "issue_bounds", "terminated", "sass_loop_counts", "device_busy_share", "golden_diff", "GOLDEN",
                 "SCENES", "V2_SCENES", "GOLDEN_VIDEO", "POV"):
        assert getattr(chip_smoke, name) is getattr(bench, name), name
    for name in ("STEP_OPS", "RAY_BYTES", "PEAK_FP32", "parse_sass_loops"):
        assert not hasattr(chip_smoke, name), name


def test_golden_diff_on_a_synthetic_image():
    golden = np.load(os.path.join(bench.GOLDEN_DIR, "e2e_cpu.npz"))["image"]
    img = golden.copy()
    img[0, 0, 0] += 0.25
    img[1, 1, 1] -= 0.125
    d_max, d_mean = bench.golden_diff(img, "e2e_cpu")
    assert d_max == pytest.approx(0.25, abs=1e-6)
    assert d_mean == pytest.approx(0.375 / img.size, rel=1e-5)
    with pytest.raises(ValueError, match="shape"):
        bench.golden_diff(img[:-1], "e2e_cpu")
