"""The measurement tools of ``bhr_tpu_torch.tools`` on the CPU.

Each of the seven ports of ``tools/{_diag_scene, bench_trace,
bench_resolutions, ablate_pipeline, ablate_shade, bench_shade_variants,
cost_shade}.py`` runs at a tiny size (a 32x16 scene, a 32x128 disk);
the anchor of ``bench_shade_variants`` is the production shade;
``_diag_scene``'s constants are ``tools/_diag_scene.py``'s; the
operation counter of ``cost_shade`` counts what it says; and each tool
refuses ``--device cuda`` without a GPU. The times they print here are
the CPU's and show only that the tools run.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest
import torch

from bhr_tpu_torch import pipeline
from bhr_tpu_torch.ops.geodesic import TraceResult
from bhr_tpu_torch.tools import (
    _diag_scene,
    ablate_pipeline,
    ablate_shade,
    bench_resolutions,
    bench_shade_variants,
    bench_trace,
    cost_shade,
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENE = ["--size", "32x16", "--tex", "32x128"]
FRAME = ["--size", "32x16", "--batch", "1", "--repeats", "1"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs():
    return _diag_scene.build_fhd_shade_inputs("cpu", (32, 16), (32, 128))


def run(tool, args):
    """``tool.main(args + ["--device", "cpu"])`` -> (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main([*args, "--device", "cpu"])
    return rc, out.getvalue()


def test_diag_scene_on_cpu(inputs):
    w, h, cam, skybox, mips, trace = inputs
    assert (w, h) == (32, 16) and cam.shape == (14,)
    assert skybox.shape == (1024, 2048, 3) and mips.shape[1:] == (32, 128, 4)
    assert trace.hit_count.shape == (32 * 16,) and bool(trace.escaped.any())
    assert int(trace.hit_count.max()) >= 1


def test_diag_scene_constants_are_bhr_tpus():
    spec = importlib.util.spec_from_file_location(
        "reference_diag_scene", os.path.join(_REPO, "tools", "_diag_scene.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for name in ("FHD", "TEX_N_R", "TEX_N_PHI", "DISK_R_INNER", "DISK_R_OUTER",
                 "TILT_DEG"):
        assert getattr(_diag_scene, name) == getattr(ref, name), name


@pytest.mark.parametrize("aa", [[], ["--aa"]])
def test_bench_trace_on_cpu(aa):
    rc, out = run(bench_trace, [*aa, "--width", "32", "--height", "16", "--iters", "1"])
    line = json.loads(out)
    assert rc == 0 and line["value"] == line["mray_steps_per_s"] > 0
    assert line["metric"].endswith("_aa") == bool(aa) and line["device"] == "cpu"
    assert line["issue_bound_share"] == "not measured"


def test_bench_resolutions_on_cpu():
    rc, out = run(bench_resolutions, ["--resolutions", "sd,fhd", *FRAME])
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 2
    assert lines[0].startswith("sd   32x16:") and "ms/frame" in lines[1]


def test_ablate_pipeline_on_cpu_restores_the_samplers():
    saved = (pipeline.sample_skybox, pipeline.sample_disk, pipeline.sample_disk_mip)
    rc, out = run(ablate_pipeline, ["--resolution", "sd", "--aa", *FRAME])
    assert rc == 0
    assert [ln.split()[2] for ln in out.splitlines()] == list(ablate_pipeline.STAGES)
    assert "(stage ~" in out.splitlines()[-1]
    assert (pipeline.sample_skybox, pipeline.sample_disk,
            pipeline.sample_disk_mip) == saved


def test_ablate_pipeline_stages_knock_out_their_stage(inputs):
    _, _, cam, skybox, mips, trace = inputs
    kw = dict(r_inner=2.0, r_outer=15.0, tilt_deg=15.0, t_offset=0.0)
    bg, disk, _ = pipeline.shade_frame(trace, skybox, mips, cam[0:3], **kw)
    with ablate_pipeline.knocked_out("nosky") as use_bloom:
        bg_ns, disk_ns, _ = pipeline.shade_frame(trace, skybox, mips, cam[0:3], **kw)
    assert use_bloom and torch.equal(disk_ns, disk) and not torch.equal(bg_ns, bg)
    with ablate_pipeline.knocked_out("nodisk"):
        _, disk_nd, _ = pipeline.shade_frame(trace, skybox, mips, cam[0:3], **kw)
    assert not torch.equal(disk_nd, disk)
    with ablate_pipeline.knocked_out("nobloom") as use_bloom:
        assert not use_bloom
    with pytest.raises(SystemExit):
        with ablate_pipeline.knocked_out("nothing"):
            pass


def test_ablate_shade_on_cpu():
    rc, out = run(ablate_shade, [*SCENE, "--iters", "1"])
    lines = out.splitlines()
    assert rc == 0 and lines[0].startswith("hit_count:") and len(lines) == 6


def test_bench_shade_variants_on_cpu():
    rc, out = run(bench_shade_variants, [*SCENE, "--iters", "1"])
    results = json.loads(out.splitlines()[-1])
    assert rc == 0 and len(results) == 6 and all(v > 0 for v in results.values())


def test_bench_shade_variants_anchor_is_shade_frame(inputs):
    _, _, cam, skybox, mips, trace = inputs
    name, anchor = bench_shade_variants.variants(inputs)[-1]
    bg, disk, _ = pipeline.shade_frame(
        trace, skybox, mips, cam[0:3], r_inner=2.0, r_outer=15.0, tilt_deg=15.0,
        t_offset=0.0, use_lod=False, aa_strength=1.0)
    assert name == "full shade_frame (anchor)"
    assert torch.equal(anchor(), bg + disk)


def test_cost_shade_on_cpu():
    rc, out = run(cost_shade, SCENE)
    assert rc == 0 and "FP32 operations" in out and "not measured (no GPU)" in out


def test_cost_shade_counts_what_it_says():
    a, b = torch.rand(10), torch.rand(10)
    ops, by_op = cost_shade.fp32_operations(
        lambda: (torch.sqrt(a * b + 1.0), torch.where(a > b, a, b).clamp(0.0, 0.5),
                 (a + b).sum(), torch.arange(10) * 3))
    # mul, add, sqrt, add, sum: 10 each; the compare, where, clamp and
    # the integer product are not FP32 arithmetic.
    assert ops == 50 and by_op == {"mul": 10, "add": 20, "sqrt": 10, "sum": 10}
    n = 4
    trace = TraceResult(
        captured=torch.tensor([True, False, False, False]),
        escaped=torch.tensor([False, True, True, False]),
        escape_dir=torch.zeros((n, 3)), hit_count=torch.tensor([0, 1, 2, 0]),
        hits=torch.zeros((4, 12, n)), steps=None)
    skybox, mips = torch.zeros((8, 16, 3)), torch.zeros((4, 8, 16, 4))
    # 2 slots x 5 features x 4 rays, hit_count, escaped, escape_dir; 3 hits
    # x 4 texels x 16 B; 2 escaped x 4 texels x 12 B; bg, disk, alpha out.
    assert cost_shade.shade_bytes(trace, skybox, mips) == (
        2 * 5 * 4 * 4 + 4 * 4 + 4 + 4 * 12 + 3 * 64 + 2 * 48 + 4 * 7 * 4)


@pytest.mark.parametrize("tool", [bench_trace, bench_resolutions, ablate_pipeline,
                                  ablate_shade, bench_shade_variants, cost_shade])
def test_tool_refuses_cuda_without_a_gpu(tool, monkeypatch):
    # --device cuda is the default; without a GPU it raises, never falls
    # back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--size", "32x16"] if tool is not bench_trace else [])


def test_diag_scene_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _diag_scene.build_fhd_shade_inputs()
