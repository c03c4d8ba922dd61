"""The port's tools (``bhr_tpu_torch/tools``) vs ``bhr_tpu``'s ``tools/``.

Each port tool runs as ``python -m bhr_tpu_torch.tools.<name>`` (here
through ``runpy`` with ``sys.argv`` set, so ``__main__`` runs in this
process) with ``--device cpu`` at a tiny size, and ``bhr_tpu``'s tool
runs from ``tools/<name>.py``, loaded by path with the same arguments in
``sys.argv``; nothing in ``tools/`` changes. Their PNGs are held to the
tolerance stated for the function underneath, after both quantised to
uint8: 1e-5 for the static texture (``test_torch_texture.py``), 1e-3 for
the lifecycle texture (``test_torch_disk.py``) and 2.6e-6 for the V2
previews (``test_torch_v2.py``) each allow at most one uint8 step.
``compare_aa`` and ``rotation_experiments`` are in
``test_torch_tools_render.py``, ``profile_pipeline`` in
``test_torch_profiling.py``.
"""

import contextlib
import importlib.util
import io
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from bhr_tpu_torch.utils.io import load_png_rgb8

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOOLS = ("check_texture", "compare_aa", "preview_v2", "profile_pipeline",
         "rotation_experiments")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _argv(argv):
    old = sys.argv
    sys.argv = list(argv)
    try:
        yield
    finally:
        sys.argv = old


def run_reference(name, args):
    """``tools/<name>.py``'s ``main()`` with ``args`` in ``sys.argv`` ->
    (exit code, what it printed)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", os.path.join(_REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = io.StringIO()
    with _argv([f"{name}.py", *args]), contextlib.redirect_stdout(out):
        rc = module.main()
    return rc, out.getvalue()


def run_port(name, args):
    """``python -m bhr_tpu_torch.tools.<name> <args> --device cpu`` in this
    process -> (exit code, what it printed)."""
    out = io.StringIO()
    with _argv([name, *args, "--device", "cpu"]), contextlib.redirect_stdout(out):
        with pytest.raises(SystemExit) as stop:
            runpy.run_module(f"bhr_tpu_torch.tools.{name}", run_name="__main__",
                             alter_sys=True)
    return stop.value.code, out.getvalue()


def assert_pngs_close(ours, theirs, max_step=1):
    """Two PNG files of one shape, no value more than ``max_step`` uint8
    steps apart -> the largest step."""
    a = load_png_rgb8(ours).astype(np.int32)
    b = load_png_rgb8(theirs).astype(np.int32)
    assert a.shape == b.shape
    step = int(np.abs(a - b).max())
    assert step <= max_step, (ours, step)
    return step


@pytest.mark.parametrize("args", [[], ["--dynamic"], ["--t", "2.5", "--seed", "7"]],
                         ids=["static", "dynamic", "static-t2.5-seed7"])
def test_check_texture_matches_bhr_tpu(tmp_path, args):
    args = ["--n_phi", "128", "--n_r", "32", *args]
    rc, out = run_port("check_texture", [*args, "--out", str(tmp_path / "port")])
    assert rc == 0 and "32x128" in out
    rc, _ = run_reference("check_texture", [*args, "--out", str(tmp_path / "ref")])
    assert rc == 0
    for part, shape in (("polar", (32, 128, 3)), ("topview", (768, 768, 3)),
                        ("density", (32, 128, 3))):
        ours = str(tmp_path / f"port_{part}.png")
        assert load_png_rgb8(ours).shape == shape
        assert load_png_rgb8(ours).max() > 0
        assert_pngs_close(ours, str(tmp_path / f"ref_{part}.png"))


@pytest.mark.parametrize("args", [[], ["--structure", "--palette", "scientific",
                                       "--t", "1.5", "--r_out", "8.0"]],
                         ids=["default", "structure-scientific"])
def test_preview_v2_matches_bhr_tpu(tmp_path, args):
    args = ["--size", "64", *args]
    rc, out = run_port("preview_v2", [*args, "--out", str(tmp_path / "port" / "v2")])
    assert rc == 0 and out.count("wrote ") == 3
    rc, _ = run_reference("preview_v2", [*args, "--out", str(tmp_path / "ref" / "v2")])
    assert rc == 0
    for part, shape in (("top", (64, 64, 3)), ("density", (32, 64, 3)),
                        ("temperature", (32, 64, 3))):
        ours = str(tmp_path / "port" / f"v2_{part}.png")
        assert load_png_rgb8(ours).shape == shape
        assert load_png_rgb8(ours).max() > 0
        assert_pngs_close(ours, str(tmp_path / "ref" / f"v2_{part}.png"))


@pytest.mark.parametrize("name", TOOLS)
def test_tool_refuses_cuda_without_a_gpu(name, monkeypatch):
    # --device cuda is the default; without a GPU it raises, never falls
    # back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = __import__(f"bhr_tpu_torch.tools.{name}", fromlist=["main"])
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])
