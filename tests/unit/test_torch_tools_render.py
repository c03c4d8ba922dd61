"""``compare_aa`` of the port vs ``bhr_tpu``'s.

As ``test_torch_tools.py`` (whose runners this file uses): the port's
tool through ``python -m`` semantics on the CPU, ``bhr_tpu``'s loaded
from ``tools/`` by path, the same arguments. ``compare_aa`` renders
through ``modes.render_image``; both packages' ``"sd"`` resolution is
set to 64x36 for the test. The composites are held to the cross-backend
bounds of ``tests/e2e_render.py`` (max 5e-2, mean 5e-4), which hold the
same function's frames everywhere else.
"""

import os
import sys

import numpy as np

import bhr_tpu.config

import bhr_tpu_torch.config
from bhr_tpu_torch.utils.io import load_png_rgb8

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402
from test_torch_tools import (  # noqa: E402
    _few_threads,  # noqa: F401  (autouse fixture)
    run_port,
    run_reference,
)


def test_compare_aa_matches_bhr_tpu(tmp_path, monkeypatch):
    for config in (bhr_tpu.config, bhr_tpu_torch.config):
        monkeypatch.setitem(config.RESOLUTIONS, "sd", (64, 36))
    args = ["--aa_strength", "1.5"]
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    rc, out = run_port("compare_aa", [*args, "--out", ours])
    assert rc == 0 and "AA off | AA on composite" in out
    assert out.count("Rendered 64x36 on cpu") == 2
    rc, _ = run_reference("compare_aa", [*args, "--out", theirs])
    assert rc == 0
    a = load_png_rgb8(ours).astype(np.float64) / 255.0
    b = load_png_rgb8(theirs).astype(np.float64) / 255.0
    assert a.shape == (18, 32 + 4 + 32, 3)
    # The white separator between the two crops, and AA changed something.
    assert (a[:, 32:36] == 1.0).all()
    assert np.abs(a[:, :32] - a[:, 36:]).max() > 0.01
    diff = np.abs(a - b)
    assert diff.max() <= XB_MAX_ABS_TOL and diff.mean() <= XB_MEAN_ABS_TOL, (
        diff.max(), diff.mean())
