"""The port's Renderer at bhr_tpu's extreme but legal scenes, on the CPU.

The nine ``CONFIGS`` of ``test_extreme_configs.py`` (tilt 89, fov 170 and
1, a camera at r = 2.2 and at r = 40, a disk inside the photon sphere,
step 1.0, AA at strength 2, lens flare) on the same 96x64 frame, sky and
random disk. Each frame must meet that test's conditions (shape, finite,
values in [0, 1 + 1e-6], not constant unless fov 1 sees only the
shadow) and lie within the cross-backend bounds of ``tests/e2e_render.py``
(max 5e-2, mean 5e-4) of ``bhr_tpu.Renderer``'s frame on the same
inputs. On the CPU the trace is the kernel's plain version; the kernel
itself is held to these scenes by ``chip_smoke.py`` (``[extreme ...]``).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

import bhr_tpu
from bhr_tpu.models.skybox import generate_skybox

from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.pipeline import Renderer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402
from unit import test_extreme_configs as reference  # noqa: E402

W, H = reference.W, reference.H
# A copy: the reference test pops keys from its own dicts as it runs.
CONFIGS = copy.deepcopy(reference.CONFIGS)


@pytest.fixture(scope="module")
def assets():
    sky = generate_skybox(256, 128, seed=5, n_stars=200)
    disk = np.random.default_rng(2).random((24, 64, 4)).astype(np.float32)
    return sky, disk


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def scene(overrides):
    """(the SceneConfig keywords of one of CONFIGS, whether it is black)."""
    o = dict(overrides)
    black = o.pop("expect_black", False)
    return dict(width=W, height=H, fov=o.pop("fov", 60.0),
                pov=o.pop("pov", (6.0, 0.0, 0.5)),
                disk_inner_radius=o.pop("disk_inner_radius", 2.0),
                disk_outer_radius=o.pop("disk_outer_radius", 3.5),
                n_stars=200, **o), black


@pytest.mark.parametrize("overrides", CONFIGS, ids=lambda o: "-".join(
    f"{k}={v}" for k, v in o.items() if k != "expect_black"))
def test_extreme_scene_matches_bhr_tpu(overrides, assets):
    kw, black = scene(overrides)
    sky, disk = assets
    cfg = SceneConfig(device="cpu", **kw).validated()
    img = Renderer(cfg, sky, disk).render(cfg.pov, cfg.fov)
    assert img.shape == (H, W, 3)
    assert np.isfinite(img).all()
    assert 0.0 <= img.min() and img.max() <= 1.0 + 1e-6
    if not black:
        assert img.std() > 1e-4

    jcfg = bhr_tpu.SceneConfig(**kw).validated()
    ref = np.asarray(bhr_tpu.Renderer(jcfg, sky, disk).render(jcfg.pov, jcfg.fov))
    diff = np.abs(img.astype(np.float64) - ref.astype(np.float64))
    assert diff.max() <= XB_MAX_ABS_TOL and diff.mean() <= XB_MEAN_ABS_TOL, (
        diff.max(), diff.mean())
