"""The anti-aliased and the lens-flared golden scenes, end to end on the CPU.

``tests/e2e_render.py``'s ``aa`` and ``flare`` families — the pinned
320x180 golden geometry with ``anti_alias="lod_radius"`` or
``lens_flare=True`` — rendered by ``bhr_tpu_torch.modes.render_image``
(plain trace with ray differentials, mip-LOD shading, flare after bloom)
against ``tests/goldens/e2e_cpu_aa.npz`` and ``e2e_cpu_flare.npz`` (what
bhr_tpu renders on the CPU), within the cross-backend bounds: max |diff|
<= 5e-2 and mean <= 5e-4. A file of its own, so that the test workers
spread it apart from the default golden of ``test_torch_slice.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.modes import render_image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import (  # noqa: E402
    GOLDEN_DIR,
    SCENES,
    XB_MAX_ABS_TOL,
    XB_MEAN_ABS_TOL,
)

GOLDEN_SCENE = dict(width=320, height=180, pov=(6.0, 0.0, 0.5), fov=60.0,
                    step_size=0.1, r_max=10.0, n_stars=100,
                    disk_inner_radius=2.0, disk_outer_radius=3.5,
                    disk_tilt=15.0, anti_alias="disabled", seed=42)


@pytest.fixture(scope="module")
def renders():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = {name: render_image(SceneConfig(device="cpu",
                                              **{**GOLDEN_SCENE, **SCENES[name]}))
               for name in ("default", "aa", "flare")}
    finally:
        torch.set_num_threads(prev)
    return out


@pytest.mark.parametrize("scene", ["aa", "flare"])
def test_golden_scene_within_cross_backend_bounds(renders, scene):
    golden = np.load(os.path.join(GOLDEN_DIR, f"e2e_cpu_{scene}.npz"))["image"]
    img = renders[scene]
    assert img.shape == golden.shape == (180, 320, 3)
    diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
    print(f"port vs e2e_cpu_{scene}.npz: max={diff.max():.3e} mean={diff.mean():.3e}")
    assert diff.max() <= XB_MAX_ABS_TOL, diff.max()
    assert diff.mean() <= XB_MEAN_ABS_TOL, diff.mean()


@pytest.mark.parametrize("scene", ["aa", "flare"])
def test_golden_scene_is_sane_and_differs_from_default(renders, scene):
    img = renders[scene]
    assert np.isfinite(img).all() and 0.0 <= img.min() and img.max() <= 1.0
    h, w = 180, 320
    center = img[h // 2 - 16: h // 2 + 16, w // 2 - 16: w // 2 + 16]
    assert img.max() > 0.5  # bright photon ring
    diff = np.abs(img - renders["default"])
    if scene == "aa":
        # Mip-LOD sampling softens the disk only: the sky and the shadow
        # stay as they were.
        assert (center.sum(axis=-1) < 0.05).mean() > 0.5
        assert 1e-3 < diff.max() and (diff.max(axis=-1) > 1e-6).mean() < 0.5
    else:
        # The flare lifts pixels across the frame, never darkens one.
        assert (img >= renders["default"] - 1e-6).all()
        assert (diff.max(axis=-1) > 1e-3).mean() > 0.05
