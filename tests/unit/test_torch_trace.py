"""Port trace (plain version of the CUDA ray-march kernel) vs bhr_tpu.

On the CPU, ``trace_geodesics_cuda`` routes a CPU camera tensor to the
plain torch version; it is held against both JAX tracers — the pure-JAX
lock-step loop and the Pallas kernel in interpret mode — on the scenes
of ``test_pallas_parity.py``: 128x32 at tilt 15 and the 128x48 tilt-40
gate case. As there, categorical outputs (captured, escaped, hit_count)
must match exactly and float outputs agree within 2e-3 (escape
direction, hit xy, hit direction).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhr_tpu.camera import build_camera
from bhr_tpu.ops import geodesic as jgeo
from bhr_tpu.ops.geodesic_pallas import trace_geodesics_pallas

from bhr_tpu_torch.ops import geodesic as tgeo
from bhr_tpu_torch.ops.geodesic_cuda import camera_params, trace_geodesics_cuda

SCENES = {"tilt15": (128, 32, 15.0), "tilt40": (128, 48, 40.0)}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _kw(tilt):
    return dict(h_base=0.2, r_escape=12.04, tilt_deg=tilt, r_inner=2.0,
                r_outer=3.5)


@pytest.mark.parametrize("reference", ["pure_jax", "pallas_interpret"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_trace_matches_jax(scene, reference):
    w, h, tilt = SCENES[scene]
    cam = build_camera([6.0, 0.0, 0.5], 60.0, w, h)
    launches = trace_geodesics_cuda.launches
    res = trace_geodesics_cuda(torch.as_tensor(camera_params(cam)),
                               width=w, height=h, **_kw(tilt))
    assert trace_geodesics_cuda.launches == launches  # CPU: no kernel launch
    if reference == "pure_jax":
        dirs, _, _ = jgeo.primary_rays(cam)
        ref = jgeo.trace_geodesics(jnp.asarray(cam.pos), dirs, **_kw(tilt))
    else:
        ref = trace_geodesics_pallas(jnp.asarray(camera_params(cam)), width=w,
                                     height=h, interpret=True,
                                     exit_check_every=1, **_kw(tilt))

    for name in ("captured", "escaped", "hit_count"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert res.hit_count.dtype == torch.int32
    np.testing.assert_allclose(res.escape_dir.numpy(), np.asarray(ref.escape_dir),
                               atol=2e-3)
    count = np.asarray(ref.hit_count)
    assert count.sum() > 0  # the scene records disk crossings
    hits_t, hits_j = res.hits.numpy(), np.asarray(ref.hits)
    assert hits_t.shape == hits_j.shape == (4, 12, w * h)
    for k in range(4):
        sel = count > k
        if sel.any():
            np.testing.assert_allclose(hits_t[k, :5][:, sel], hits_j[k, :5][:, sel],
                                       atol=2e-3)
        np.testing.assert_array_equal(hits_t[k, :, ~sel], 0.0)
    np.testing.assert_array_equal(hits_t[:, 5:11], 0.0)


def test_primary_rays_match_jax():
    cam = build_camera([6.0, 0.0, 0.5], 60.0, 96, 40)
    dirs = tgeo.primary_rays_from_params(torch.as_tensor(camera_params(cam)), 96, 40)
    ref, _, _ = jgeo.primary_rays(cam)
    np.testing.assert_allclose(dirs.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(dirs.numpy(), axis=1), 1.0, atol=1e-6)


def test_trace_terminates_every_ray_on_small_scene():
    cam = build_camera([6.0, 0.0, 0.5], 60.0, 100, 20)
    res = trace_geodesics_cuda(torch.as_tensor(camera_params(cam)),
                               width=100, height=20, **_kw(15.0))
    assert res.captured.shape == (2000,)
    assert bool((res.captured | res.escaped).all())
    assert not bool((res.captured & res.escaped).any())
    norms = res.escape_dir.norm(dim=1)
    torch.testing.assert_close(norms[res.escaped], torch.ones_like(norms[res.escaped]))
    assert bool((norms[~res.escaped] == 0).all())


@pytest.mark.parametrize("variant", [
    {"with_differentials": True}, {"record_step_counts": True},
    {"row_count": 8}, {"record_hits": False}, {"row_start": 4},
])
def test_unported_variants_raise(variant):
    cam = build_camera([6.0, 0.0, 0.5], 60.0, 32, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace_geodesics_cuda(torch.as_tensor(camera_params(cam)), width=32,
                             height=16, **_kw(15.0), **variant)


@pytest.mark.parametrize("cam", [
    torch.zeros(14, dtype=torch.float64),
    torch.zeros(13, dtype=torch.float32),
    torch.zeros(28, dtype=torch.float32)[::2],
])
def test_wrapper_rejects_bad_camera_tensor(cam):
    with pytest.raises(ValueError, match="cam_params"):
        trace_geodesics_cuda(cam, width=8, height=8, **_kw(15.0))
