"""Port trace (plain version of the CUDA ray-march kernel) vs bhr_tpu.

On the CPU, ``trace_geodesics_cuda`` routes a CPU camera tensor to the
plain torch version; it is held against both JAX tracers — the pure-JAX
lock-step loop and the Pallas kernel in interpret mode — on the scenes
of ``test_pallas_parity.py``: 128x32 at tilt 15 and the 128x48 tilt-40
gate case, in every variant the port has (slim, AA, no disk, step
counts). As there, categorical outputs (captured, escaped, hit_count)
and step counts must match exactly and float outputs agree within 2e-3
(escape direction, hit xy, hit direction, t_frac). The AA differentials
(features 5..10) agree within ``test_pallas_parity.py``'s own 5e-3: XLA
contracts multiply-adds into FMAs on the CPU, and the pure-JAX path
starts its differentials from ``primary_rays_from_arrays``, a different
formula from the Pallas kernel's that the port follows. The plain version
computes the Pallas kernel's divide-free formulas (rsqrt per stage,
reciprocals, 1/6 as a multiply); the pure-JAX tracer divides.

The CLI default disk (2-15 at tilt 0, step 0.1, fov 90) reaches past the
escape radius (12.04), the regime of the FHD main path; it is held to
``bhr_tpu_torch.ops.trace_compare``'s tolerances at the parity scenes'
strictness (exact categories and step counts), which the CUDA kernel is
held to on the card, and that module's negative control (swapped x and y
differentials) must fail against it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhr_tpu.camera import build_camera
from bhr_tpu.ops import geodesic as jgeo
from bhr_tpu.ops.geodesic_pallas import trace_geodesics_pallas

from bhr_tpu_torch.ops import geodesic as tgeo
from bhr_tpu_torch import interop
from bhr_tpu_torch.ops.geodesic_cuda import (
    KERNELS,
    camera_params,
    kernel_name,
    trace_geodesics_cuda,
)
from bhr_tpu_torch.ops.trace_compare import (
    compare_traces,
    failures,
    swap_differentials,
)

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


def _jax_trace(reference, cam, w, h, **kw):
    """bhr_tpu's trace of the camera: pure JAX (with primary_rays'
    differentials) or the Pallas kernel in interpret mode."""
    if reference == "pure_jax":
        dirs, ddx, ddy = jgeo.primary_rays(cam)
        return jgeo.trace_geodesics(jnp.asarray(cam.pos), dirs, d_dir_dx0=ddx,
                                    d_dir_dy0=ddy, **kw)
    return trace_geodesics_pallas(jnp.asarray(camera_params(cam)), width=w,
                                  height=h, interpret=True, exit_check_every=1,
                                  **kw)


def _port_trace_params(params, w, h, **kw):
    launches = dict(trace_geodesics_cuda.launches)
    res = trace_geodesics_cuda(params, width=w, height=h, **kw)
    assert trace_geodesics_cuda.launches == launches  # CPU: no kernel launch
    return res


def _port_trace(cam, w, h, **kw):
    return _port_trace_params(torch.as_tensor(camera_params(cam)), w, h, **kw)


@pytest.mark.parametrize("reference", ["pure_jax", "pallas_interpret"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_trace_matches_jax(scene, reference):
    w, h, tilt = SCENES[scene]
    cam = build_camera([6.0, 0.0, 0.5], 60.0, w, h)
    res = _port_trace(cam, w, h, **_kw(tilt))
    ref = _jax_trace(reference, cam, w, h, **_kw(tilt))

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


@pytest.mark.parametrize("reference", ["pure_jax", "pallas_interpret"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_aa_trace_matches_jax(scene, reference):
    w, h, tilt = SCENES[scene]
    cam = build_camera([6.0, 0.0, 0.5], 60.0, w, h)
    kw = dict(_kw(tilt), with_differentials=True)
    res = _port_trace(cam, w, h, **kw)
    ref = _jax_trace(reference, cam, w, h, **kw)

    for name in ("captured", "escaped", "hit_count"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(res.escape_dir.numpy(), np.asarray(ref.escape_dir),
                               atol=2e-3)
    count = np.asarray(ref.hit_count)
    hits_t, hits_j = res.hits.numpy(), np.asarray(ref.hits)
    assert hits_t.shape == hits_j.shape == (4, 12, w * h)
    for k in range(4):
        sel = count > k
        if sel.any():
            np.testing.assert_allclose(hits_t[k, :5][:, sel], hits_j[k, :5][:, sel],
                                       atol=2e-3)
            np.testing.assert_allclose(hits_t[k, 5:11][:, sel],
                                       hits_j[k, 5:11][:, sel], atol=5e-3)
            np.testing.assert_allclose(hits_t[k, 11, sel], hits_j[k, 11, sel],
                                       atol=2e-3)
        np.testing.assert_array_equal(hits_t[k, :, ~sel], 0.0)
    # The differentials are live: a one-pixel footprint on the disk.
    assert np.abs(hits_t[0, 5:11][:, count > 0]).max() > 1e-3


@pytest.mark.parametrize("reference", ["pure_jax", "pallas_interpret"])
@pytest.mark.parametrize("variant", [
    {}, {"with_differentials": True}, {"record_hits": False},
], ids=["slim", "aa", "nodisk"])
def test_step_counts_match_jax(variant, reference):
    w, h, tilt = SCENES["tilt15"]
    cam = build_camera([6.0, 0.0, 0.5], 60.0, w, h)
    kw = dict(_kw(tilt), record_step_counts=True, **variant)
    res = _port_trace(cam, w, h, **kw)
    ref = _jax_trace(reference, cam, w, h, **kw)
    assert res.steps.dtype == torch.int32 and res.steps.shape == (w * h,)
    np.testing.assert_array_equal(res.steps.numpy(), np.asarray(ref.steps))
    assert int(res.steps.min()) >= 1
    # Step counts leave every other output as it was.
    plain = _port_trace(cam, w, h, **{**kw, "record_step_counts": False})
    assert plain.steps is None
    for a, b in zip(res[:5], plain[:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", [
    {}, {"with_differentials": True}, {"record_hits": False},
], ids=["slim", "aa", "nodisk"])
def test_cli_default_disk_trace_matches_jax(variant):
    """The CLI default disk (r_outer 15 > r_escape 12.04) at 64x36, fov 90,
    step 0.1, against pure JAX: categories and step counts exact, floats
    within trace_compare's tolerances."""
    w, h = 64, 36
    cam = build_camera([6.0, 0.0, 0.5], 90.0, w, h)
    kw = dict(h_base=0.1, r_escape=12.04, tilt_deg=0.0, r_inner=2.0,
              r_outer=15.0, record_step_counts=True, **variant)
    res = _port_trace(cam, w, h, **kw)
    ref = interop.trace_result_from_numpy(*(
        np.asarray(x) for x in _jax_trace("pure_jax", cam, w, h, **kw)))
    n_feat = 11 if not variant else 12  # slim: the kernel leaves t_frac 0
    diff = compare_traces(res, ref, n_feat)
    assert failures(diff, exact=True, outliers_allowed=False) == [], diff
    # Rays near the photon ring integrate longer than typical rays.
    assert int(res.steps.max()) > 1.5 * float(res.steps.float().median())
    if variant.get("record_hits", True):
        # The disk is recorded out to near the escape radius, where its
        # outer edge (15) can no longer bind.
        hits = res.hits[0, :2][:, res.hit_count > 0]
        assert float((hits * hits).sum(0).sqrt().max()) > 10.0
    if variant.get("with_differentials"):
        assert diff.diff_rel_p99 > 0.0
        control = compare_traces(swap_differentials(res), ref)
        assert failures(control, exact=True, outliers_allowed=False)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_nodisk_trace_matches_jax(scene):
    w, h, tilt = SCENES[scene]
    cam = build_camera([6.0, 0.0, 0.5], 60.0, w, h)
    kw = dict(_kw(tilt), record_hits=False)
    res = _port_trace(cam, w, h, **kw)
    ref = _jax_trace("pure_jax", cam, w, h, **kw)
    for name in ("captured", "escaped", "hit_count"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(res.escape_dir.numpy(), np.asarray(ref.escape_dir),
                               atol=2e-3)
    assert bool((res.hits == 0).all()) and bool((res.hit_count == 0).all())
    # Lensing alone is the slim trace's: the same rays escape the same way.
    slim = _port_trace(cam, w, h, **_kw(tilt))
    assert torch.equal(res.escape_dir, slim.escape_dir)


def test_primary_differentials_match_jax():
    cam = build_camera([6.0, 0.0, 0.5], 60.0, 96, 40)
    params = torch.as_tensor(camera_params(cam))
    ddx, ddy = tgeo.primary_differentials_from_params(params, 96, 40)
    _, ref_x, ref_y = jgeo.primary_rays(cam)
    np.testing.assert_allclose(ddx.numpy(), np.asarray(ref_x), atol=1e-6)
    np.testing.assert_allclose(ddy.numpy(), np.asarray(ref_y), atol=1e-6)


@pytest.mark.parametrize("width, height", [(1920, 1080), (3840, 2160)])
def test_primary_differentials_hold_their_precision(width, height):
    """The one-pixel deltas of four rows through the frame's centre at
    fov 90 (a pixel's angle ~1e-3 at FHD, half that at 4K) against the
    same deltas in float64: within 2e-6 of each delta's norm. Subtracting
    two float32 unit vectors, as the Pallas kernel does, errs by up to
    ~3e-7 absolute, several 1e-4 of such a delta."""
    cam = build_camera([6.0, 0.0, 0.5], 90.0, width, height)
    params = torch.as_tensor(camera_params(cam))
    row0 = height // 2 - 2
    got = tgeo.primary_differentials_from_params(params, width, height, row0, 4)

    c = params.numpy().astype(np.float64)
    centre, right, up, pw, ph = c[0:3], c[3:6], c[6:9], c[12], c[13]
    top_left = centre + c[9:12] - right * (pw * width / 2) + up * (ph * height / 2)
    col = np.arange(width, dtype=np.float64)[None, :, None]
    row = np.arange(row0, row0 + 4, dtype=np.float64)[:, None, None]

    def unit(ox, oy):
        v = top_left + (col + ox) * pw * right - (row + oy) * ph * up - centre
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).reshape(-1, 3)

    for delta, (ox, oy) in zip(got, [(1.5, 0.5), (0.5, 1.5)]):
        ref = unit(ox, oy) - unit(0.5, 0.5)
        norm = np.linalg.norm(ref, axis=1, keepdims=True)
        np.testing.assert_array_less(np.abs(delta.numpy() - ref) / norm, 2e-6)


@pytest.mark.parametrize("band", [
    {"row_count": 8}, {"row_start": 4, "row_count": 12},
])
def test_row_band_runs_on_cpu(band):
    cam = torch.as_tensor(camera_params(build_camera([6.0, 0.0, 0.5], 60.0, 32, 16)))
    res = _port_trace_params(cam, 32, 16, **_kw(15.0), **band)
    full = _port_trace_params(cam, 32, 16, **_kw(15.0))
    start = band.get("row_start", 0)
    sel = slice(start * 32, (start + band["row_count"]) * 32)
    assert res.captured.shape == (band["row_count"] * 32,)
    assert bool((res.captured | res.escaped).all())
    for a, b in zip(res[:5], full[:5]):
        assert torch.equal(a, b[..., sel] if a.dim() == 3 else b[sel])


@pytest.mark.parametrize("variant", [
    {"with_differentials": True}, {"record_step_counts": True},
    {"record_hits": False},
])
def test_ported_variants_run_on_cpu(variant):
    cam = build_camera([6.0, 0.0, 0.5], 60.0, 32, 16)
    res = trace_geodesics_cuda(torch.as_tensor(camera_params(cam)), width=32,
                               height=16, **_kw(15.0), **variant)
    assert bool((res.captured | res.escaped).all())
    assert (res.steps is not None) == bool(variant.get("record_step_counts"))
    if variant.get("record_hits") is False:
        assert not bool(res.hits.any()) and not bool(res.hit_count.any())
    else:
        assert bool((res.hit_count > 0).any())
        recorded = res.hits[0][:, res.hit_count > 0]
        diffs_written = bool(recorded[5:11].abs().gt(0).any())
        assert diffs_written == bool(variant.get("with_differentials"))


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("steps", [False, True])
def test_kernel_name_covers_every_variant(diff, record, steps):
    name = kernel_name(with_differentials=diff, record_hits=record,
                       record_step_counts=steps)
    assert name in KERNELS
    assert name.endswith("_steps") == steps
    # AA without hit recording has nothing to write its differentials
    # into: it is the no-disk kernel.
    base = name.removesuffix("_steps")
    assert base == ("ray_march_aa" if diff and record
                    else "ray_march_slim" if record else "ray_march_nodisk")


@pytest.mark.parametrize("cam", [
    torch.zeros(14, dtype=torch.float64),
    torch.zeros(13, dtype=torch.float32),
    torch.zeros(28, dtype=torch.float32)[::2],
])
def test_wrapper_rejects_bad_camera_tensor(cam):
    with pytest.raises(ValueError, match="cam_params"):
        trace_geodesics_cuda(cam, width=8, height=8, **_kw(15.0))
