"""The port's V2 volume disk vs bhr_tpu, on the CPU.

The same inputs, made from a seed with NumPy, go through each function
of ``bhr_tpu.models.disk_v2`` and its counterpart in
``bhr_tpu_torch.models.disk_v2``:

* geometry, physical fields, the three modulations and their product
  (t = 0 and t > 0), both palettes and ``integrate_emission`` (default
  and explicit structure params, t = 0 and t > 0, grazing rays at the
  ``inv_dz`` cap, points inside ``r_in`` and beyond ``r_out``): abs
  1e-5 (XLA's and torch's ``atan2`` / ``exp`` / ``pow`` differ by ulps;
  measured <= 2.9e-6). The previews: abs 5e-5 (measured <= 2.7e-6).
* The seeded shear terms and hotspots are equal to ``bhr_tpu``'s
  exactly and the two lattice normalizers to 1e-6 relative; a normalizer
  is computed once over repeated calls.
* The conditions of ``tests/unit/test_disk_v2.py`` that no comparison
  covers, against the port: params validation, boundary conventions,
  batch independence, the seed reaching the structure, a narrow hotspot
  not saturated, preview shapes.
* ``shade_frame_v2`` against ``bhr_tpu.pipeline.shade_frame_v2`` on one
  trace carried across (64x36, tilt 15, both palettes, structure on,
  t > 0): max 1e-4 (measured 1.4e-6), in one pass over all hits and as
  the masked pass slot by slot.
* The slice as a whole: ``modes.render_image`` on the ``v2`` and
  ``v2sci`` golden scenes within max 5e-2 / mean 5e-4 of
  ``tests/goldens/e2e_cpu_v2.npz`` / ``e2e_cpu_v2sci.npz``, through
  exactly one plain trace call that records hits and no differentials,
  also with ``anti_alias="lod_radius"`` (the same image); a whole
  ``Renderer`` frame against ``bhr_tpu``'s: atol 1e-3.
* Config and CLI: the ``v2_*`` fields, their validation and
  ``v2_params()`` / ``v2_structure_params()`` equal ``bhr_tpu``'s; bad
  ``--v2_*`` values raise ValueError; ``device="cuda"`` without a GPU
  raises on the V2 entry points.
"""

import dataclasses
import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu.config as jcfg
import bhr_tpu.models.disk_v2 as jv2
import bhr_tpu.models.disk_v2.structure_modulations as jsm
from bhr_tpu import pipeline as jpipe
from bhr_tpu.camera import build_camera
from bhr_tpu.ops import geodesic as jgeo
from bhr_tpu.ops.sampling import pack_quad

import bhr_tpu_torch.models.disk_v2 as tv2
import bhr_tpu_torch.models.disk_v2.structure_modulations as tsm
import bhr_tpu_torch.ops.geodesic_cuda as tcuda
from bhr_tpu_torch import cli, interop
from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.modes import _scene_assets, render_image, render_video
from bhr_tpu_torch.parallel.frames import render_image_tiled
from bhr_tpu_torch.pipeline import (
    _shade_frame_v2_masked, shade_frame_v2, v2_shade_args)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import GOLDEN_DIR, SCENES, XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402

ATOL = 1e-5
N = 2048
JP = jv2.DiskV2Params(r_in=2.0, r_out=3.5)
JSP = jv2.DiskV2StructureParams(shear_strength=0.3, hotspot_count=5,
                                hotspot_phi_sigma=0.2)
TP, TSP = interop.disk_v2_params_from_dicts(dataclasses.asdict(JP),
                                            dataclasses.asdict(JSP))
GOLDEN_SCENE = dict(width=320, height=180, pov=(6.0, 0.0, 0.5), fov=60.0,
                    step_size=0.1, r_max=10.0, n_stars=100,
                    disk_inner_radius=2.0, disk_outer_radius=3.5,
                    disk_tilt=15.0, anti_alias="disabled", seed=42)
SMALL = dict(width=64, height=36, pov=(6.0, 0.0, 0.5), fov=60.0, step_size=0.3,
             n_stars=50, disk_inner_radius=2.0, disk_outer_radius=3.5,
             disk_tilt=15.0, disk_model="v2")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _points(seed=0):
    """(r, z, phi) float32: radii from inside r_in to beyond r_out, the
    two boundaries included; heights within and above the slab."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.2, 4.5, N).astype(np.float32)
    r[:4] = [JP.r_in, JP.r_out, JP.r_in - 1e-3, JP.r_out + 1e-3]
    z = rng.uniform(-0.3, 0.3, N).astype(np.float32)
    z[4:8] = 0.0
    phi = rng.uniform(-np.pi, 2 * np.pi, N).astype(np.float32)
    return r, z, phi


def _close(ours, theirs, atol=ATOL):
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    if ours.dtype == np.bool_:
        np.testing.assert_array_equal(ours, theirs)
        return
    assert np.isfinite(ours).all()
    err = float(np.abs(ours - theirs).max())
    print(f"max abs err {err:.3e} (bar {atol:g})")
    assert err <= atol, err


# -- every function against bhr_tpu's -----------------------------------------


@pytest.mark.parametrize("name", [
    "disk_half_thickness", "disk_radial_mask", "disk_radial_weight",
    "angular_velocity_field", "midplane_density_field",
    "midplane_temperature_field"])
def test_radial_function_matches(name):
    r, _, _ = _points()
    _close(getattr(tv2, name)(torch.tensor(r), TP),
           getattr(jv2, name)(jnp.asarray(r), JP))


@pytest.mark.parametrize("name", [
    "disk_vertical_weight", "disk_volume_mask", "density_field",
    "temperature_field"])
def test_volume_function_matches(name):
    r, z, _ = _points(1)
    _close(getattr(tv2, name)(torch.tensor(r), torch.tensor(z), TP),
           getattr(jv2, name)(jnp.asarray(r), jnp.asarray(z), JP))


def test_shared_fields_equal_their_parts_bit_for_bit():
    """rho and T computed together over shared terms are the products of
    geometry's public functions, bit for bit."""
    r, z, _ = _points(8)
    r, z = torch.tensor(r).reshape(-1, 8), torch.tensor(z).reshape(-1, 8)
    rho, temp = tv2.density_temperature_fields(r, z, TP)
    thickness = torch.clamp(tv2.disk_half_thickness(r, TP), min=2.220446049250313e-16)
    inside = tv2.disk_volume_mask(r, z, TP)
    w_z = tv2.disk_vertical_weight(r, z, TP)
    assert torch.equal(rho, torch.where(
        inside, tv2.midplane_density_field(r, TP)
        * torch.exp(-0.5 * torch.square(z / thickness)) * w_z, 0.0))
    assert torch.equal(temp, torch.where(
        inside, tv2.midplane_temperature_field(r, TP)
        * torch.clamp(1.0 - 0.25 * torch.abs(z) / thickness, 0.0, 1.0) * w_z, 0.0))
    assert torch.equal(rho, tv2.density_field(r, z, TP))
    assert float(rho.max()) > 0.1 and float(temp.max()) > 0.1


def test_smoothstep_matches_and_rejects_empty_edge():
    x = np.linspace(-1.0, 2.0, 257).astype(np.float32)
    _close(tv2.smoothstep(0.25, 1.5, torch.tensor(x)),
           jv2.smoothstep(0.25, 1.5, jnp.asarray(x)))
    y = tv2.smoothstep(0.0, 1.0, torch.tensor(x)).numpy()
    assert y[0] == 0.0 and y[-1] == 1.0 and (np.diff(y) >= -1e-7).all()
    with pytest.raises(ValueError):
        tv2.smoothstep(1.0, 1.0, torch.tensor(x))


@pytest.mark.parametrize("t", [0.0, 2.5])
@pytest.mark.parametrize("name", [
    "weak_mode_modulation", "shear_modulation", "hotspot_modulation",
    "structure_modulation"])
def test_modulation_matches(name, t):
    r, _, phi = _points(2)
    kw = {} if name == "weak_mode_modulation" else {"seed": 5}
    ours = getattr(tv2, name)(torch.tensor(r), torch.tensor(phi), TP, TSP,
                              t=t, **kw)
    theirs = getattr(jv2, name)(jnp.asarray(r), jnp.asarray(phi), JP, JSP,
                                t=t, **kw)
    _close(ours, theirs)
    # Neutral outside the disk, a real modulation inside it.
    assert (ours[torch.tensor(r) > JP.r_out] == 1.0).all()
    assert float((ours - 1.0).abs().max()) > 0.02


@pytest.mark.parametrize("mode", ["cinematic", "scientific"])
def test_palette_matches(mode):
    rng = np.random.default_rng(3)
    inten = rng.uniform(0.0, 6.0, N).astype(np.float32)
    inten[:8] = 0.0
    temp = rng.uniform(-0.1, 1.1, N).astype(np.float32)
    ours = tv2.apply_palette(torch.tensor(inten), torch.tensor(temp), mode)
    _close(ours, jv2.apply_palette(jnp.asarray(inten), jnp.asarray(temp), mode))
    assert ours.shape == (N, 3) and (ours[:8] == 0).all()  # no light, black
    if mode == "cinematic":  # blue clamped below red
        assert (ours[:, 2] <= ours[:, 0] + 1e-6).all()


def test_palette_rejects_unknown_mode_and_leaves_inputs_alone():
    inten, temp = torch.tensor([0.5, 2.0]), torch.tensor([0.2, 0.9])
    before = inten.clone(), temp.clone()
    tv2.apply_palette(inten, temp, "cinematic")
    assert torch.equal(inten, before[0]) and torch.equal(temp, before[1])
    with pytest.raises(ValueError, match="unknown palette"):
        tv2.apply_palette(inten, temp, "bogus")


def _crossings(seed=4):
    """Hit positions in the disk frame from inside r_in to beyond r_out
    and unit directions, the first 64 grazing (|dz| below the 0.05 cap)."""
    rng = np.random.default_rng(seed)
    rad = rng.uniform(1.5, 4.2, N)
    ang = rng.uniform(0.0, 2.0 * np.pi, N)
    hit = np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros(N)],
                   axis=-1).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:64, 2] = 0.004 * np.sign(d[:64, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    assert (np.abs(d[:64, 2]) < 0.05).all()
    return hit, d


@pytest.mark.parametrize("structure,t,samples", [
    (False, 0.0, 8), (False, 1.5, 8), (True, 0.0, 8), (True, 2.5, 8),
    (True, 2.5, 3)], ids=["default_t0", "default_t", "params_t0", "params_t",
                          "three_samples"])
def test_integrate_emission_matches(structure, t, samples):
    hit, d = _crossings()
    theirs = jv2.integrate_emission(
        jnp.asarray(hit), jnp.asarray(d), JP, JSP if structure else None,
        n_samples=samples, seed=7, t=t)
    ours = tv2.integrate_emission(
        torch.tensor(hit), torch.tensor(d), TP, TSP if structure else None,
        n_samples=samples, seed=7, t=t)
    for o, r in zip(ours, theirs):
        _close(o, r)
    inten, temp, alpha = (o.numpy() for o in ours)
    rad = np.hypot(hit[:, 0], hit[:, 1])
    outside = (rad < JP.r_in - 0.3) | (rad > JP.r_out + 0.3)
    steep = np.abs(d[:, 2]) > 0.9
    # Outside the disk is dark (0, not NaN), inside is lit.
    assert (inten[outside & steep] == 0).all() and (alpha[outside & steep] == 0).all()
    assert inten.max() > 0.1 and 0.9 < alpha.max() <= 1.0 and (temp >= 0).all()


def test_integrator_grazing_rays_more_opaque_and_outside_dark():
    hit = torch.tensor([[2.8, 0.0, 0.0]])
    steep = torch.tensor([[0.0, 0.0, -1.0]])
    shallow = torch.tensor([[0.95, 0.0, -0.31225]])
    a_steep = tv2.integrate_emission(hit, steep, TP)[2]
    a_shallow = tv2.integrate_emission(hit, shallow, TP)[2]
    assert float(a_shallow) > float(a_steep) > 0.0
    far = torch.tensor([[TP.r_out + 2.0, 0.0, 0.0]])
    inten, _, alpha = tv2.integrate_emission(far, steep, TP)
    assert float(inten) == 0.0 and float(alpha) == 0.0


def test_emissivity_volume_matches():
    r, z, phi = _points(5)
    ours = tv2.emissivity_volume(torch.tensor(r), torch.tensor(z),
                                 torch.tensor(phi), TP, TSP, seed=9, t=0.7)
    theirs = jv2.emissivity_volume(jnp.asarray(r), jnp.asarray(z),
                                   jnp.asarray(phi), JP, JSP, seed=9, t=0.7)
    for o, r_ in zip(ours, theirs):
        _close(o, r_)


@pytest.mark.parametrize("view", ["top", "density", "temperature"])
def test_preview_matches_and_has_its_shape(view):
    params_j = jv2.DiskV2Params(r_in=2.0, r_out=6.0)
    params_t = tv2.DiskV2Params(r_in=2.0, r_out=6.0)
    if view == "top":
        ours = tv2.render_top_view(params_t, size=96, seed=3)
        _close(ours, jv2.render_top_view(params_j, size=96, seed=3), atol=5e-5)
        top = ours.numpy()
        assert top.shape == (96, 96, 3) and top.max() > 0.05
        assert top[48, 48].max() < 1e-3  # dark inside r_in
        assert top[48, int(48 + 4.0 / (6.0 * 1.05) * 48)].max() > 0.01
        return
    ours = tv2.render_cross_section(params_t, size_r=64, size_z=16, field=view)
    _close(ours, jv2.render_cross_section(params_j, size_r=64, size_z=16,
                                          field=view), atol=5e-5)
    cs = ours.numpy()
    assert cs.shape == (16, 64) and 0.99 <= cs.max() <= 1.01
    assert cs[8].mean() >= cs[0].mean()  # the midplane is the brightest
    with pytest.raises(ValueError):
        tv2.render_cross_section(params_t, size_r=8, size_z=4, field="nope")


# -- seeded draws and the normalizers -----------------------------------------


@pytest.fixture()
def jax_lattice(monkeypatch):
    """Records what ``bhr_tpu``'s modulations hand to their lattice
    normalizer: the closure's seeded terms and the value returned."""
    seen = []
    real = jsm._lattice_max_abs

    def spy(raw_fn, *args, **kwargs):
        value = real(raw_fn, *args, **kwargs)
        seen.append((inspect.getclosurevars(raw_fn).nonlocals, float(value)))
        return value

    monkeypatch.setattr(jsm, "_lattice_max_abs", spy)
    return seen


@pytest.mark.parametrize("seed", [42, 5])
def test_shear_terms_and_normalizer_match(seed, jax_lattice):
    jv2.shear_modulation(jnp.asarray([2.5]), jnp.asarray([1.0]), JP, JSP,
                         seed=seed)
    (closure, theirs), = jax_lattice
    assert tsm.shear_terms(TSP, seed) == tuple(closure["terms"])
    assert len(closure["terms"]) == TSP.shear_components
    ours = tsm.shear_normalizer(TP, TSP, seed)
    print(f"shear normalizer {ours!r} vs {theirs!r}")
    assert abs(ours / theirs - 1.0) <= 1e-6


@pytest.mark.parametrize("seed", [43, 6])
def test_hotspots_and_normalizer_match(seed, jax_lattice):
    jv2.hotspot_modulation(jnp.asarray([2.5]), jnp.asarray([1.0]), JP, JSP,
                           seed=seed)
    (closure, theirs), = jax_lattice
    assert tsm.hotspot_spots(TP, TSP, seed) == tuple(closure["spots"])
    assert len(closure["spots"]) == TSP.hotspot_count
    ours = tsm.hotspot_normalizer(TP, TSP, seed)
    print(f"hotspot normalizer {ours!r} vs {theirs!r}")
    assert abs(ours / theirs - 1.0) <= 1e-6


def test_structure_draws_from_seed_and_seed_plus_one(jax_lattice):
    jv2.structure_modulation(jnp.asarray([2.5]), jnp.asarray([1.0]), JP, JSP,
                             seed=11)
    (shear, _), (hot, _) = jax_lattice
    assert tsm.shear_terms(TSP, 11) == tuple(shear["terms"])
    assert tsm.hotspot_spots(TP, TSP, 12) == tuple(hot["spots"])


def test_normalizers_are_computed_once():
    params = tv2.DiskV2Params(r_in=2.0, r_out=3.25)  # no other test's key
    r, _, phi = _points(6)
    r, phi = torch.tensor(r), torch.tensor(phi)
    before = tsm.lattice_evaluations
    first = tv2.structure_modulation(r, phi, params, TSP, seed=21, t=0.0)
    assert tsm.lattice_evaluations == before + 2  # shear and hotspots
    for t in (0.0, 1.0, 2.0):
        again = tv2.structure_modulation(r, phi, params, TSP, seed=21, t=t)
        tv2.integrate_emission(*map(torch.tensor, _crossings()), params, TSP,
                               seed=21, t=t)
    assert tsm.lattice_evaluations == before + 2
    assert not torch.equal(first, again)  # t moved the pattern
    # Another seed is another pattern: it is normalized on its own.
    tv2.shear_modulation(r, phi, params, TSP, seed=22)
    assert tsm.lattice_evaluations == before + 3


# -- test_disk_v2.py's conditions, for the port -------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(r_in=-1.0), dict(r_in=5.0, r_out=3.0), dict(h0=0.0),
    dict(rho_power=0.0), dict(edge_softness=0.6), dict(temp_scale=0.0),
    dict(omega_scale=-1.0)])
def test_params_validation(kwargs):
    with pytest.raises(ValueError):
        tv2.DiskV2Params(**kwargs)
    with pytest.raises(ValueError):  # bhr_tpu refuses the same values
        jv2.DiskV2Params(**kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(mode1_strength=0.6, mode2_strength=0.5), dict(shear_strength=1.0),
    dict(hotspot_strength=1.0), dict(hotspot_count=0),
    dict(shear_components=0), dict(hotspot_phi_sigma=0.0),
    dict(hotspot_inner_bias=-1.0)])
def test_structure_params_validation(kwargs):
    with pytest.raises(ValueError):
        tv2.DiskV2StructureParams(**kwargs)
    with pytest.raises(ValueError):
        jv2.DiskV2StructureParams(**kwargs)


def test_params_defaults_and_fields_match():
    assert dataclasses.asdict(tv2.DiskV2Params()) == dataclasses.asdict(
        jv2.DiskV2Params())
    assert dataclasses.asdict(tv2.DiskV2StructureParams()) == dataclasses.asdict(
        jv2.DiskV2StructureParams())
    params, structure = interop.disk_v2_params_from_dicts(
        dataclasses.asdict(JP))
    assert params == TP and structure is None
    with pytest.raises(ValueError):
        interop.disk_v2_params_from_dicts({"r_in": 3.0, "r_out": 2.0})


def test_mask_closed_interval_weight_closes_to_zero():
    p = tv2.DiskV2Params()
    for r in (p.r_in, p.r_out):
        assert bool(tv2.disk_radial_mask(r, p))
        assert float(tv2.disk_radial_weight(r, p)) == 0.0
    assert float(tv2.disk_radial_weight(0.5 * (p.r_in + p.r_out), p)) == 1.0
    assert not bool(tv2.disk_radial_mask(p.r_in - 1e-6, p))
    assert not bool(tv2.disk_radial_mask(p.r_out + 1e-6, p))
    h = float(tv2.disk_half_thickness(5.0, p))
    assert float(tv2.disk_vertical_weight(5.0, 0.0, p)) == 1.0
    assert float(tv2.disk_vertical_weight(5.0, h, p)) == 0.0
    assert bool(tv2.disk_volume_mask(5.0, h, p))
    assert not bool(tv2.disk_volume_mask(5.0, h + 1e-6, p))
    # Scalars in, 0-d tensors out; a tensor and a number mix.
    assert tv2.density_field(5.0, 0.0, p).ndim == 0
    assert tv2.density_field(torch.linspace(2.5, 9.0, 8), 0.0, p).shape == (8,)
    assert float(tv2.midplane_temperature_field(p.r_in, p)) == 0.0


def test_modulation_batch_independent():
    p = tv2.DiskV2Params()
    rng = np.random.default_rng(7)
    r = torch.tensor(rng.uniform(p.r_in + 0.2, p.r_out - 0.2, 64), dtype=torch.float32)
    phi = torch.tensor(rng.uniform(0, 2 * np.pi, 64), dtype=torch.float32)
    full = tv2.structure_modulation(r, phi, p)
    # The lattice constant normalizes: a point does not feel its batch.
    assert torch.equal(tv2.structure_modulation(r[:5], phi[:5], p), full[:5])
    one = float(tv2.structure_modulation(r[0], phi[0], p))
    np.testing.assert_allclose(one, float(full[0]), rtol=1e-6)
    assert (full > 0).all() and 0.3 < float(full.mean()) < 1.7


def test_advection_rotates_pattern():
    p = tv2.DiskV2Params()
    omega = float(tv2.angular_velocity_field(4.0, p))
    moved = float(tv2.shear_modulation(4.0, 1.0, p, seed=3, t=3.0))
    static = float(tv2.shear_modulation(4.0, 1.0 - omega * 3.0, p, seed=3))
    assert abs(moved - static) < 1e-5


def test_hotspot_narrow_sigma_not_saturated():
    sp = tv2.DiskV2StructureParams(hotspot_phi_sigma=0.004,
                                   hotspot_logr_sigma=0.003)
    params = tv2.DiskV2Params()
    center_phi, center_logr, _ = tsm.hotspot_spots(params, sp, 11)[0]
    r0 = params.r_in * float(np.exp(center_logr))
    offs = np.array([0.0, 0.25, 0.5, 1.0]) * sp.hotspot_phi_sigma
    vals = tv2.hotspot_modulation(
        torch.full(offs.shape, r0, dtype=torch.float32),
        torch.tensor(center_phi + offs, dtype=torch.float32),
        params, sp, seed=11).numpy()
    # Peak bounded by the normalization, smooth monotone falloff.
    assert vals[0] <= 1.0 + sp.hotspot_strength + 1e-6
    assert np.all(np.diff(vals) < 0), vals
    assert vals[0] - vals[1] > 5e-3 * sp.hotspot_strength, vals


def test_pipeline_v2_seed_reaches_structure():
    cfg = SceneConfig(device="cpu", **SMALL).validated()
    sky = np.random.default_rng(0).random((64, 128, 3)).astype(np.float32)
    imgs = [interop.renderer_from_numpy(dataclasses.replace(cfg, seed=seed),
                                        sky, None).render(cfg.pov, cfg.fov)
            for seed in (1, 2)]
    assert not np.allclose(imgs[0], imgs[1])


# -- shade_frame_v2 on one trace carried across -------------------------------


@pytest.fixture(scope="module")
def jax_trace():
    w, h = 64, 36
    cam = build_camera([6.0, 0.0, 0.5], 60.0, w, h)
    dirs, _, _ = jgeo.primary_rays(cam)
    trace = jgeo.trace_geodesics(jnp.asarray(cam.pos), dirs, h_base=0.2,
                                 r_escape=12.04, tilt_deg=15.0, r_inner=2.0,
                                 r_outer=3.5)
    assert int(np.asarray(trace.hit_count).max()) >= 2  # ghost slots shade too
    return cam, trace, (h, w)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "masked"])
@pytest.mark.parametrize("palette", ["cinematic", "scientific"])
def test_shade_frame_v2_matches_on_jax_trace(jax_trace, palette, compact):
    cam, trace, image_shape = jax_trace
    sky = np.random.default_rng(0).random((64, 128, 3)).astype(np.float32)
    kw = dict(tilt_deg=15.0, t_offset=0.7, palette=palette, n_samples=8,
              seed=42)
    ref = jpipe.shade_frame_v2(
        trace, pack_quad(jnp.asarray(sky)), jnp.asarray(cam.pos),
        v2_params=JP, v2_structure=JSP, image_shape=image_shape, **kw)
    port_trace = interop.trace_result_from_numpy(
        *(np.asarray(x) for x in trace[:5]))
    slots = []
    shade = shade_frame_v2 if compact else _shade_frame_v2_masked
    out = shade(
        port_trace, torch.as_tensor(sky), torch.as_tensor(cam.pos),
        v2_params=TP, v2_structure=TSP,
        on_slot=lambda k, n: slots.append((k, n)), **kw)
    for o, r in zip(out, ref):
        _close(o, r, atol=1e-4)
    assert float(out[1].max()) > 0.3  # the disk is lit
    # One entry per populated slot; compaction integrates only its hits.
    counts = np.asarray(trace.hit_count)
    assert [k for k, _ in slots] == list(range(int(counts.max())))
    n = counts.size
    assert [m for _, m in slots] == [
        int((counts > k).sum()) if compact else n for k, _ in slots]


def test_shade_frame_v2_without_hits_is_the_sky(jax_trace):
    cam, trace, _ = jax_trace
    arrays = [np.asarray(x) for x in trace[:5]]
    arrays[3] = np.zeros_like(arrays[3])  # no ray recorded a crossing
    sky = np.random.default_rng(0).random((64, 128, 3)).astype(np.float32)
    slots = []
    bg, disk, alpha = shade_frame_v2(
        interop.trace_result_from_numpy(*arrays), torch.as_tensor(sky),
        torch.as_tensor(cam.pos), v2_params=TP, v2_structure=None,
        tilt_deg=15.0, t_offset=0.0, on_slot=lambda k, n: slots.append(k))
    assert slots == [] and float(disk.max()) == 0.0 and float(alpha.max()) == 0.0
    assert float(bg.max()) > 0.5


# -- the slice as a whole -----------------------------------------------------


@pytest.fixture()
def plain_traces(monkeypatch):
    """Counts the plain trace's calls: (with_differentials, record_hits)."""
    calls = []
    real = tcuda.trace_geodesics

    def spy(*args, **kwargs):
        calls.append((bool(kwargs.get("with_differentials", False)),
                      bool(kwargs.get("record_hits", True))))
        return real(*args, **kwargs)

    monkeypatch.setattr(tcuda, "trace_geodesics", spy)
    return calls


@pytest.mark.parametrize("scene", ["v2", "v2sci"])
def test_golden_v2_scene_within_cross_backend_bounds(scene, plain_traces):
    img = render_image(SceneConfig(device="cpu", **{**GOLDEN_SCENE,
                                                     **SCENES[scene]}))
    golden = np.load(os.path.join(GOLDEN_DIR, f"e2e_cpu_{scene}.npz"))["image"]
    assert img.shape == golden.shape == (180, 320, 3)
    diff = np.abs(img.astype(np.float64) - golden.astype(np.float64))
    print(f"port vs e2e_cpu_{scene}.npz: max={diff.max():.3e} "
          f"mean={diff.mean():.3e}")
    assert diff.max() <= XB_MAX_ABS_TOL, diff.max()
    assert diff.mean() <= XB_MEAN_ABS_TOL, diff.mean()
    # One trace, with hits recorded (there is a disk to shade) and no
    # differentials.
    assert plain_traces == [(False, True)]
    assert np.isfinite(img).all() and img.max() > 0.5


def test_v2_ignores_anti_alias(plain_traces):
    base = SceneConfig(device="cpu", **SMALL)
    plain = render_image(base)
    aa = render_image(dataclasses.replace(base, anti_alias="lod_radius"))
    np.testing.assert_array_equal(plain, aa)
    assert plain_traces == [(False, True)] * 2


def test_v2_scene_has_no_texture_and_no_lifecycle():
    cfg = SceneConfig(device="cpu", **SMALL).validated()
    sky, tex, dynamic = _scene_assets(cfg, torch.device("cpu"))
    assert tex is None and dynamic is None and sky.shape == (1024, 2048, 3)
    renderer = interop.renderer_from_numpy(cfg, sky[::8, ::8], None)
    assert renderer.disk_mips is None
    with pytest.raises(ValueError, match="no disk texture"):
        interop.renderer_from_numpy(cfg, sky[::8, ::8],
                                    np.zeros((8, 16, 4), np.float32))


@pytest.mark.parametrize("extra", [
    {}, {"v2_palette": "scientific", "v2_structure": True,
         "v2_shear_strength": 0.4, "v2_samples": 5}], ids=["v2", "v2_knobs"])
def test_renderer_v2_frame_matches_on_same_assets(extra):
    v, u = np.meshgrid(np.linspace(0, np.pi, 64), np.linspace(0, 2 * np.pi, 128),
                       indexing="ij")
    sky = np.stack([0.3 + 0.2 * np.sin(3 * u) * np.sin(v),
                    0.2 + 0.1 * np.cos(2 * v), 0.25 + 0.2 * np.sin(u + v)],
                   -1).astype(np.float32)
    kw = {**SMALL, "step_size": 0.2, **extra}
    ref = jpipe.Renderer(jcfg.SceneConfig(**kw).validated(), sky, None,
                         use_pallas=False).render(kw["pov"], kw["fov"], frame=3)
    port = interop.renderer_from_numpy(
        SceneConfig(device="cpu", **kw).validated(), sky, None)
    out = port.render(kw["pov"], kw["fov"], frame=3)
    err = float(np.abs(out - ref).max())
    print(f"V2 Renderer frame vs bhr_tpu: max abs err {err:.3e} (bar 1e-3)")
    assert out.shape == (36, 64, 3) and err <= 1e-3
    # The frame index is the structure's advection time.
    assert np.abs(out - port.render(kw["pov"], kw["fov"], frame=0)).max() > 1e-3


@pytest.mark.parametrize("extra", [{}, {"v2_structure": True,
                                        "v2_palette": "scientific"}],
                         ids=["v2", "v2sci"])
def test_v2_tiled_still_equals_whole_frame(extra):
    kw = dict(SMALL, width=64, height=32, **extra)
    whole = render_image(SceneConfig(device="cpu", **kw))
    tiled = render_image_tiled(
        SceneConfig(device="cpu", tile_shards=4, **kw),
        devices=[torch.device("cpu")] * 4)
    err = float(np.abs(tiled - whole).max())
    print(f"V2 tiled vs whole: max abs err {err:.3e} (bar 2e-5)")
    assert err <= 2e-5 and whole.max() > 0.3


# -- config and CLI -----------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    {"disk_model": "v2"},
    {"disk_model": "v2", "v2_structure": True, "v2_palette": "scientific",
     "v2_samples": 4, "v2_h0": 0.08, "v2_beta_h": 0.1, "v2_rho_power": 1.5,
     "v2_temp_scale": 2.0, "v2_omega_scale": 0.5, "v2_edge_softness": 0.2,
     "v2_mode1_strength": 0.1, "v2_shear_components": 4,
     "v2_hotspot_count": 3, "disk_inner_radius": 3.0}],
    ids=["defaults", "knobs"])
def test_v2_config_matches(kwargs):
    j = jcfg.SceneConfig(**kwargs).validated()
    t = SceneConfig(device="cpu", **kwargs).validated()
    fields = [f.name for f in dataclasses.fields(t) if f.name.startswith("v2_")]
    assert len(fields) == 18
    assert {k: getattr(t, k) for k in fields} == {k: getattr(j, k) for k in fields}
    assert dataclasses.asdict(t.v2_params()) == dataclasses.asdict(j.v2_params())
    js, ts = j.v2_structure_params(), t.v2_structure_params()
    assert (ts is None) == (js is None) == (not t.v2_structure)
    if ts is not None:
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert not t.use_ray_differentials
    args = v2_shade_args(t)
    assert args["v2_params"] == t.v2_params() and args["seed"] == t.seed
    assert args["n_samples"] == t.v2_samples and args["palette"] == t.v2_palette


@pytest.mark.parametrize("bad", [
    {"v2_palette": "sepia"}, {"v2_samples": 0}, {"v2_h0": 0.0},
    {"v2_edge_softness": 0.5}, {"v2_rho_power": -1.0},
    {"v2_structure": True, "v2_mode1_strength": 0.6, "v2_mode2_strength": 0.5},
    {"v2_structure": True, "v2_hotspot_count": 0},
    {"disk_texture": "disk.npy"}])
def test_v2_config_rejects_bad_values(bad):
    with pytest.raises(ValueError):
        SceneConfig(device="cpu", disk_model="v2", **bad).validated()
    with pytest.raises(ValueError):
        jcfg.SceneConfig(disk_model="v2", **bad).validated()


@pytest.mark.parametrize("flags", [
    ["--v2_samples", "0"], ["--v2_h0", "-0.1"], ["--v2_edge_softness", "0.7"],
    ["--v2_structure", "--v2_shear_strength", "1.0"],
    ["--v2_structure", "--v2_hotspot_logr_sigma", "0"]])
def test_cli_rejects_bad_v2_values(flags, tmp_path):
    with pytest.raises(ValueError):
        cli.main(["--disk_model", "v2", "--device", "cpu", "--width", "32",
                  "--height", "16", "-o", str(tmp_path / "x.png")] + flags)
    assert os.listdir(tmp_path) == []


def test_cli_v2_flags_have_bhr_tpu_defaults():
    import bhr_tpu.cli as jcli

    ours = vars(cli.build_parser().parse_args([]))
    theirs = vars(jcli.build_parser().parse_args([]))
    names = [k for k in ours if k.startswith("v2_")]
    assert len(names) == 18
    assert {k: ours[k] for k in names} == {k: theirs[k] for k in names}
    config = cli.config_from_args(cli.build_parser().parse_args(
        ["--disk_model", "v2", "--v2_structure", "--v2_hotspot_count", "3",
         "--v2_palette", "scientific", "--device", "cpu"]))
    assert config.v2_structure and config.v2_hotspot_count == 3
    assert config.v2_palette == "scientific"


def test_cli_writes_v2_png(tmp_path, capsys):
    out = tmp_path / "v2.png"
    assert cli.main(["--disk_model", "v2", "--v2_structure", "--v2_palette",
                     "scientific", "--device", "cpu", "--width", "64",
                     "--height", "36", "--fov", "60", "--n_stars", "50",
                     "--ar2", "3.5", "--disk_tilt", "15", "-o", str(out)]) == 0
    assert "Saved" in capsys.readouterr().out and out.stat().st_size > 500


@pytest.mark.parametrize("entry", ["still", "tiled", "video", "batched"])
def test_v2_cuda_without_gpu_raises(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    kw = dict(SMALL, output=str(tmp_path / "x.mp4"))
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        if entry == "still":
            render_image(SceneConfig(**kw))
        elif entry == "tiled":
            render_image(SceneConfig(tile_shards=2, **kw))
        elif entry == "video":
            render_video(SceneConfig(video=True, n_frames=2, **kw))
        else:
            from bhr_tpu_torch.parallel.video import render_video_sharded

            render_video_sharded(SceneConfig(video=True, n_frames=2, **kw))
