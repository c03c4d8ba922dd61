"""Port host layer vs bhr_tpu: config, camera, skybox, lifecycle control.

These modules are framework-free host code copied into the port (so it
imports no JAX); the same inputs must give the same values. Config and
camera compare exactly; the skybox is seeded NumPy and compares bit for
bit; lifecycle counts are exact and float parameters agree to rtol 1e-6
(radial_omega_rows evaluates the rotation law in float32, through XLA
on one side and torch on the other).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import bhr_tpu.camera as jcam
import bhr_tpu.config as jcfg
import bhr_tpu.models.lifecycle as jlife
from bhr_tpu.models.skybox import generate_skybox as j_generate_skybox

import bhr_tpu_torch.camera as tcam
import bhr_tpu_torch.config as tcfg
import bhr_tpu_torch.models.lifecycle as tlife
from bhr_tpu_torch import _build
from bhr_tpu_torch.models.skybox import generate_skybox as t_generate_skybox

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Scene fields the two SceneConfigs share (the port drops the settings
# of modes it does not have yet, and names torch devices).
_SHARED = [f.name for f in dataclasses.fields(tcfg.SceneConfig)
           if f.name != "device"]

_GOLDEN = dict(width=320, height=180, pov=(6.0, 0.0, 0.5), fov=60.0,
               step_size=0.1, r_max=10.0, n_stars=100, disk_inner_radius=2.0,
               disk_outer_radius=3.5, disk_tilt=15.0, seed=42)


def test_port_imports_no_jax():
    # Every module of the package, found by walking it (so a new module is
    # held to the rule without being listed here): none may pull in JAX,
    # bhr_tpu or the root bench.py and tools/, and none may import a viewer library (matplotlib, PIL) at
    # import time; the viewers import theirs when a window or JPEG is made.
    code = (
        "import importlib, pkgutil, sys\n"
        "import bhr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    bhr_tpu_torch.__path__, 'bhr_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('bhr_tpu_torch.ops.random', 'bhr_tpu_torch.utils.cache',\n"
        "             'bhr_tpu_torch.models.disk_v2.preview',\n"
        "             'bhr_tpu_torch.utils.preview_server', 'bhr_tpu_torch.bench',\n"
        "             'bhr_tpu_torch.tools._diag_scene',\n"
        "             'bhr_tpu_torch.tools.cost_shade'):\n"
        "    assert name in names, name\n"
        "from bhr_tpu_torch.parallel.mesh import initialize_multihost\n"
        "assert initialize_multihost(None) == 1\n"
        "assert 'matplotlib' not in sys.modules and 'PIL' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'bhr_tpu', 'bench',\n"
        "                                    'tools'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kwargs", [{}, _GOLDEN, {"resolution": "sd",
                                                   "disk_tilt": 30.0},
                                    {"anti_alias": "lod_radius", "lens_flare": True,
                                     "aa_strength": 1.5}])
def test_scene_config_matches(kwargs):
    j = jcfg.SceneConfig(**kwargs).validated()
    t = tcfg.SceneConfig(device="cpu", **kwargs).validated()
    assert {k: getattr(t, k) for k in _SHARED} == {k: getattr(j, k) for k in _SHARED}
    assert t.use_ray_differentials == j.use_ray_differentials
    assert t.image_size == j.image_size
    assert tcfg.scene_escape_radius(t) == jcfg.scene_escape_radius(j)
    assert tcfg.SceneConfig().device == "cuda"


@pytest.mark.parametrize("bad", [
    {"fov": 190.0}, {"pov": (0.5, 0.0, 0.0)}, {"width": 64},
    {"disk_inner_radius": 5.0, "disk_outer_radius": 4.0},
    {"step_size": 0.0}, {"resolution": "8k"}, {"device": "tpu"},
    {"aa_strength": 0.4}, {"aa_strength": 2.5},
])
def test_scene_config_rejects_bad_values(bad):
    with pytest.raises(ValueError):
        tcfg.SceneConfig(**bad).validated()


@pytest.mark.parametrize("args", [
    (1920, 1080, (6.0, 0.0, 0.5), 90.0, 2.0, 15.0),
    (320, 180, (6.0, 0.0, 0.5), 60.0, 2.0, 3.5),
    (3840, 2160, (4.0, 3.0, 1.0), 45.0, 3.0, 9.0),
])
def test_texture_resolution_and_escape_radius_match(args):
    assert (tcfg.compute_disk_texture_resolution(*args)
            == jcfg.compute_disk_texture_resolution(*args))
    assert tcfg.escape_radius(10.0, args[2]) == jcfg.escape_radius(10.0, args[2])


def test_fhd_texture_size_is_the_documented_one():
    # The full-width configuration: 2912 x 416 at generation scale 2.
    assert tcfg.compute_disk_texture_resolution(
        1920, 1080, (6.0, 0.0, 0.5), 90.0, 2.0, 15.0) == (2912, 416)


@pytest.mark.parametrize("pos,fov,w,h", [
    ((6.0, 0.0, 0.5), 60.0, 320, 180),
    ((0.0, 0.0, 8.0), 90.0, 64, 36),  # on the z-axis: right falls back to +x
    ((-3.0, 4.0, -1.0), 30.0, 100, 100),
])
def test_build_camera_matches(pos, fov, w, h):
    a, b = tcam.build_camera(pos, fov, w, h), jcam.build_camera(pos, fov, w, h)
    for name in ("pos", "right", "up", "forward"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.pixel_width, a.pixel_height, a.width, a.height) == (
        b.pixel_width, b.pixel_height, b.width, b.height)
    assert (tcam.orbit_camera_position(7, 36, 360.0, pos)
            == jcam.orbit_camera_position(7, 36, 360.0, pos))


def test_skybox_bit_identical():
    np.testing.assert_array_equal(
        t_generate_skybox(256, 128, n_stars=200, seed=42),
        j_generate_skybox(256, 128, n_stars=200, seed=42),
    )


@pytest.mark.parametrize("enable_rt", [True, False])
def test_lifecycle_factories_and_packs_match(enable_rt):
    n_r, r_in, r_out = 128, 2.0, 3.5
    tf = tlife.make_factories(n_r, r_in, r_out, 42, enable_rt=enable_rt)
    jf = jlife.make_factories(n_r, r_in, r_out, 42, enable_rt=enable_rt)
    for fam in ("filament", "hotspot", "rt_spike"):
        tf[fam].seed_initial(0.0)
        jf[fam].seed_initial(0.0)
    for now, dt in ((0.0, 0.0), (3.0, 3.0), (40.0, 37.0)):
        for fam in tf:
            tf[fam].tick(now, dt)
            jf[fam].tick(now, dt)
            assert len(tf[fam].entities) == len(jf[fam].entities)
        np.testing.assert_allclose(
            tlife.pack_filaments(tf["filament"], now),
            jlife.pack_filaments(jf["filament"], now), rtol=1e-6)
        for fam, cap in (("hotspot", tlife.MAX_HOTSPOTS),
                         ("rt_spike", tlife.MAX_RT_SPIKES)):
            np.testing.assert_allclose(
                tlife.pack_timer_entities(tf[fam], now, cap),
                jlife.pack_timer_entities(jf[fam], now, cap), rtol=1e-6)


def test_radial_omega_rows_match():
    tr, to = tlife.radial_omega_rows(416, 2.0, 15.0)
    jr, jo = jlife.radial_omega_rows(416, 2.0, 15.0)
    np.testing.assert_array_equal(tr, jr)
    assert to.dtype == np.float32
    np.testing.assert_allclose(to, jo, rtol=1e-6)


def test_cuda_device_without_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: 'cuda' is a valid device here")
    with pytest.raises(RuntimeError, match="cuda"):
        tcfg.torch_device("cuda")
    assert tcfg.torch_device("cpu").type == "cpu"


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    real_isfile = _build.os.path.isfile
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
