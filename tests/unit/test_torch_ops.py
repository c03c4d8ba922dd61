"""Port ops vs bhr_tpu on identical inputs (CPU, float32).

Inputs are made with NumPy from a seed and fed to both packages. The
JAX side runs its own CPU path (textures quad-packed in f32, as off the
TPU; the mip pyramid as the quad-packed mip atlas its Renderer builds).
Tolerances: 1e-5 absolute for the elementwise and sampling ops (XLA
contracts multiply-adds into FMAs on the CPU, torch does not, so results
differ in the last bits); 1e-3 for the lens flare, whose light position
is a brightness-weighted sum over the whole image (summation order
differs); the histogram quantiles return the same bin edge exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhr_tpu.ops import bloom as jbloom
from bhr_tpu.ops import fastmath as jfm
from bhr_tpu.ops import lens_flare as jflare
from bhr_tpu.ops import noise as jnoise
from bhr_tpu.ops import sampling as jsamp
from bhr_tpu.ops import shading as jshade
from bhr_tpu.ops import stats as jstats

from bhr_tpu_torch.ops import bloom as tbloom
from bhr_tpu_torch.ops import fastmath as tfm
from bhr_tpu_torch.ops import lens_flare as tflare
from bhr_tpu_torch.ops import noise as tnoise
from bhr_tpu_torch.ops import sampling as tsamp
from bhr_tpu_torch.ops import shading as tshade
from bhr_tpu_torch.ops import stats as tstats

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0,
                               atol=atol)


def test_fast_trig_matches():
    rng = np.random.default_rng(0)
    y = rng.normal(size=4096).astype(np.float32)
    x = rng.normal(size=4096).astype(np.float32)
    x[:8] = 0.0  # on the axes
    y[8:16] = 0.0
    _close(tfm.fast_atan2(_t(y), _t(x)), jfm.fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    z = np.concatenate([rng.uniform(-1.2, 1.2, 4000), [-1.0, 1.0, 0.0]]).astype(np.float32)
    _close(tfm.fast_arccos(_t(z)), jfm.fast_arccos(jnp.asarray(z)))


def test_skybox_sampler_matches():
    rng = np.random.default_rng(1)
    sky = rng.random((64, 128, 3)).astype(np.float32)
    d = rng.normal(size=(5000, 3)).astype(np.float32)
    d[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0]]  # poles, seam
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = jsamp.sample_skybox_quad(jsamp.pack_quad(jnp.asarray(sky)), jnp.asarray(d))
    _close(tsamp.sample_skybox(_t(sky), _t(d)), ref)


@pytest.mark.parametrize("t_offset", [0.0, 0.7])
def test_disk_sampler_matches(t_offset):
    rng = np.random.default_rng(2)
    tex = rng.random((32, 96, 4)).astype(np.float32)
    # Radii below r_inner (v < 0: row 0 alone) and above r_outer (v
    # clamps to the last row) as well as inside the annulus.
    r = rng.uniform(1.5, 4.0, 6000).astype(np.float32)
    phi = rng.uniform(-np.pi, np.pi, 6000).astype(np.float32)
    hx, hy = (r * np.cos(phi)).astype(np.float32), (r * np.sin(phi)).astype(np.float32)
    ref = jsamp.sample_disk_quad(jsamp.pack_quad(jnp.asarray(tex)), jnp.asarray(hx),
                                 jnp.asarray(hy), 2.0, 3.5, t_offset)
    _close(tsamp.sample_disk(_t(tex), _t(hx), _t(hy), 2.0, 3.5, t_offset), ref)


def _disk_hits(rng, n):
    """Hits inside, below (v < 0) and beyond (v clamps) the 2-3.5 annulus."""
    r = rng.uniform(1.5, 4.0, n).astype(np.float32)
    phi = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return (r * np.cos(phi)).astype(np.float32), (r * np.sin(phi)).astype(np.float32)


@pytest.mark.parametrize("layout,shape,t_offset", [
    ("atlas", (32, 96), 0.0), ("atlas", (32, 96), 0.7),
    ("quad_pyramid", (36, 100), 0.3),
])
def test_disk_mip_sampler_matches(layout, shape, t_offset):
    rng = np.random.default_rng(11)
    tex = rng.random(shape + (4,)).astype(np.float32)
    hx, hy = _disk_hits(rng, 6000)
    # LODs below 0, above the top level, on level boundaries and between.
    lod = np.concatenate([rng.uniform(-0.5, 5.0, 5990),
                          [0.0, 1.0, 2.0, 3.0, 4.0, 0.999, 1.999, 2.5, -1.0, 9.0]]
                         ).astype(np.float32)
    jmips = jsamp.build_mipmaps(jnp.asarray(tex), levels=4)
    n_levels = int(jmips.shape[0])
    args = (jnp.asarray(hx), jnp.asarray(hy), 2.0, 3.5, t_offset, jnp.asarray(lod))
    if layout == "atlas":  # what bhr_tpu's Renderer samples off the TPU
        ref = jsamp.sample_disk_mip_atlas(
            jsamp.pack_mip_atlas_from_pyramid(jmips, jnp.float32), n_levels, *args)
    else:  # sizes not divisible by 2^levels: the padded quad pyramid
        ref = jsamp.sample_disk_mip_quad(jsamp.pack_quad_mips(jmips), n_levels, *args)
    mips = tsamp.build_mipmaps(_t(tex), levels=4)
    assert mips.shape[0] == n_levels
    out = tsamp.sample_disk_mip(mips, n_levels, _t(hx), _t(hy), 2.0, 3.5, t_offset,
                                _t(lod))
    _close(out, ref)
    # LOD 0 everywhere is the level-0 sampler.
    zero = torch.zeros(6000)
    _close(tsamp.sample_disk_mip(mips, n_levels, _t(hx), _t(hy), 2.0, 3.5, t_offset,
                                 zero),
           tsamp.sample_disk(_t(tex), _t(hx), _t(hy), 2.0, 3.5, t_offset).numpy())


def _flare_images(seed, h=90, w=160, dark=False):
    rng = np.random.default_rng(seed)
    final = rng.random((h, w, 3)).astype(np.float32)
    disk = np.zeros((h, w, 3), np.float32)
    if not dark:
        # A bright off-center blob as the light, centered between pixels:
        # at the light's own pixel the streak angle is atan2 of rounding
        # noise.
        ys, xs = np.mgrid[0:h, 0:w]
        blob = np.exp(-((xs - 0.3 * w - 0.37) ** 2 + (ys - 0.6 * h - 0.21) ** 2)
                      / 60.0)
        disk = (blob[..., None] * rng.uniform(0.5, 1.0, 3)).astype(np.float32)
    else:
        disk[3, 5] = 0.001  # below the 0.01 guard
    return final, disk


@pytest.mark.parametrize("seed,shape,dark", [
    (12, (90, 160), False), (13, (64, 48), False), (14, (90, 160), True),
])
def test_lens_flare_matches(seed, shape, dark):
    final, disk = _flare_images(seed, *shape, dark=dark)
    out = tflare.apply_lens_flare(_t(final), _t(disk))
    ref = jflare.apply_lens_flare(jnp.asarray(final), jnp.asarray(disk))
    _close(out, ref, atol=1e-3)
    if dark:
        np.testing.assert_array_equal(out.numpy(), final)
    else:
        assert float((out - _t(final)).abs().max()) > 0.05  # the flare shows


def test_build_mipmaps_matches():
    rng = np.random.default_rng(3)
    tex = rng.random((32, 48, 4)).astype(np.float32)
    _close(tsamp.build_mipmaps(_t(tex), levels=4),
           jsamp.build_mipmaps(jnp.asarray(tex), levels=4), atol=1e-7)


@pytest.mark.parametrize("p", [1.5, 6.0, 1.2, 0.5])
def test_pow_const_matches(p):
    x = np.random.default_rng(4).random(1000).astype(np.float32)
    _close(tshade.pow_const(_t(x), p), jshade.pow_const(jnp.asarray(x), p))


def test_blackbody_matches():
    t = np.linspace(1000.0, 40000.0, 2000).astype(np.float32)
    _close(tshade.blackbody_rgb(_t(t)), jshade.blackbody_rgb(jnp.asarray(t)))


@pytest.mark.parametrize("tilt_deg", [0.0, 15.0])
def test_apply_g_factor_matches(tilt_deg):
    rng = np.random.default_rng(5)
    n = 4000
    r = rng.uniform(1.8, 15.0, n).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    tan_t = np.tan(np.deg2rad(tilt_deg))
    hit = np.stack([r * np.cos(phi), r * np.sin(phi), r * np.sin(phi) * tan_t],
                   -1).astype(np.float32)
    hit[:4] = 0.0  # empty slots reach the shader as zeros
    hit_r = np.sqrt(hit[:, 0] ** 2 + hit[:, 1] ** 2).astype(np.float32)
    to_cam = rng.normal(size=(n, 3)).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    cam = np.asarray([6.0, 0.0, 0.5], np.float32)
    args = (2.0, 15.0, float(np.deg2rad(tilt_deg)))
    ref = jshade.apply_g_factor(jnp.asarray(color), jnp.asarray(hit), jnp.asarray(hit_r),
                                jnp.asarray(to_cam), jnp.asarray(cam), *args)
    out = tshade.apply_g_factor(_t(color), _t(hit), _t(hit_r), _t(to_cam), _t(cam), *args)
    _close(out, ref)


@pytest.mark.parametrize("reference", ["apply_bloom_conv", "apply_bloom"])
def test_bloom_matches(reference):
    rng = np.random.default_rng(6)
    disk = (rng.random((64, 96, 3)) ** 4).astype(np.float32)
    disk[rng.random((64, 96)) < 0.5] = 0.0  # dark texels, bright blobs
    ref = getattr(jbloom, reference)(jnp.asarray(disk), width_ref=96)
    _close(tbloom.apply_bloom(_t(disk), width_ref=96), ref)


def test_lattice_hash_bit_exact():
    rng = np.random.default_rng(7)
    ijk = rng.integers(-2**20, 2**20, size=(3, 5000)).astype(np.int32)
    out = tnoise._hash3(*(_t(a) for a in ijk))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jnoise._hash3(*(jnp.asarray(a) for a in ijk))))


@pytest.mark.parametrize("scale", [1.0, 80.0, 800.0])
def test_simplex_and_fbm_match(scale):
    rng = np.random.default_rng(8)
    xyz = (rng.uniform(-1, 1, size=(3, 4000)) * scale).astype(np.float32)
    tx, jx = [_t(a) for a in xyz], [jnp.asarray(a) for a in xyz]
    _close(tnoise.simplex_noise_3d(*tx), jnoise.simplex_noise_3d(*jx))
    _close(tnoise.fbm_3d(*tx, 4, 0.45, 2.0), jnoise.fbm_3d(*jx, 4, 0.45, 2.0))


@pytest.mark.parametrize("q,masked", [(0.98, False), (0.95, True), (0.5, False)])
def test_approx_quantile_edges_equal(q, masked):
    rng = np.random.default_rng(9)
    x = (rng.random((96, 160)) ** 3).astype(np.float32)
    mask = x > 0.05 if masked else None
    out = tstats.approx_quantile(_t(x), q, mask=None if mask is None else _t(mask))
    ref = jstats.approx_quantile(jnp.asarray(x), q,
                                 mask=None if mask is None else jnp.asarray(mask))
    assert out.item() == float(ref)


def test_approx_quantile_rows_edges_equal():
    rng = np.random.default_rng(10)
    x = (rng.random((96, 160)) * 1.2).astype(np.float32)
    out = tstats.approx_quantile_rows(_t(x), 0.7, lo=0.0, hi=1.2)
    ref = jstats.approx_quantile_rows(jnp.asarray(x), 0.7, lo=0.0, hi=1.2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
