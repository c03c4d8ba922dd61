"""The port's still-frame slice vs bhr_tpu, end to end on the CPU.

* ``shade_frame`` on a trace made by JAX (passed in through
  ``interop``) against ``bhr_tpu.pipeline.shade_frame``, with level-0
  sampling and with the AA mip-LOD branch: atol 1e-4.
* A whole ``Renderer`` frame over identical NumPy assets — default, AA
  with lens flare, and without a disk texture: atol 1e-3.
* The golden default scene rendered by ``modes.render_image`` against
  ``tests/goldens/e2e_cpu.npz`` (what bhr_tpu renders on the CPU),
  within the cross-backend bounds of ``tests/e2e_render.py``: max
  |diff| <= 5e-2 and mean <= 5e-4 (the AA and flare goldens are in
  ``test_torch_aa.py``).
* The CLI writes a PNG, with AA and lens flare, for the V2 disk and
  with ``--disk_texture auto`` too; ``--interactive`` reaches the
  session, and more row bands than devices raise.
"""

import os
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu.config as jcfg
from bhr_tpu import pipeline as jpipe
from bhr_tpu.camera import build_camera
from bhr_tpu.ops import geodesic as jgeo
from bhr_tpu.ops.sampling import (
    build_mipmaps,
    pack_mip_atlas_from_pyramid,
    pack_quad,
    pack_quad_mips,
)

from bhr_tpu_torch import cli, interop
from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.modes import render_image
from bhr_tpu_torch.ops.sampling import build_mipmaps as t_build_mipmaps
from bhr_tpu_torch.pipeline import shade_frame
from bhr_tpu_torch.utils.io import quantize_frame

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import GOLDEN_DIR, XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402

GOLDEN_SCENE = dict(width=320, height=180, pov=(6.0, 0.0, 0.5), fov=60.0,
                    step_size=0.1, r_max=10.0, n_stars=100,
                    disk_inner_radius=2.0, disk_outer_radius=3.5,
                    disk_tilt=15.0, anti_alias="disabled", seed=42)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Module scope: autouse fixtures of a scope run before the other
    # fixtures of that scope, so the module-scoped golden render runs
    # with few threads too (many threads per test worker contend).
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assets(seed=0):
    rng = np.random.default_rng(seed)
    sky = rng.random((64, 128, 3)).astype(np.float32)
    tex = rng.random((32, 96, 4)).astype(np.float32)
    tex[..., 3] = rng.random((32, 96)).astype(np.float32) ** 0.5
    return sky, tex


def test_shade_frame_matches_on_jax_trace():
    w, h = 96, 48
    sky, tex = _assets()
    cam = build_camera([6.0, 0.0, 0.5], 60.0, w, h)
    dirs, _, _ = jgeo.primary_rays(cam)
    trace = jgeo.trace_geodesics(jnp.asarray(cam.pos), dirs, h_base=0.2,
                                 r_escape=12.04, tilt_deg=15.0, r_inner=2.0,
                                 r_outer=3.5)
    assert int(np.asarray(trace.hit_count).max()) >= 2  # ghost slots shade too
    kw = dict(r_inner=2.0, r_outer=3.5, tilt_deg=15.0, t_offset=0.3)
    ref = jpipe.shade_frame(
        trace, pack_quad(jnp.asarray(sky)),
        pack_quad_mips(build_mipmaps(jnp.asarray(tex), levels=2)), 3,
        jnp.asarray(cam.pos), use_lod=False, aa_strength=1.0,
        image_shape=(h, w), **kw)
    port_trace = interop.trace_result_from_numpy(
        *(np.asarray(x) for x in trace[:5]))
    out = shade_frame(port_trace, torch.as_tensor(sky), torch.as_tensor(tex)[None],
                      torch.as_tensor(cam.pos), **kw)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4)
    back = interop.trace_result_to_numpy(port_trace)
    np.testing.assert_array_equal(back[3], np.asarray(trace.hit_count))
    assert back[5] is None  # no step counts in this trace


@pytest.mark.parametrize("aa_strength", [1.0, 2.0])
def test_shade_frame_lod_matches_on_jax_aa_trace(aa_strength):
    w, h = 96, 48
    sky, tex = _assets(1)
    cam = build_camera([6.0, 0.0, 0.5], 60.0, w, h)
    dirs, ddx, ddy = jgeo.primary_rays(cam)
    trace = jgeo.trace_geodesics(jnp.asarray(cam.pos), dirs, d_dir_dx0=ddx,
                                 d_dir_dy0=ddy, with_differentials=True,
                                 record_step_counts=True, h_base=0.2,
                                 r_escape=12.04, tilt_deg=15.0, r_inner=2.0,
                                 r_outer=3.5)
    assert int(np.asarray(trace.hit_count).max()) >= 2  # ghost slots shade too
    kw = dict(r_inner=2.0, r_outer=3.5, tilt_deg=15.0, t_offset=0.3)
    jmips = build_mipmaps(jnp.asarray(tex), levels=4)
    # bhr_tpu's Renderer samples the mip atlas for LOD renders.
    ref = jpipe.shade_frame(
        trace, pack_quad(jnp.asarray(sky)),
        pack_mip_atlas_from_pyramid(jmips, jnp.float32), int(jmips.shape[0]),
        jnp.asarray(cam.pos), use_lod=True, aa_strength=aa_strength,
        image_shape=(h, w), **kw)
    port_trace = interop.trace_result_from_numpy(*(np.asarray(x) for x in trace))
    assert port_trace.steps.dtype == torch.int32
    mips = t_build_mipmaps(torch.as_tensor(tex), levels=4)
    out = shade_frame(port_trace, torch.as_tensor(sky), mips,
                      torch.as_tensor(cam.pos), use_lod=True,
                      aa_strength=aa_strength, **kw)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4)
    # The LOD branch does sample coarser levels than level 0 here.
    flat = shade_frame(port_trace, torch.as_tensor(sky), mips,
                       torch.as_tensor(cam.pos), **kw)
    assert float((flat[1] - out[1]).abs().max()) > 1e-3
    back = interop.trace_result_to_numpy(port_trace)
    np.testing.assert_array_equal(back[5], np.asarray(trace.steps))


def _smooth_assets():
    """Band-limited sky and disk textures: a trace's float outputs agree
    to ~1e-4 (see test_torch_trace.py), and a smooth texture keeps that
    from turning into texel-sized jumps."""
    v, u = np.meshgrid(np.linspace(0, np.pi, 64), np.linspace(0, 2 * np.pi, 128),
                       indexing="ij")
    sky = np.stack([0.3 + 0.2 * np.sin(3 * u) * np.sin(v),
                    0.2 + 0.1 * np.cos(2 * v), 0.25 + 0.2 * np.sin(u + v)], -1)
    r, p = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 2 * np.pi, 96,
                                                          endpoint=False),
                       indexing="ij")
    tex = np.stack([0.6 + 0.3 * np.sin(4 * p), 0.4 + 0.2 * r,
                    0.3 + 0.2 * np.cos(2 * p + 3 * r), 0.5 + 0.4 * np.sin(p) * r], -1)
    return sky.astype(np.float32), tex.astype(np.float32)


def test_renderer_frame_matches_on_same_assets():
    sky, tex = _smooth_assets()
    kw = dict(width=96, height=48, pov=(6.0, 0.0, 0.5), fov=60.0,
              step_size=0.2, disk_inner_radius=2.0, disk_outer_radius=3.5,
              disk_tilt=15.0)
    ref = jpipe.Renderer(jcfg.SceneConfig(**kw).validated(), sky, tex,
                         use_pallas=False).render(kw["pov"], kw["fov"])
    port = interop.renderer_from_numpy(
        SceneConfig(device="cpu", **kw).validated(), sky, tex)
    out = port.render(kw["pov"], kw["fov"])
    assert out.shape == (48, 96, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_renderer_aa_flare_frame_matches_on_same_assets():
    sky, tex = _smooth_assets()
    kw = dict(width=96, height=48, pov=(6.0, 0.0, 0.5), fov=60.0,
              step_size=0.2, disk_inner_radius=2.0, disk_outer_radius=3.5,
              disk_tilt=15.0, anti_alias="lod_radius", lens_flare=True)
    ref = jpipe.Renderer(jcfg.SceneConfig(**kw).validated(), sky, tex,
                         use_pallas=False).render(kw["pov"], kw["fov"])
    port = interop.renderer_from_numpy(
        SceneConfig(device="cpu", **kw).validated(), sky, tex)
    out = port.render(kw["pov"], kw["fov"])
    assert out.shape == (48, 96, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    # Both switches change the frame.
    plain = port.render(kw["pov"], kw["fov"], skip_differentials=True,
                        lens_flare=False)
    assert np.abs(out - plain).max() > 1e-2


def test_renderer_frame_without_disk_matches():
    sky, _ = _smooth_assets()
    kw = dict(width=96, height=48, pov=(6.0, 0.0, 0.5), fov=60.0,
              step_size=0.2, disk_inner_radius=2.0, disk_outer_radius=3.5,
              disk_tilt=15.0, anti_alias="lod_radius")
    ref = jpipe.Renderer(jcfg.SceneConfig(**kw).validated(), sky, None,
                         use_pallas=False).render(kw["pov"], kw["fov"])
    port = interop.renderer_from_numpy(
        SceneConfig(device="cpu", **kw).validated(), sky, None)
    assert port.disk_mips is None
    out = port.render(kw["pov"], kw["fov"])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def golden_render():
    return render_image(SceneConfig(device="cpu", **GOLDEN_SCENE))


def test_golden_default_scene_within_cross_backend_bounds(golden_render):
    golden = np.load(os.path.join(GOLDEN_DIR, "e2e_cpu.npz"))["image"]
    assert golden_render.shape == golden.shape == (180, 320, 3)
    diff = np.abs(golden_render.astype(np.float64) - golden.astype(np.float64))
    print(f"port vs e2e_cpu.npz: max={diff.max():.3e} mean={diff.mean():.3e}")
    assert diff.max() <= XB_MAX_ABS_TOL, diff.max()
    assert diff.mean() <= XB_MEAN_ABS_TOL, diff.mean()


def test_golden_default_scene_is_sane(golden_render):
    img = golden_render
    assert np.isfinite(img).all() and 0.0 <= img.min() and img.max() <= 1.0
    h, w = 180, 320
    center = img[h // 2 - 16: h // 2 + 16, w // 2 - 16: w // 2 + 16]
    assert (center.sum(axis=-1) < 0.05).mean() > 0.5  # dark shadow
    assert img.max() > 0.5  # bright photon ring
    assert (img.sum(axis=-1) > 0.02).mean() > 0.05


def _read_png_rgb8(path):
    """Decode an 8-bit RGB PNG whose rows use the None, Sub or Up filter
    (what the native encoder writes; the zlib path writes None) with zlib
    and NumPy alone."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            size = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color = size[:4]
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert set(raw[:, 0].tolist()) <= {0, 1, 2}
    img = np.zeros((h, w, 3), np.uint8)
    prev = img[0]
    for y in range(h):
        row = raw[y, 1:].reshape(w, 3)
        if raw[y, 0] == 1:  # Sub: each byte adds the one 3 to its left
            row = np.cumsum(row, axis=0, dtype=np.uint8)
        elif raw[y, 0] == 2:  # Up: each byte adds the one above
            row = row + prev
        img[y] = row
        prev = img[y]
    return img


def test_cli_writes_png(tmp_path, capsys):
    out = tmp_path / "frame.png"
    args = ["--width", "64", "--height", "36", "--fov", "60", "--n_stars", "100",
            "--disk_outer_radius", "3.5", "--disk_tilt", "15", "--device", "cpu",
            "-o", str(out)]
    assert cli.main(args) == 0
    assert "Saved" in capsys.readouterr().out
    img = _read_png_rgb8(out)
    assert img.shape == (36, 64, 3)
    expect = render_image(cli.config_from_args(cli.build_parser().parse_args(args)))
    np.testing.assert_array_equal(img, quantize_frame(expect))


@pytest.mark.parametrize("flags", [
    ["--anti_alias", "lod_radius"], ["--lens_flare"],
    ["--anti_alias", "lod_radius", "--aa_strength", "2.0", "--lens_flare"],
])
def test_cli_renders_ported_features(flags, tmp_path):
    out = tmp_path / "frame.png"
    args = ["--width", "64", "--height", "36", "--fov", "60", "--n_stars", "100",
            "--disk_outer_radius", "3.5", "--disk_tilt", "15", "--device", "cpu",
            "-o", str(out)] + flags
    assert cli.main(args) == 0
    config = cli.config_from_args(cli.build_parser().parse_args(args))
    assert config.use_ray_differentials == ("--anti_alias" in flags)
    assert config.lens_flare == ("--lens_flare" in flags)
    assert config.aa_strength == (2.0 if "--aa_strength" in flags else 1.0)
    np.testing.assert_array_equal(_read_png_rgb8(out),
                                  quantize_frame(render_image(config)))


@pytest.mark.parametrize("flags", [
    ["--disk_model", "v2"],
    ["--disk_model", "v2", "--v2_structure", "--v2_palette", "scientific"],
])
def test_cli_renders_v2_disk(flags, tmp_path):
    out = tmp_path / "frame.png"
    args = ["--width", "64", "--height", "36", "--fov", "60", "--n_stars", "100",
            "--disk_outer_radius", "3.5", "--disk_tilt", "15", "--device", "cpu",
            "-o", str(out)] + flags
    assert cli.main(args) == 0
    config = cli.config_from_args(cli.build_parser().parse_args(args))
    assert config.disk_model == "v2" and not config.use_ray_differentials
    assert config.v2_structure == ("--v2_structure" in flags)
    img = _read_png_rgb8(out)
    np.testing.assert_array_equal(img, quantize_frame(render_image(config)))
    assert img.max() > 128  # the disk is lit


# What the CLI does with the switches it once refused: the interactive
# session, the one-process "fleet" run, and the still with the static
# --disk_texture auto disk (a small one: the cache lives under tmp_path).
# (The cases keep the ids they had while all five were refusals.)
@pytest.mark.parametrize("flags,outcome", [
    (["--interactive"], "interactive"),
    (["--disk_model", "v2", "--interactive"], "interactive"),
    (["--disk_texture", "auto", "--width", "64", "--height", "36", "--fov",
      "60", "--n_stars", "100", "--disk_outer_radius", "3.5", "--disk_tilt",
      "15"], "auto"),
    (["--coordinator_address", "localhost:1234"], "needs the fleet's size"),
    (["--disk_model", "v2", "--coordinator_address", "localhost:1234"],
     "needs the fleet's size"),
], ids=[f"flags{i}" for i in range(5)])
def test_cli_refuses_unported_features(flags, outcome, tmp_path, monkeypatch):
    argv = flags + ["--device", "cpu", "-o", str(tmp_path / "x.png")]
    if outcome == "interactive":
        # Ported: --interactive reaches the session's dispatcher with
        # the scene's config, on the chosen device.
        import bhr_tpu_torch.interactive as tinter

        seen = []
        monkeypatch.setattr(tinter, "run_interactive",
                            lambda config, **kw: seen.append((config, kw)))
        assert cli.main(argv + ["--preview_port", "8089"]) == 0
        (config, kw), = seen
        assert config.interactive and config.device == "cpu"
        assert config.disk_model == ("v2" if "v2" in flags else "texture")
        assert kw == {"preview_port": 8089, "preview_host": "127.0.0.1"}
    elif outcome == "auto":
        # Ported: the still renders with the generated texture, saved to
        # the cache once and loaded from it for the second render.
        import bhr_tpu_torch.utils.cache as tcache

        monkeypatch.setattr(tcache, "DEFAULT_CACHE_DIR", str(tmp_path / "cache"))
        assert cli.main(argv) == 0
        config = cli.config_from_args(cli.build_parser().parse_args(argv))
        assert config.disk_texture == "auto" and config.disk_generation_scale == 2
        assert [p.name for p in (tmp_path / "cache").iterdir()] == [
            "disk_2.00_3.50_42_256x128_scale2.npy"]
        np.testing.assert_array_equal(_read_png_rgb8(tmp_path / "x.png"),
                                      quantize_frame(render_image(config)))
    else:
        # Ported: a fleet is joined with its size and this process's
        # rank; the address alone is argparse's error, exit code 2.
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
    if outcome != "auto":
        assert os.listdir(tmp_path) == []


def test_cli_tile_shards_need_as_many_devices(tmp_path):
    # --device cpu sees one CPU device, so two row bands have too few.
    with pytest.raises(ValueError, match="tile_shards=2 but only 1"):
        cli.main(["--width", "32", "--height", "16", "--tile_shards", "2",
                  "--device", "cpu", "-o", str(tmp_path / "x.png")])


def test_cli_default_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--width", "32", "--height", "18",
                  "-o", str(tmp_path / "x.png")])
