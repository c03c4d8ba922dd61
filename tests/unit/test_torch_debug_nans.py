"""The NaN trap of ``--debug_nans`` (``bhr_tpu_torch/utils/nans.py``)
against ``bhr_tpu``'s ``jax.debug_nans``, on the CPU at 48x27 (48x28
for two row bands).

* Parity, positive: the ``default``, ``aa`` (lod_radius), ``flare`` and
  ``v2`` scenes render with the trap on in both packages without a
  raise, over the same NumPy assets; the port's image with the trap on
  is bit-equal to its image with the trap off, through its ``Renderer``
  and through ``modes.render_image`` (the lifecycle disk's stages too).
* Parity, negative: a NaN skybox and a NaN disk texture raise
  ``FloatingPointError`` in both, at the same boundary: the skybox
  upload (``bhr_tpu``: its jitted quantize) and the mip build (its
  jitted ``_mip_and_pack``). The port's message names the stage. For a
  renderer made before the trap was turned on, a NaN sky raises at the
  port's ``shade`` (``shade_v2``).
* Port only (``bhr_tpu``'s sharded programs would cost about a minute):
  2 row bands, a 4-frame batched video, the whole batched and the
  sequential video loops, one session step and ``--disk_texture auto``
  with the trap on, each bit-equal to the trap off; a NaN skybox names
  the band's or the ``video/`` stage.
* Off means free: with the trap off, the NaN count runs 0 times a frame.
* The trace stage checks the outputs of the kernel's wrapper (a NaN
  put into them raises at ``trace[<instantiation>]``).

``jax.debug_nans`` is used as a context manager only, so no test leaves
JAX's configuration changed.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

import bhr_tpu.config as jcfg
from bhr_tpu import pipeline as jpipe

from bhr_tpu_torch import interop, modes
from bhr_tpu_torch.config import SceneConfig
from bhr_tpu_torch.interactive import InteractiveSession
from bhr_tpu_torch.parallel import frames as tframes
from bhr_tpu_torch.parallel import video as tvideo
from bhr_tpu_torch.parallel.mesh import make_frame_mesh
from bhr_tpu_torch.utils import cache as tcache
from bhr_tpu_torch.utils import nans
from bhr_tpu_torch.utils.io import load_png_rgb8

CPU = torch.device("cpu")
BASE = dict(width=48, height=27, pov=(6.0, 0.0, 0.5), fov=60.0,
            step_size=0.2, n_stars=50, disk_inner_radius=2.0,
            disk_outer_radius=3.5, disk_tilt=15.0)
SCENES = {
    "default": {},
    "aa": dict(anti_alias="lod_radius"),
    "flare": dict(lens_flare=True),
    "v2": dict(disk_model="v2"),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _trap_left_off():
    """Every test starts and must end with the trap off."""
    assert not nans.debug_nans_enabled()
    yield
    assert not nans.debug_nans_enabled()


def _assets():
    """A smooth sky and disk texture (as test_torch_slice.py's)."""
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


def _cfg(**changes):
    return SceneConfig(device="cpu", **{**BASE, **changes}).validated()


def _port_renderer(cfg, sky, tex):
    return interop.renderer_from_numpy(
        cfg, sky, None if cfg.disk_model == "v2" else tex)


def _jax_renderer(extra, sky, tex):
    cfg = jcfg.SceneConfig(**{**BASE, **extra}).validated()
    return jpipe.Renderer(cfg, sky, None if cfg.disk_model == "v2" else tex,
                          use_pallas=False)


def _counting(monkeypatch):
    """Count the calls of the trap's NaN reduction."""
    calls = []
    real = nans._count_nans

    def counted(tensors):
        calls.append(len(tensors))
        return real(tensors)

    monkeypatch.setattr(nans, "_count_nans", counted)
    return calls


# -- the switch --------------------------------------------------------------


def test_switch_and_context_restore():
    assert not nans.debug_nans_enabled()
    with nans.debug_nans():
        assert nans.debug_nans_enabled()
        with nans.debug_nans(False):
            assert not nans.debug_nans_enabled()
        assert nans.debug_nans_enabled()
    with pytest.raises(RuntimeError):
        with nans.debug_nans(True):
            raise RuntimeError("inside")
    assert not nans.debug_nans_enabled()
    nans.set_debug_nans(True)
    assert nans.debug_nans_enabled()
    nans.set_debug_nans(False)


def test_check_nans_counts_nan_only_in_float_outputs():
    x = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    ints = torch.tensor([1, 2], dtype=torch.int32)
    nans.check_nans("off", x)  # the trap is off: no raise
    with nans.debug_nans():
        nans.check_nans("finite", torch.ones(3), ints, None)
        nans.check_nans("inf", torch.tensor([float("inf"), -float("inf")]))
        nans.check_nans("no float output", ints, torch.zeros(2, dtype=torch.bool))
        with pytest.raises(FloatingPointError,
                           match=r"^invalid value \(nan\) encountered in "
                                 r"stage\[x\]: 2 of 7 values$"):
            nans.check_nans("stage[x]", (x, ints), torch.tensor([float("nan"), 0.0, 1.0]))


# -- parity with bhr_tpu -----------------------------------------------------


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_trap_quiet_in_both_and_port_bit_equal(scene):
    extra = SCENES[scene]
    sky, tex = _assets()
    with jax.debug_nans(True):
        ref = _jax_renderer(extra, sky, tex).render(BASE["pov"], BASE["fov"])
    assert np.isfinite(ref).all()
    cfg = _cfg(**extra)
    off = _port_renderer(cfg, sky, tex).render(cfg.pov, cfg.fov)
    with nans.debug_nans():
        on = _port_renderer(cfg, sky, tex).render(cfg.pov, cfg.fov)
    np.testing.assert_array_equal(on, off)
    if scene not in ("default", "aa"):
        return
    # The mode, with the lifecycle disk's stages (disk_texture, disk_stats).
    still_off = modes.render_image(cfg)
    with nans.debug_nans():
        still_on = modes.render_image(cfg)
    np.testing.assert_array_equal(still_on, still_off)


def _jax_boundary(exc: FloatingPointError) -> str:
    """The bhr_tpu jit boundary a debug_nans error came from."""
    import traceback

    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.endswith(os.path.join("bhr_tpu", "pipeline.py"))]
    for f in frames:
        if f.name == "__init__" and "skybox_q" in (f.line or ""):
            return "skybox"
        if f.name == "_mip_and_pack":
            return "mips"
    raise AssertionError(f"no known boundary in {frames}")


@pytest.mark.parametrize("stage", ["skybox", "mips"])
def test_trap_fires_where_bhr_tpu_does(stage):
    sky, tex = _assets()
    if stage == "skybox":
        sky = np.full_like(sky, np.nan)
    else:
        tex = np.full_like(tex, np.nan)
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError) as jax_err:
            _jax_renderer({}, sky, tex)
    assert _jax_boundary(jax_err.value) == stage
    with nans.debug_nans():
        with pytest.raises(FloatingPointError,
                           match=rf"encountered in {stage}: \d+ of \d+ values"):
            _port_renderer(_cfg(), sky, tex)


@pytest.mark.parametrize("scene", ["default", "v2"])
def test_nan_sky_of_an_earlier_renderer_raises_at_shade(scene):
    """A renderer made before the trap was turned on: the NaN sky reaches
    the frame's shade. bhr_tpu raises in its jitted ``shade_frame`` there
    too; that run is left out for its cost (JAX's de-optimized rerun of
    the shade takes ~8 s on the CPU)."""
    sky, tex = _assets()
    cfg = _cfg(**SCENES[scene])
    r = _port_renderer(cfg, np.full_like(sky, np.nan), tex)
    stage = "shade_v2" if scene == "v2" else "shade"
    with nans.debug_nans():
        with pytest.raises(FloatingPointError,
                           match=rf"encountered in {stage}: \d+ of \d+ values"):
            r.render(cfg.pov, cfg.fov)


def test_nan_texture_update_raises_at_mips_in_both():
    sky, tex = _assets()
    nan_tex = np.full_like(tex, np.nan)
    jr = _jax_renderer({}, sky, tex)
    tr = _port_renderer(_cfg(), sky, tex)
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError) as jax_err:
            jr.update_disk_texture(nan_tex)
    assert _jax_boundary(jax_err.value) == "mips"
    with nans.debug_nans():
        with pytest.raises(FloatingPointError, match="encountered in mips:"):
            tr.update_disk_texture(nan_tex)


def test_untrapped_nan_sky_reaches_the_image():
    """Without the trap a NaN sky renders NaN pixels (the trap's reason)."""
    sky, tex = _assets()
    img = _port_renderer(_cfg(), np.full_like(sky, np.nan), tex).render(
        BASE["pov"], BASE["fov"])
    assert np.isnan(img).any()


@pytest.mark.parametrize("aa", [False, True])
def test_trace_outputs_are_checked(aa, monkeypatch):
    """The trace stage checks what the kernel's wrapper returns (here its
    plain version's outputs with one value made NaN). A NaN camera is no
    control on the CPU: the plain version's clamps carry the NaN into the
    step size, so its rays march to the iteration cap (seconds here),
    neither escaping nor captured, and every output stays finite.
    ``chip_smoke.py`` holds the kernel to a NaN camera."""
    from bhr_tpu_torch import pipeline as tpipe

    sky, tex = _assets()
    cfg = _cfg(anti_alias="lod_radius" if aa else "disabled")
    r = _port_renderer(cfg, sky, tex)
    cam = r.camera(cfg.pov, cfg.fov)
    with nans.debug_nans():
        r.trace(cam, 12.0, aa)
        real = tpipe.trace_geodesics_cuda

        def poisoned(*args, **kw):
            trace = real(*args, **kw)
            trace.escape_dir[7, 1] = float("nan")
            return trace

        monkeypatch.setattr(tpipe, "trace_geodesics_cuda", poisoned)
        name = "ray_march_aa" if aa else "ray_march_slim"
        with pytest.raises(FloatingPointError,
                           match=rf"encountered in trace\[{name}\]: 1 of "):
            r.trace(cam, 12.0, aa)


# -- the port's other paths --------------------------------------------------


def test_two_bands_bit_equal_and_nan_sky_names_a_band():
    cfg = _cfg(tile_shards=2, anti_alias="lod_radius", height=28)
    off = tframes.render_image_tiled(cfg, devices=[CPU] * 2)
    with nans.debug_nans():
        on = tframes.render_image_tiled(cfg, devices=[CPU] * 2)
    np.testing.assert_array_equal(on, off)
    sky, tex = _assets()
    render = tframes.build_sharded_frame_renderer(
        make_frame_mesh(1, 2, devices=[CPU] * 2), cfg, 48, 28, 1,
        r_escape=12.0, return_layers=True)
    cam = tframes.pack_cameras([_port_renderer(cfg, sky, tex).camera(cfg.pov, cfg.fov)])
    mips = torch.as_tensor(tex)[None]
    render(sky, mips, cam, np.zeros(1, np.float32))
    with nans.debug_nans():
        render(sky, mips, cam, np.zeros(1, np.float32))
        with pytest.raises(FloatingPointError,
                           match=r"encountered in band[01]/shade:"):
            render(np.full_like(sky, np.nan), mips, cam, np.zeros(1, np.float32))


def _batch(cfg, skybox):
    dyn = tvideo.DynamicDiskSystem(32, 96, 2.0, 3.5, seed=cfg.seed, device=CPU)
    packs = tvideo.pack_frame_params(dyn, 4, cfg.disk_rotation_speed)
    mesh = make_frame_mesh(1, 1, devices=[CPU])
    out, _ = tvideo.render_video_frames_sharded(
        cfg, mesh, range(4), skybox, dyn, *packs)
    return np.stack([f for _, f in out])


@pytest.mark.parametrize("aa", [False, True])
def test_video_batch_bit_equal_and_nan_sky_names_a_video_stage(aa):
    cfg = _cfg(video=True, orbit=True, n_frames=4,
               anti_alias="lod_radius" if aa else "disabled")
    sky, _ = _assets()
    off = _batch(cfg, sky)
    with nans.debug_nans():
        on = _batch(cfg, sky)
        with pytest.raises(FloatingPointError,
                           match=r"encountered in video/shade:"):
            _batch(cfg, np.full_like(sky, np.nan))
    assert off.shape == (4, 27, 48, 3)
    np.testing.assert_array_equal(on, off)


def _frames(cfg):
    temp_dir = modes.video_temp_paths(cfg.output)[0]
    paths = sorted(glob.glob(os.path.join(temp_dir, "frame_*.png")))
    return [load_png_rgb8(p) for p in paths]


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_video_loops_bit_equal(engine, tmp_path):
    runs = []
    for on in (False, True):
        cfg = _cfg(video=True, orbit=True, n_frames=3, fps=2,
                   frame_shards=1 if engine == "sequential" else 0,
                   disk_model="v2" if engine == "sequential" else "texture",
                   output=str(tmp_path / f"{on}.mp4"))
        with nans.debug_nans(on):
            if engine == "batched":
                tvideo.render_video_sharded(cfg, devices=[CPU])
            else:
                modes.render_video(cfg)
        runs.append(_frames(cfg))
    assert len(runs[0]) == len(runs[1]) == 3
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
def test_session_step_bit_equal(fused):
    cfg = _cfg(interactive=True)
    imgs = []
    for on in (False, True):
        with nans.debug_nans(on):
            sess = InteractiveSession(cfg, lookahead=False, fused=fused)
            sess.handle_key("d")  # the AA trace and the mip pyramid too
            imgs.append(sess.step(0.05))
    np.testing.assert_array_equal(imgs[1], imgs[0])


def test_auto_disk_texture_bit_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(tcache, "DEFAULT_CACHE_DIR", str(tmp_path))
    calls = _counting(monkeypatch)
    cfg = _cfg(disk_texture="auto", force_regenerate_disk_texture=True)
    off = modes.render_image(cfg)
    with nans.debug_nans():
        on = modes.render_image(cfg)
    np.testing.assert_array_equal(on, off)
    # skybox, static_texture, mips, trace, shade, post
    assert len(calls) == 6


# -- the cost when off -------------------------------------------------------


def test_off_costs_no_reduction(monkeypatch):
    calls = _counting(monkeypatch)
    cfg = _cfg()
    renderer, dynamic = modes._make_renderer(cfg)
    for frame in range(3):
        renderer.update_disk_texture(dynamic.advance(0.1 * frame, 0.1))
        renderer.render(cfg.pov, cfg.fov)
    assert calls == []
    with nans.debug_nans():
        renderer.update_disk_texture(dynamic.advance(0.3, 0.1, recompute_stats=True))
        renderer.render(cfg.pov, cfg.fov)
    # disk_stats, disk_texture, mips, trace, shade, post
    assert len(calls) == 6


def test_off_costs_no_reduction_in_the_video_engine(monkeypatch):
    calls = _counting(monkeypatch)
    cfg = _cfg(video=True, orbit=True, n_frames=4, anti_alias="lod_radius")
    sky, _ = _assets()
    _batch(cfg, sky)
    assert calls == []
    with nans.debug_nans():
        _batch(cfg, sky)
    # background once; per frame disk_stats, disk_texture, mips, trace,
    # shade, post
    assert len(calls) == 1 + 4 * 6
