"""The port's interactive mode vs bhr_tpu, on the CPU.

* ``solo_comp`` against ``bhr_tpu``'s for every index 0-12: equal.
  ``advance(solo_idx=...)`` against ``bhr_tpu``'s through ``interop``
  for the views 3, 5, 9 and 12: atol 1e-3 with the same stats
  (``test_torch_disk.py``'s bound for ``advance``), and end to end 1e-3
  where the view's histogram quantiles land in the same bins, 2e-2 where
  they do not (the filament view, see the test); the solo view's stats
  are not kept.
* ``Renderer``: ``force_differentials`` changes the image by more than
  1e-4 and is inert for V2; ``r_escape_quantum=4.0`` traces with
  ``bhr_tpu``'s escape radius; a frame with it against ``bhr_tpu``'s
  ``Renderer(r_escape_quantum=4.0)`` on the same assets: atol 1e-3.
* ``build_sharded_video_renderer(solo_idx=5, use_bloom=False)`` against
  ``bhr_tpu``'s at 32x16: max 5e-2 / mean 5e-4 of the uint8 frames as
  floats (the cross-backend bounds of ``tests/e2e_render.py``).
* ``InteractiveSession`` over fake renderers, ``bhr_tpu``'s and the
  port's driven by one script of keys, drags and steps: equal state,
  equal calls into the fakes, equal HUD text up to the timing fields;
  the lookahead order f0, f0, f1, f2; lookahead off without a device
  path; a state key drops the pending frame.
* The real session at 64x36: the port's fused first frame against
  ``bhr_tpu``'s (max 5e-2 / mean 5e-4 of the 255-scaled values; the
  share one uint8 step apart is printed); fused against staged at most
  one uint8 step, also for the solo view of key ``6`` with the staged
  path patched to raise; the toggles; a V2 session.
* ``run_headless_preview`` writes its PNGs; ``run_interactive``'s three
  dispatch cases; the mock-window loop and its blit fallback; the CLI's
  ``--interactive --preview_port`` serves frames over loopback and stops
  on ``/key?k=q``; ``device="cuda"`` without a GPU raises.
* ``MJPEGServer`` over loopback: 503 before the first frame, ``/frame``,
  a stream opened before the first frame, ``/key?k=+``, the backlog
  replay, ``run_http_preview(max_frames=)``.
"""

import dataclasses
import glob
import io
import os
import re
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu.config as jcfg
import bhr_tpu.interactive as jinter
from bhr_tpu import pipeline as jpipe
from bhr_tpu.models import dynamic_disk as jdyn
from bhr_tpu.ops.sampling import pack_quad, production_tex_dtype, quantize_packed
from bhr_tpu.parallel import video as jvideo
from bhr_tpu.parallel.frames import pack_cameras as j_pack_cameras
from bhr_tpu.parallel.mesh import make_frame_mesh as j_make_frame_mesh

import bhr_tpu_torch.interactive as tinter
from bhr_tpu_torch import cli, interop
from bhr_tpu_torch.camera import build_camera
from bhr_tpu_torch.config import SceneConfig, compute_disk_texture_resolution
from bhr_tpu_torch.interactive import InteractiveSession
from bhr_tpu_torch.models import dynamic_disk as tdyn
from bhr_tpu_torch.models.skybox import load_or_generate_skybox
from bhr_tpu_torch.parallel import video as tvideo
from bhr_tpu_torch.parallel.frames import pack_cameras
from bhr_tpu_torch.parallel.mesh import make_frame_mesh
from bhr_tpu_torch.utils.io import load_png_rgb8, quantize_frame
from bhr_tpu_torch.utils.preview_server import MJPEGServer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from e2e_render import XB_MAX_ABS_TOL, XB_MEAN_ABS_TOL  # noqa: E402

TINY = dict(width=64, height=36, fov=60.0, step_size=0.3, n_stars=100,
            disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0,
            interactive=True)
N_R, N_PHI, R_IN, R_OUT = 128, 256, 2.0, 3.5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def tiny_cfg():
    return SceneConfig(device="cpu", **TINY).validated()


@pytest.fixture()
def jax_cfg():
    return jcfg.SceneConfig(**TINY).validated()


# -- the solo view ----------------------------------------------------------


@pytest.mark.parametrize("solo_idx", range(13))
def test_solo_comp_equals_bhr_tpu(solo_idx):
    comp = np.random.default_rng(solo_idx).random((13, 6, 10)).astype(np.float32)
    ref = np.asarray(jdyn.solo_comp(jnp.asarray(comp), solo_idx))
    out = tdyn.solo_comp(torch.as_tensor(comp), solo_idx).numpy()
    np.testing.assert_array_equal(out, ref)
    kept = [i for i in range(13) if (out[i] == comp[i]).all()]
    assert solo_idx in kept and len(kept) <= 2
    assert tdyn._SOLO_PAIRS == jdyn._SOLO_PAIRS


@pytest.fixture(scope="module")
def solo_systems():
    """bhr_tpu's system ticked to t=0 and the port's carrying its state."""
    ref = jdyn.DynamicDiskSystem(N_R, N_PHI, R_IN, R_OUT, seed=42)
    for f in ref.factories.values():
        f.tick(now=0.0, dt=0.0)
    packs = tuple(np.asarray(p) for p in ref._pack(0.0))
    port = interop.dynamic_disk_from_state(
        n_r=N_R, n_phi=N_PHI, r_inner=R_IN, r_outer=R_OUT,
        az_freq=ref.az_freq, az_shear=ref.az_shear,
        fil_params=packs[0], hs_params=packs[1], rt_params=packs[2],
        omega_rows=np.asarray(ref.omega_rows), edge=np.asarray(ref.edge),
        density_p98=np.asarray(ref.density_p98),
        struct_scale=np.asarray(ref.struct_scale),
        row_stats=np.asarray(ref.row_stats),
        generation_scale=ref.generation_scale,
    )
    return ref, port


@pytest.mark.parametrize("solo_idx", [3, 5, 9, 12])
def test_advance_solo_matches_through_interop(solo_idx, solo_systems):
    """The solo view's texture, normalized with the view's own stats.

    With the same stats the port's texture is within 1e-3 of
    ``bhr_tpu``'s (``advance``'s bound in ``test_torch_disk.py``). The
    stats are histogram quantiles of a sparse field: a component field
    that differs in its last bits (the entity layer's exp) can move
    ``struct_scale`` and a row's p70 to a neighbouring bin, and the
    whole view's normalization with them. That happens for the filament
    and RT-spike views (indices 5-8), so the end-to-end texture is held
    to 1e-3 where the stats landed in the same bins and to 2e-2 (one
    row-stat bin, 1.2 / 64) where they did not; the stats themselves
    are held to two bins of each quantile.
    """
    ref, port = solo_systems
    kept = (float(port.density_p98), float(port.struct_scale))
    expect = np.asarray(ref.advance(t=0.0, dt=0.0, solo_idx=solo_idx))
    out = port.advance(t=0.0, dt=0.0, solo_idx=solo_idx).numpy()
    assert out.shape == expect.shape == (N_R, N_PHI, 4)
    # The solo view's stats are for display only: nothing was kept, and
    # the whole component field (not the masked one) is.
    assert (float(port.density_p98), float(port.struct_scale)) == kept
    assert float(port.comp[0].abs().max()) > 0 and float(port.comp[5].max()) > 0

    j_view = jdyn.solo_comp(ref.comp, solo_idx)
    j_stats = [np.asarray(x) for x in
               jdyn._recompute_stats(j_view, ref.edge, True)]
    t_stats = [x.numpy() for x in tdyn._recompute_stats(
        tdyn.solo_comp(port.comp, solo_idx), port.edge, True)]
    from bhr_tpu.models import disk_texture as jtex

    bins = (float(jnp.max(jtex.density_from_comp(j_view, ref.edge, True))) / 512,
            float(jnp.max(jtex.temp_struct_from_comp(j_view))) / 512, 1.2 / 64)
    apart = [float(np.abs(a - b).max()) for a, b in zip(t_stats, j_stats)]
    same_bins = all(d <= 0.1 * max(w, 1e-4) for d, w in zip(apart, bins))
    with_ref_stats, _, _ = port._frame_texture(
        0.0, tuple(torch.tensor(np.array(x)) for x in j_stats), solo_idx)
    d_same = float(np.abs(with_ref_stats.numpy() - expect).max())
    d_own = float(np.abs(out - expect).max())
    print(f"advance(solo_idx={solo_idx}) port vs bhr_tpu: max {d_own:.3e}; with "
          f"bhr_tpu's solo stats {d_same:.3e}; stats apart (p98, scale, rows) "
          f"{apart[0]:.3e} {apart[1]:.3e} {apart[2]:.3e}, bins {bins[0]:.3e} "
          f"{bins[1]:.3e} {bins[2]:.3e}")
    assert d_same <= 1e-3
    for d, width in zip(apart, bins):
        assert d <= 2 * width + 1e-6
    assert d_own <= (1e-3 if same_bins else 2e-2)
    # The view differs from the whole compose.
    whole = port.advance(t=0.0, dt=0.0).numpy()
    assert np.abs(whole - out).max() > 1e-2


def test_recompute_while_soloed_keeps_whole_field_stats(solo_systems):
    ref, port = solo_systems
    before = float(port.density_p98)
    port.advance(t=0.0, dt=0.0, recompute_stats=True, solo_idx=5)
    ref.advance(t=0.0, dt=0.0, recompute_stats=True, solo_idx=5)
    assert float(port.density_p98) != before
    # bhr_tpu's whole-field p98, within a histogram bin (a few percent).
    np.testing.assert_allclose(float(port.density_p98), float(ref.density_p98),
                               rtol=0.02)
    np.testing.assert_allclose(port.row_stats.numpy(), np.asarray(ref.row_stats),
                               rtol=0, atol=1.2 / 64)


# -- the Renderer's interactive switches ------------------------------------


def _smooth_assets():
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


def test_force_differentials_switches_lod_path(tiny_cfg):
    """The pipeline contract behind the 'd' key: with
    anti_alias="disabled", force_differentials renders the differential
    + mip-LOD variant."""
    from bhr_tpu_torch.modes import _make_renderer

    renderer, dynamic = _make_renderer(tiny_cfg)
    renderer.update_disk_texture(dynamic.advance(0.0, 0.0, recompute_stats=True))
    off = renderer.render(tiny_cfg.pov, tiny_cfg.fov, force_differentials=False)
    on = renderer.render(tiny_cfg.pov, tiny_cfg.fov, skip_differentials=False,
                         force_differentials=True)
    assert np.isfinite(on).all()
    assert np.abs(on - off).max() > 1e-4
    # skip_differentials wins over the force, as in bhr_tpu.
    both = renderer.render(tiny_cfg.pov, tiny_cfg.fov, skip_differentials=True,
                           force_differentials=True)
    np.testing.assert_array_equal(both, off)
    # Inert for V2, which has no LOD path.
    v2, none = _make_renderer(dataclasses.replace(tiny_cfg, disk_model="v2"))
    assert none is None
    np.testing.assert_array_equal(
        v2.render(tiny_cfg.pov, tiny_cfg.fov, force_differentials=True),
        v2.render(tiny_cfg.pov, tiny_cfg.fov))


@pytest.mark.parametrize("pos", [(6.0, 0.0, 0.5), (5.2, 1.0, 0.5), (9.0, 0.0, 2.0)])
def test_escape_quantum_is_bhr_tpus(pos):
    sky, tex = _smooth_assets()
    kw = dict(width=48, height=24, pov=pos, fov=60.0, step_size=0.3,
              disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0)
    ref = jpipe.Renderer(jcfg.SceneConfig(**kw).validated(), sky, tex,
                         use_pallas=False, r_escape_quantum=4.0)
    seen, real = [], ref._trace
    ref._trace = lambda cam, r_escape, use_diff: (
        seen.append(r_escape), real(cam, r_escape, use_diff))[1]
    expect = ref.render(pos, 60.0)
    cfg = SceneConfig(device="cpu", **kw).validated()
    from bhr_tpu_torch.pipeline import Renderer

    port = Renderer(cfg, sky, tex, device="cpu", r_escape_quantum=4.0)
    assert port.frame_escape_radius(pos) == seen[0]
    assert seen[0] % 4.0 == 0 and seen[0] >= jcfg.escape_radius(10.0, pos)
    out = port.render(pos, 60.0)
    diff = np.abs(out - expect).max()
    print(f"Renderer(r_escape_quantum=4.0) at {pos}: r_escape {seen[0]}, "
          f"port vs bhr_tpu max {diff:.3e}")
    assert diff <= 1e-3
    # No quantum: the exact radius; an override wins over the quantum.
    assert Renderer(cfg, sky, tex, device="cpu").frame_escape_radius(pos) == (
        jcfg.escape_radius(10.0, pos))
    assert Renderer(cfg, sky, tex, device="cpu", r_escape_quantum=4.0,
                    r_escape_override=13.0).frame_escape_radius(pos) == 13.0


def test_solo_video_renderer_matches_bhr_tpu():
    kw = dict(width=32, height=16, fov=60.0, step_size=0.3, n_stars=100,
              disk_inner_radius=2.0, disk_outer_radius=3.5, disk_tilt=15.0)
    ref_cfg = jcfg.SceneConfig(**kw).validated()
    cfg = SceneConfig(device="cpu", **kw).validated()
    n_phi, n_r = compute_disk_texture_resolution(32, 16, cfg.pov, cfg.fov, 2.0, 3.5)
    args = (n_r, n_phi, 2.0, 3.5)
    ref_sys = jdyn.DynamicDiskSystem(*args, seed=42)
    port_sys = tdyn.DynamicDiskSystem(*args, seed=42, device="cpu")
    for system in (ref_sys, port_sys):
        for fac in system.factories.values():
            fac.tick(now=0.3, dt=0.3)
    sky, _, _ = load_or_generate_skybox(None, 256, 128, 100, seed=42)
    builder_kw = dict(r_escape=16.0, az_freq=ref_sys.az_freq,
                      az_shear=ref_sys.az_shear, use_bloom=False)
    cam = build_camera(cfg.pov, cfg.fov, 32, 16)
    t = np.asarray([0.3], np.float32)

    def render(solo_idx):
        fn = jvideo.build_sharded_video_renderer(
            j_make_frame_mesh(1, 1, devices=jax.devices()[:1]), ref_cfg, n_r,
            n_phi, tex_dtype=production_tex_dtype(), solo_idx=solo_idx,
            **builder_kw)
        sky_q = quantize_packed(pack_quad(jnp.asarray(sky, jnp.float32)),
                                production_tex_dtype())
        ref = np.asarray(fn(sky_q, jnp.asarray(j_pack_cameras([cam])),
                            jnp.asarray(t), *(p[None] for p in ref_sys._pack(0.3))))
        out = tvideo.build_sharded_video_renderer(
            make_frame_mesh(1, 1, devices=[torch.device("cpu")]), cfg, n_r,
            n_phi, solo_idx=solo_idx, **builder_kw)(
                sky, pack_cameras([cam]), t,
                *(np.asarray(p)[None] for p in port_sys._pack(0.3))).numpy()
        assert out.shape == ref.shape == (1, 16, 32, 3) and out.dtype == np.uint8
        return out, ref

    out, ref = render(5)
    step = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    print(f"solo_idx=5 video renderer, port vs bhr_tpu: max {step.max() / 255:.3e} "
          f"mean {step.mean() / 255:.3e}; one uint8 step apart "
          f"{(step == 1).mean():.4%}, more {(step > 1).mean():.4%}")
    assert step.max() / 255 <= XB_MAX_ABS_TOL and step.mean() / 255 <= XB_MEAN_ABS_TOL
    whole, _ = render(-1)
    assert out.max() > 64 and (out != whole).any()  # a lit view, and a view


# -- the session over fake renderers: equal to bhr_tpu's --------------------


class _FakeRenderer:
    def __init__(self):
        self.calls = []
        self.textures = 0

    def render(self, cam_pos, fov, frame=0, skip_differentials=False,
               force_differentials=False, skip_bloom=False,
               lens_flare=False):
        self.calls.append(dict(
            cam_pos=list(cam_pos), fov=fov, frame=frame,
            skip_differentials=skip_differentials,
            force_differentials=force_differentials,
            skip_bloom=skip_bloom, lens_flare=lens_flare,
        ))
        return np.zeros((4, 4, 3), np.float32)

    def update_disk_texture(self, tex):
        self.textures += 1


class _FakeDynamic:
    entity_count = 7

    def __init__(self):
        self.advances = []

    def advance(self, t, dt, recompute_stats=False, solo_idx=-1):
        self.advances.append((t, dt, recompute_stats, solo_idx))
        return np.zeros((8, 16, 4), np.float32)


class _FakeDeviceRenderer(_FakeRenderer):
    """Fake with a device-resident path, to drive the lookahead swap."""

    def render_device(self, cam_pos, fov, frame=0, skip_differentials=False,
                      force_differentials=False, skip_bloom=False,
                      lens_flare=False):
        self.render(cam_pos, fov, frame, skip_differentials,
                    force_differentials, skip_bloom, lens_flare)
        return np.full((4, 4, 3), float(len(self.calls) - 1), np.float32)


SCRIPT = [
    ("step", 0.05), ("key", "d"), ("key", "b"), ("key", "l"), ("key", "up"),
    ("key", "+"), ("step", 0.5), ("key", "6"), ("step", 0.05), ("key", "0"),
    ("step", 0.05), ("drag", 0, 0), ("drag", 200, -100000), ("step", 0.02),
    ("drag", None, None), ("key", "down"), ("key", "down"), ("key", "-"),
    ("key", "="), ("key", "3"), ("step", 0.07), ("key", "x"), ("step", 0.0),
    ("key", "escape"),
]
STATE = ("r", "theta", "phi", "fov", "diff", "bloom", "flare", "solo",
         "running", "wall_time", "frames", "fps", "drag", "lookahead")


def _hud(sess):
    return re.sub(r"\(render \d+ ms / view \d+ ms\)", "(...)", sess.hud_text())


@pytest.mark.parametrize("fake,disk_model", [
    (_FakeRenderer, "texture"), (_FakeDeviceRenderer, "texture"),
    (_FakeRenderer, "v2")], ids=["staged", "lookahead", "v2"])
def test_session_equals_bhr_tpus_under_one_script(fake, disk_model, tiny_cfg,
                                                  jax_cfg):
    sessions = []
    for module, cfg in ((tinter, tiny_cfg), (jinter, jax_cfg)):
        cfg = dataclasses.replace(cfg, disk_model=disk_model)
        dynamic = _FakeDynamic() if disk_model == "texture" else None
        sessions.append(module.InteractiveSession(cfg, renderer=fake(),
                                                  dynamic=dynamic))
    port, ref = sessions
    assert port._fused is None and ref._fused is None
    for op, *args in SCRIPT:
        shown = []
        for sess in sessions:
            if op == "step":
                shown.append(np.asarray(sess.step(*args)))
            elif op == "key":
                sess.handle_key(*args)
            else:
                sess.handle_drag(*args)
        if shown:
            np.testing.assert_array_equal(*shown)
        assert ({k: getattr(port, k) for k in STATE}
                == {k: getattr(ref, k) for k in STATE}), (op, args)
        assert port.cam_pos() == ref.cam_pos()
        assert _hud(port) == _hud(ref)
        assert (port._pending is None) == (ref._pending is None), (op, args)
    assert port.renderer.calls == ref.renderer.calls and len(port.renderer.calls) == 7
    assert port.renderer.textures == ref.renderer.textures
    if disk_model == "texture":
        assert port.dynamic.advances == ref.dynamic.advances
        assert [a[3] for a in port.dynamic.advances] == [-1, -1, 5, -1, -1, 3, 3]
        assert "E:7 SOLO:turbulence" in port.hud_text()
    else:
        assert "D:n/a" in port.hud_text() and "E:0" in port.hud_text()
        frames = [c["frame"] for c in port.renderer.calls]
        assert frames[1] > frames[0] > 0 and port.renderer.textures == 0
    assert not port.running
    port.record_viewer_time(0.033)
    assert port.last_viewer_ms == pytest.approx(33.0)
    assert re.fullmatch(r"interactive: 7 frames, render \d+ ms/frame, "
                        r"viewer \d+ ms/frame", port.summary())


def test_lookahead_double_buffers(tiny_cfg):
    """Step N enqueues frame N and shows frame N-1: f0, f0, f1, f2."""
    sess = InteractiveSession(tiny_cfg, renderer=_FakeDeviceRenderer(),
                              dynamic=_FakeDynamic())
    assert sess.lookahead
    assert [float(sess.step(0.05)[0, 0, 0]) for _ in range(4)] == [0.0, 0.0, 1.0, 2.0]


def test_lookahead_off_without_device_path(tiny_cfg):
    sess = InteractiveSession(tiny_cfg, renderer=_FakeRenderer(),
                              dynamic=_FakeDynamic(), lookahead=True)
    assert not sess.lookahead
    assert sess.step(0.05).shape == (4, 4, 3)


@pytest.mark.parametrize("key", sorted(InteractiveSession._STATE_KEYS))
def test_state_key_drops_pending_lookahead_frame(key, tiny_cfg):
    sess = InteractiveSession(tiny_cfg, renderer=_FakeDeviceRenderer(),
                              dynamic=_FakeDynamic())
    sess.step(0.05)
    assert sess._pending is not None
    sess.handle_key("s")  # not a state key: the pending frame stays
    assert sess._pending is not None
    sess.handle_key(key)
    assert sess._pending is None
    # The next frame shown is the one rendered after the key.
    assert float(sess.step(0.05)[0, 0, 0]) == 1.0
    assert InteractiveSession._STATE_KEYS == jinter.InteractiveSession._STATE_KEYS
    assert (tinter._SOLO_KEYS, tinter._SOLO_NAMES) == (jinter._SOLO_KEYS,
                                                       jinter._SOLO_NAMES)


# -- the real session -------------------------------------------------------


def _steps_apart(a, b):
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


def test_fused_first_frame_matches_bhr_tpu_and_staged(tiny_cfg, jax_cfg):
    fused = InteractiveSession(tiny_cfg, lookahead=False)
    assert fused._fused is not None and not fused.lookahead
    a = fused.step(0.05)
    assert a.dtype == np.uint8 and a.shape == (36, 64, 3) and a.any()

    ref = np.asarray(jinter.InteractiveSession(jax_cfg, lookahead=False).step(0.05))
    assert ref.dtype == np.uint8
    step = _steps_apart(a, ref)
    print(f"fused first frame, port vs bhr_tpu: max {step.max() / 255:.3e} mean "
          f"{step.mean() / 255:.3e}; one uint8 step apart {(step == 1).mean():.4%}, "
          f"more {(step > 1).mean():.4%}")
    assert step.max() / 255 <= XB_MAX_ABS_TOL and step.mean() / 255 <= XB_MEAN_ABS_TOL

    staged = InteractiveSession(tiny_cfg, lookahead=False, fused=False)
    assert staged._fused is None
    b = quantize_frame(staged.step(0.05))
    step = _steps_apart(a, b)
    print(f"fused vs staged first frame: {(step != 0).mean():.4%} of values differ")
    assert step.max() <= 1


def test_fused_solo_stays_fused_and_matches_staged(tiny_cfg, monkeypatch):
    fused = InteractiveSession(tiny_cfg, lookahead=False)
    monkeypatch.setattr(
        InteractiveSession, "_step_staged",
        lambda self, dt: (_ for _ in ()).throw(
            AssertionError("solo frame took the staged path")))
    fused.handle_key("6")  # solo filaments (comp slice 5)
    assert fused.solo == 5
    a = fused.step(0.05)
    assert a.dtype == np.uint8 and a.any()
    monkeypatch.undo()
    staged = InteractiveSession(tiny_cfg, lookahead=False, fused=False)
    staged.handle_key("6")
    step = _steps_apart(a, quantize_frame(staged.step(0.05)))
    print(f"fused vs staged solo frame: {(step != 0).mean():.4%} of values differ")
    assert step.max() <= 1


def test_fused_session_toggles_and_lookahead(tiny_cfg):
    sess = InteractiveSession(tiny_cfg)
    assert sess.lookahead and sess._fused is not None
    engine = sess._fused
    made = []
    real = engine.render_async
    engine.render_async = lambda *a, **kw: made.append(real(*a, **kw)) or made[-1]
    base = sess.step(0.05)
    np.testing.assert_array_equal(base, made[0].numpy())  # first step: its own
    np.testing.assert_array_equal(sess.step(0.05), made[0].numpy())  # then N-1
    frames = {}
    for key in ("b", "l", "d", "6", "0", "+", "up"):
        sess.handle_key(key)
        assert sess._pending is None
        frames[key] = sess.step(0.05)
        # After a state key the frame shown was rendered after it.
        np.testing.assert_array_equal(frames[key], made[-1].numpy())
        assert frames[key].shape == base.shape and frames[key].dtype == np.uint8
    assert (frames["b"] != base).any() and (frames["l"] != frames["b"]).any()
    assert (frames["d"] != frames["l"]).any() and (frames["6"] != frames["d"]).any()
    assert (frames["0"] != frames["6"]).any()
    # One renderer closure per (diff, bloom, flare, solo, r_escape) seen,
    # kept: going back to a seen state builds nothing.
    n_built = len(engine._renderers)
    assert n_built == 6  # '+' keeps r_escape 16.0, 'up' changes no key
    sess.handle_key("down")
    sess.step(0.05)
    assert len(engine._renderers) == n_built
    assert "D:ON B:off L:ON" in sess.hud_text()


def test_fused_session_v2(tiny_cfg):
    cfg = dataclasses.replace(tiny_cfg, disk_model="v2").validated()
    sess = InteractiveSession(cfg, lookahead=False)
    assert sess._fused is not None and sess.dynamic is None
    img = sess.step(0.05)
    assert img.dtype == np.uint8 and img.shape == (36, 64, 3) and img.max() > 64
    sess.handle_key("d")  # inert for V2
    assert "D:n/a" in sess.hud_text()
    again = sess.step(0.0)
    np.testing.assert_array_equal(img, again)
    staged = InteractiveSession(cfg, lookahead=False, fused=False)
    assert _steps_apart(img, quantize_frame(staged.step(0.05))).max() <= 1


# -- the viewers ------------------------------------------------------------


def test_headless_preview_renders_frames(tiny_cfg, tmp_path, capsys):
    out = str(tmp_path / "preview")
    tinter.run_headless_preview(tiny_cfg, n_frames=2, out_dir=out)
    frames = sorted(glob.glob(os.path.join(out, "preview_*.png")))
    assert [os.path.basename(f) for f in frames] == ["preview_000.png",
                                                     "preview_001.png"]
    img = load_png_rgb8(frames[0])
    assert img.shape == (36, 64, 3) and img.max() > 8
    assert (img != load_png_rgb8(frames[1])).any()  # the preview orbits
    assert "Headless preview: 2 frames" in capsys.readouterr().out


def test_run_interactive_dispatch(tiny_cfg, monkeypatch):
    called = []
    monkeypatch.setattr(tinter, "run_headless_preview",
                        lambda config, **kw: called.append("headless"))
    monkeypatch.setattr(tinter, "run_http_preview",
                        lambda config, port, host="127.0.0.1":
                        called.append(("http", port, host)))
    # 1. a port: the HTTP stream, bound to loopback unless told otherwise
    tinter.run_interactive(tiny_cfg, preview_port=8089)
    tinter.run_interactive(tiny_cfg, preview_port=8089, preview_host="0.0.0.0")
    assert called == [("http", 8089, "127.0.0.1"), ("http", 8089, "0.0.0.0")]
    # 2. a non-GUI backend, or no display at all: the PNG preview
    called.clear()
    monkeypatch.setenv("MPLBACKEND", "agg")
    tinter.run_interactive(tiny_cfg)
    monkeypatch.delenv("MPLBACKEND")
    monkeypatch.delenv("DISPLAY", raising=False)
    tinter.run_interactive(tiny_cfg)
    assert called == ["headless", "headless"]
    # 3. a GUI backend: only a failing window falls back; an error from
    # the loop itself propagates and renders no preview
    called.clear()
    monkeypatch.setenv("MPLBACKEND", "TkAgg")
    monkeypatch.setattr(tinter, "_open_window",
                        lambda config: (_ for _ in ()).throw(ImportError("no tk")))
    tinter.run_interactive(tiny_cfg)
    assert called == ["headless"]
    called.clear()
    monkeypatch.setattr(tinter, "_open_window", lambda config: object())
    monkeypatch.setattr(tinter, "_run_matplotlib",
                        lambda config, window: (_ for _ in ()).throw(
                            RuntimeError("mid-session device error")))
    with pytest.raises(RuntimeError, match="mid-session"):
        tinter.run_interactive(tiny_cfg)
    assert called == []
    assert tinter._HEADLESS_BACKENDS == jinter._HEADLESS_BACKENDS


def _mock_window(frames, handlers, can_blit, n_loops):
    class _Canvas:
        def mpl_connect(self, name, fn):
            handlers[name] = fn

        def draw(self):
            pass

        def copy_from_bbox(self, bbox):
            if not can_blit:
                raise NotImplementedError("no blitting here")
            return "bg-cache"

        def restore_region(self, bg):
            assert bg == "bg-cache"

        def blit(self, bbox):
            frames["blits"] = frames.get("blits", 0) + 1

        def flush_events(self):
            pass

        def draw_idle(self):
            frames["draw_idle"] = frames.get("draw_idle", 0) + 1

    class _Im:
        def set_data(self, img):
            frames["img_shape"] = img.shape

        def get_array(self):
            return np.zeros((4, 4, 3), np.float32)

    class _Hud:
        def set_text(self, s):
            frames["hud"] = s

    class _Ax:
        transAxes = None

        def axis(self, *_):
            pass

        def imshow(self, arr):
            frames["canvas_shape"] = arr.shape
            return _Im()

        def text(self, *a, **kw):
            return _Hud()

        def draw_artist(self, artist):
            pass

    class _Fig:
        number = 1
        bbox = "figbbox"
        canvas = _Canvas()

    class _Plt:
        @staticmethod
        def ion():
            pass

        @staticmethod
        def show():
            pass

        @staticmethod
        def pause(dt):
            pass

        @staticmethod
        def fignum_exists(num):
            frames["n"] = frames.get("n", 0) + 1
            return frames["n"] <= n_loops

    return _Plt, _Fig(), _Ax()


@pytest.mark.parametrize("can_blit", [True, False], ids=["blit", "draw_idle"])
def test_run_matplotlib_loop_with_mock_window(can_blit, tiny_cfg, monkeypatch):
    """The windowed loop's body without a display: the blit path, or the
    full redraw of a backend whose canvas cannot blit."""
    frames, handlers = {}, {}
    monkeypatch.setattr(tinter, "_build",
                        lambda config: (_FakeRenderer(), _FakeDynamic()))
    tinter._run_matplotlib(tiny_cfg, _mock_window(frames, handlers, can_blit, 4))
    if can_blit:
        assert frames["blits"] == 4 and "draw_idle" not in frames
    else:
        assert frames["draw_idle"] == 4 and "blits" not in frames
    assert frames["img_shape"] == (4, 4, 3) and frames["canvas_shape"] == (36, 64, 3)
    assert "FPS" in frames["hud"]
    assert {"key_press_event", "button_press_event", "button_release_event",
            "motion_notify_event", "resize_event"} <= set(handlers)


def test_cuda_session_without_gpu_raises(tiny_cfg, monkeypatch):
    """device="cuda" on a host without a GPU raises on every way into the
    interactive mode; none renders on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(tiny_cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        InteractiveSession(cfg)
    monkeypatch.setenv("MPLBACKEND", "agg")
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        tinter.run_interactive(cfg)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        tinter.run_interactive(cfg, preview_port=_free_port())
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        cli.main(["--interactive", "--width", "64", "--height", "36"])


# -- the MJPEG server -------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, timeout=10):
    return urllib.request.urlopen(url, timeout=timeout).read()


def _decode_jpeg(data):
    from PIL import Image

    assert data[:3] == b"\xff\xd8\xff"  # JPEG SOI marker
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_mjpeg_server_frame_key_and_stream():
    keys = []
    server = MJPEGServer(port=0, on_key=keys.append)
    assert server.host == "127.0.0.1"  # loopback unless asked otherwise
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{base}/frame")
        assert exc.value.code == 503  # no frame yet
        frame = np.zeros((8, 8, 3), np.uint8)
        frame[2:6, 2:6] = 255
        server.submit(frame)
        img = _decode_jpeg(_get(f"{base}/frame"))
        assert img.shape == (8, 8, 3) and img[3:5, 3:5].mean() > 200 > 60 > img[0].mean()
        server.submit(np.full((8, 8, 3), 0.5, np.float32))  # a float frame
        assert abs(float(_decode_jpeg(_get(f"{base}/frame.jpg")).mean()) - 127.5) < 3
        _get(f"{base}/key?k=d&k=q")
        assert keys == ["d", "q"]
        with urllib.request.urlopen(base, timeout=10) as stream:
            assert b"--bhrframe" in stream.read(64)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{base}/nothing")
        assert exc.value.code == 404
    finally:
        server.stop()


def test_mjpeg_stream_open_before_first_frame_and_plus_key():
    """A stream opened before the first frame waits for it, and
    /key?k=+ is the zoom-in key though parse_qs decodes '+' as a space."""
    keys = []
    server = MJPEGServer(port=0, on_key=keys.append)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        got = {}

        def read_stream():
            with urllib.request.urlopen(base, timeout=30) as stream:
                got["head"] = stream.read(64)

        t = threading.Thread(target=read_stream, daemon=True)
        t.start()
        time.sleep(0.5)  # the stream connects while no frame exists yet
        server.submit(np.zeros((8, 8, 3), np.uint8))
        t.join(timeout=30)
        assert b"--bhrframe" in got.get("head", b""), got
        _get(f"{base}/key?k=+")
        _get(f"{base}/key?k=%2B")
        assert keys == ["+", "+"]
        # The handler swap replays the backlog exactly once.
        replayed = []
        server.set_key_handler(replayed.append, backlog=keys)
        assert replayed == ["+", "+"] and keys == []
        _get(f"{base}/key?k=q")
        assert replayed == ["+", "+", "q"]
    finally:
        server.stop()


def test_http_preview_loop_over_fake_renderer(tiny_cfg, monkeypatch, capsys):
    r, d = _FakeRenderer(), _FakeDynamic()
    monkeypatch.setattr(tinter, "_build", lambda config: (r, d))
    port = _free_port()
    tinter.run_http_preview(tiny_cfg, port=port, max_frames=3)
    assert len(r.calls) == 3
    out = capsys.readouterr().out
    assert f"Live preview: http://127.0.0.1:{port}/" in out
    assert "interactive: 3 frames" in out
    with pytest.raises(OSError):  # stopped: nothing listens any more
        _get(f"http://127.0.0.1:{port}/frame", timeout=2)


def test_cli_interactive_serves_frames_and_stops_on_q(tmp_path, capsys):
    """``--interactive --preview_port P --device cpu``: the real session
    behind the real server, driven over loopback."""
    port = _free_port()
    done = []
    thread = threading.Thread(target=lambda: done.append(cli.main(
        ["--interactive", "--preview_port", str(port), "--device", "cpu",
         "--width", "64", "--height", "36", "--n_stars", "100", "--ar2", "3.5",
         "--disk_tilt", "15", "--fov", "60", "-o", str(tmp_path / "x.png")])),
        daemon=True)
    thread.start()
    base, img, deadline = f"http://127.0.0.1:{port}", None, time.time() + 120
    while img is None and time.time() < deadline:
        try:
            img = _decode_jpeg(_get(f"{base}/frame", timeout=5))
        except (urllib.error.URLError, OSError):  # not up yet, or 503
            time.sleep(0.2)
    assert img is not None and img.shape == (36, 64, 3) and img.max() > 64
    _get(f"{base}/key?k=l")  # flare on: a state key through the server
    _get(f"{base}/key?k=q")
    thread.join(timeout=60)
    assert done == [0] and not thread.is_alive()
    assert re.search(r"interactive: \d+ frames", capsys.readouterr().out)
    assert os.listdir(tmp_path) == []  # the session writes no file
