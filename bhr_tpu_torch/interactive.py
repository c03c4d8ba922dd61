"""Interactive preview mode.

The port of ``bhr_tpu/interactive.py``. The reference uses `ti.GUI`
(render.py:4156-4353): spherical-orbit mouse camera, FOV keys, toggles
for differentials/bloom/flare, solo-component debug keys, live lifecycle
advance, FPS HUD. GPU hosts are often headless, so this module provides:

  * a matplotlib-backed interactive window when a display is available,
    with the same key bindings (d/b/l toggles, arrows for FOV, +/- zoom,
    1-8/0 solo components, s screenshot, q quit);
  * the same session streamed as MJPEG over HTTP (``--preview_port``),
    with the keys injected through ``/key?k=``;
  * a headless fallback that renders a short animated preview sequence
    (lifecycle advancing + slow orbit) to PNG frames.

Which of the three serves a session is decided by ``run_interactive``
from the port flag and the display; the device is ``config.device`` in
all of them. Every frame's trace goes through ``trace_geodesics_cuda``:
on a CUDA device, one launch of the slim ray-march kernel, or of the AA
one while the ``d`` toggle is on.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

from .config import SceneConfig, escape_radius
from .utils.io import save_image
from .utils.profiling import span

_SOLO_KEYS = {
    "1": 0, "2": 1, "3": 3, "4": 11, "5": 12, "6": 5, "7": 9, "8": 7,
}
_SOLO_NAMES = {
    0: "temp_base", 1: "spiral", 3: "turbulence", 5: "filaments",
    7: "rt_spikes", 9: "hotspot", 11: "az_hotspot", 12: "disturb_mod",
}


def _build(config: SceneConfig):
    # One renderer-construction path for every mode (modes._make_renderer
    # handles the V2 branch and lifecycle sizing). r_escape_quantum: zoom
    # ('+'/'-') changes the camera distance a few percent per keypress;
    # the staged path rounds r_escape up to the same 4.0 grid as the
    # fused engine, so both trace the same scene (see pipeline.Renderer).
    from .modes import _make_renderer

    return _make_renderer(config, r_escape_quantum=4.0)


# Non-GUI matplotlib backends: selecting one "succeeds" headlessly, so
# it must route to the headless preview, not an invisible event loop.
_HEADLESS_BACKENDS = {"agg", "pdf", "pgf", "ps", "svg", "template", "cairo"}


def run_interactive(config: SceneConfig, preview_port: int = 0,
                    preview_host: str = "127.0.0.1") -> None:
    """Dispatch to windowed, HTTP-stream, or headless preview."""
    if preview_port:
        run_http_preview(config, preview_port, host=preview_host)
        return
    env_backend = os.environ.get("MPLBACKEND", "").lower()
    if env_backend in _HEADLESS_BACKENDS:
        run_headless_preview(config)
        return
    if os.environ.get("DISPLAY") or env_backend:
        # Only backend/window creation falls back to the headless
        # preview; an error raised later from the render loop itself
        # must propagate with its traceback, not trigger a minutes-long
        # preview render that masks it.
        try:
            window = _open_window(config)
        except Exception as exc:  # no usable backend
            print(f"Interactive window unavailable ({exc}); "
                  "falling back to headless preview")
        else:
            _run_matplotlib(config, window)
            return
    run_headless_preview(config)


def run_http_preview(config: SceneConfig, port: int,
                     max_frames: Optional[int] = None,
                     host: str = "127.0.0.1", on_start=None) -> None:
    """Interactive session streamed as MJPEG over HTTP (headless hosts).

    Serves the live render at http://host:port/ with the same key
    bindings as the window, injected via /key?k=<key> (q stops). The
    loop paces itself by real render time (InteractiveSession.step),
    exactly like the windowed path; the JPEG encode happens on the
    render thread and counts as viewer time in the HUD split.
    ``on_start(server)``, if given, is called once the server listens
    (with ``port=0`` the caller learns the bound port from it).
    """
    from .utils.preview_server import MJPEGServer

    # Start serving BEFORE the renderer is built (skybox, lifecycle
    # system, on a GPU the kernel's build): viewers get
    # 503-until-first-frame instead of connection-refused, and the URL
    # prints immediately.
    pending_keys = []
    server = MJPEGServer(port=port, on_key=pending_keys.append, host=host)
    server.start()
    print(f"Live preview: http://{server.host}:{server.port}/  "
          f"(keys via /key?k=d|b|l|up|down|+|-|0-8|q)", flush=True)
    if on_start is not None:
        on_start(server)
    sess = None
    try:
        sess = InteractiveSession(config)
        # Atomic swap + replay: keys pressed while the session was built
        # land either in the backlog (replayed here) or on the live
        # handler.
        server.set_key_handler(sess.handle_key, backlog=pending_keys)
        last = time.time()
        while sess.running:
            now = time.time()
            real_dt, last = now - last, now
            img = sess.step(real_dt)
            v0 = time.perf_counter()
            server.submit(img)
            sess.record_viewer_time(time.perf_counter() - v0)
            if max_frames is not None and sess.frames >= max_frames:
                break
    finally:
        server.stop()
        if sess is not None:
            print(sess.summary())


def run_headless_preview(config: SceneConfig, n_frames: int = 24,
                         out_dir: str = "output/preview") -> None:
    """Render a short lifecycle+orbit preview sequence to PNG frames."""
    renderer, dynamic = _build(config)
    os.makedirs(out_dir, exist_ok=True)
    cam = np.asarray(config.pov, dtype=np.float64)
    radius = float(np.linalg.norm(cam))
    base_angle = float(np.arctan2(cam[1], cam[0]))
    dt = config.disk_rotation_speed * 2.0

    speed = max(config.disk_rotation_speed, 1e-9)
    for i in range(n_frames):
        t = i * dt
        angle = base_angle + np.radians(i * 1.5)
        pos = [radius * np.cos(angle), radius * np.sin(angle), cam[2]]
        if dynamic is not None:
            tex = dynamic.advance(t, dt, recompute_stats=(i % 60 == 0))
            renderer.update_disk_texture(tex)
            frame = 0  # rotation lives in the advancing texture
        else:
            frame = t / speed  # V2: rotation via the sampler's t_offset
        img = renderer.render(
            pos, config.fov, frame=frame, skip_differentials=True
        )
        save_image(img, os.path.join(out_dir, f"preview_{i:03d}.png"))
    print(f"Headless preview: {n_frames} frames in {out_dir}/")


def _open_window(config: SceneConfig):
    """Select a GUI backend and create the window — the only part whose
    failure should fall back to the headless preview."""
    import matplotlib

    matplotlib.use(os.environ.get("MPLBACKEND", "TkAgg"))
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    return plt, fig, ax


class _FusedEngine:
    """The interactive session's frame, through the batched video
    engine's per-frame renderer on a one-device grid.

    ``bhr_tpu`` routes the session through its video engine because that
    engine compiles texture generation, trace, shade and post into one
    program per frame. PyTorch runs eagerly and compiles nothing, but
    the video engine's frame is still the better one for a live session:
    it makes the frame's texture, mips, trace, shade and post on the
    device without a host copy in between, normalizes every frame with
    stats recomputed from that frame (no 60-frame brightness jumps), and
    hands back the uint8 frame on the device, so its copy to the host can
    overlap the next frame (``InteractiveSession.step``). The toggles
    (d/b/l), the solo views and zoom select among renderer closures that
    are built once each and kept: building one uploads the per-row omegas
    and the edge alpha. Zoom rounds the escape radius up to the 4.0 grid
    of the staged path (``pipeline.Renderer``), so both paths trace the
    same scene and the closures stay few.
    """

    R_ESCAPE_QUANTUM = 4.0

    def __init__(self, config: SceneConfig, renderer, dynamic):
        from .parallel.mesh import make_frame_mesh

        self.config = config
        # The Renderer's device-resident skybox is shared: one
        # generation and one upload per session, both paths agree.
        self.device = renderer.skybox.device
        self.skybox = {self.device: renderer.skybox}
        self.dynamic = dynamic
        self.mesh = make_frame_mesh(1, 1, devices=[self.device])
        if dynamic is not None:
            self.n_r, self.n_phi = dynamic.n_r, dynamic.n_phi
            self.az_freq, self.az_shear = dynamic.az_freq, dynamic.az_shear
        else:  # V2 volume model: no texture pipeline
            self.n_r = self.n_phi = 0
            self.az_freq = self.az_shear = 0.0
        self._renderers: dict = {}

    def _renderer(self, diff: bool, bloom: bool, flare: bool, solo: int,
                  r_escape: float):
        from .parallel.video import build_sharded_video_renderer

        key = (diff, bloom, flare, solo, r_escape)
        fn = self._renderers.get(key)
        if fn is None:
            cfg = self.config
            want_aa = "lod_radius" if diff else "disabled"
            if cfg.anti_alias != want_aa or cfg.lens_flare != flare:
                cfg = dataclasses.replace(cfg, anti_alias=want_aa,
                                          lens_flare=flare)
            fn = build_sharded_video_renderer(
                self.mesh, cfg, self.n_r, self.n_phi, r_escape=r_escape,
                az_freq=self.az_freq, az_shear=self.az_shear,
                use_bloom=bloom, solo_idx=solo,
            )
            # Kept for the session: the toggles and a quantised radius
            # span a few dozen keys, each holding two small tensors.
            self._renderers[key] = fn
        return fn

    def render_async(self, cam_pos, fov, t, entities, diff, bloom, flare,
                     solo=-1):
        """Enqueue one frame; returns the (H, W, 3) uint8 tensor on the
        device without waiting for its last kernels (the host does wait
        for the trace inside the frame: shading reads ``max(hit_count)``).
        ``entities`` are the lifecycle's packs at ``t``
        (``DynamicDiskSystem._pack``), None for V2. ``solo`` >= 0 selects
        the solo-component debug view (the masked component field, inside
        the same frame program)."""
        from .camera import build_camera
        from .parallel.frames import pack_cameras

        cfg = self.config
        is_v2 = cfg.disk_model == "v2"
        q = self.R_ESCAPE_QUANTUM
        r_esc = float(np.ceil(escape_radius(cfg.r_max, cam_pos) / q) * q)
        fn = self._renderer(bool(diff) and not is_v2, bool(bloom), bool(flare),
                            -1 if is_v2 else int(solo), r_esc)
        width, height = cfg.image_size
        cam_pack = pack_cameras([build_camera(cam_pos, fov, width, height)])
        fil = hs = rt = None
        if entities is not None:
            fil, hs, rt = (np.asarray(a)[None] for a in entities)
        return fn(self.skybox, cam_pack, np.asarray([t], np.float32),
                  fil, hs, rt)[0]


def _to_host(frame) -> np.ndarray:
    """A device frame (torch tensor, or whatever a stubbed renderer
    returns) as a NumPy array."""
    if hasattr(frame, "detach"):
        return frame.detach().cpu().numpy()
    return np.asarray(frame)


class InteractiveSession:
    """The interactive loop's state + per-frame logic, viewer-agnostic.

    Everything the matplotlib window does besides pixels-on-screen lives
    here so it runs (and is tested) headlessly: camera spherical state,
    key/mouse handling, lifecycle advance, render dispatch, and the
    render-vs-viewer timing split the HUD reports. The reference's
    equivalent is the ti.GUI body (render.py:4227-4348)."""

    def __init__(self, config: SceneConfig, renderer=None, dynamic=None,
                 lookahead: bool = True, fused: bool = True):
        if renderer is None:
            renderer, dynamic = _build(config)
        self.config = config
        self.renderer = renderer
        self.dynamic = dynamic
        # Production path: the whole frame through the video engine's
        # per-frame renderer (_FusedEngine), solo debug views included.
        # The staged Renderer path remains for sessions built with
        # fused=False and for test doubles that stub the renderer (no
        # skybox tensor to share).
        self._fused = None
        if fused and hasattr(renderer, "skybox"):
            self._fused = _FusedEngine(config, renderer, dynamic)
        # Double-buffered display: step N enqueues frame N, starts its
        # copy into pinned host memory on a copy stream, and returns
        # frame N-1 once its copy has landed, so the device finishes
        # frame N while the viewer draws frame N-1. Costs one frame of
        # display latency (the classic swap-chain trade). Disabled when
        # the renderer has no device-resident path.
        self.lookahead = lookahead and (
            self._fused is not None or hasattr(renderer, "render_device")
        )
        self._pending = None
        self._fetcher = None
        cam = np.asarray(config.pov, dtype=np.float64)
        self.r = float(np.linalg.norm(cam))
        self.theta = float(np.arccos(np.clip(cam[2] / self.r, -1, 1)))
        self.phi = float(np.arctan2(cam[1], cam[0]))
        self.fov = config.fov
        # 'd' toggles the differential+mip-LOD path live (inert for V2,
        # which has no LOD path); start from the launch config.
        self.diff = config.use_ray_differentials
        self.bloom = True
        self.flare = False
        self.solo = -1
        self.running = True
        self.drag = None
        self.wall_time = 0.0
        self.frames = 0
        self.fps = 0.0
        # Per-stage accounting: sim+render (device) vs viewer (display)
        # wall time, so a slow session is attributable at a glance.
        self.render_s = 0.0
        self.viewer_s = 0.0
        self.last_render_ms = 0.0
        self.last_viewer_ms = 0.0

    # -- input -------------------------------------------------------------

    # Keys that change what the NEXT frame should look like; a pending
    # lookahead frame rendered under the old settings must be dropped
    # so no stale-mode frame is displayed (or screenshot) after a
    # toggle.
    _STATE_KEYS = frozenset(
        ("d", "b", "l", "up", "down", "+", "=", "-", "0")
    ) | frozenset(_SOLO_KEYS)

    def handle_key(self, k, screenshot_img=None) -> None:
        if k in ("q", "escape"):
            self.running = False
        elif k == "d":
            self.diff = not self.diff
        elif k == "b":
            self.bloom = not self.bloom
        elif k == "l":
            self.flare = not self.flare
        elif k == "up":
            self.fov = max(10.0, self.fov - 5.0)
        elif k == "down":
            self.fov = min(170.0, self.fov + 5.0)
        elif k in ("+", "="):
            self.r = max(2.0, self.r * 0.97)
        elif k == "-":
            self.r *= 1.03
        elif k == "0":
            self.solo = -1
        elif k in _SOLO_KEYS:
            self.solo = _SOLO_KEYS[k]
        elif k == "s" and screenshot_img is not None:
            path = f"output/screenshot_{int(time.time())}.png"
            save_image(np.asarray(screenshot_img), path)
            print(f"Screenshot: {path}")
        if k in self._STATE_KEYS:
            self._pending = None

    def handle_drag(self, x, y) -> None:
        if self.drag is None or x is None:
            self.drag = (x, y) if x is not None else None
            return
        dx = (x - self.drag[0]) / 200.0
        dy = (y - self.drag[1]) / 200.0
        self.phi -= dx
        self.theta = float(np.clip(self.theta - dy, 0.05, np.pi - 0.05))
        self.drag = (x, y)

    def cam_pos(self):
        r, th, ph = self.r, self.theta, self.phi
        return [r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                r * np.cos(th)]

    # -- per-frame ----------------------------------------------------------

    def _fetch(self, frame) -> np.ndarray:
        """Start the fused frame's copy to the host and return the frame
        to display: with lookahead the previous step's (this one's on the
        first step and after a state key), whose copy is waited for."""
        from .parallel.video import _FrameFetcher

        if self._fetcher is None:
            self._fetcher = _FrameFetcher()
        started = self._fetcher.start(frame)
        if self.lookahead:
            # last_render_ms then measures enqueue(N) + the rest of
            # fetch(N-1): the steady per-frame wall cost.
            prev, self._pending = self._pending, started
            if prev is not None:
                started = prev
        host, copied = started
        with span("session.fetch_wait"):
            if copied is not None:
                copied[1].synchronize()
        return host

    def step(self, real_dt: float) -> np.ndarray:
        """Advance the simulation by one display frame and render it:
        the span ``session.step``, whose time the HUD shows."""
        with span("session.step") as step:
            img = self._step(real_dt)
        self.last_render_ms = step.seconds * 1e3
        self.render_s += step.seconds
        self.fps = 0.9 * self.fps + 0.1 * (1.0 / max(real_dt, 1e-3))
        return img

    def _step(self, real_dt: float) -> np.ndarray:
        """``step``'s work: the spans ``session.lifecycle``,
        ``session.enqueue`` and ``session.fetch_wait`` on the fused path."""
        dt = min(real_dt, 0.1)  # clamped sim step (no jumps after stalls)
        scaled_dt = dt * self.config.disk_rotation_speed * 20.0
        self.wall_time += scaled_dt
        self.frames += 1

        if self._fused is None:
            return self._step_staged(scaled_dt)
        # Production path: the whole frame stays on the device; factory
        # bookkeeping and the entities' packing are the only host work
        # besides enqueueing. Its normalization stats are recomputed
        # every frame, and the solo debug views (1-8 keys) render here
        # too, from the masked component field.
        entities = None
        with span("session.lifecycle"):
            if self.dynamic is not None:
                for fac in self.dynamic.factories.values():
                    fac.tick(now=self.wall_time, dt=scaled_dt)
                entities = self.dynamic._pack(self.wall_time)
        with span("session.enqueue"):
            frame = self._fused.render_async(
                self.cam_pos(), self.fov, self.wall_time, entities,
                self.diff, self.bloom, self.flare, solo=self.solo,
            )
        return self._fetch(frame)

    def _step_staged(self, scaled_dt: float) -> np.ndarray:
        """The staged Renderer path: stubbed-renderer tests and
        sessions built with fused=False (it still honors solo_idx via
        DynamicDiskSystem.advance, so both paths render solo views)."""
        if self.dynamic is not None:
            tex = self.dynamic.advance(
                self.wall_time, scaled_dt,
                recompute_stats=(self.frames % 60 == 1),
                solo_idx=self.solo,
            )
            self.renderer.update_disk_texture(tex)
            render_frame = 0  # rotation lives in the advancing texture
        else:
            # V2 volume disk: rotation via the sampler's t_offset.
            render_frame = self.wall_time / max(
                self.config.disk_rotation_speed, 1e-9
            )
        render_kwargs = dict(
            frame=render_frame,
            skip_differentials=not self.diff,
            force_differentials=self.diff,
            skip_bloom=not self.bloom,
            lens_flare=self.flare,
        )
        if self.lookahead and hasattr(self.renderer, "render_device"):
            dev = self.renderer.render_device(
                self.cam_pos(), self.fov, **render_kwargs
            )
            prev, self._pending = self._pending, dev
            return _to_host(dev if prev is None else prev)
        return self.renderer.render(
            self.cam_pos(), self.fov, **render_kwargs
        )

    def record_viewer_time(self, seconds: float) -> None:
        self.last_viewer_ms = seconds * 1e3
        self.viewer_s += seconds

    def hud_text(self) -> str:
        solo_txt = (f" SOLO:{_SOLO_NAMES.get(self.solo, self.solo)}"
                    if self.solo >= 0 else "")
        d_txt = ("n/a" if self.config.disk_model == "v2"
                 else ("ON" if self.diff else "off"))
        ec = self.dynamic.entity_count if self.dynamic is not None else 0
        return (
            f"{self.fps:.0f} FPS "
            f"(render {self.last_render_ms:.0f} ms / "
            f"view {self.last_viewer_ms:.0f} ms) | D:{d_txt} "
            f"B:{'ON' if self.bloom else 'off'} "
            f"L:{'ON' if self.flare else 'off'} | E:{ec}{solo_txt}\n"
            f"r={self.r:.1f} fov={self.fov:.0f} t={self.wall_time:.1f}"
        )

    def summary(self) -> str:
        n = max(self.frames, 1)
        return (
            f"interactive: {self.frames} frames, "
            f"render {self.render_s / n * 1e3:.0f} ms/frame, "
            f"viewer {self.viewer_s / n * 1e3:.0f} ms/frame"
        )


def _run_matplotlib(config: SceneConfig, window) -> None:
    """Matplotlib interactive loop over an InteractiveSession.

    Display path: blit the image + HUD artists onto a cached canvas
    background instead of a full draw_idle per frame — the full redraw
    is the viewer's bottleneck (the reference's ti.GUI set_image is
    zero-copy, render.py:4333). Falls back to draw_idle when the backend
    cannot blit.
    """
    plt, fig, ax = window
    sess = InteractiveSession(config)

    ax.axis("off")
    im = ax.imshow(np.zeros((*config.image_size[::-1], 3)))
    hud = ax.text(0.01, 0.97, "", transform=ax.transAxes, color="w",
                  fontsize=8, va="top")

    fig.canvas.mpl_connect(
        "key_press_event",
        lambda e: sess.handle_key(e.key, screenshot_img=im.get_array()),
    )
    fig.canvas.mpl_connect(
        "button_press_event", lambda e: sess.handle_drag(e.x, e.y))
    fig.canvas.mpl_connect(
        "button_release_event", lambda e: sess.handle_drag(None, None))
    fig.canvas.mpl_connect(
        "motion_notify_event",
        lambda e: (sess.drag is not None) and sess.handle_drag(e.x, e.y))
    plt.ion()
    plt.show()

    # Blit state: the cached background must be re-captured after a
    # window resize (the canvas buffer is recreated at the new size;
    # restoring the stale region would paint garbage without raising).
    # blit["ok"] False permanently disables the fast path (backend
    # without copy_from_bbox / blit).
    blit = {"bg": None, "ok": True}

    def _invalidate_bg(event=None):
        blit["bg"] = None

    try:
        fig.canvas.mpl_connect("resize_event", _invalidate_bg)
    except Exception:
        pass

    def _cache_bg():
        try:
            fig.canvas.draw()
            blit["bg"] = fig.canvas.copy_from_bbox(fig.bbox)
        except Exception:
            blit["bg"] = None
            blit["ok"] = False

    last = time.time()
    while sess.running and plt.fignum_exists(fig.number):
        now = time.time()
        real_dt = now - last
        last = now
        img = sess.step(real_dt)

        v0 = time.perf_counter()
        im.set_data(img)
        hud.set_text(sess.hud_text())
        if blit["ok"] and blit["bg"] is None:
            _cache_bg()
        if blit["bg"] is not None:
            try:
                fig.canvas.restore_region(blit["bg"])
                ax.draw_artist(im)
                ax.draw_artist(hud)
                fig.canvas.blit(fig.bbox)
                fig.canvas.flush_events()
            except Exception:
                blit["bg"] = None  # backend lied about blitting
                blit["ok"] = False
        if blit["bg"] is None:
            fig.canvas.draw_idle()
            plt.pause(0.001)
        sess.record_viewer_time(time.perf_counter() - v0)
    print(sess.summary())
