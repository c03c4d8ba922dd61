"""Stills as the CLI's default mode renders them, one after another.

Every still is what ``cli.main`` does without ``--video`` or
``--interactive``: ``modes.render_image`` of the still's scene, then
``utils.io.save_image`` of the frame to a fresh PNG path under the run's
scratch directory. Stills run back to back from the window's start, one
client; a still that starts inside the window finishes and counts.
``still_ms`` is the mean host ms from the call to ``render_image`` to the
return of ``save_image``, over the window's stills; what the harness
does between stills is not timed. Every PNG is kept until ``check``.

Traffic parameters:

- ``cameras``: ``"orbit"`` puts still ``k`` at orbit position ``k`` modulo
  the scene's ``n_frames`` of its ``orbit_degrees`` orbit (the video's
  cameras); ``"pov"`` keeps the scene's own camera for every still.
- ``disk_seeds``: ``"scene"`` renders every still with the scene's
  ``seed``; ``"per_still"`` gives still ``k`` a disk seed of its own,
  drawn from ``--seed`` and ``k``. With the static texture
  (``disk_texture: "auto"``) every still then misses the texture cache:
  it generates the texture, saves the ``.npy`` and renders. The harness
  deletes the cache file after the still, outside the timed interval.
- ``tile_shards`` (default 0): the CLI's ``--tile_shards``. Above 1,
  ``render_image`` renders the still in that many row bands over as many
  of the cell's cards (``parallel/frames.render_image_tiled``): each card
  traces and shades its band, card 0 gathers them and runs bloom, the
  clamp and the flare over the whole frame. More bands than the cell has
  chips are refused at set-up.
- ``warm_stills`` (set-up), ``traced_stills`` (profiled in a ``--trace 1``
  run, then as many again with the layers timed), ``sample_stills`` (the
  window's stills compared with the reference, drawn from the seed, and
  the run's last still besides).

Still ``k`` counts from the first set-up still, so a run's stills, their
cameras and seeds are a function of ``--seed`` alone. Every still is
checked against ``reference/still.py``'s frame of its camera and seed,
rendered by the scene that ``reference_scene`` chooses (plain, or with
AA the AA reference; the flare as the configuration states it).
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import statistics
import tempfile
from typing import Dict, List, Tuple

import numpy as np

from .. import compare, devtrace
from ..harness import Run, now, scene_seed, sync
from ..hostinfo import say, tree_bytes
from ..reference.frozen.camera import orbit_camera_position


def still_plan(scene: Dict, traffic: Dict, seed: int, k: int
               ) -> Tuple[Tuple[float, float, float], int]:
    """(camera position, disk seed) of still ``k`` of a run of ``seed``."""
    if traffic["cameras"] == "orbit":
        n = int(scene["n_frames"])
        pos = orbit_camera_position(k % n, n, float(scene["orbit_degrees"]),
                                    scene["pov"])
    elif traffic["cameras"] == "pov":
        pos = scene["pov"]
    else:
        raise ValueError(f"unknown cameras {traffic['cameras']!r}")
    if traffic["disk_seeds"] == "scene":
        disk_seed = int(scene["seed"])
    elif traffic["disk_seeds"] == "per_still":
        rng = np.random.default_rng([scene_seed(seed), int(k)])
        disk_seed = int(rng.integers(0, 2 ** 32))
    else:
        raise ValueError(f"unknown disk_seeds {traffic['disk_seeds']!r}")
    return tuple(float(c) for c in pos), disk_seed


def _still(run: Run, k: int) -> dict:
    """Still ``k``: the CLI's still branch, timed, into a fresh PNG."""
    from bhr_tpu_torch import modes
    from bhr_tpu_torch.config import SceneConfig
    from bhr_tpu_torch.utils import cache
    from bhr_tpu_torch.utils.io import save_image

    pos, disk_seed = still_plan(run.scene, run.traffic, run.seed, k)
    path = os.path.join(run.state["dir"], f"still_{k:06d}.png")
    cfg = SceneConfig(**dict(run.scene, pov=pos, seed=disk_seed, output=path,
                             tile_shards=tile_shards(run.traffic)))
    t0 = now()
    img = modes.render_image(cfg)
    t1 = now()
    save_image(img, cfg.output)
    t2 = now()
    shutil.rmtree(cache.DEFAULT_CACHE_DIR, ignore_errors=True)
    return {"k": k, "path": path, "ms": (t2 - t0) * 1e3,
            "write_ms": (t2 - t1) * 1e3}


def _stills(run: Run, n: int) -> List[dict]:
    out = []
    for _ in range(n):
        out.append(_still(run, run.state["next"]))
        run.state["next"] += 1
    return out


def tile_shards(traffic: Dict) -> int:
    """The traffic's ``tile_shards`` (0, the whole frame, by default)."""
    return int(traffic.get("tile_shards", 0))


def setup(run: Run) -> None:
    if tile_shards(run.traffic) > run.chips:
        raise ValueError(f"tile_shards {tile_shards(run.traffic)} is more "
                         f"than the cell's {run.chips} chips")
    run.state["dir"] = tempfile.mkdtemp(dir=run.tmpdir, prefix="stills_")
    run.state["next"] = 0
    warm = _stills(run, int(run.traffic["warm_stills"]))
    say(f"set-up stills: ms {[round(s['ms'], 3) for s in warm]}")
    for s in warm:
        os.remove(s["path"])


def window(run: Run, seconds: float) -> None:
    stills = run.rec["stills"] = []
    start = now()
    while not stills or now() - start < seconds:
        stills.append(_still(run, run.state["next"]))
        run.state["next"] += 1
    ms = [s["ms"] for s in stills]
    say(f"window: {len(stills)} stills in {now() - start:.3f} s; still ms "
        f"mean {statistics.fmean(ms):.3f}, median {statistics.median(ms):.3f}, "
        f"max {max(ms):.3f}")


def end_to_end(run: Run) -> dict:
    return {"still_ms": statistics.fmean(s["ms"] for s in run.rec["stills"])}


@contextlib.contextmanager
def _layer_timers(run: Run, layers: Dict[str, List[float]]):
    """Time three calls of the program inside ``render_image``, each
    from a synchronised start to a synchronised end, into ``layers``:
    ``lifecycle`` (``DynamicDiskSystem.advance``), ``render``
    (``Renderer.render``) and ``generate`` (the static texture's
    ``generate_disk_texture``, called on a cache miss). The program is
    left as it was on exit."""
    from bhr_tpu_torch.models import disk_texture
    from bhr_tpu_torch.models.dynamic_disk import DynamicDiskSystem
    from bhr_tpu_torch.pipeline import Renderer

    def timed(fn, name):
        def call(*args, **kwargs):
            sync(run)
            t0 = now()
            out = fn(*args, **kwargs)
            sync(run)
            layers[name].append((now() - t0) * 1e3)
            return out
        return call

    patched = [(DynamicDiskSystem, "advance", "lifecycle"),
               (Renderer, "render", "render"),
               (disk_texture, "generate_disk_texture", "generate")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patched]
    try:
        for owner, attr, name in patched:
            layers.setdefault(name, [])
            setattr(owner, attr, timed(getattr(owner, attr), name))
        yield layers
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def expected_layers(scene: Dict, traffic: Dict) -> Tuple[str, ...]:
    """The timed calls that every still of ``scene`` under ``traffic``
    makes once: the render, and the static texture's generation (every
    still misses the cache, which ``_still`` empties) or the lifecycle's
    t=0 tick. A still in row bands (``tile_shards`` above 1) never calls
    ``Renderer.render`` (``render_image_tiled`` traces and shades band by
    band), so it has no ``render`` and its run no ``still.render_ms``."""
    layers = () if tile_shards(traffic) > 1 else ("render",)
    if scene.get("disk_texture") == "auto":
        return layers + ("generate",)
    if scene.get("disk_texture") is None and scene["disk_model"] == "texture":
        return layers + ("lifecycle",)
    return layers


def traced(run: Run) -> None:
    """Profile ``traced_stills`` more stills, then time the layers of as
    many again (the profiler's ranges and the timers' waits kept apart).
    A timer that did not see one call a still of a layer that
    ``expected_layers`` names (the program calls it by another path)
    fails the run rather than leave its metric out; a still in row bands
    names no ``render``, so ``still.render_ms`` is absent from its line."""
    n = int(run.traffic["traced_stills"])
    profiled, prof = devtrace.profile(lambda: _stills(run, n), run.tmpdir)
    prof["frames"] = n
    run.rec["profile"] = prof
    layers: Dict[str, List[float]] = {}
    with _layer_timers(run, layers):
        timed = _stills(run, n)
    run.rec["layers"] = layers
    run.rec["traced_stills"] = profiled + timed
    say("layers (ms): " + ", ".join(
        f"{k} {[round(v, 3) for v in vs]}" for k, vs in layers.items()))
    missed = {k: len(layers[k]) for k in expected_layers(run.scene, run.traffic)
              if len(layers[k]) != n}
    if missed:
        raise RuntimeError(f"the layer timers saw {missed} calls in {n} stills")


def release(run: Run) -> None:
    gc.collect()
    if run.device == "cuda":
        import torch

        torch.cuda.empty_cache()


def _decode(path: str):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def sample_stills(n: int, k: int, seed: int) -> List[int]:
    """Indices of ``k`` of a window's ``n`` stills, drawn from the seed
    without repeats (all of them where ``n <= k``)."""
    rng = np.random.default_rng(scene_seed(seed))
    return sorted(int(i) for i in rng.choice(n, size=min(int(k), n), replace=False))


def check(run: Run) -> dict:
    """Every still's PNG on disk and not empty; a sample of the window's
    stills drawn from the seed, and the run's last still, decoded and
    compared with the reference's frames (``reference_scene``'s)."""
    from ..reference.still import frames_of, reference_scene

    window_stills = run.rec["stills"]
    every = window_stills + run.rec.get("traced_stills", [])
    say(f"bytes of the stills' PNGs: {tree_bytes(run.state['dir'])}")
    missing = sum(1 for s in every
                  if not os.path.isfile(s["path"]) or os.path.getsize(s["path"]) == 0)
    picked = [window_stills[i] for i in sample_stills(
        len(window_stills), int(run.traffic["sample_stills"]), run.seed)]
    if every[-1] not in picked:
        picked.append(every[-1])
    t0 = now()
    plan = {s["k"]: still_plan(run.scene, run.traffic, run.seed, s["k"])
            for s in picked}
    if run.device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(run.devices()[0])
    ref = frames_of(reference_scene(run.scene, run.devices()[0]), plan)
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    peak = (f", peak {torch.cuda.max_memory_allocated(run.devices()[0])} bytes"
            if run.device == "cuda" else "")
    say(f"reference: {len(ref)} stills {sorted(ref)} in {now() - t0:.3f} s{peak}")
    pairs = []
    for s in picked:
        path = s["path"]
        on_disk = os.path.isfile(path) and os.path.getsize(path) > 0
        prog = _decode(path) if on_disk else np.zeros((0,), np.uint8)
        pairs.append((s["k"], prog, ref[s["k"]]))
    failed, numbers = compare.judge(pairs, run.limits)
    shutil.rmtree(run.state["dir"], ignore_errors=True)
    return {"attempted": len(every), "failed": missing + len(failed),
            "numbers": numbers, "compared": len(pairs)}
