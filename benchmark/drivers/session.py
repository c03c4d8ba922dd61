"""One live session, closed loop: ``InteractiveSession.step`` again and
again, each step given the time since the last one began, as the CLI's
loop gives it (the session clamps it to 0.1 s).

The window is one continuous drag of the mouse, a drag event every step
(the camera orbits): every step shows the frame the step before it
rendered (the lookahead). ``session_fps`` is the steps over the window;
``session_frame_ms_p90`` the 90th percentile of the host clock around
``step``. A ``--trace 1`` run then profiles ``traced_steps`` more steps
and times ``key_steps`` steps after a zoom key each (``keys`` in turn):
these are state keys, so the session drops its lookahead frame and the
step renders and waits for its own frame; their median is a per-layer
metric of its own, so the window's tail hinges on no rate of keys.

The drags are the same for every seed, with jitter from the seed; each
step's time is recorded in the script, which the reference replays. The
frames a step returns are compared with the reference: a sample drawn
from the seed with the slowest step and the last one in it, and in a
traced run the last key step.
"""

from __future__ import annotations

import gc
import statistics

import numpy as np

from .. import compare, devtrace
from ..harness import Run, now
from ..hostinfo import say

STATE_KEYS = ("+", "=", "-", "up", "down")
# The session's clamp of a step's time: every step at FHD takes longer.
CLAMP_DT = 0.1


class Script:
    """The per-step moves: (keys, drags, real_dt). The drags are made on
    demand from one seeded stream, so every seed makes the same kind of
    moves; keys and times are recorded as the run presses and measures
    them (a step with no recorded time takes ``CLAMP_DT``)."""

    def __init__(self, traffic: dict, seed: int):
        self.t = traffic
        self.rng = np.random.default_rng(seed)
        self.drags = []
        self.keys = {}
        self.dts = {}
        self.x, self.y = 400.0, 300.0

    def __getitem__(self, i: int):
        while len(self.drags) <= i:
            jitter = float(self.t["drag_jitter_px"])
            self.x += float(self.t["drag_px"]) + self.rng.uniform(-jitter, jitter)
            self.y = 300.0 + self.rng.uniform(-jitter, jitter)
            self.drags.append((self.x, self.y))
        return (self.keys.get(i, []), [self.drags[i]],
                self.dts.get(i, CLAMP_DT))

    def shown(self, i: int) -> int:
        """The step whose frame step ``i`` returns."""
        if i == 0 or any(k in STATE_KEYS for k in self.keys.get(i, ())):
            return i
        return i - 1


def _step(run: Run, i: int, keys=()):
    """Step ``i``, given the time since the last step began."""
    sess, script = run.state["session"], run.state["script"]
    if keys:
        script.keys[i] = list(keys)
    t = now()
    script.dts[i] = t - run.state["last"]
    run.state["last"] = t
    keys, drags, dt = script[i]
    for k in keys:
        sess.handle_key(k)
    for xy in drags:
        sess.handle_drag(*xy)
    return sess.step(dt)


def setup(run: Run) -> None:
    from bhr_tpu_torch.interactive import InteractiveSession

    run.state["script"] = Script(run.traffic, run.seed)
    run.state["session"] = InteractiveSession(run.scene_config())
    run.state["next"] = 0
    run.state["last"] = now()
    for _ in range(int(run.traffic["warm_steps"])):
        _step(run, run.state["next"])
        run.state["next"] += 1


def window(run: Run, seconds: float) -> None:
    k = int(run.traffic["sample_steps"])
    rng = np.random.default_rng(run.seed)
    kept = {}  # reservoir of k steps: {step: frame}
    slow = (-1.0, None, None)
    start = now()
    ms = run.rec["steps_ms"]
    bad = 0
    last = None
    while not ms or now() - start < seconds:
        i = run.state["next"]
        t0 = now()
        img = _step(run, i)
        dt_ms = (now() - t0) * 1e3
        run.state["next"] += 1
        ms.append(dt_ms)
        if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
                and img.shape == (int(run.scene["height"]),
                                  int(run.scene["width"]), 3)):
            bad += 1
            continue
        n = len(ms)
        if len(kept) < k:
            kept[i] = img.copy()
        else:
            j = int(rng.integers(0, n))
            if j < k:
                kept.pop(sorted(kept)[j])
                kept[i] = img.copy()
        if dt_ms > slow[0]:
            slow = (dt_ms, i, img.copy())
        last = (i, img)
    run.rec["window_s"] = now() - start
    if slow[1] is not None:
        kept[slow[1]] = slow[2]
    if last is not None:
        kept[last[0]] = last[1].copy()
    run.rec["kept"] = kept
    run.rec["bad_frames"] = bad
    say(f"window: {len(ms)} steps in {run.rec['window_s']:.3f} s; step ms "
        f"median {statistics.median(ms):.3f}, max {max(ms):.3f}")


def end_to_end(run: Run) -> dict:
    ms = run.rec["steps_ms"]
    return {"session_fps": len(ms) / run.rec["window_s"],
            "session_frame_ms_p90": float(np.percentile(ms, 90))}


def traced(run: Run) -> None:
    n = int(run.traffic["traced_steps"])

    def steps():
        for _ in range(n):
            _step(run, run.state["next"])
            run.state["next"] += 1

    _, prof = devtrace.profile(steps, run.tmpdir)
    prof["frames"] = n
    run.rec["profile"] = prof
    keys = run.traffic["keys"]
    ms = run.rec["key_steps_ms"] = []
    for j in range(int(run.traffic["key_steps"])):
        i = run.state["next"]
        t0 = now()
        img = _step(run, i, [keys[j % len(keys)]])
        ms.append((now() - t0) * 1e3)
        run.state["next"] += 1
    if ms:
        run.rec["kept"][i] = img.copy()
    say(f"key steps: {len(ms)}, ms {[round(v, 3) for v in ms]}")


def release(run: Run) -> None:
    run.state.pop("session", None)
    gc.collect()
    if run.device == "cuda":
        import torch

        torch.cuda.empty_cache()


def check(run: Run) -> dict:
    from ..reference.frame import Scene, session_frames

    script = run.state["script"]
    kept = run.rec["kept"]
    shown = {i: script.shown(i) for i in kept}
    t0 = now()
    ref = session_frames(Scene(run.scene, run.devices()[0]),
                         [script[i] for i in range(max(kept) + 1)],
                         set(shown.values()))
    ref = {i: v.cpu().numpy() for i, v in ref.items()}
    say(f"reference: {len(ref)} frames of steps {sorted(ref)} in "
        f"{now() - t0:.3f} s")
    failed, numbers = compare.judge(
        ((i, kept[i], ref[shown[i]]) for i in sorted(kept)), run.limits)
    return {"attempted": len(run.rec["steps_ms"]),
            "failed": run.rec["bad_frames"] + len(failed), "numbers": numbers,
            "compared": len(kept)}
