"""The anti-aliased, lens-flared orbit video, job after job.

``drivers/video.py`` as it stands (its jobs, window, metrics, record,
sample of frames and traffic parameters), for a scene with
``anti_alias="lod_radius"``: the trace carries the two ray
differentials, so a ``--trace 1`` run counts the ray march's work with
the plain tracer that carries them too, against the op model's ``aa``
row, and the frames are checked against the AA reference
(``reference/frame_aa.py``: mips, LOD shade, flare).
"""

from __future__ import annotations

import os

import numpy as np

from .. import compare, devtrace
from ..harness import Run, now
from ..hostinfo import say, tree_bytes
from . import video
from .video import (  # noqa: F401  (the driver's interface)
    _decode,
    _drop,
    _frames_dir,
    _job,
    end_to_end,
    release,
    sample_frames,
    window,
)


def setup(run: Run) -> None:
    # The run's record is the video driver's (jobs, profile), so the
    # video metrics that read only a video record read this one.
    run.rec["driver"] = "video"
    video.setup(run)


def traced(run: Run) -> None:
    """Profile one more whole job of ``traced_frames`` frames, and count
    the work its ray marches need with the reference's plain tracer,
    differentials and all."""
    from ..opmodel import trace_work
    from ..reference.frame import orbit_camera
    from ..reference.frame_aa import trace_frame_aa
    from ..reference.frozen.config import orbit_escape_radius

    n = int(run.traffic["traced_frames"])
    job, prof = devtrace.profile(lambda: _job(run, n), run.tmpdir)
    _drop(job)
    prof["frames"] = n
    run.rec["profile"] = prof
    # At tilt 0 every orbit frame needs the same steps up to rounding:
    # count frame 0, check another.
    r_esc = orbit_escape_radius(float(run.scene["r_max"]), run.scene["pov"])
    works = []
    t0 = now()
    for f in (0, n // 2):
        tr = trace_frame_aa(run.scene, orbit_camera(run.scene, f, n), r_esc,
                            run.devices()[0], record_step_counts=True)
        works.append(trace_work(tr.steps, tr.captured, tr.escaped, tr.hit_count))
        del tr
    say(f"plain AA trace work, frames 0 and {n // 2}: {works} "
        f"in {now() - t0:.3f} s")
    run.rec["trace_work"] = {"variant": "aa", "per_frame": works[0],
                             "second_frame": works[1]}


def check(run: Run) -> dict:
    """``drivers/video.check`` against the AA reference: every frame of
    every job on disk; in each job the seed's sample, decoded and
    compared."""
    from ..reference.frame import video_frames
    from ..reference.frame_aa import Scene

    jobs = run.rec["jobs"]
    n = int(run.scene["n_frames"])
    sample = sample_frames(n, int(run.traffic["strata"]), run.seed)
    say(f"bytes written by the window's jobs: {tree_bytes(run.tmpdir)}")
    missing = 0
    for job in jobs:
        frames_dir = _frames_dir(job["output"])
        pngs = [os.path.join(frames_dir, f"frame_{f:04d}.png") for f in range(n)]
        lost = sum(1 for p in pngs if not os.path.isfile(p) or os.path.getsize(p) == 0)
        base = os.path.splitext(job["output"])[0]
        if not any(os.path.isfile(base + ext) for ext in (".mp4", ".avi")):
            lost = n  # no video file: the job's frames never reached the user
        missing += lost
    if run.device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(run.devices()[0])
    t0 = now()
    ref = video_frames(Scene(run.scene, run.devices()[0]), n, sample)
    ref = {f: v.cpu().numpy() for f, v in ref.items()}
    peak = (f", peak {torch.cuda.max_memory_allocated(run.devices()[0])} bytes"
            if run.device == "cuda" else "")
    say(f"reference: {len(sample)} frames {sample} in {now() - t0:.3f} s{peak}")
    pairs = []
    for j, job in enumerate(jobs):
        frames_dir = _frames_dir(job["output"])
        for f in sample:
            path = os.path.join(frames_dir, f"frame_{f:04d}.png")
            prog = _decode(path) if os.path.isfile(path) else np.zeros((0,), np.uint8)
            pairs.append(((j, f), prog, ref[f]))
    failed, numbers = compare.judge(pairs, run.limits)
    for job in jobs:
        _drop(job)
    return {"attempted": sum(j["frames"] for j in jobs),
            "failed": missing + len(failed), "numbers": numbers,
            "compared": len(pairs)}
