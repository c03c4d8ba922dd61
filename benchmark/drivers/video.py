"""The orbit video as the CLI's ``--video --orbit`` runs it, job after job.

Every job is one ``modes.render_video`` call of the configuration's
``n_frames`` frames over the orbit, written to a fresh directory under
the run's scratch directory (the PNG frames, ``progress.json`` and the
video file). Jobs run back to back from the window's start; a job that
starts inside the window finishes and counts. ``video_fps`` is every
frame of every job over the time from the first job's start to the last
job's end.

Traffic parameters: ``frame_shards`` (the port's ``--frame_shards``: 0
spreads each batch over every card the cell has), ``warm_frames`` (the
set-up job), ``traced_frames`` (the job profiled in a ``--trace 1``
run), ``strata`` (the positions of a batch to compare: every frame of
a job whose index is ``r`` modulo ``strata`` falls on the same card and
the same place in its batch, so one frame drawn from the seed for each
``r``, and the last frame, cover every card and every place in a
batch; each job is compared at these frames).
"""

from __future__ import annotations

import gc
import hashlib
import os
import shutil
import tempfile

import numpy as np

from .. import compare, devtrace
from ..harness import Run, now, sync
from ..hostinfo import say, tree_bytes


def _frames_dir(output: str) -> str:
    """Where the port writes a video's PNG frames: ``.frames_`` and the
    first 16 hex digits of the output path's md5, beside the output."""
    return os.path.join(os.path.dirname(output), ".frames_"
                        + hashlib.md5(output.encode()).hexdigest()[:16])


def _job(run: Run, n_frames: int) -> dict:
    """One video job of ``n_frames`` frames in a fresh directory."""
    from bhr_tpu_torch import modes

    d = tempfile.mkdtemp(dir=run.tmpdir, prefix="job_")
    output = os.path.join(d, "orbit.mp4")
    cfg = run.scene_config(video=True, orbit=True, n_frames=n_frames,
                           frame_shards=int(run.traffic["frame_shards"]),
                           output=output)
    t0 = now()
    stats = modes.render_video(cfg)
    sync(run)
    t1 = now()
    return {"dir": d, "output": output, "n_frames": n_frames, "t0": t0,
            "t1": t1, "frames": int(stats["frames"]),
            "stage_ms": stats.get("stage_ms") or {},
            "writer_wait_s": stats.get("writer_wait_s"),
            "assembler": stats.get("assembler")}


def _drop(job: dict) -> None:
    shutil.rmtree(job["dir"], ignore_errors=True)


def setup(run: Run) -> None:
    job = _job(run, int(run.traffic["warm_frames"]))
    say(f"set-up job: {job['frames']} frames in {job['t1'] - job['t0']:.3f} s, "
        f"assembler {job['assembler']}")
    _drop(job)


def window(run: Run, seconds: float) -> None:
    n = int(run.scene["n_frames"])
    start = now()
    while not run.rec["jobs"] or now() - start < seconds:
        job = _job(run, n)
        run.rec["jobs"].append(job)
        say(f"job {len(run.rec['jobs'])}: {job['frames']} frames in "
            f"{job['t1'] - job['t0']:.3f} s, assembler {job['assembler']}")


def end_to_end(run: Run) -> dict:
    jobs = run.rec["jobs"]
    frames = sum(j["frames"] for j in jobs)
    span = jobs[-1]["t1"] - jobs[0]["t0"]
    say(f"window: {len(jobs)} jobs, {frames} frames in {span:.3f} s")
    return {"video_fps": frames / span}


def traced(run: Run) -> None:
    """Profile one more whole job of ``traced_frames`` frames, and count
    the work its ray marches need with the reference's plain tracer."""
    from ..reference.frame import orbit_camera, trace_frame
    from ..reference.frozen.config import orbit_escape_radius
    from ..opmodel import trace_work

    n = int(run.traffic["traced_frames"])
    job, prof = devtrace.profile(lambda: _job(run, n), run.tmpdir)
    _drop(job)
    prof["frames"] = n
    run.rec["profile"] = prof
    # At tilt 0 the scene is symmetric about z, so every orbit frame
    # needs the same steps up to rounding: count frame 0, check another.
    r_esc = orbit_escape_radius(float(run.scene["r_max"]), run.scene["pov"])
    works = []
    for f in (0, n // 2):
        tr = trace_frame(run.scene, orbit_camera(run.scene, f, n), r_esc,
                         run.devices()[0], record_step_counts=True)
        works.append(trace_work(tr.steps, tr.captured, tr.escaped, tr.hit_count))
        del tr
    say(f"plain trace work, frames 0 and {n // 2}: {works}")
    run.rec["trace_work"] = {"variant": "slim", "per_frame": works[0],
                             "second_frame": works[1]}


def release(run: Run) -> None:
    gc.collect()
    if run.device == "cuda":
        import torch

        torch.cuda.empty_cache()


def _decode(path: str):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def sample_frames(n: int, strata: int, seed: int) -> list:
    """The frames of a job that are compared: for each residue ``r``
    modulo ``strata``, one frame ``r + strata * k`` with ``k`` drawn from
    the seed, and the last frame."""
    rng = np.random.default_rng(seed)
    s = min(int(strata), n)
    picked = {r + s * int(rng.integers(0, -(-(n - r) // s))) for r in range(s)}
    return sorted(picked | {n - 1})


def check(run: Run) -> dict:
    """Every frame of every job on disk; in each job a sample of them,
    one in each stratum drawn from the seed and the last frame, decoded
    and compared with the reference's frames."""
    from ..reference.frame import Scene, video_frames

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
    t0 = now()
    ref = video_frames(Scene(run.scene, run.devices()[0]), n, sample)
    ref = {f: v.cpu().numpy() for f, v in ref.items()}
    say(f"reference: {len(sample)} frames {sample} in {now() - t0:.3f} s")
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
