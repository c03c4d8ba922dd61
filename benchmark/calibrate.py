"""The control of the comparison: the reference in bfloat16 put where the
program's frames go, on a cell's own frames and size.

    python3 -m benchmark.calibrate --workload <name> --seeds 11,12,13

For each seed it renders the frames a run of the cell would compare
(video: the sampled orbit frames of a job; session: the frames of a
sample of steps of the key script; still: a sample of a window of
``STILL_WINDOW`` stills drawn from the seed, and the window's last) with
the float32 reference and with the control (every stage's output rounded
to bfloat16; a static still's generated texture too), and prints the
comparison's numbers of the control, one JSON line per seed. A
``video_aa`` cell takes ``calibrate_aa``'s bfloat16 control. The
smallest of them over the seeds is the limits' upper reading
(``PERF.md``). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# The stills a window is taken to hold when no run has counted them.
STILL_WINDOW = 100


def _video(run, seed):
    from .drivers.video import sample_frames
    from .reference.frame import video_frames

    n = int(run.scene["n_frames"])
    idx = sample_frames(n, int(run.traffic["strata"]), seed)
    return idx, lambda scene: video_frames(scene, n, idx)


def _session(run, seed):
    from .drivers.session import Script
    from .reference.frame import session_frames

    script = Script(run.traffic, seed)
    first = int(run.traffic["warm_steps"])
    rng = np.random.default_rng(seed)
    steps = sorted(set(int(i) for i in rng.integers(
        first, first + 100, int(run.traffic["sample_steps"]))))
    idx = sorted({script.shown(i) for i in steps})
    return idx, lambda scene: session_frames(
        scene, [script[i] for i in range(max(idx) + 1)], idx)


def _still(run, seed):
    from .drivers.still import sample_stills, still_plan
    from .reference.still import frames_of

    first = int(run.traffic["warm_stills"])
    picked = sample_stills(STILL_WINDOW, int(run.traffic["sample_stills"]), seed)
    idx = sorted({first + i for i in picked} | {first + STILL_WINDOW - 1})
    plan = {k: still_plan(run.scene, run.traffic, seed, k) for k in idx}
    return idx, lambda scene: frames_of(scene, plan)


# The frames each driver's runs compare, by the driver's name.
FRAMES = {"video": _video, "session": _session, "still": _still}


def control_numbers(workload: str, seed: int, device: str = "cuda:0",
                    overrides=None) -> dict:
    """{number: worst value} of the control against the reference."""
    from . import compare
    from .harness import Run, find_cell, load_benchmark, load_traffic
    from .reference.frame import Scene

    driver = load_traffic(find_cell(load_benchmark(), workload)["traffic"])["driver"]
    if driver == "video_aa":
        from .calibrate_aa import control_numbers as aa_control

        return aa_control(workload, seed, ("bf16",), device, overrides)[0]
    if driver not in FRAMES:
        raise ValueError(f"no control for the {driver!r} driver of {workload}")
    run = Run(workload, seed, 0.0, False, overrides=overrides)
    try:
        idx, frames = FRAMES[driver](run, seed)
        dev = device if run.device == "cuda" else "cpu"
        ref = {i: v.cpu().numpy() for i, v in frames(Scene(run.scene, dev)).items()}
        ctl = {i: v.cpu().numpy()
               for i, v in frames(Scene(run.scene, dev, lowp=True)).items()}
        failed, numbers = compare.judge(((i, ctl[i], ref[i]) for i in idx),
                                        run.limits)
        return {"workload": workload, "seed": seed, "frames": idx,
                "failed": len(failed), **{n: v for n, v, _ in numbers}}
    finally:
        run.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_numbers(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
