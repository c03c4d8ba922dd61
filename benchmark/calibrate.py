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
``video_aa`` cell renders with the AA reference, a still with the scene
``reference/still.reference_scene`` chooses (the AA reference for an
anti-aliased still), so its control is that reference rounded; the other
controls of an anti-aliased cell are ``calibrate_aa``'s. The smallest of
them over the seeds is the limits' upper reading (``PERF.md``). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# The stills a window is taken to hold when no run has counted them.
STILL_WINDOW = 100


def _video(run, seed, scene_class=None):
    from .drivers.video import sample_frames
    from .reference.frame import Scene, video_frames

    make = scene_class or Scene
    n = int(run.scene["n_frames"])
    idx = sample_frames(n, int(run.traffic["strata"]), seed)
    return idx, lambda scene, dev, lowp: video_frames(make(scene, dev, lowp),
                                                      n, idx)


def _video_aa(run, seed):
    from .reference.frame_aa import Scene

    return _video(run, seed, Scene)


def _session(run, seed):
    from .drivers.session import Script
    from .reference.frame import Scene, session_frames

    script = Script(run.traffic, seed)
    first = int(run.traffic["warm_steps"])
    rng = np.random.default_rng(seed)
    steps = sorted(set(int(i) for i in rng.integers(
        first, first + 100, int(run.traffic["sample_steps"]))))
    idx = sorted({script.shown(i) for i in steps})
    keys = [script[i] for i in range(max(idx) + 1)]
    return idx, lambda scene, dev, lowp: session_frames(
        Scene(scene, dev, lowp), keys, idx)


def _still(run, seed):
    from .drivers.still import sample_stills, still_plan
    from .reference.still import frames_of, reference_scene

    first = int(run.traffic["warm_stills"])
    picked = sample_stills(STILL_WINDOW, int(run.traffic["sample_stills"]), seed)
    idx = sorted({first + i for i in picked} | {first + STILL_WINDOW - 1})
    plan = {k: still_plan(run.scene, run.traffic, seed, k) for k in idx}
    return idx, lambda scene, dev, lowp: frames_of(
        reference_scene(scene, dev, lowp), plan)


# The frames each driver's runs compare, by the driver's name: (indices,
# render(scene, device, lowp) -> {index: uint8 frame}).
FRAMES = {"video": _video, "video_aa": _video_aa, "session": _session,
          "still": _still}


def controls(workload: str, seed: int, changed: dict, device: str = "cuda:0",
             overrides=None, spec=None) -> list:
    """[{number: worst value} of each control against the reference]:
    ``changed`` maps a control's name to (changes to the scene, lowp)."""
    from . import compare
    from .harness import Run, find_cell, load_benchmark, load_traffic

    spec = spec if spec is not None else load_benchmark()
    driver = load_traffic(find_cell(spec, workload)["traffic"])["driver"]
    if driver not in FRAMES:
        raise ValueError(f"no control for the {driver!r} driver of {workload}")
    run = Run(workload, seed, 0.0, False, overrides=overrides, spec=spec)
    try:
        idx, frames = FRAMES[driver](run, seed)
        dev = device if run.device == "cuda" else "cpu"

        def render(changes, lowp):
            return {i: v.cpu().numpy() for i, v in
                    frames(dict(run.scene, **changes), dev, lowp).items()}

        ref = render({}, False)
        out = []
        for name, (changes, lowp) in changed.items():
            ctl = render(changes, lowp)
            failed, numbers = compare.judge(((i, ctl[i], ref[i]) for i in idx),
                                            run.limits)
            out.append({"workload": workload, "seed": seed, "control": name,
                        "frames": idx, "failed": len(failed),
                        **{n: v for n, v, _ in numbers}})
        return out
    finally:
        run.close()


def control_numbers(workload: str, seed: int, device: str = "cuda:0",
                    overrides=None, spec=None) -> dict:
    """{number: worst value} of the bfloat16 control against the reference."""
    return controls(workload, seed, {"bf16": ({}, True)}, device, overrides,
                    spec)[0]


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
