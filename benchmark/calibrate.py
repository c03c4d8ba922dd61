"""The control of the comparison: the reference in bfloat16 put where the
program's frames go, on a cell's own frames and size.

    python3 -m benchmark.calibrate --workload <name> --seeds 11,12,13

For each seed it renders the frames a run of the cell would compare
(video: the sampled orbit frames of a job; session: the frames of a
sample of steps of the key script) with the float32 reference and with
the control (every stage's output rounded to bfloat16), and prints the
comparison's numbers of the control, one JSON line per seed. The
smallest of them over the seeds is the limits' upper reading
(``PERF.md``). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def control_numbers(workload: str, seed: int, device: str = "cuda:0",
                    overrides=None) -> dict:
    """{number: worst value} of the control against the reference."""
    from . import compare
    from .harness import Run
    from .reference.frame import Scene, session_frames, video_frames

    run = Run(workload, seed, 0.0, False, overrides=overrides)
    try:
        if run.traffic["driver"] == "video":
            from .drivers.video import sample_frames

            n = int(run.scene["n_frames"])
            idx = sample_frames(n, int(run.traffic["strata"]), seed)
            frames = lambda scene: video_frames(scene, n, idx)  # noqa: E731
        else:
            from .drivers.session import Script

            script = Script(run.traffic, seed)
            first = int(run.traffic["warm_steps"])
            rng = np.random.default_rng(seed)
            steps = sorted(set(int(i) for i in rng.integers(
                first, first + 100, int(run.traffic["sample_steps"]))))
            idx = sorted({script.shown(i) for i in steps})
            frames = lambda scene: session_frames(  # noqa: E731
                scene, [script[i] for i in range(max(idx) + 1)], idx)
        dev = device if run.device == "cuda" else "cpu"
        ref = {i: v.cpu().numpy() for i, v in frames(Scene(run.scene, dev)).items()}
        ctl = {i: v.cpu().numpy()
               for i, v in frames(Scene(run.scene, dev, lowp=True)).items()}
        _, numbers = compare.judge(((i, ctl[i], ref[i]) for i in idx), run.limits)
        return {"workload": workload, "seed": seed, "frames": idx,
                **{n: v for n, v, _ in numbers}}
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
