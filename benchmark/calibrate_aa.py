"""The controls of the comparison for a ``video_aa`` cell, as
``calibrate.py`` gives them for ``video``: the AA reference
(``reference/frame_aa.py``) changed one way, on the cell's own frames
and size.

    python3 -m benchmark.calibrate_aa --workload <name> --seeds 11,12,13 \
        [--controls bf16,level0,noflare]

Controls: ``bf16`` (every stage's output rounded to bfloat16, below the
float32 that the configuration states), ``level0`` (every hit sampled
at mip level 0: ``aa_strength`` 0) and ``noflare`` (the lens flare left
out). For each seed it renders the frames a run of the cell compares
(the sampled orbit frames of a job) with the float32 reference and with
each control, and prints the comparison's numbers of each control, one
JSON line per seed and control. The smallest ``bf16`` numbers over the
seeds are the limits' upper reading (``PERF.md``); each of the others
must fail a limit. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

# Each control: (changes to the scene, lowp).
CONTROLS = {
    "bf16": ({}, True),
    "level0": ({"aa_strength": 0.0}, False),
    "noflare": ({"lens_flare": False}, False),
}


def control_numbers(workload: str, seed: int, controls=("bf16",),
                    device: str = "cuda:0", overrides=None) -> list:
    """[{number: worst value} of each control against the reference]."""
    from . import compare
    from .drivers.video import sample_frames
    from .harness import Run
    from .reference.frame import video_frames
    from .reference.frame_aa import Scene

    run = Run(workload, seed, 0.0, False, overrides=overrides)
    try:
        if run.traffic["driver"] != "video_aa":
            raise ValueError(f"{workload} is not a video_aa cell")
        n = int(run.scene["n_frames"])
        idx = sample_frames(n, int(run.traffic["strata"]), seed)
        dev = device if run.device == "cuda" else "cpu"

        def frames(scene, lowp=False):
            return {i: v.cpu().numpy() for i, v in video_frames(
                Scene(scene, dev, lowp=lowp), n, idx).items()}

        ref = frames(run.scene)
        out = []
        for name in controls:
            changes, lowp = CONTROLS[name]
            ctl = frames(dict(run.scene, **changes), lowp)
            failed, numbers = compare.judge(
                ((i, ctl[i], ref[i]) for i in idx), run.limits)
            out.append({"workload": workload, "seed": seed, "control": name,
                        "frames": idx, "failed": len(failed),
                        **{k: v for k, v, _ in numbers}})
        return out
    finally:
        run.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate_aa")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="bf16")
    args = p.parse_args(argv)
    controls = args.controls.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in control_numbers(args.workload, seed, controls):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
