"""The controls of the comparison for an anti-aliased cell, a ``video_aa``
cell or a still cell whose scene has ``anti_alias``, as ``calibrate.py``
gives the bfloat16 one for every cell: the AA reference
(``reference/frame_aa.py``) changed one way, on the cell's own frames
and size.

    python3 -m benchmark.calibrate_aa --workload <name> --seeds 11,12,13 \
        [--controls bf16,level0,noflare]

Controls: ``bf16`` (every stage's output rounded to bfloat16, below the
float32 that the configuration states), ``level0`` (every hit sampled
at mip level 0: ``aa_strength`` 0) and ``noflare`` (the lens flare left
out). For each seed it renders the frames a run of the cell compares
(``calibrate.FRAMES``: the sampled orbit frames of a job, or a sample of
a window of stills and its last) with the float32 reference and with
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
                    device: str = "cuda:0", overrides=None, spec=None) -> list:
    """[{number: worst value} of each control against the AA reference],
    over the frames a run of the cell compares."""
    from . import calibrate
    from .harness import find_cell, load_benchmark, load_config, load_traffic

    spec = spec if spec is not None else load_benchmark()
    cell = find_cell(spec, workload)
    driver = load_traffic(cell["traffic"])["driver"]
    scene = dict(load_config(cell["config"])["scene"],
                 **(overrides or {}).get("scene", {}))
    if driver not in ("video_aa", "still") or scene["anti_alias"] == "disabled":
        raise ValueError(f"{workload} ({driver!r} driver) is not an "
                         "anti-aliased video_aa or still cell")
    return calibrate.controls(workload, seed, {n: CONTROLS[n] for n in controls},
                              device, overrides, spec)


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
