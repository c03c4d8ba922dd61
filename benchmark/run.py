"""The benchmark of bhr_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the port. It refuses a host without as many CUDA cards as
the cell asks for, sets the cell up (counted in ``setup_s``, from the
process's start to the first timed job or step), measures for
``--seconds``, and with ``--trace 1`` profiles a little more work for
the per-layer metrics. Then, with the program's state freed, it checks
the frames of the timed path against the plain reference and prints
the numbers compared beside their limits on standard error and, as its
last line on standard output, the result as one JSON object.
"""

from __future__ import annotations

import time

_T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches inside the checkout, at fixed paths: only the
# first run of a cell in a checkout builds.
_CACHE = os.path.join(_ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _visible_cards(chips: int) -> None:
    """Show CUDA the cell's first ``chips`` cards and no others, before
    CUDA starts: with ``frame_shards 0`` the port spreads its work over
    every card it sees."""
    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([s for s in seen.split(",") if s.strip()] if seen is not None
           else [str(i) for i in range(chips)])
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def _metric(entry: dict, value: float) -> dict:
    return {"value": float(value), "unit": entry["unit"]}


def main(argv=None, overrides=None) -> int:
    """One run; ``overrides`` is the tests' path to a tiny cell on the
    CPU (``harness.Run``), which skips the look for a card."""
    from . import harness
    from .hostinfo import cache_state, launch_us, say, smi

    args = _args(argv)
    if not os.path.isfile(os.path.join(harness.ROOT, "BENCHMARK.json")):
        say("no BENCHMARK.json at the checkout's root")
        return 2
    if overrides is None:
        _visible_cards(int(harness.find_cell(harness.load_benchmark(),
                                             args.workload)["chips"]))
    import torch

    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace),
                      overrides=overrides)
    if overrides is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < run.chips:
            say(f"{args.workload} needs {run.chips} CUDA cards, this host has {have}")
            run.close()
            return 2
        say(f"cards: {smi(run.chips)}")
        say(f"launch_us {launch_us('cuda:0'):.3f}")
    spec = run.spec
    # The port caches the skybox under the working directory: each run
    # works in its own scratch directory, so every run makes its skybox
    # as a first run does, and the cache goes with the directory.
    cwd = os.getcwd()
    os.chdir(run.tmpdir)
    say(cache_state(run.scene))
    try:
        run.driver.setup(run)
        setup_s = time.time() - _T_START
        say(f"setup_s {setup_s:.3f}")
        run.driver.window(run, run.seconds)
        e2e = dict(run.driver.end_to_end(run), setup_s=setup_s)
        devices = run.devices()
        seen = torch.cuda.device_count() if run.device == "cuda" else 1
        peak = (max(torch.cuda.max_memory_allocated(d) for d in range(seen))
                if run.device == "cuda" else 0)
        per_layer, breakdown, device_extra = {}, None, {}
        if run.trace:
            run.driver.traced(run)
            for entry in harness.cell_metrics(spec, "per_layer", run.workload):
                value = harness.load_metric(entry["name"])(run.rec)
                if value is not None:
                    per_layer[entry["name"]] = _metric(entry, value)
            prof = run.rec["profile"]
            busy = [prof["busy_s"].get(i, 0.0) for i in range(len(devices))]
            device_extra = {"busy_s": sum(busy) / len(busy),
                            "window_s": prof["wall_s"]}
            breakdown = {"device_ops": prof["top_ops"],
                         "idle_gaps": prof["idle_gaps"]}
            say(f"traced: {prof['frames']} frames, {prof['launches']} launches, "
                f"{prof['device_ops']} device ops, busy {busy} s of "
                f"{prof['wall_s']:.6f} s")
        run.driver.release(run)
        verdict = run.driver.check(run)
    finally:
        os.chdir(cwd)
        run.close()
    found = harness.forbidden_modules()
    if found:
        say(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    if run.trace:
        metrics = per_layer
    else:
        metrics = {e["name"]: _metric(e, e2e[e["name"]])
                   for e in harness.cell_metrics(spec, "end_to_end", run.workload)}
    correct = verdict["failed"] == 0 and all(v <= lim for _, v, lim in verdict["numbers"])
    say(f"compared {verdict['compared']} frames; attempted {verdict['attempted']}, "
        f"failed {verdict['failed']}")
    for name, value, limit in verdict["numbers"]:
        say(f"check {name} {value!r} limit {limit!r}")
    device = {"platform": "gpu" if run.device == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0) if run.device == "cuda"
                       else "cpu"),
              "count": seen, "memory_peak_bytes": int(peak),
              **device_extra}
    result = {"correct": bool(correct), "attempted": int(verdict["attempted"]),
              "failed": int(verdict["failed"]), "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in verdict["numbers"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
