"""Ray-march throughput of the bench scene: Mray-steps/s on one card.

The port of ``tools/bench_trace.py``: a thin shell over
``bhr_tpu_torch.bench.time_trace``, so that this tool and
``chip_smoke.py`` can never measure different things. A "ray-step" is
one useful RK4 step of one ray, counted by the kernel's step-count
instantiation. Beside it, the kernel's shares of its FP32-operation
bound and of its issue bound (``bench.bound``, ``bench.issue_bounds``:
the op model of ``csrc/ray_march.cu`` and the SASS of the built
library), which take the place of ``bhr_tpu``'s VPU utilizations.

Usage:
    python -m bhr_tpu_torch.tools.bench_trace [--aa] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..config import DEVICES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--aa", action="store_true",
                    help="trace with ray-differential transport (the AA path: "
                         "two more Jacobian RK4 systems a step)")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=20,
                    help="timed launches (CUDA events around all of them)")
    args = ap.parse_args(argv)

    from .. import bench

    tr = bench.time_trace(args.aa, device=args.device,
                          size=(args.width, args.height), iters=args.iters)
    base = "aa" if args.aa else "slim"
    tr.update({
        "metric": "geodesic_rk4_mray_steps_per_s" + ("_aa" if args.aa else ""),
        "value": tr["mray_steps_per_s"],
        "unit": "Mray-steps/s",
        "device": args.device,
        "step_ops_model": bench.STEP_OPS[base] + bench.DIFF_STEP_OPS[base],
        "peak_fp32_tflops": bench.PEAK_FP32 / 1e12,
    })
    print(json.dumps(tr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
