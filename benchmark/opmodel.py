"""The ray march's work and the card's peaks: the yardstick of the trace
kernel's roofline share.

A frozen copy of the op model of ``bhr_tpu_torch/bench.py`` (an add,
multiply, sqrt, rsqrt or reciprocal counts one, a fused multiply-add
two; fmin/fmax and compares are not counted):

- per RK4 step: adaptive step 16, four stages 35, stage slopes and
  positions 66, update 42, r^2 and affine tests 6, plus the disk-plane
  test 5 where hits are recorded; AA adds two differential RK4s of 168
  each on every step that survives (not the terminating one);
- per ray: image plane and primary ray 63 (AA: 127), escape direction
  10 per escaped ray;
- per recorded crossing: 13 (AA: 31).

The steps are counted by the benchmark's own plain tracer for the
frames' cameras, so the bound reads the work these inputs need,
whatever implements the kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

STEP_OPS = {"slim": 170, "aa": 170, "nodisk": 165}
DIFF_STEP_OPS = {"slim": 0, "aa": 336, "nodisk": 0}
RAY_OPS = {"slim": 63, "aa": 127, "nodisk": 63}
ESCAPE_OPS = 10
HIT_OPS = {"slim": 13, "aa": 31, "nodisk": 0}
# Bytes written per ray: captured, escaped, escape_dir, hit_count, hits
# (4 slots x 12 floats); the camera's 14 floats are read once.
RAY_BYTES = 1 + 1 + 12 + 4 + 4 * 12 * 4
CAMERA_BYTES = 14 * 4

# One NVIDIA H100 SXM at its 700 W limit (data sheet, dense): FP32
# outside the tensor cores, a fused multiply-add counting two; HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def trace_work(steps, captured, escaped, hit_count) -> Dict[str, int]:
    """The counts the bound needs, from one plain trace's per-ray
    tensors: rays, RK4 steps (the terminating one included), rays that
    terminated (captured or escaped), escaped rays, recorded hits."""
    return {
        "rays": int(steps.numel()),
        "steps": int(steps.sum()),
        "terminated": int((captured | escaped).sum()),
        "escaped": int(escaped.sum()),
        "hits": int(hit_count.sum()),
    }


def bound_ms(variant: str, work: Dict[str, int]) -> Tuple[float, str]:
    """(least ms one card could take for ``work``, "operations" or
    "bytes"): FP32 operations over ``PEAK_FP32`` against bytes written
    over ``PEAK_BYTES``, the larger."""
    ops = (STEP_OPS[variant] * work["steps"]
           + DIFF_STEP_OPS[variant] * (work["steps"] - work["terminated"])
           + RAY_OPS[variant] * work["rays"]
           + ESCAPE_OPS * work["escaped"]
           + HIT_OPS[variant] * work["hits"])
    nbytes = CAMERA_BYTES + work["rays"] * RAY_BYTES
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
