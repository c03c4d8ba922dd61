"""The comparison that decides ``correct``: frames of the timed path
against the plain reference's, in uint8 steps.

Three numbers per frame, each judged by its worst frame:

- ``frame_mean_abs``: the mean |program - reference| over every channel
  of every pixel (uint8 steps);
- ``frame_off1_share``: the share (%) of channels off by more than one
  step (a systematic small error: a lower precision, a changed stage);
- ``frame_far_share``: the share (%) of pixels with a channel off by
  more than ``FAR_STEPS`` (rays that took another path: captured for
  escaped, disk for sky).

The ray-march kernel fuses multiply-adds where the plain tracer does
not, so a few rays cross the disk or the horizon on another step; the
limits leave room for that and no more (``PERF.md`` gives the readings
they were set from).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

FAR_STEPS = 8
NUMBERS = ("frame_mean_abs", "frame_off1_share", "frame_far_share")


def frame_numbers(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """The three numbers of one (H, W, 3) uint8 frame pair."""
    if prog.shape != ref.shape or prog.dtype != np.uint8:
        return {n: float("inf") for n in NUMBERS}
    d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return {
        "frame_mean_abs": float(d.mean()),
        "frame_off1_share": float((d > 1).mean() * 100.0),
        "frame_far_share": float((d.max(axis=-1) > FAR_STEPS).mean() * 100.0),
    }


def judge(pairs: Iterable[Tuple[object, np.ndarray, np.ndarray]],
          limits: Dict[str, float]) -> Tuple[List[object], List[list]]:
    """(labels of the frames over a limit, [[name, worst value, limit]]
    for each number) over ``(label, program frame, reference frame)``."""
    worst = {n: 0.0 for n in NUMBERS}
    failed = []
    for label, prog, ref in pairs:
        nums = frame_numbers(prog, ref)
        if any(nums[n] > limits[n] for n in NUMBERS):
            failed.append(label)
        for n in NUMBERS:
            worst[n] = max(worst[n], nums[n])
    return failed, [[n, worst[n], limits[n]] for n in NUMBERS]
