"""Reading the device's trace: torch.profiler over one call, reduced to
the launches the host made, each card's busy time, the kernels by name
and the device's idle gaps by what the host was doing.

The profiler's Chrome trace is written to a file under ``TMPDIR``, read
back and deleted: its events carry the category (``kernel``,
``gpu_memcpy``, ``gpu_memset``, ``cuda_runtime``, ``cpu_op``), the card
and the times in microseconds.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
TOP = 10
# Host events searched back from a gap for the one that spans it.
SCAN = 64


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _device_of(ev) -> int:
    args = ev.get("args") or {}
    dev = args.get("device", ev.get("pid", 0))
    try:
        return int(dev)
    except (TypeError, ValueError):
        return 0


def short_name(name: str) -> str:
    """A kernel's name without the namespaces and return type that every
    PyTorch kernel carries, cut to 160 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    return name[:160]


def reduce_events(events: List[dict], wall_s: float) -> Dict:
    """The profile's numbers from Chrome-trace events (times in µs)."""
    on_card = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS and "dur" in e]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and "dur" in e]
    launches = sum(1 for e in host if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("name") in LAUNCH_CALLS)
    per_dev: Dict[int, list] = collections.defaultdict(list)
    kernels: Dict[str, list] = {}
    for e in on_card:
        a = float(e["ts"])
        per_dev[_device_of(e)].append((a, a + float(e["dur"])))
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += float(e["dur"]) * 1e-6
    busy = {d: sum(b - a for a, b in _merge(iv)) * 1e-6 for d, iv in per_dev.items()}
    # Idle gaps between a card's merged busy intervals, each labelled by
    # the innermost host event (the latest to start) that spans its
    # midpoint, and summed by label.
    host_iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in host)
    starts = [h[0] for h in host_iv]
    gaps: Dict[str, float] = collections.defaultdict(float)
    for iv in per_dev.values():
        merged = _merge(iv)
        for (_, b), (a2, _) in zip(merged, merged[1:]):
            mid, label = 0.5 * (b + a2), "(host between events)"
            j = bisect.bisect_right(starts, mid)
            for h in reversed(host_iv[max(0, j - SCAN):j]):
                if h[1] >= mid:
                    label = h[2]
                    break
            gaps[label] += (a2 - b) * 1e-6
    top_ops = sorted(((short_name(n), v[1]) for n, v in kernels.items()),
                     key=lambda x: -x[1])
    top_gaps = sorted(gaps.items(), key=lambda x: -x[1])
    return {
        "wall_s": wall_s,
        "launches": launches,
        "device_ops": sum(v[0] for v in kernels.values()),
        "busy_s": busy,
        "kernels": {n: v for n, v in kernels.items()},
        "top_ops": [[n, s] for n, s in top_ops[:TOP]],
        "idle_gaps": [[n, s] for n, s in top_gaps[:TOP]],
    }


def profile(fn, tmpdir: str) -> Tuple[object, Dict]:
    """(fn's result, the reduced profile of one call of ``fn``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    _sync_all()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        _sync_all()
        wall_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return out, reduce_events(events, wall_s)


def idle_share(prof: Dict, n_devices: int) -> float:
    """Share (%) of the traced wall time in which a card ran nothing,
    the mean over the ``n_devices`` cards the cell uses."""
    busy = [prof["busy_s"].get(d, 0.0) for d in range(n_devices)]
    return 100.0 * (1.0 - sum(busy) / n_devices / prof["wall_s"])
