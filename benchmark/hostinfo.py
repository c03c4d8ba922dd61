"""The earlier lines of a run, for reading a cell's spread: the cards,
their power limit and clocks, the host's dispatch speed, whether the
program's build and skybox caches were warm, the bytes a run wrote."""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import time

from .harness import ROOT


def say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def smi(n: int) -> str:
    """name, power limit, SM clock and its maximum of the first ``n``
    cards, from ``nvidia-smi`` ("unavailable" where it does not run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable ({exc})"
    return " | ".join(out.strip().splitlines()[:n])


def launch_us(device: str) -> float:
    """Host µs to enqueue one tiny op (an in-place add on one float),
    over 1000 after 100 warm ones (a copy of the port's bench probe)."""
    import torch

    x = torch.zeros(1, device=device)
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(1000):
        x.add_(1.0)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    return dt / 1000 * 1e6


def cache_state(scene: dict) -> str:
    """Whether the program's kernel build directory and the skybox cache
    of this scene (under the working directory) already held their files
    before set-up."""
    libs = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(ROOT, "bhr_tpu_torch", "_build", "lib*.so")))
    sky = os.path.join("output", ".skybox_cache",
                       f"skybox_v2_2048x1024_{scene['skybox_seed']}_"
                       f"{scene['n_stars']}.npy")
    return (f"build cache: {libs or 'empty'}; skybox cache: "
            f"{'hit' if os.path.isfile(sky) else 'miss'}")


def tree_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total
