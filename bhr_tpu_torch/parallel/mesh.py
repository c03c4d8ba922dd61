"""The device grid of multi-frame and tile-sharded rendering.

The port of ``make_frame_mesh`` from ``bhr_tpu/parallel/mesh.py``. A JAX
``Mesh`` names an (F, T) array of devices with the axes ("frames",
"tile"); here a ``FrameMesh`` holds the same grid of ``torch.device``s,
and ``parallel.frames`` loops over it, since PyTorch runs eagerly and
needs no sharded program. Orbit frames are independent given their
camera and time, and the row bands of one frame are independent given
the full frame's camera, so the render path needs no collectives: only
the finished bands are copied to the grid's first device.

A grid may name one device more than once; its shards then run one
after another on it. That is how the CPU tests and a one-card machine
exercise a grid with T > 1: PyTorch cannot split one CPU (or one card)
into the several virtual devices that ``tests/conftest.py`` gives JAX.

``initialize_multihost`` is not ported yet: only the multi-host video
fleet uses it (ROADMAP.md Queue 1 item 17).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class FrameMesh(NamedTuple):
    """An (F, T) grid of devices: frames shard over rows of the grid,
    pixel rows of each frame over its columns."""

    devices: Tuple[Tuple[torch.device, ...], ...]  # devices[f][t]
    shape: dict  # {"frames": F, "tile": T}


def cuda_devices() -> list:
    """Every visible CUDA device; raises RuntimeError when there is none
    (the grid never drops to the CPU behind the caller's back)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "no CUDA device is visible; pass devices explicitly (e.g. "
            "[torch.device('cpu')] * n) to build a grid on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_frame_mesh(
    n_frames_axis: Optional[int] = None,
    n_tile_axis: int = 1,
    devices: Optional[Sequence] = None,
) -> FrameMesh:
    """An (n_frames_axis, n_tile_axis) grid over ``devices`` (default:
    every visible CUDA device), row-major as ``bhr_tpu``'s mesh.

    frames — data-parallel axis over orbit frames.
    tile   — spatial axis splitting the pixel rows of a frame.

    ``n_frames_axis`` defaults to len(devices) // n_tile_axis. ``devices``
    may repeat a device (see the module docstring).
    """
    devs = [torch.device(d) for d in
            (devices if devices is not None else cuda_devices())]
    total = len(devs)
    if n_tile_axis < 1:
        raise ValueError(f"n_tile_axis must be >= 1, got {n_tile_axis}")
    if n_frames_axis is None:
        n_frames_axis = total // n_tile_axis
    if n_frames_axis < 1 or n_frames_axis * n_tile_axis != total:
        raise ValueError(
            f"mesh {n_frames_axis}x{n_tile_axis} != {total} devices"
        )
    grid = tuple(tuple(devs[f * n_tile_axis:(f + 1) * n_tile_axis])
                 for f in range(n_frames_axis))
    return FrameMesh(grid, {"frames": n_frames_axis, "tile": n_tile_axis})
