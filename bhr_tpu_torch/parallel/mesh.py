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

``initialize_multihost`` joins the processes of a multi-process video
fleet (``parallel/video.py``). The fleet's grid is every process's slots
in rank order; no tensor ever crosses between processes, so its process
group carries only host-side collectives (see the function).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> int:
    """Join the ``torch.distributed`` process group of a multi-process
    render; returns the process count.

    ``coordinator_address=None`` is a single-process run: nothing is
    initialised and 1 is returned. Otherwise every process calls this
    with the same ``"host:port"`` (process 0 listens there), the total
    ``num_processes`` and its own ``process_id``. Extra kwargs pass
    through to ``init_process_group`` — e.g. ``timeout`` (a
    ``datetime.timedelta``), which bounds every collective and so decides
    how fast the fleet notices a process that hangs.

    The backend is gloo, on CUDA machines too. The fleet shards whole
    frames, so rendering needs no traffic between processes; its only
    collectives are host-side (the device counts gathered once, one
    broadcast of a bool mask, a barrier per batch) and run on CPU
    tensors. NCCL would add nothing to them and refuses two ranks on one
    card, which is a layout the fleet supports (two processes sharing
    ``cuda:0``). A process's devices are the ones visible to it: on one
    machine, set ``CUDA_VISIBLE_DEVICES`` per process.
    """
    if coordinator_address is None:
        return 1
    if num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs num_processes and process_id "
            "beside the coordinator address")
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **kwargs)
    return dist.get_world_size()


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def shutdown_multihost() -> None:
    """Leave the process group of :func:`initialize_multihost`, if any."""
    if _joined():
        dist.destroy_process_group()


def process_count() -> int:
    """Processes of the fleet; 1 when no group was initialised."""
    return dist.get_world_size() if _joined() else 1


def process_index() -> int:
    """This process's rank in the fleet; 0 when no group was initialised."""
    return dist.get_rank() if _joined() else 0


def fleet_slot_counts(n_local: int) -> list:
    """The grid slots of every process, in rank order: ``[n_local]`` for a
    single process, else an all-gather (a collective: every process of
    the fleet must call it, in the same order among its collectives)."""
    if process_count() == 1:
        return [int(n_local)]
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(process_count())]
    dist.all_gather(counts, torch.tensor([int(n_local)], dtype=torch.int64))
    return [int(c) for c in counts]


def fleet_broadcast_mask(mask):
    """Process 0's bool NumPy ``mask`` on every process of the fleet (a
    collective; the array itself for a single process). Every process
    passes a mask of the same length; only process 0's values count."""
    if process_count() == 1:
        return np.asarray(mask, bool)
    t = torch.from_numpy(np.asarray(mask, bool).astype(np.uint8))
    dist.broadcast(t, src=0)
    return t.numpy().astype(bool)


def fleet_barrier() -> None:
    """Wait for every process of the fleet (nothing for a single one).
    Raises when a peer is gone or the group's timeout passes."""
    if process_count() > 1:
        dist.barrier()


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
