"""Ray-march trace through the hand-written CUDA kernel (``csrc/ray_march.cu``).

The port of ``bhr_tpu/ops/geodesic_pallas.py``: ``trace_geodesics_cuda``
is the counterpart of ``trace_geodesics_pallas`` and ``camera_params``
packs the same 14 camera floats. The kernel runs one thread per pixel,
builds its primary ray (and, for AA, its two one-pixel ray
differentials) from the camera floats, integrates it until it is
captured, escapes or reaches the iteration cap, and writes the
TraceResult layout directly.

Each static variant is one instantiation of the kernel template, named
in ``KERNELS``; ``kernel_name`` picks the one a call needs. The row band
(``row_start``, ``row_count``: rows of a taller frame, as a tile shard
traces them) is a runtime argument of every instantiation.

Routing is by the device of ``cam_params``: a CUDA tensor launches the
kernel (or raises); a CPU tensor runs the plain version,
``geodesic.trace_geodesics`` on ``geodesic.primary_rays_from_params``.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..camera import Camera
from ..constants import MAX_DISK_CROSSINGS, RS
from .geodesic import (
    CAM_PARAMS,
    HIT_FEATURES,
    TraceResult,
    primary_differentials_from_params,
    primary_rays_from_params,
    trace_constants,
    trace_geodesics,
)

# Parameter layouts of the bhr_ray_march_* entry points (enum FParam /
# IParam in the .cu source; checked against the library's own counts at
# load).
_FPARAMS = ("h_base", "rs", "r_floor", "inv_rs", "inv_r_floor", "rs2",
            "r_escape2", "max_affine", "tan_t", "r_in2", "r_out2")
_IPARAMS = ("width", "height", "row0", "rows", "max_iter")

# The kernel's instantiations; the C entry point of each is "bhr_" + name.
KERNELS = ("ray_march_slim", "ray_march_aa", "ray_march_nodisk",
           "ray_march_slim_steps", "ray_march_aa_steps",
           "ray_march_nodisk_steps")

_lib = None


def _kernel_lib():
    """The loaded ray-march library with its C signatures declared. It is
    built (or loaded from the build cache) at the first call and kept for
    the process: a later switch of the build cache
    (``utils.cache.disable_compile_cache``) does not rebuild it."""
    global _lib
    if _lib is None:
        lib = _build.build("ray_march").lib
        lib.bhr_ray_march_layout.argtypes = [ctypes.c_int]
        lib.bhr_ray_march_layout.restype = ctypes.c_int
        expect = (len(_FPARAMS), len(_IPARAMS), MAX_DISK_CROSSINGS,
                  HIT_FEATURES, len(KERNELS))
        got = tuple(lib.bhr_ray_march_layout(i) for i in range(len(expect)))
        if got != expect:
            raise RuntimeError(
                f"ray_march.cu layout {got} != wrapper layout {expect}")
        for name in KERNELS:
            fn = getattr(lib, f"bhr_{name}")
            fn.argtypes = [ctypes.c_void_p] * 10
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_name(*, with_differentials: bool, record_hits: bool,
                record_step_counts: bool) -> str:
    """The instantiation that traces a variant. Differentials are read
    only at a recorded crossing, so AA without hit recording is the
    no-disk kernel: its outputs are the same."""
    if not record_hits:
        base = "ray_march_nodisk"
    elif with_differentials:
        base = "ray_march_aa"
    else:
        base = "ray_march_slim"
    return base + ("_steps" if record_step_counts else "")


def camera_params(camera: Camera) -> np.ndarray:
    """Pack a Camera into the (14,) kernel parameter vector."""
    return np.concatenate(
        [
            camera.pos,
            camera.right,
            camera.up,
            camera.forward,
            np.asarray([camera.pixel_width, camera.pixel_height], np.float32),
        ]
    ).astype(np.float32)


def trace_geodesics_cuda(
    cam_params: torch.Tensor,
    row_start: int = 0,
    *,
    width: int,
    height: int,
    h_base: float,
    r_escape: float,
    rs: float = RS,
    tilt_deg: float = 0.0,
    r_inner: float = 2.0,
    r_outer: float = 15.0,
    with_differentials: bool = False,
    max_crossings: int = MAX_DISK_CROSSINGS,
    record_hits: bool = True,
    record_step_counts: bool = False,
    row_count: Optional[int] = None,
) -> TraceResult:
    """Trace rows [row_start, row_start + row_count) of the ``width`` x
    ``height`` frame of the camera ``cam_params`` ((14,) float32, see
    ``camera_params``) -> TraceResult with flat row-major (row_count*W)
    ray order. ``row_count`` defaults to ``height`` (the whole frame);
    the image plane is always the whole frame's, so a band's rays are
    those rows of the whole frame's.

    ``with_differentials`` writes the AA hit features 5..11,
    ``record_hits=False`` skips the crossing test (hits stay zero) and
    ``record_step_counts`` fills ``TraceResult.steps``.
    """
    if row_count is None:
        row_count = height
    row_start, row_count = operator.index(row_start), operator.index(row_count)
    if row_start < 0 or row_count < 1 or row_start + row_count > height:
        raise ValueError(
            f"row band [{row_start}, {row_start + row_count}) is not a "
            f"non-empty band of the {height} frame rows")
    if max_crossings != MAX_DISK_CROSSINGS:
        raise ValueError(
            f"the kernel holds {MAX_DISK_CROSSINGS} hit slots, got "
            f"max_crossings={max_crossings}")
    if (cam_params.shape != (CAM_PARAMS,) or cam_params.dtype != torch.float32
            or not cam_params.is_contiguous()):
        raise ValueError(
            f"cam_params must be a contiguous ({CAM_PARAMS},) float32 "
            f"tensor, got {tuple(cam_params.shape)} {cam_params.dtype}")
    trace_kw = dict(h_base=h_base, r_escape=r_escape, rs=rs,
                    tilt_deg=tilt_deg, r_inner=r_inner, r_outer=r_outer)
    variant = dict(with_differentials=with_differentials,
                   record_hits=record_hits,
                   record_step_counts=record_step_counts)
    band = (width, height, row_start, row_count)
    dev = cam_params.device
    if dev.type == "cpu":
        dirs = primary_rays_from_params(cam_params, *band)
        ddx = ddy = None
        if with_differentials:
            ddx, ddy = primary_differentials_from_params(
                cam_params, width, height, row_start, row_count)
        return trace_geodesics(cam_params[0:3], dirs, d_dir_dx0=ddx,
                               d_dir_dy0=ddy, **trace_kw, **variant)
    if dev.type != "cuda":
        raise ValueError(f"no ray-march route for device {dev}")
    return _launch(kernel_name(**variant), cam_params, band, trace_kw,
                   record_step_counts)


def _launch(name: str, cam: torch.Tensor, band: tuple, trace_kw: dict,
            record_step_counts: bool) -> TraceResult:
    """Allocate the outputs of the band ``(width, height, row_start,
    row_count)`` and launch kernel ``name`` on the current stream."""
    lib = _kernel_lib()
    k = trace_constants(**trace_kw)
    fparams = (ctypes.c_float * len(_FPARAMS))(
        *(getattr(k, p) for p in _FPARAMS))
    width, height, row_start, row_count = band
    iparams = (ctypes.c_int * len(_IPARAMS))(width, height, row_start,
                                             row_count, k.max_iter)

    dev = cam.device
    n = width * row_count
    captured = torch.empty(n, dtype=torch.bool, device=dev)
    escaped = torch.empty(n, dtype=torch.bool, device=dev)
    escape_dir = torch.empty((n, 3), dtype=torch.float32, device=dev)
    hit_count = torch.empty(n, dtype=torch.int32, device=dev)
    hits = torch.empty((MAX_DISK_CROSSINGS, HIT_FEATURES, n),
                       dtype=torch.float32, device=dev)
    steps = (torch.empty(n, dtype=torch.int32, device=dev)
             if record_step_counts else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"bhr_{name}")(
            ctypes.cast(fparams, ctypes.c_void_p),
            ctypes.cast(iparams, ctypes.c_void_p),
            cam.data_ptr(), captured.data_ptr(), escaped.data_ptr(),
            escape_dir.data_ptr(), hit_count.data_ptr(), hits.data_ptr(),
            None if steps is None else steps.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    trace_geodesics_cuda.launches[name] += 1
    return TraceResult(captured, escaped, escape_dir, hit_count, hits, steps)


# Kernel launches made through this wrapper, by instantiation (never the
# plain version's runs), so a caller can show a run went through the
# kernel it expects.
trace_geodesics_cuda.launches = dict.fromkeys(KERNELS, 0)
