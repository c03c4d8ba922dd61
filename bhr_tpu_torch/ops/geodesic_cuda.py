"""Ray-march trace through the hand-written CUDA kernel (``csrc/ray_march.cu``).

The port of ``bhr_tpu/ops/geodesic_pallas.py``: ``trace_geodesics_cuda``
is the counterpart of ``trace_geodesics_pallas`` and ``camera_params``
packs the same 14 camera floats. The kernel runs one thread per pixel,
builds its primary ray from the camera floats, integrates it until it is
captured, escapes or reaches the iteration cap, and writes the
TraceResult layout directly.

Routing is by the device of ``cam_params``: a CUDA tensor launches the
kernel (or raises); a CPU tensor runs the plain version,
``geodesic.trace_geodesics`` on ``geodesic.primary_rays_from_params``.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..camera import Camera
from ..constants import MAX_DISK_CROSSINGS, RS
from .geodesic import (
    CAM_PARAMS,
    HIT_FEATURES,
    TraceResult,
    primary_rays_from_params,
    refuse_unported_variant,
    trace_constants,
    trace_geodesics,
)

# Parameter layouts of bhr_ray_march_slim (enum FParam / IParam in the
# .cu source; checked against the library's own counts at load).
_FPARAMS = ("h_base", "rs", "r_floor", "rs2", "r_escape2", "max_affine",
            "tan_t", "r_in2", "r_out2")
_IPARAMS = ("width", "height", "row0", "max_iter")

_lib = None


def _kernel_lib():
    """The loaded ray-march library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.build("ray_march").lib
        lib.bhr_ray_march_layout.argtypes = [ctypes.c_int]
        lib.bhr_ray_march_layout.restype = ctypes.c_int
        expect = (len(_FPARAMS), len(_IPARAMS), MAX_DISK_CROSSINGS,
                  HIT_FEATURES)
        got = tuple(lib.bhr_ray_march_layout(i) for i in range(4))
        if got != expect:
            raise RuntimeError(
                f"ray_march.cu layout {got} != wrapper layout {expect}")
        lib.bhr_ray_march_slim.argtypes = [ctypes.c_void_p] * 9
        lib.bhr_ray_march_slim.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    row_count=None,
) -> TraceResult:
    """Trace the ``width`` x ``height`` frame of the camera ``cam_params``
    ((14,) float32, see ``camera_params``) -> TraceResult with flat
    row-major (H*W) ray order.

    Only the slim hit-recording variant is ported; any other variant
    raises NotImplementedError on every device.
    """
    refuse_unported_variant(with_differentials=with_differentials,
                            record_step_counts=record_step_counts,
                            row_count=row_count, record_hits=record_hits)
    if max_crossings != MAX_DISK_CROSSINGS:
        raise ValueError(
            f"the kernel holds {MAX_DISK_CROSSINGS} hit slots, got "
            f"max_crossings={max_crossings}")
    if row_start != 0:
        raise NotImplementedError(
            "row_start != 0 traces a row band: ray-march variant not "
            "ported to bhr_tpu_torch yet (ROADMAP.md Queue 2 item 4)")
    if (cam_params.shape != (CAM_PARAMS,) or cam_params.dtype != torch.float32
            or not cam_params.is_contiguous()):
        raise ValueError(
            f"cam_params must be a contiguous ({CAM_PARAMS},) float32 "
            f"tensor, got {tuple(cam_params.shape)} {cam_params.dtype}")
    trace_kw = dict(h_base=h_base, r_escape=r_escape, rs=rs,
                    tilt_deg=tilt_deg, r_inner=r_inner, r_outer=r_outer)
    dev = cam_params.device
    if dev.type == "cpu":
        dirs = primary_rays_from_params(cam_params, width, height)
        return trace_geodesics(cam_params[0:3], dirs, **trace_kw)
    if dev.type != "cuda":
        raise ValueError(f"no ray-march route for device {dev}")
    return _launch(cam_params, width, height, trace_kw)


def _launch(cam: torch.Tensor, width: int, height: int,
            trace_kw: dict) -> TraceResult:
    """Allocate the outputs and launch the kernel on the current stream."""
    lib = _kernel_lib()
    k = trace_constants(**trace_kw)
    fparams = (ctypes.c_float * len(_FPARAMS))(
        *(getattr(k, name) for name in _FPARAMS))
    iparams = (ctypes.c_int * len(_IPARAMS))(width, height, 0, k.max_iter)

    dev = cam.device
    n = width * height
    captured = torch.empty(n, dtype=torch.bool, device=dev)
    escaped = torch.empty(n, dtype=torch.bool, device=dev)
    escape_dir = torch.empty((n, 3), dtype=torch.float32, device=dev)
    hit_count = torch.empty(n, dtype=torch.int32, device=dev)
    hits = torch.empty((MAX_DISK_CROSSINGS, HIT_FEATURES, n),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bhr_ray_march_slim(
            ctypes.cast(fparams, ctypes.c_void_p),
            ctypes.cast(iparams, ctypes.c_void_p),
            cam.data_ptr(), captured.data_ptr(), escaped.data_ptr(),
            escape_dir.data_ptr(), hit_count.data_ptr(), hits.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"ray_march_slim launch failed: cudaError {err}")
    trace_geodesics_cuda.launches += 1
    return TraceResult(captured, escaped, escape_dir, hit_count, hits)


# Kernel launches made through this wrapper (never the plain version's
# runs), so a caller can show a run went through the kernel.
trace_geodesics_cuda.launches = 0
