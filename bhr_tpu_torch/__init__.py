"""bhr_tpu_torch — the PyTorch/CUDA port of the bhr_tpu black-hole renderer.

Renders still frames and resumable orbit videos (Schwarzschild
null-geodesic ray tracing, the procedural lifecycle accretion disk and
star field, relativistic shading, bloom, lens flare) on an NVIDIA GPU:
the trace runs in a hand-written CUDA kernel (``csrc/ray_march.cu``),
everything else in PyTorch. The JAX package ``bhr_tpu`` stays the reference; this package
imports no JAX.
"""

from .camera import Camera, build_camera, orbit_camera_position
from .config import RESOLUTIONS, SceneConfig, compute_disk_texture_resolution
from .pipeline import Renderer, shade_frame

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "build_camera",
    "orbit_camera_position",
    "SceneConfig",
    "RESOLUTIONS",
    "compute_disk_texture_resolution",
    "Renderer",
    "shade_frame",
]
