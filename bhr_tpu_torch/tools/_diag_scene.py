"""The FHD diagnostic scene of the shade tools.

The port of ``tools/_diag_scene.py``: one source for the scene constants
(camera, texture size, seeds) of ``ablate_shade`` and
``bench_shade_variants``, so that the diagnostics and the bench measure
one configuration. ``bhr_tpu``'s ``fhd_shade_avals`` (abstract inputs
for XLA's cost analysis) has no counterpart: ``cost_shade`` counts from
real tensors.
"""

from __future__ import annotations

FHD = (1920, 1080)
TEX_N_R, TEX_N_PHI = 416, 2912
DISK_R_INNER, DISK_R_OUTER = 2.0, 15.0
TILT_DEG = 15.0
POV = (6.0, 0.0, 0.5)
FOV = 90.0


def build_fhd_shade_inputs(device="cuda", size=FHD, tex_size=(TEX_N_R, TEX_N_PHI)):
    """(W, H, cam (14,) tensor, skybox (Hs, Ws, 3), disk mips (L, n_r,
    n_phi, 4), trace) of the FHD scene on ``device``, every tensor float32.

    The disk is ``models/disk_texture.generate_disk_texture`` at
    ``tex_size`` (n_r, n_phi), seed 42, with its mip pyramid; the sky 2000
    stars, seed 42; the trace a completed ``trace_geodesics_cuda`` of the
    same scene (the ray-march kernel on a CUDA device) at the production
    escape radius, ``escape_radius(10, pov)`` = 12.04, not the disk's
    outer radius. ``size`` and ``tex_size`` shrink the scene for tests.
    """
    import torch

    from ..camera import build_camera
    from ..config import escape_radius, torch_device
    from ..models.disk_texture import generate_disk_texture
    from ..models.skybox import generate_skybox
    from ..ops.geodesic_cuda import camera_params, trace_geodesics_cuda
    from ..ops.sampling import build_mipmaps
    from ..pipeline import MIP_LEVELS

    dev = torch_device(device) if isinstance(device, str) else torch.device(device)
    width, height = size
    cam = torch.as_tensor(camera_params(build_camera(POV, FOV, width, height)),
                          device=dev)
    skybox = torch.as_tensor(generate_skybox(2048, 1024, seed=42, n_stars=2000),
                             device=dev)
    n_r, n_phi = tex_size
    tex = generate_disk_texture(n_phi=n_phi, n_r=n_r, seed=42, r_inner=DISK_R_INNER,
                                r_outer=DISK_R_OUTER, device=dev)
    mips = build_mipmaps(tex, levels=MIP_LEVELS)
    trace = trace_geodesics_cuda(
        cam, width=width, height=height, h_base=0.1,
        r_escape=escape_radius(10.0, POV), tilt_deg=TILT_DEG,
        r_inner=DISK_R_INNER, r_outer=DISK_R_OUTER)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return width, height, cam, skybox, mips, trace


def shade_kwargs() -> dict:
    """The scene arguments of ``pipeline.shade_frame`` for this scene
    (no AA: the production trace carries no differentials)."""
    return dict(r_inner=DISK_R_INNER, r_outer=DISK_R_OUTER, tilt_deg=TILT_DEG,
                t_offset=0.0, use_lod=False, aa_strength=1.0)
