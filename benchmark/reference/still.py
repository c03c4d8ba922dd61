"""The plain reference of the benchmark's stills: the frame that the CLI's
default mode (``modes.render_image``) renders, worked out again from the
scene's settings, the still's camera and its disk seed alone.

A lifecycle still is the lifecycle at t = 0 (the entities seeded, one
tick of ``now = 0, dt = 0``, this frame's own stats), the plain ray march
from the still's camera with its own escape radius, the shade, bloom and
the uint8 quantise. A static still (``disk_texture: "auto"``) generates
the static procedural texture of its seed (``frozen/models/
static_disk.py``) and renders it the same way. Both take the texture's
size from the still's camera, as the program does. ``reference_scene``
chooses how a still is rendered: with ``anti_alias`` the AA reference
(``frame_aa.Scene``: mips, the ray march with its differentials, the LOD
shade), else the plain one (``frame.Scene``); the lens flare where the
configuration states it. A still in row bands (``tile_shards``) is the
same frame, so it has the same reference.

Like ``frame.py`` it runs the frozen copy of the port's plain modules and
nothing of the port; ``lowp=True`` is the control, which also rounds the
generated texture to bfloat16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import frame, frame_aa
from .frame import _packs, camera_params
from .frozen.config import compute_disk_texture_resolution, escape_radius
from .frozen.models.dynamic_disk import (
    DynamicDiskSystem,
    adaptive_generation_scale,
)
from .frozen.models.lifecycle import radial_omega_rows
from .frozen.models.static_disk import generate_disk_texture
from .frozen.utils.io import compute_edge_alpha

Camera = Tuple[float, float, float]


def reference_scene(scene: Dict, device, lowp: bool = False) -> frame.Scene:
    """The reference scene of a still of ``scene`` on ``device``: the AA
    reference where ``anti_alias`` is not ``"disabled"``, else the plain
    one. A scene the still reference cannot render (the V2 volume disk,
    a disk texture from a file) raises ``ValueError``."""
    if scene["disk_model"] != "texture":
        raise ValueError(f"the still reference renders a texture-model "
                         f"disk, not disk_model {scene['disk_model']!r}")
    if scene.get("disk_texture") not in (None, "auto"):
        raise ValueError("the still reference renders the lifecycle or the "
                         "static texture, not a disk texture from a file")
    if scene["anti_alias"] != "disabled":
        return frame_aa.Scene(scene, device, lowp)
    return frame.Scene(scene, device, lowp)


def _fit_texture(scene: frame.Scene, pos: Camera) -> None:
    """Give ``scene`` the lifecycle texture's size and per-row tables of
    a camera at ``pos`` (the size follows the camera's distance)."""
    n_phi, n_r = compute_disk_texture_resolution(
        scene.width, scene.height, tuple(pos), float(scene.s["fov"]),
        scene.r_inner, scene.r_outer)
    if (n_phi, n_r) == (scene.n_phi, scene.n_r):
        return
    scene.n_phi, scene.n_r = n_phi, n_r
    scene.generation_scale = adaptive_generation_scale(n_r, n_phi)
    _, omega = radial_omega_rows(n_r, scene.r_inner, scene.r_outer)
    scene.omega_rows = torch.tensor(omega, dtype=torch.float32,
                                    device=scene.device)
    scene.edge = torch.tensor(compute_edge_alpha(n_r), dtype=torch.float32,
                              device=scene.device)


def _still_frame(scene: frame.Scene, tex: torch.Tensor,
                 pos: Camera) -> torch.Tensor:
    """One (H, W, 3) uint8 still of the disk texture ``tex`` from
    ``pos``: its camera, its own escape radius, the flare as the
    configuration states it."""
    cam = camera_params(pos, float(scene.s["fov"]), scene.width, scene.height)
    return scene.render(tex, cam, escape_radius(float(scene.s["r_max"]), pos),
                        flare=bool(scene.s["lens_flare"]))


def still_frames(scene: frame.Scene, stills: Dict[int, Tuple[Camera, int]]
                 ) -> Dict[int, torch.Tensor]:
    """{still: (H, W, 3) uint8 frame} of lifecycle stills, each given as
    (camera position, disk seed): a fresh lifecycle of that seed at t = 0,
    rendered from that camera."""
    out = {}
    for k in sorted(stills):
        pos, seed = stills[k]
        _fit_texture(scene, pos)
        dyn = DynamicDiskSystem(scene.n_r, scene.n_phi, scene.r_inner,
                                scene.r_outer, seed=int(seed),
                                device=scene.device)
        scene.az = (dyn.az_freq, dyn.az_shear)
        for fac in dyn.factories.values():
            fac.tick(now=0.0, dt=0.0)
        out[k] = _still_frame(scene, scene.texture(_packs(dyn, 0.0), 0.0), pos)
    return out


def static_still_frames(scene: frame.Scene, stills: Dict[int, Tuple[Camera, int]]
                        ) -> Dict[int, torch.Tensor]:
    """{still: (H, W, 3) uint8 frame} of static-disk stills, each given
    as (camera position, disk seed): the static texture of that seed at
    the camera's texture size and the scene's generation scale, rendered
    from that camera. Matrix products run in float32, not TF32."""
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for k in sorted(stills):
            pos, seed = stills[k]
            n_phi, n_r = compute_disk_texture_resolution(
                scene.width, scene.height, tuple(pos), float(scene.s["fov"]),
                scene.r_inner, scene.r_outer)
            tex = generate_disk_texture(
                n_phi=n_phi, n_r=n_r, seed=int(seed), r_inner=scene.r_inner,
                r_outer=scene.r_outer,
                generation_scale=int(scene.s["disk_generation_scale"]),
                device=scene.device)
            out[k] = _still_frame(scene, tex, pos)
            del tex
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def frames_of(scene: frame.Scene, stills: Dict[int, Tuple[Camera, int]]
              ) -> Dict[int, torch.Tensor]:
    """The reference frames of ``stills`` ({still: (camera, disk seed)}):
    static stills where the scene asks for the static texture
    (``disk_texture: "auto"``), else lifecycle stills."""
    if scene.s.get("disk_texture") == "auto":
        return static_still_frames(scene, stills)
    return still_frames(scene, stills)

