"""Scene configuration: one dataclass mirroring the reference CLI.

The port of ``bhr_tpu/config.py``. The fields it shares and their
validation rules are the same, so a scene means the same thing in both
packages. It leaves out the deprecated settings that only ``bhr_tpu``'s
config reads (the CLI parses and ignores their flags), and ``device``
names a torch device, ``"cuda"`` (the default) or ``"cpu"``:
:func:`torch_device` refuses ``"cuda"`` on a host without a GPU instead
of dropping to the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

from .constants import (
    DISK_GENERATION_SCALE_CHOICES,
    R_DISK_INNER_DEFAULT,
    R_DISK_OUTER_DEFAULT,
    RS,
)

RESOLUTIONS = {
    "4k": (3840, 2160),
    "fhd": (1920, 1080),
    "hd": (1280, 720),
    "sd": (640, 360),
}

DEVICES = ("cuda", "cpu")


@dataclass(frozen=True)
class SceneConfig:
    """Complete scene + run configuration (the reference's CLI surface)."""

    # Camera
    pov: Tuple[float, float, float] = (6.0, 0.0, 0.5)
    fov: float = 90.0
    resolution: str = "fhd"
    width: Optional[int] = None  # explicit override of resolution preset
    height: Optional[int] = None

    # Integration
    step_size: float = 0.1
    r_max: float = 10.0

    # Skybox
    texture: Optional[str] = None
    n_stars: int = 6000
    skybox_seed: int = 42

    # Disk
    disk_model: str = "texture"  # "texture" (V1) | "v2" (volume model)
    disk_texture: Optional[str] = None
    disk_inner_radius: float = R_DISK_INNER_DEFAULT
    disk_outer_radius: float = R_DISK_OUTER_DEFAULT
    disk_tilt: float = 0.0
    disk_rotation_speed: float = 0.1
    seed: int = 42
    # --disk_texture auto: low-res generation factor of the static
    # texture, and regenerate over its cached file.
    disk_generation_scale: int = 2
    force_regenerate_disk_texture: bool = False

    # Disk V2 (volume model) surface: mirrors DiskV2Params /
    # DiskV2StructureParams (reference disk_v2/params.py:12-144) plus
    # the renderer knobs (palette, quadrature samples). r_in/r_out come
    # from disk_inner_radius/disk_outer_radius.
    v2_palette: str = "cinematic"  # "scientific" | "cinematic"
    v2_samples: int = 8  # slab quadrature samples per crossing
    v2_h0: float = 0.05
    v2_beta_h: float = 0.05
    v2_rho_power: float = 1.0
    v2_temp_scale: float = 1.0
    v2_omega_scale: float = 1.0
    v2_edge_softness: float = 0.1
    # Structure modulation layer; strengths validated by
    # DiskV2StructureParams.__post_init__. As in bhr_tpu, with
    # v2_structure off the integrator still modulates, with
    # DiskV2StructureParams' default strengths (the fields below hold the
    # same defaults, so the switch matters once one of them is changed).
    v2_structure: bool = False
    v2_mode1_strength: float = 0.03
    v2_mode2_strength: float = 0.05
    v2_shear_strength: float = 0.22
    v2_shear_components: int = 8
    v2_hotspot_strength: float = 0.16
    v2_hotspot_count: int = 8
    v2_hotspot_phi_sigma: float = 0.18
    v2_hotspot_logr_sigma: float = 0.12
    v2_hotspot_inner_bias: float = 2.0

    # Post-FX / AA
    lens_flare: bool = False
    anti_alias: str = "disabled"  # "disabled" | "lod_radius"
    aa_strength: float = 1.0

    # Modes. The orbit settings place the cameras of
    # parallel.frames.cameras_for_orbit.
    video: bool = False
    interactive: bool = False
    orbit: bool = False
    orbit_degrees: float = 360.0
    n_frames: int = 3600
    fps: int = 36
    # H.264 quality of assembled videos (x264 CRF: 0 lossless .. 51
    # worst; 18 ~ visually lossless), used by the native writer.
    video_crf: int = 18
    resume: bool = False
    output: str = "output/blackhole.png"

    # Device / parallelism
    device: str = "cuda"  # "cuda" | "cpu"
    frame_shards: int = 0  # video: 0 = all visible devices, 1 = sequential
    # Single-frame spatial sharding: split the pixel rows of ONE frame
    # over this many devices ("tile" mesh axis; 0/1 = off).
    tile_shards: int = 0
    # Video frames rendered per device per batch (0 = adaptive: small
    # frames are batched until a batch carries ~4 FHD frames of pixels,
    # capped at 16). progress.json is written once per batch, so smaller
    # batches lose less to an interruption. Like the engine choice, this
    # does not invalidate a resume: a frame's content does not depend on
    # its batch.
    frames_per_dispatch: int = 0

    @property
    def image_size(self) -> Tuple[int, int]:
        """(width, height) in pixels."""
        if self.width is not None and self.height is not None:
            return (self.width, self.height)
        return RESOLUTIONS[self.resolution]

    def validated(self) -> "SceneConfig":
        """Validate and normalize; raises ValueError on bad input."""
        if not (0.0 < self.fov < 180.0):
            raise ValueError(f"FOV must be in (0, 180), got {self.fov}")
        pov_dist = _cam_distance(self.pov)
        if not math.isfinite(pov_dist) or pov_dist <= RS:
            raise ValueError(
                f"camera |pov| must be finite and outside the event "
                f"horizon r={RS}, got |{tuple(self.pov)}| = {pov_dist:.3g}"
            )
        if (self.width is None) != (self.height is None):
            raise ValueError(
                "width and height must be overridden together "
                f"(got width={self.width}, height={self.height}); a lone "
                "override would silently fall back to the resolution preset"
            )
        if self.width is not None and (self.width <= 0 or self.height <= 0):
            raise ValueError(
                f"image size must be positive, got {self.width}x{self.height}"
            )
        if self.disk_inner_radius >= self.disk_outer_radius:
            raise ValueError(
                f"disk_inner_radius ({self.disk_inner_radius}) must be less "
                f"than disk_outer_radius ({self.disk_outer_radius})"
            )
        if self.step_size <= 0:
            raise ValueError(f"step_size must be positive, got {self.step_size}")
        if self.disk_generation_scale not in DISK_GENERATION_SCALE_CHOICES:
            raise ValueError(
                f"disk_generation_scale must be one of "
                f"{DISK_GENERATION_SCALE_CHOICES}, got {self.disk_generation_scale}"
            )
        if not (0.5 <= self.aa_strength <= 2.0):
            raise ValueError(f"aa_strength must be in [0.5, 2.0], got {self.aa_strength}")
        if self.n_frames <= 0:
            raise ValueError(f"n_frames must be positive, got {self.n_frames}")
        if self.fps <= 0:
            raise ValueError(f"fps must be positive, got {self.fps}")
        if not (0 <= self.video_crf <= 51):
            raise ValueError(
                f"video_crf must be in [0, 51], got {self.video_crf}")
        if not math.isfinite(self.orbit_degrees):
            raise ValueError(f"orbit_degrees must be finite, got {self.orbit_degrees}")
        if self.anti_alias not in ("disabled", "lod_radius"):
            raise ValueError(f"unknown anti_alias mode: {self.anti_alias}")
        if self.disk_model not in ("texture", "v2"):
            raise ValueError(f"unknown disk_model: {self.disk_model}")
        if self.v2_palette not in ("scientific", "cinematic"):
            raise ValueError(
                f"v2_palette must be 'scientific' or 'cinematic', "
                f"got {self.v2_palette!r}"
            )
        if self.v2_samples <= 0:
            raise ValueError(
                f"v2_samples must be positive, got {self.v2_samples}"
            )
        if self.disk_model == "v2":
            # Construct the param objects so their validators run at
            # config time (fail fast on e.g. mode strengths summing
            # past 1) instead of deep inside a frame.
            self.v2_params()
            self.v2_structure_params()
        if self.disk_texture and (self.video or self.interactive):
            raise ValueError(
                "disk_texture only supports static single-frame rendering; "
                "video/interactive modes use the lifecycle system"
            )
        if self.disk_texture and self.disk_model == "v2":
            raise ValueError(
                "disk_texture is a V1 (texture-model) input; the v2 disk "
                "model shades by volume integration and takes no texture"
            )
        if self.tile_shards < 0:
            raise ValueError(
                f"tile_shards must be >= 0, got {self.tile_shards}")
        if self.frame_shards < 0:
            raise ValueError(
                f"frame_shards must be >= 0, got {self.frame_shards}")
        if self.frame_shards > 1 and not self.video:
            # An explicit shard request is never silently ignored: frame
            # sharding belongs to the video engine; a still shards rows.
            raise ValueError(
                "frame_shards applies to --video only; for single-frame "
                "spatial sharding use --tile_shards"
            )
        if self.frames_per_dispatch < 0:
            raise ValueError(
                f"frames_per_dispatch must be >= 0 (0 = adaptive), "
                f"got {self.frames_per_dispatch}")
        if self.resolution not in RESOLUTIONS:
            raise ValueError(f"unknown resolution preset: {self.resolution}")
        if self.tile_shards > 1:
            if self.video or self.interactive:
                raise ValueError(
                    "tile_shards applies to single-frame rendering only; "
                    "video shards whole frames (--frame_shards)"
                )
            height = self.image_size[1]
            if height % self.tile_shards != 0:
                raise ValueError(
                    f"image height {height} is not divisible by "
                    f"tile_shards {self.tile_shards}"
                )
        if self.device not in DEVICES:
            raise ValueError(
                f"device must be one of {DEVICES}, got {self.device!r}")
        return self

    def v2_params(self):
        """Build the DiskV2Params for this scene (disk_model='v2')."""
        from .models.disk_v2.params import DiskV2Params

        return DiskV2Params(
            r_in=float(self.disk_inner_radius),
            r_out=float(self.disk_outer_radius),
            h0=float(self.v2_h0),
            beta_h=float(self.v2_beta_h),
            rho_power=float(self.v2_rho_power),
            temp_scale=float(self.v2_temp_scale),
            omega_scale=float(self.v2_omega_scale),
            edge_softness=float(self.v2_edge_softness),
        )

    def v2_structure_params(self):
        """DiskV2StructureParams when v2_structure is on, else None."""
        if not self.v2_structure:
            return None
        from .models.disk_v2.params import DiskV2StructureParams

        return DiskV2StructureParams(
            mode1_strength=float(self.v2_mode1_strength),
            mode2_strength=float(self.v2_mode2_strength),
            shear_strength=float(self.v2_shear_strength),
            shear_components=int(self.v2_shear_components),
            hotspot_strength=float(self.v2_hotspot_strength),
            hotspot_count=int(self.v2_hotspot_count),
            hotspot_phi_sigma=float(self.v2_hotspot_phi_sigma),
            hotspot_logr_sigma=float(self.v2_hotspot_logr_sigma),
            hotspot_inner_bias=float(self.v2_hotspot_inner_bias),
        )

    @property
    def use_ray_differentials(self) -> bool:
        """Whether frames trace the two ray differentials (AA).

        They feed the texture-model mip-LOD sampler only; the v2 volume
        integrator has no LOD path (``bhr_tpu/config.py:279-287``)."""
        return self.anti_alias != "disabled" and self.disk_model != "v2"


def torch_device(name: str):
    """The torch device for a ``SceneConfig.device`` name.

    ``"cuda"`` on a host without a usable GPU raises: the port never
    drops to the CPU behind the caller's back.
    """
    import torch

    if name not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to render on the CPU"
        )
    return torch.device(name)


def _cam_distance(cam_pos) -> float:
    """Euclidean camera distance |cam_pos| (host float)."""
    return math.sqrt(sum(float(c) ** 2 for c in cam_pos))


def escape_radius(r_max: float, cam_pos) -> float:
    """Trace escape radius: ``max(r_max, 2 x camera distance)`` — the
    reference's formula (render.py:3829, 3884).

    With the default r_max=10 and disk_outer_radius=15, disk-plane
    crossings beyond the escape radius are shaded as sky, as in the
    reference; raising r_max is the supported way to render the far
    annulus.
    """
    return max(float(r_max), 2.0 * _cam_distance(cam_pos))


def scene_escape_radius(config: "SceneConfig") -> float:
    """Escape radius for a whole scene or video, identical across engines.

    Orbit videos place every frame's camera at distance
    ``sqrt(|pov|**2 + pov_z**2)`` (the orbit keeps radius ``|pov|`` in
    the xy-plane AND preserves z, camera.orbit_camera_position), so the
    per-frame escape radius is one constant.
    """
    if config.orbit:
        d = math.sqrt(
            _cam_distance(config.pov) ** 2 + float(config.pov[2]) ** 2
        )
        return max(float(config.r_max), 2.0 * d)
    return escape_radius(config.r_max, config.pov)


def compute_disk_texture_resolution(
    width: int,
    height: int,
    cam_pos: Tuple[float, float, float],
    fov: float,
    r_inner: float,
    r_outer: float,
) -> Tuple[int, int]:
    """Camera-dependent polar texture size (n_phi, n_r).

    ~1 phi sample per screen pixel of disk coverage, 0.5 radial samples;
    floors of 256/128, rounded up to multiples of 16.
    Parity: reference render.py:1128-1149.
    """
    cam_dist = math.sqrt(sum(c * c for c in cam_pos))
    ang_radius = math.atan(r_outer / cam_dist)
    ang_extent = 2.0 * ang_radius
    screen_fraction = fov * math.pi / 180.0

    n_phi = int(width * (ang_extent / screen_fraction))
    n_r = int(height * (ang_radius / screen_fraction) * 0.5)
    n_phi = max(256, n_phi)
    n_r = max(128, n_r)
    n_phi += (16 - n_phi % 16) % 16
    n_r += (16 - n_r % 16) % 16
    return n_phi, n_r
