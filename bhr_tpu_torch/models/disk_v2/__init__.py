"""Disk V2: physically-structured accretion disk model (PyTorch).

The port of ``bhr_tpu/models/disk_v2``: finite-thickness
emission-absorption path integration, unified advection, structure
modulations and palette mapping.

All field functions are plain broadcasting functions of float32 tensors
that run on the device of their inputs; scalars in -> 0-d tensors out.
"""

from .params import DiskV2Params, DiskV2StructureParams
from .geometry import (
    disk_half_thickness,
    disk_radial_mask,
    disk_radial_weight,
    disk_vertical_weight,
    disk_volume_mask,
    smoothstep,
)
from .physical_fields import (
    angular_velocity_field,
    density_field,
    density_temperature_fields,
    midplane_density_field,
    midplane_temperature_field,
    temperature_field,
)
from .structure_modulations import (
    hotspot_modulation,
    shear_modulation,
    structure_modulation,
    weak_mode_modulation,
)
from .integrator import emissivity_volume, integrate_emission
from .palette import apply_palette
from .preview import render_cross_section, render_top_view

__all__ = [
    "DiskV2Params",
    "DiskV2StructureParams",
    "smoothstep",
    "disk_half_thickness",
    "disk_radial_mask",
    "disk_radial_weight",
    "disk_vertical_weight",
    "disk_volume_mask",
    "angular_velocity_field",
    "midplane_density_field",
    "midplane_temperature_field",
    "density_field",
    "density_temperature_fields",
    "temperature_field",
    "weak_mode_modulation",
    "shear_modulation",
    "hotspot_modulation",
    "structure_modulation",
    "emissivity_volume",
    "integrate_emission",
    "apply_palette",
    "render_top_view",
    "render_cross_section",
]
