"""Global physical and tuning constants of the PyTorch/CUDA port.

A copy of ``bhr_tpu/constants.py``: the port must render the same scene
as the JAX package, so every tuning value is identical.
"""

# Schwarzschild radius (geometric units). Everything is scaled by RS.
RS = 1.0
EPS = 1e-6

# --- Relativistic g-factor shading (affects disk only) -------------------
# Soft cap on the combined Doppler x gravitational g-factor.
G_FACTOR_CAP = 1.5
# Exponent controlling how brightness scales with g.
G_LUMINOSITY_POWER = 1.5
# Global disk brightness gain.
G_BRIGHTNESS_GAIN = 0.38

# --- Disk opacity & color temperature ------------------------------------
# Base color temperature of the accretion disk in Kelvin.
DISK_COLOR_TEMPERATURE = 6000.0
# alpha' = 1 - (1 - alpha)^DISK_ALPHA_GAIN makes the disk more opaque.
DISK_ALPHA_GAIN = 6.0
# Radial brightness falloff (1 - radial_t)^p remapped into [MIN, MAX].
DISK_RADIAL_BRIGHTNESS_POWER = 1.2
DISK_RADIAL_BRIGHTNESS_MIN = 0.2
DISK_RADIAL_BRIGHTNESS_MAX = 8.0

# --- Procedural skybox ----------------------------------------------------
SKY_STAR_BRIGHTNESS_MIN = 0.03
SKY_STAR_BRIGHTNESS_MAX = 1.0
SKY_STAR_BRIGHTNESS_GAIN = 1.8
SKY_STAR_COLOR_SATURATION = 0.3
SKY_STAR_SIZE_MIN = 0.5
SKY_STAR_SIZE_MAX = 1.7
SKY_MILKY_WAY_GLOW = 0.10
SKY_GALACTIC_CENTER_GLOW = 0.08

# --- Default accretion-disk radii (match reference render.py:433-434) ----
R_DISK_INNER_DEFAULT = 2.0 * RS
R_DISK_OUTER_DEFAULT = 15.0 * RS

# --- Entity lifecycle system (reference render.py:493-497) ---------------
FILAMENT_SHEAR_ALPHA = 0.1
FILAMENT_TAU_COOL = 50.0
FILAMENT_DEATH_THRESHOLD = 0.008
FILAMENT_MAX_LIFETIME = 120.0
FILAMENT_BIRTH_FADE_DUR = 5.0

# Deprecated-but-accepted CLI surface (reference render.py:4540).
DISK_GENERATION_SCALE_CHOICES = (1, 2, 4)
ENABLE_DISK_SPIRAL_ARMS = False

# Maximum number of recorded disk-plane crossings per ray in the deferred
# shading pipeline: the trace records hits and shading runs in a second
# vectorized pass. Direct image + 2-3 ghost images saturate alpha, so 4
# slots reproduce the reference image to well below visual tolerance.
MAX_DISK_CROSSINGS = 4
