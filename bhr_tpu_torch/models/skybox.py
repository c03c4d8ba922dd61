"""Procedural equirectangular starfield skybox.

One-time host-side asset generation (seeded NumPy), matching the feature
set of the reference generator (reference render.py:153-368):
galactic-plane + bulge star density (here via Gumbel-top-k importance
resampling over one fixed candidate batch; the reference loops rejection
sampling), Salpeter IMF masses, mass-luminosity + mass-temperature
relations, apparent-magnitude selection, Gaussian PSF blobs with
horizontal wrap (here painted offset-major), Milky-Way glow with
galactic-center brightening and 4-arm sinusoidal modulation.

Asset generation runs once per scene (like a data-loading step), so it
stays on host; per-frame work (textures, shading, ray-march) runs on the
torch device. A copy of ``bhr_tpu/models/skybox.py``: seeded NumPy, so
both packages produce the same array bit for bit, and the same cache
key.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from ..constants import (
    SKY_GALACTIC_CENTER_GLOW,
    SKY_MILKY_WAY_GLOW,
    SKY_STAR_BRIGHTNESS_GAIN,
    SKY_STAR_BRIGHTNESS_MAX,
    SKY_STAR_BRIGHTNESS_MIN,
    SKY_STAR_COLOR_SATURATION,
    SKY_STAR_SIZE_MAX,
    SKY_STAR_SIZE_MIN,
)
from ..utils.profiling import span

# Galactic geometry (J2000-ish): inclination of the galactic plane to the
# equator and the RA/Dec of the galactic center.
_GAL_INCL = np.radians(62.87)
_GAL_RA_CENTER = np.radians(266.4)
_GAL_DEC_CENTER = np.radians(-28.9)

# Bump when generate_skybox's output changes for the same (size, seed,
# n_stars) — the on-disk cache key includes it, so stale pre-change
# entries can never shadow a generator update. v2: Gumbel-top-k star
# placement + offset-major PSF painting.
_GENERATOR_VERSION = 2


def _blackbody_rgb_np(temp_k: np.ndarray) -> np.ndarray:
    """NumPy twin of ops.shading.blackbody_rgb (host asset generation)."""
    t = temp_k / 100.0
    safe = np.maximum(t - 60.0, 1e-6)
    r = np.where(t <= 66.0, 1.0, np.clip(1.292936 * np.power(safe, -0.1332047592), 0, 1))
    g = np.where(
        t <= 66.0,
        np.clip(0.390082 * np.log(np.maximum(t, 1e-6)) - 0.631841, 0, 1),
        np.clip(1.129891 * np.power(safe, -0.0755148492), 0, 1),
    )
    b = np.where(
        t >= 66.0,
        1.0,
        np.where(t <= 19.0, 0.0, np.clip(0.543207 * np.log(np.maximum(t - 10.0, 1e-6)) - 1.19625, 0, 1)),
    )
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def _galactic_latitude(dec: np.ndarray, ra: np.ndarray) -> np.ndarray:
    """Galactic latitude b for equatorial (dec, ra)."""
    sin_b = (
        np.sin(dec) * np.cos(_GAL_INCL)
        - np.cos(dec) * np.sin(_GAL_INCL) * np.sin(ra - _GAL_RA_CENTER)
    )
    return np.arcsin(np.clip(sin_b, -1.0, 1.0))


def _star_density(dec: np.ndarray, ra: np.ndarray) -> np.ndarray:
    """Unnormalized sky density of stars at equatorial (dec, ra).

    The visual recipe (SURVEY §2.1): a uniform isotropic floor, a
    Gaussian band around the galactic plane (sigma 8 deg in latitude),
    and a bulge around the galactic center (sigma 20 deg angular).
    """
    b = _galactic_latitude(dec, ra)
    density = 0.15 + 0.85 * np.exp(-0.5 * (b / np.radians(8.0)) ** 2)
    cos_sep = (
        np.sin(dec) * np.sin(_GAL_DEC_CENTER)
        + np.cos(dec) * np.cos(_GAL_DEC_CENTER) * np.cos(ra - _GAL_RA_CENTER)
    )
    center_sep = np.arccos(np.clip(cos_sep, -1.0, 1.0))
    return density + 0.3 * np.exp(-0.5 * (center_sep / np.radians(20.0)) ** 2)


def _sample_star_positions(
    rng: np.random.Generator, n_stars: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Star directions distributed as _star_density over the sphere.

    One fixed-size candidate batch + Gumbel-top-k importance
    resampling: perturb log-density with Gumbel noise and keep the
    n_stars largest keys — an exact weighted sample WITHOUT
    replacement, with no data-dependent accept/retry loop. (The
    reference reaches the same distribution by looped rejection
    sampling, reference render.py:186-233.)
    """
    m = max(n_stars * 8, 4096)
    z = rng.uniform(-1.0, 1.0, m)  # uniform on the sphere
    ra = rng.uniform(0.0, 2.0 * np.pi, m)
    dec = np.arcsin(z)
    weight = _star_density(dec, ra)
    gumbel = -np.log(-np.log(rng.random(m) + 1e-300) + 1e-300)
    keep = np.argpartition(-(np.log(weight) + gumbel), n_stars)[:n_stars]
    return ra[keep], np.pi / 2 - dec[keep]


def _sample_star_photometry(
    rng: np.random.Generator, n_stars: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Salpeter IMF + magnitude-limited selection -> (brightness, sigma, rgb)."""
    alpha = 2.35
    m_lo, m_hi = 0.08, 50.0
    oversample = n_stars * 30
    u = rng.random(oversample)
    mass = (m_lo ** (1 - alpha) + u * (m_hi ** (1 - alpha) - m_lo ** (1 - alpha))) ** (
        1.0 / (1 - alpha)
    )

    # Main-sequence mass-luminosity relation, L ~ M^a (Duric 2004 bands).
    lum_exp = np.where(mass < 0.43, 2.3, np.where(mass < 2.0, 4.0, np.where(mass < 55.0, 3.5, 1.0)))
    luminosity = np.power(mass, lum_exp)
    abs_mag = -2.5 * np.log10(luminosity + 1e-30) + 4.83

    dist = np.clip(rng.exponential(scale=200.0, size=oversample), 1.0, 5000.0)
    app_mag = abs_mag + 5.0 * np.log10(dist / 10.0)

    visible = np.where(app_mag <= 8.0)[0]
    if len(visible) >= n_stars:
        idx = rng.choice(visible, size=n_stars, replace=False)
    else:
        idx = np.argsort(app_mag)[:n_stars]
    mass_sel = mass[idx]
    mag_sel = app_mag[idx]

    mag_norm = (mag_sel - mag_sel.min()) / (mag_sel.max() - mag_sel.min() + 1e-30)
    brightness = SKY_STAR_BRIGHTNESS_MAX - (SKY_STAR_BRIGHTNESS_MAX - SKY_STAR_BRIGHTNESS_MIN) * mag_norm
    brightness = np.clip(brightness * SKY_STAR_BRIGHTNESS_GAIN, 0.0, 1.0).astype(np.float32)
    sigma = (SKY_STAR_SIZE_MIN + (SKY_STAR_SIZE_MAX - SKY_STAR_SIZE_MIN) * brightness).astype(np.float32)

    temp_k = np.clip(5778.0 * np.power(mass_sel, 0.57), 2000.0, 50000.0)
    colors = _blackbody_rgb_np(temp_k)
    colors = SKY_STAR_COLOR_SATURATION * colors + (1.0 - SKY_STAR_COLOR_SATURATION)
    return brightness, sigma, colors.astype(np.float32)


def _splat_stars(
    texture: np.ndarray,
    cx: np.ndarray,
    cy: np.ndarray,
    brightness: np.ndarray,
    sigma: np.ndarray,
    colors: np.ndarray,
    radius: int = 4,
) -> None:
    """Accumulate Gaussian PSF blobs (u wraps, v clamps out of frame).

    Offset-major: each of the (2*radius+1)^2 patch cells does ONE
    vectorized scatter-add of every star's Gaussian-weighted color at
    that offset. The per-cell Gaussian factor exp(-d2/(2 sigma^2))
    depends only on (dy, dx) and the per-star sigma, so it is computed
    per pass over an n_stars-sized working set — no flattened
    star x patch index tensor is ever materialized.
    """
    tex_h, tex_w = texture.shape[:2]
    col0 = np.floor(cx).astype(int)
    row0 = np.floor(cy).astype(int)
    energy = colors * brightness[:, None]
    inv_two_sigma2 = 1.0 / (2.0 * sigma**2)
    for dy in range(-radius, radius + 1):
        rows = row0 + dy
        on_sphere = (rows >= 0) & (rows < tex_h)  # v clamps out
        for dx in range(-radius, radius + 1):
            psf = np.exp(-(dx * dx + dy * dy) * inv_two_sigma2[on_sphere])
            cols = (col0[on_sphere] + dx) % tex_w  # u wraps
            np.add.at(
                texture, (rows[on_sphere], cols),
                energy[on_sphere] * psf[:, None],
            )


def _milky_way_glow(tex_w: int, tex_h: int) -> np.ndarray:
    """Diffuse Milky-Way band + galactic-center glow + 4-arm modulation."""
    v = np.linspace(0.0, np.pi, tex_h)
    u = np.linspace(0.0, 2.0 * np.pi, tex_w)
    uu, vv = np.meshgrid(u, v)
    dec = np.pi / 2 - vv

    b = _galactic_latitude(dec, uu)
    sin_l_cos_b = (
        np.cos(dec) * np.cos(_GAL_INCL) * np.sin(uu - _GAL_RA_CENTER)
        + np.sin(dec) * np.sin(_GAL_INCL)
    )
    cos_l_cos_b = np.cos(dec) * np.cos(uu - _GAL_RA_CENTER)
    gal_lon = np.arctan2(sin_l_cos_b, cos_l_cos_b)

    glow = SKY_MILKY_WAY_GLOW * np.exp(-0.5 * (b / np.radians(6.0)) ** 2)
    glow += SKY_GALACTIC_CENTER_GLOW * np.exp(
        -0.5 * (gal_lon**2 + b**2) / np.radians(15.0) ** 2
    )

    arm_pattern = 0.4 + 0.6 * (0.5 + 0.5 * np.cos(4.0 * gal_lon + np.radians(30.0)))
    arm_mask = np.exp(-0.5 * (b / np.radians(8.0)) ** 2)
    glow = glow * ((1.0 - arm_mask) + arm_mask * arm_pattern)
    return glow.astype(np.float32)


def _bilinear_upscale(small: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Plain bilinear upscaling of an (h, w, c) array (no PIL dependency)."""
    h, w = small.shape[:2]
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = small[y0][:, x0] * (1 - fx) + small[y0][:, x1] * fx
    bot = small[y1][:, x0] * (1 - fx) + small[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def generate_skybox(
    tex_w: int = 2048, tex_h: int = 1024, seed: int = 42, n_stars: int = 6000
) -> np.ndarray:
    """Generate the (tex_h, tex_w, 3) float32 starfield in [0, 1]."""
    rng = np.random.default_rng(seed)
    texture = np.full((tex_h, tex_w, 3), 0.003, dtype=np.float32)

    # Low-frequency nebula haze.
    neb = rng.random((tex_h // 16, tex_w // 16, 3)).astype(np.float32) * 0.06
    texture += _bilinear_upscale(neb, tex_w, tex_h) * 0.04

    phi_s, theta_s = _sample_star_positions(rng, n_stars)
    cx = (phi_s / (2.0 * np.pi) * tex_w).astype(np.float32)
    cy = (theta_s / np.pi * tex_h).astype(np.float32)

    brightness, sigma, colors = _sample_star_photometry(rng, n_stars)
    _splat_stars(texture, cx, cy, brightness, sigma, colors)

    texture += _milky_way_glow(tex_w, tex_h)[:, :, None] * np.array(
        [1.0, 0.95, 0.85], dtype=np.float32
    )
    return np.clip(texture, 0.0, 1.0)


def load_or_generate_skybox(
    skybox_path: Optional[str],
    tex_w: int = 2048,
    tex_h: int = 1024,
    n_stars: int = 6000,
    seed: int = 42,
    cache_dir: str = "output/.skybox_cache",
) -> Tuple[np.ndarray, int, int]:
    """Load an external equirectangular texture or generate one.

    Procedural generation is deterministic in (size, seed, n_stars), so
    the result is cached as .npy keyed by exactly those parameters —
    generation costs ~6 s of host time on every startup otherwise (the
    reference regenerates each run, render.py:344-368; the cache
    follows the repo's disk-texture cache pattern). Delete the cache
    dir or pass cache_dir=None to force regeneration.
    """
    if skybox_path and os.path.isfile(skybox_path):
        from PIL import Image

        img = Image.open(skybox_path).convert("RGB")
        texture = np.asarray(img, dtype=np.float32) / 255.0
        tex_h, tex_w = texture.shape[:2]
        return texture, tex_h, tex_w

    cache_path = None
    if cache_dir:
        key = (f"skybox_v{_GENERATOR_VERSION}_"
               f"{tex_w}x{tex_h}_{seed}_{n_stars}.npy")
        cache_path = os.path.join(cache_dir, key)
        if os.path.isfile(cache_path):
            try:
                texture = np.load(cache_path)
                if texture.shape == (tex_h, tex_w, 3):
                    return texture, tex_h, tex_w
            except Exception:
                pass  # corrupt cache entry: fall through and regenerate

    with span("skybox.generate"):
        texture = generate_skybox(tex_w=tex_w, tex_h=tex_h, seed=seed,
                                  n_stars=n_stars)
    if cache_path:
        # Temp + replace: concurrent starts (multi-host video
        # processes, parallel tests) must never load a half-written
        # entry. mkstemp gives every writer a name unique even across
        # hosts sharing the filesystem (a pid suffix is not: two hosts
        # can hold the same pid), and the finally-unlink never leaves
        # an orphan temp file behind a failed write.
        try:
            os.makedirs(cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(cache_path) + ".", dir=cache_dir
            )
            try:
                # mkstemp creates 0600; restore umask-derived perms so a
                # shared cache dir stays readable by other users (plain
                # open() would have given 0644 under the usual umask).
                umask = os.umask(0)
                os.umask(umask)
                os.fchmod(fd, 0o666 & ~umask)
                with os.fdopen(fd, "wb") as f:
                    np.save(f, texture)
                os.replace(tmp, cache_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError:
            pass  # read-only output dir: cache is best-effort
    return texture, tex_h, tex_w
