"""Bloom with chromatic dispersion as a separable, boundary-normalized blur.

The port of ``bhr_tpu/ops/bloom.py: apply_bloom_conv`` (reference
``_bloom_kernel``, render.py:3022-3116): brightness extraction
(threshold 0), a horizontal then a vertical Gaussian blur with
per-channel denominators (25, 80, 1600) * sigma_scale (red sharp, blue
wide = lens dispersion), each tap sum normalized by the in-bounds
weight sum. Returns the raw normalized blur; the renderer adds it back
at scale 1, as the reference's PNG path does.

The blur is written as shifted multiply-adds, not ``conv1d``: cuDNN runs
float32 convolutions in TF32 by default (``torch.backends.cudnn.
allow_tf32``), which keeps about three decimal digits. Shifted adds run
in full float32 on every device with no global flag to set.
"""

from __future__ import annotations

import numpy as np
import torch

# Per-channel Gaussian denominators: w_c(d) = exp(-d^2 / (DEN_c * sigma_scale)).
_CHANNEL_DENOMS = (25.0, 80.0, 1600.0)


def _bloom_kernels(kernel_radius: int, sigma_scale: float) -> np.ndarray:
    """(3, 2R+1) per-channel 1D Gaussian taps (unnormalized)."""
    d = np.arange(-kernel_radius, kernel_radius + 1, dtype=np.float32)
    return np.stack(
        [np.exp(-(d**2) / (den * sigma_scale)) for den in _CHANNEL_DENOMS], axis=0
    )


def _blur_axis(img: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """Boundary-normalized blur of (H, W, 3) along ``axis`` (0 or 1).

    out[i] = sum_d taps[d] * img[i + d] / sum_{i + d in bounds} taps[d],
    with zero padding — the contract of a zero-padded depthwise conv
    divided by the same conv of a ones image.
    """
    n = img.shape[axis]
    radius = (taps.shape[1] - 1) // 2
    num = torch.zeros_like(img)
    den = img.new_zeros((n, 3))
    for k in range(taps.shape[1]):
        d = k - radius
        lo, hi = max(0, -d), min(n, n - d)  # output range with i + d in bounds
        if lo >= hi:
            continue
        w = taps[:, k]
        if axis == 0:
            num[lo:hi] += img[lo + d: hi + d] * w
        else:
            num[:, lo:hi] += img[:, lo + d: hi + d] * w
        den[lo:hi] += w
    den = torch.clamp(den, min=1e-12)
    return num / (den[:, None, :] if axis == 0 else den[None, :, :])


def apply_bloom(
    disk_layer: torch.Tensor, *, width_ref: int, threshold: float = 0.0
) -> torch.Tensor:
    """Separable per-channel bloom of the (H, W, 3) disk layer.

    ``width_ref`` is the frame width behind the resolution-scaled radius
    (kernel_radius = width * 0.02) and sigma_scale = (width / 640)^2.
    Returns the (H, W, 3) normalized blur (not yet added back).
    """
    kernel_radius = max(int(width_ref * 0.02), 1)
    sigma_scale = (width_ref / 640.0) ** 2
    taps = torch.as_tensor(_bloom_kernels(kernel_radius, sigma_scale),
                           device=disk_layer.device)

    lum = (
        disk_layer[..., 0] * 0.2126
        + disk_layer[..., 1] * 0.7152
        + disk_layer[..., 2] * 0.0722
    )
    bright = torch.where((lum > threshold)[..., None], disk_layer, 0.0)
    return _blur_axis(_blur_axis(bright, taps, axis=1), taps, axis=0)
