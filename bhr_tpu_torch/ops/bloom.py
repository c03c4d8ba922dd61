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

The post layer calls ``bloom_composite``: the blur added back onto
bg + disk and clamped to [0, 1]. Routing is by device: a CUDA tensor
launches the hand-written kernel ``csrc/bloom.cu`` (two launches a
frame, or raises); a CPU tensor runs the plain version,
``bloom_composite_plain`` (``apply_bloom`` and the clamp). There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

# Per-channel Gaussian denominators: w_c(d) = exp(-d^2 / (DEN_c * sigma_scale)).
_CHANNEL_DENOMS = (25.0, 80.0, 1600.0)


def _radius_and_sigma(width_ref: int):
    """kernel_radius = width * 0.02 (at least 1), sigma_scale = (width / 640)^2."""
    return max(int(width_ref * 0.02), 1), (width_ref / 640.0) ** 2


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
    taps = torch.as_tensor(_bloom_kernels(*_radius_and_sigma(width_ref)),
                           device=disk_layer.device)

    lum = (
        disk_layer[..., 0] * 0.2126
        + disk_layer[..., 1] * 0.7152
        + disk_layer[..., 2] * 0.0722
    )
    bright = torch.where((lum > threshold)[..., None], disk_layer, 0.0)
    return _blur_axis(_blur_axis(bright, taps, axis=1), taps, axis=0)


def bloom_composite_plain(bg_img: torch.Tensor, disk_img: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the post layer's bloom and clamp,
    ``clamp(bg + disk + apply_bloom(disk, width_ref=W), 0, 1)``, on any
    device: what the CPU route runs and what the kernel is held to on
    the card."""
    blur = apply_bloom(disk_img, width_ref=disk_img.shape[1])
    return torch.clamp(bg_img + disk_img + blur, 0.0, 1.0)


def _check_layers(bg_img: torch.Tensor, disk_img: torch.Tensor) -> None:
    for name, t in (("bg", bg_img), ("disk", disk_img)):
        if t.dtype != torch.float32:
            raise ValueError(f"bloom: {name} layer is {t.dtype}, not float32")
        if t.ndim != 3 or t.shape[2] != 3 or t.shape[0] < 1 or t.shape[1] < 1:
            raise ValueError(f"bloom: {name} layer has shape {tuple(t.shape)}, "
                             "not (H, W, 3)")
        if not t.is_contiguous():
            raise ValueError(f"bloom: {name} layer is not contiguous")
    if bg_img.shape != disk_img.shape or bg_img.device != disk_img.device:
        raise ValueError(
            f"bloom: bg {tuple(bg_img.shape)} on {bg_img.device} and disk "
            f"{tuple(disk_img.shape)} on {disk_img.device} differ")


def bloom_composite(bg_img: torch.Tensor, disk_img: torch.Tensor) -> torch.Tensor:
    """``clamp(bg + disk + bloom(disk), 0, 1)`` of two (H, W, 3) float32
    contiguous layers on one device, the bloom at ``width_ref`` = W ->
    a new (H, W, 3) float32 frame.

    A CUDA tensor launches ``csrc/bloom.cu`` on the device's current
    stream (two launches, counted in ``bloom_composite.launches``) or
    raises; a CPU tensor runs ``bloom_composite_plain`` (counted in
    ``bloom_composite.plain_passes``). The layers are checked before
    either route.
    """
    _check_layers(bg_img, disk_img)
    dev = disk_img.device
    if dev.type == "cpu":
        bloom_composite.plain_passes += 1
        return bloom_composite_plain(bg_img, disk_img)
    if dev.type != "cuda":
        raise ValueError(f"no bloom route for device {dev}")
    return _launch(bg_img, disk_img)


# Kernel launches and plain passes made through the router, so a run can
# show that its main path went through the kernel.
bloom_composite.launches = 0
bloom_composite.plain_passes = 0


# ---------------------------------------------------------------------------
# The kernel: csrc/bloom.cu, a horizontal and a vertical launch, fed the
# plain version's taps and denominators.
# ---------------------------------------------------------------------------


def _denominators(taps: np.ndarray, n: int) -> np.ndarray:
    """``_blur_axis``'s clamped denominators along an axis of ``n``,
    (n, 3): the in-bounds taps summed in ascending order from 0 in
    float32, as the plain version sums them, then clamped at 1e-12."""
    radius = (taps.shape[1] - 1) // 2
    den = np.zeros((n, 3), np.float32)
    for k in range(taps.shape[1]):
        d = k - radius
        lo, hi = max(0, -d), min(n, n - d)
        if lo < hi:
            den[lo:hi] += taps[:, k]
    return np.maximum(den, np.float32(1e-12))


def bloom_tables(height: int, width: int):
    """The kernel's float32 inputs for an (height, width) frame: the
    radius, the (3, 2R + 1) taps and the denominators along a row
    (width, 3) and down a column (height, 3)."""
    radius, sigma_scale = _radius_and_sigma(width)
    taps = _bloom_kernels(radius, sigma_scale)
    return radius, taps, _denominators(taps, width), _denominators(taps, height)


# (device, height, width) -> (radius, taps, den_x, den_y) on the device:
# copied there once a frame size, so no host-to-device copy sits between
# the post layer's launches.
_tables = {}


def _device_tables(height: int, width: int, dev: torch.device):
    key = (dev, height, width)
    if key not in _tables:
        radius, *host = bloom_tables(height, width)
        buf = torch.as_tensor(np.concatenate([a.ravel() for a in host]), device=dev)
        sizes = [a.size for a in host]
        _tables[key] = (radius, *torch.split(buf, sizes))
    return _tables[key]


_lib = None


def _kernel_lib():
    """The loaded bloom library, built (or loaded from the build cache)
    at the first call and kept for the process."""
    global _lib
    if _lib is None:
        lib = _build.build("bloom").lib
        lib.bhr_bloom.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.bhr_bloom.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(bg_img: torch.Tensor, disk_img: torch.Tensor) -> torch.Tensor:
    lib = _kernel_lib()
    height, width, _ = disk_img.shape
    dev = disk_img.device
    radius, taps, den_x, den_y = _device_tables(height, width, dev)
    tmp = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bhr_bloom(bg_img.data_ptr(), disk_img.data_ptr(), taps.data_ptr(),
                            den_x.data_ptr(), den_y.data_ptr(), tmp.data_ptr(),
                            out.data_ptr(), height, width, radius, stream)
    if err != 0:
        raise RuntimeError(f"bloom launch failed: cudaError {err}")
    bloom_composite.launches += 2
    return out
