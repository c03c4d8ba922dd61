"""Time-evolving background components for the dynamic disk.

The port of ``bhr_tpu/ops/background.py`` (reference GPU background
kernel, render.py:3332-3453): the wide-r component slices [0 temp_base,
1-2 spiral (zeroed), 3-4 turbulence, 11 az_hotspot, 12 disturb_mod] of
the 13-component field, from 3D simplex/FBM noise in seamlessly
rotating coordinates (cos(phi_rot), sin(phi_rot), r) with
phi_rot = phi + omega(r) * t.

Routing is by device: a CUDA device launches the hand-written kernel
``csrc/background_noise.cu`` (one launch a pass, or raises); a CPU
device runs the plain version, ``generate_background_components_plain``.
There is no fallback from one to the other. Both read the 13 noise
fields' coefficients from ``NOISE_FIELDS``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .noise import fbm_3d, simplex_noise_3d
from .shading import keplerian_omega


class NoiseField(NamedTuple):
    """One noise field of the pass, at (cx, cy, r) = (cos(phi_rot),
    sin(phi_rot), r): ``unit(fbm_3d(cx * xy, cy * xy, r * r_freq + t *
    t_coef, octaves, persistence))``, or with ``octaves`` 0 one simplex
    evaluation clamped to [0, 1]; either times ``weight`` (1.0 where the
    reference applies none: x * 1.0 is x exactly)."""

    xy: float
    r_freq: float
    t_coef: float
    octaves: int
    persistence: float
    weight: float


# temp_base: radial decay x slow FBM.
TEMP_BASE = NoiseField(8.0, 8.0, 0.05, 4, 0.6, 1.0)
# turbulence: six time-evolving scales, summed in this order.
TURBULENCE = (
    NoiseField(8.0, 4.0, 0.06, 3, 0.45, 0.08),
    NoiseField(24.0, 12.0, 0.08, 4, 0.45, 0.15),
    NoiseField(80.0, 40.0, 0.1, 5, 0.45, 0.25),
    NoiseField(200.0, 100.0, 0.12, 4, 0.4, 0.22),
    NoiseField(400.0, 200.0, 0.15, 3, 0.35, 0.18),
    NoiseField(800.0, 400.0, 0.2, 0, 0.0, 0.12),
)
# az_hotspot: sinusoidal azimuthal wave with radial shear x FBM.
AZ_HOTSPOT = NoiseField(3.0, 3.0, 0.04, 3, 0.5, 1.0)
# disturb_mod: slow multi-scale modulation in [0.1, 1], summed in order.
DISTURB = (
    NoiseField(8.0, 4.0, 0.003, 3, 0.5, 0.05),
    NoiseField(32.0, 16.0, 0.005, 3, 0.5, 0.15),
    NoiseField(100.0, 50.0, 0.006, 4, 0.45, 0.30),
    NoiseField(250.0, 125.0, 0.008, 4, 0.4, 0.30),
    NoiseField(500.0, 250.0, 0.01, 0, 0.0, 0.20),
)
# The kernel's field order (csrc/background_noise.cu reads them by index).
NOISE_FIELDS = (TEMP_BASE, *TURBULENCE, AZ_HOTSPOT, *DISTURB)
PLANES = 7  # temp_base, spiral, spiral_temp, turbulence, turb_temp, az_hotspot, disturb_mod


def _check_args(n_r, n_phi, t, generation_scale) -> torch.Tensor:
    """The times as a float32 tensor (0-d or 1-d), after the checks both
    routes share."""
    if n_r % generation_scale or n_phi % generation_scale:
        raise ValueError(
            f"texture size ({n_r}, {n_phi}) must be divisible by "
            f"generation_scale {generation_scale}"
        )
    times = torch.as_tensor(t, dtype=torch.float32)
    if times.ndim not in (0, 1):
        raise ValueError(f"t must be one time or a sequence, got {times.shape}")
    return times


def generate_background_components(
    n_r: int,
    n_phi: int,
    az_freq: float,
    az_shear: float,
    r_inner: float,
    r_outer: float,
    t,
    generation_scale: int = 1,
    device=None,
) -> torch.Tensor:
    """Return a (7, n_r, n_phi) stack for comp indices [0,1,2,3,4,11,12].

    Order in the output stack: [temp_base, spiral(0), spiral_temp(0),
    turbulence, turb_temp, az_hotspot, disturb_mod].

    ``t`` is one time, or a sequence of F times, and then the stacks of
    all F frames come back as (F, 7, n_r, n_phi) from one pass: every
    texel is computed from its own coordinates and time alone, so frame i
    of that pass equals the call with ``t[i]`` alone bit for bit.

    ``generation_scale`` > 1 evaluates the noise on an (n_r/s, n_phi/s)
    grid and repeats each value s x s times (reference render.py:78-87).

    A CUDA ``device`` launches ``csrc/background_noise.cu`` (one launch
    for up to ``MAX_FRAMES`` frames, counted in
    ``generate_background_components.launches``); a CPU device runs
    ``generate_background_components_plain`` (counted in
    ``generate_background_components.plain_passes``). ``None`` is torch's
    default device.
    """
    times = _check_args(n_r, n_phi, t, generation_scale)
    dev = torch.device(device) if device is not None else torch.empty(0).device
    if dev.type == "cpu":
        generate_background_components.plain_passes += 1
        return generate_background_components_plain(
            n_r, n_phi, az_freq, az_shear, r_inner, r_outer, times,
            generation_scale, dev)
    if dev.type != "cuda":
        raise ValueError(f"no background-noise route for device {dev}")
    return _launch(n_r, n_phi, (az_freq, az_shear, r_inner, r_outer), times,
                   generation_scale, dev)


# Kernel launches and plain passes made through the router, so a run can
# show that its main path went through the kernel.
generate_background_components.launches = 0
generate_background_components.plain_passes = 0


def _unit(v):
    return torch.clamp(0.5 + 0.5 * v, 0.0, 1.0)


def _noise(spec: NoiseField, cx, cy, r, t):
    """One field of the table at the rotating coordinates (one
    simplex-noise pass per octave)."""
    x, y, z = cx * spec.xy, cy * spec.xy, r * spec.r_freq + t * spec.t_coef
    if spec.octaves:
        v = _unit(fbm_3d(x, y, z, spec.octaves, spec.persistence, 2.0))
    else:
        v = torch.clamp(simplex_noise_3d(x, y, z), 0.0, 1.0)
    return v * spec.weight


def _summed(specs, cx, cy, r, t):
    total = _noise(specs[0], cx, cy, r, t)
    for spec in specs[1:]:
        total = total + _noise(spec, cx, cy, r, t)
    return total


def generate_background_components_plain(
    n_r: int,
    n_phi: int,
    az_freq: float,
    az_shear: float,
    r_inner: float,
    r_outer: float,
    t,
    generation_scale: int = 1,
    device=None,
) -> torch.Tensor:
    """The plain PyTorch version of the pass, element-wise operations on
    ``device`` (any): what the CPU route runs and what the kernel is held
    to on the card. Arguments and result as
    :func:`generate_background_components`."""
    times = _check_args(n_r, n_phi, t, generation_scale)
    f32 = torch.float32
    gr, gp = n_r // generation_scale, n_phi // generation_scale
    r = (torch.arange(gr, dtype=f32, device=device)[:, None]
         * generation_scale / n_r)
    phi = (
        torch.arange(gp, dtype=f32, device=device)[None, :]
        * generation_scale / n_phi * (2.0 * math.pi)
    )
    r = r.expand(gr, gp)
    phi = phi.expand(gr, gp)
    # The scalars arrive as float32 values in the JAX program; round
    # them the same way before they meet the float32 grids.
    az_freq, az_shear, r_inner, r_outer = (
        torch.tensor(v, dtype=f32, device=device)
        for v in (az_freq, az_shear, r_inner, r_outer)
    )
    t = times.to(device)
    if t.ndim == 1:
        t = t[:, None, None]  # a leading frame axis on all that moves

    r_phys = r_inner + (r_outer - r_inner) * r
    omega = keplerian_omega(r_phys)
    phi_rot = phi + omega * t
    cx = torch.cos(phi_rot)
    cy = torch.sin(phi_rot)

    decay = torch.pow(torch.clamp(1.0 - r, min=0.0), 1.3)
    tb_noise = _noise(TEMP_BASE, cx, cy, r, t)
    temp_base = decay * (0.85 + 0.15 * tb_noise) * 0.25

    zeros = torch.zeros_like(temp_base)

    turb = torch.clamp(_summed(TURBULENCE, cx, cy, r, t), 0.0, 1.0)

    shear = torch.pow(r, 1.2) * az_shear
    az_wave = 0.5 + 0.5 * torch.sin((phi_rot + shear) * az_freq)
    az_hotspot = az_wave * _noise(AZ_HOTSPOT, cx, cy, r, t)

    disturb = torch.clamp(_summed(DISTURB, cx, cy, r, t) * 1.4, 0.05, 1.0)
    disturb = torch.clamp(disturb * (0.6 + 0.4 * r), 0.1, 1.0)

    stack = torch.stack(
        [temp_base, zeros, zeros, turb, 0.05 * turb, az_hotspot, disturb],
        dim=-3,
    )
    if generation_scale > 1:
        stack = stack.repeat_interleave(generation_scale, dim=-2)
        stack = stack.repeat_interleave(generation_scale, dim=-1)
    return stack


# ---------------------------------------------------------------------------
# The kernel: csrc/background_noise.cu, one thread per (frame, r, phi) point
# of the generation grid, the parameters passed by value.
# ---------------------------------------------------------------------------

MAX_OCTAVES = 5
MAX_FRAMES = 16  # times one launch takes by value; more frames launch again


class _Field(ctypes.Structure):
    # struct Field in the .cu source.
    _fields_ = [("xy", ctypes.c_float), ("r_freq", ctypes.c_float),
                ("t_coef", ctypes.c_float), ("weight", ctypes.c_float),
                ("amp", ctypes.c_float * MAX_OCTAVES), ("octaves", ctypes.c_int)]


class KernelParams(ctypes.Structure):
    # struct Params in the .cu source.
    _fields_ = [("field", _Field * len(NOISE_FIELDS)),
                ("time", ctypes.c_float * MAX_FRAMES),
                ("az_freq", ctypes.c_float), ("az_shear", ctypes.c_float),
                ("r_inner", ctypes.c_float), ("r_outer", ctypes.c_float),
                ("inv_n_r", ctypes.c_float), ("inv_n_phi", ctypes.c_float),
                ("n_r", ctypes.c_int), ("n_phi", ctypes.c_int),
                ("scale", ctypes.c_int), ("frames", ctypes.c_int)]


def kernel_params(n_r: int, n_phi: int, scalars, times, scale: int) -> KernelParams:
    """The kernel's parameters for up to ``MAX_FRAMES`` float32 ``times``.

    Every float is the float32 value the plain version's operation meets
    on the card: the table's coefficients and the four scalars rounded
    to float32, ``fbm_3d``'s octave amplitudes as Python multiplies them
    in double (``amplitude *= persistence``) and then rounded, and the
    grid's ``x / n`` as torch computes a division by a Python number on
    CUDA: ``x * (1 / n)`` with the reciprocal taken in float32.
    """
    if not 1 <= len(times) <= MAX_FRAMES:
        raise ValueError(f"{len(times)} times, the kernel takes 1 to {MAX_FRAMES}")
    p = KernelParams()
    for dst, spec in zip(p.field, NOISE_FIELDS):
        dst.xy, dst.r_freq, dst.t_coef, dst.weight = (
            spec.xy, spec.r_freq, spec.t_coef, spec.weight)
        dst.octaves = spec.octaves
        amplitude = 1.0
        for o in range(spec.octaves):
            dst.amp[o] = amplitude
            amplitude *= spec.persistence
    for k, v in enumerate(times):
        p.time[k] = v
    p.az_freq, p.az_shear, p.r_inner, p.r_outer = scalars
    p.inv_n_r = np.float32(1.0) / np.float32(n_r)
    p.inv_n_phi = np.float32(1.0) / np.float32(n_phi)
    p.n_r, p.n_phi, p.scale, p.frames = n_r, n_phi, scale, len(times)
    return p


_lib = None


def _kernel_lib():
    """The loaded background-noise library, its layout checked against
    ``KernelParams``. Built (or loaded from the build cache) at the first
    call and kept for the process."""
    global _lib
    if _lib is None:
        lib = _build.build("background_noise").lib
        lib.bhr_background_noise_layout.argtypes = [ctypes.c_int]
        lib.bhr_background_noise_layout.restype = ctypes.c_int
        expect = (ctypes.sizeof(KernelParams), len(NOISE_FIELDS), MAX_OCTAVES,
                  MAX_FRAMES, PLANES)
        got = tuple(lib.bhr_background_noise_layout(i) for i in range(len(expect)))
        if got != expect:
            raise RuntimeError(
                f"background_noise.cu layout {got} != wrapper layout {expect}")
        lib.bhr_background_noise.argtypes = [ctypes.c_void_p] * 3
        lib.bhr_background_noise.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(n_r, n_phi, scalars, times, scale, dev) -> torch.Tensor:
    """Allocate the (7, n_r, n_phi) or (F, 7, n_r, n_phi) result and fill
    it with one launch per ``MAX_FRAMES`` frames on the current stream.
    The times go by value in the parameters: no copy to the device sits
    between this pass and the launches around it."""
    lib = _kernel_lib()
    host_t = times.cpu().reshape(-1).tolist()
    out = torch.empty((*times.shape, PLANES, n_r, n_phi), dtype=torch.float32,
                      device=dev)
    frames = out.view(-1, PLANES, n_r, n_phi)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for f0 in range(0, len(host_t), MAX_FRAMES):
            params = kernel_params(n_r, n_phi, scalars,
                                   host_t[f0:f0 + MAX_FRAMES], scale)
            err = lib.bhr_background_noise(ctypes.addressof(params),
                                           frames[f0].data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"background_noise launch failed: cudaError {err}")
            generate_background_components.launches += 1
    return out
