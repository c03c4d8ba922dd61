"""Null-geodesic integration around a Schwarzschild black hole (plain torch).

The port of ``bhr_tpu/ops/geodesic.py``: the Cartesian
equivalent-potential photon equation d^2 x / dlambda^2 =
-1.5 * L^2 * x / r^5 with conserved L^2 = |dir x pos|^2, integrated by
RK4 with an r-adaptive step; disk-plane crossings are recorded into a
fixed (K, 12, N) hit buffer for deferred shading.

This is the plain version of the ray-march kernel
(``geodesic_cuda.trace_geodesics_cuda``, ``csrc/ray_march.cu``): a
lock-step masked loop over all rays that runs on any device. It is the
CPU path and the oracle the kernel is checked against on the card, so
its arithmetic follows the kernel's operation order exactly:

  * every sum of squares is written x*x + y*y + z*z (never a reduction,
    whose order is unspecified);
  * every division divides by a tensor on the same device: PyTorch's
    CUDA division by a CPU scalar multiplies by its reciprocal instead,
    which rounds differently from the kernel's ``/``.

Rays that terminated are dropped from the working set (compaction):
their state is frozen in the masked formulation anyway, so results are
identical and the loop's cost follows the live rays only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import MAX_DISK_CROSSINGS, RS

# Hit-record feature layout along axis 1 of `hits` (K, HIT_FEATURES, N):
#   0:2   hit_x, hit_y          (world xy on the tilted disk plane)
#   2:5   ray direction at the crossing step (pre-step, points away from cam)
#   5:11  ray differentials (zero: the AA variant is not ported yet)
#   11    t_frac within the step (diagnostics; the kernel writes 0)
HIT_FEATURES = 12

# Camera parameter vector layout (as bhr_tpu.ops.geodesic_pallas):
#   0:3 cam_pos, 3:6 right, 6:9 up, 9:12 forward, 12 pw, 13 ph
CAM_PARAMS = 14


class TraceResult(NamedTuple):
    """Output of the geodesic integrator for N rays (``bhr_tpu``'s layout)."""

    captured: torch.Tensor  # (N,) bool — fell through the horizon
    escaped: torch.Tensor  # (N,) bool — left the escape sphere / affine cap
    escape_dir: torch.Tensor  # (N, 3) unit direction, zero where not escaped
    hit_count: torch.Tensor  # (N,) int32 number of recorded disk crossings
    hits: torch.Tensor  # (K, HIT_FEATURES, N)


def refuse_unported_variant(*, with_differentials: bool = False,
                            record_step_counts: bool = False,
                            row_count=None, record_hits: bool = True) -> None:
    """Raise for a ray-march variant the port does not have yet."""
    for requested, variant, item in (
        (with_differentials, "with_differentials (AA)", "Queue 2 item 2"),
        (record_step_counts, "record_step_counts", "Queue 2 item 3"),
        (row_count is not None, "row_count (row band)", "Queue 2 item 4"),
        (not record_hits, "record_hits=False (no disk)", "Queue 2 item 5"),
    ):
        if requested:
            raise NotImplementedError(
                f"ray-march variant {variant} is not ported to "
                f"bhr_tpu_torch yet (ROADMAP.md {item})"
            )


class TraceConstants(NamedTuple):
    """Scalar trace parameters as Python doubles, derived on the host
    exactly as ``bhr_tpu`` derives them (squares, 40 * r_escape and
    tan(tilt) in double). Each is rounded to float32 once: where it meets
    a float32 tensor in the plain version, by ``ctypes.c_float`` for the
    kernel — the same rounding either way."""

    h_base: float
    rs: float
    r_floor: float  # rs + 1e-3, the adaptive step's clamp
    rs2: float
    r_escape2: float
    max_affine: float  # 40 * r_escape
    tan_t: float
    r_in2: float
    r_out2: float
    max_iter: int


def trace_constants(*, h_base: float, r_escape: float, rs: float,
                    tilt_deg: float, r_inner: float,
                    r_outer: float) -> TraceConstants:
    """The scalar arguments shared by the plain version and the kernel."""
    max_affine = r_escape * 40.0
    return TraceConstants(
        h_base=float(h_base), rs=float(rs), r_floor=rs + 1e-3, rs2=rs * rs,
        r_escape2=r_escape * r_escape, max_affine=max_affine,
        tan_t=math.tan(math.radians(tilt_deg)),
        r_in2=r_inner * r_inner, r_out2=r_outer * r_outer,
        # Derived from max_affine so the iteration budget and the affine
        # cap can never desynchronize.
        max_iter=int(max_affine / h_base),
    )


def primary_rays_from_params(cam_params: torch.Tensor, width: int,
                             height: int) -> torch.Tensor:
    """(H*W, 3) unit primary ray directions, row-major (y, x) pixels.

    Same image-plane arithmetic as the kernel (and the Pallas kernel):
    plane 1 unit ahead, pixel centers at +0.5, y down, the top-left
    corner computed in float32 from the 14 camera floats; the
    normalization divides by the correctly rounded norm.
    """
    c = cam_params.to(torch.float32)
    dev = c.device
    cx, cy, cz = c[0], c[1], c[2]
    rx, ry, rz = c[3], c[4], c[5]
    ux, uy, uz = c[6], c[7], c[8]
    fx, fy, fz = c[9], c[10], c[11]
    pw, ph = c[12], c[13]
    half_w = pw * width * 0.5
    half_h = ph * height * 0.5
    tlx = cx + fx - rx * half_w + ux * half_h
    tly = cy + fy - ry * half_w + uy * half_h
    tlz = cz + fz - rz * half_w + uz * half_h

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    a = (px + 0.5) * pw
    b = (py + 0.5) * ph
    dx = tlx + a * rx - b * ux - cx
    dy = tly + a * ry - b * uy - cy
    dz = tlz + a * rz - b * uz - cz
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    d = torch.stack([dx / norm, dy / norm, dz / norm], dim=-1)
    return d.reshape(-1, 3)


def trace_geodesics(
    origin: torch.Tensor,
    directions: torch.Tensor,
    *,
    h_base: float,
    r_escape: float,
    rs: float = RS,
    tilt_deg: float = 0.0,
    r_inner: float = 2.0,
    r_outer: float = 15.0,
    with_differentials: bool = False,
    max_crossings: int = MAX_DISK_CROSSINGS,
    record_hits: bool = True,
    record_step_counts: bool = False,
) -> TraceResult:
    """Integrate N photon geodesics and record disk-plane crossings.

    Args:
        origin: (3,) shared ray origin (camera position).
        directions: (N, 3) unit ray directions.
        h_base: base affine step (CLI --step_size).
        r_escape: escape radius; affine cap is 40 * r_escape.
        tilt_deg: disk tilt about the x-axis; plane is z = y * tan(tilt).
        max_crossings: hit-buffer slots per ray (front-to-back order).

    Rays that neither escape nor get captured within the iteration
    budget report neither flag (background renders black, matching the
    reference).
    """
    refuse_unported_variant(with_differentials=with_differentials,
                            record_step_counts=record_step_counts,
                            record_hits=record_hits)
    dev = directions.device
    f32 = torch.float32
    n = directions.shape[0]
    k = trace_constants(h_base=h_base, r_escape=r_escape, rs=rs,
                        tilt_deg=tilt_deg, r_inner=r_inner, r_outer=r_outer)

    def const(v):
        return torch.tensor(v, dtype=f32, device=dev)

    rs_t, six, eps_t = const(k.rs), const(6.0), const(1e-8)
    one, min_norm = const(1.0), const(1e-9)

    o = origin.to(device=dev, dtype=f32)
    d = directions.to(f32)
    px = o[0].expand(n).clone()
    py = o[1].expand(n).clone()
    pz = o[2].expand(n).clone()
    vx, vy, vz = d[:, 0].clone(), d[:, 1].clone(), d[:, 2].clone()
    # L = dir x pos, conserved along the ray.
    lx = vy * pz - vz * py
    ly = vz * px - vx * pz
    lz = vx * py - vy * px
    neg15_l2 = -1.5 * (lx * lx + ly * ly + lz * lz)
    affine = torch.zeros(n, dtype=f32, device=dev)
    hc = torch.zeros(n, dtype=torch.int32, device=dev)  # live rays' counts
    ids = torch.arange(n, device=dev)  # live rays' indices

    captured = torch.zeros(n, dtype=torch.bool, device=dev)
    escaped = torch.zeros(n, dtype=torch.bool, device=dev)
    escape_dir = torch.zeros((n, 3), dtype=f32, device=dev)
    hit_count = torch.zeros(n, dtype=torch.int32, device=dev)
    hits = torch.zeros((max_crossings, HIT_FEATURES, n), dtype=f32, device=dev)

    def accel_factor(x, y, z, nl2):
        r2 = x * x + y * y + z * z
        r5 = r2 * r2 * torch.sqrt(r2)
        return nl2 / r5

    for _ in range(k.max_iter):
        if ids.numel() == 0:
            break
        r = torch.sqrt(px * px + py * py + pz * pz)
        r_safe = torch.clamp(r, min=k.r_floor)
        far = torch.clamp(torch.sqrt(r_safe / rs_t), max=10.0)
        q = rs_t / r_safe
        near = one / (1.0 + 2.0 * (q * q * q))
        h = k.h_base * torch.clamp(far * near, 0.2, 10.0)

        f1 = accel_factor(px, py, pz, neg15_l2)
        k1px, k1py, k1pz = h * vx, h * vy, h * vz
        k1dx, k1dy, k1dz = h * (f1 * px), h * (f1 * py), h * (f1 * pz)
        k2px = h * (vx + 0.5 * k1dx)
        k2py = h * (vy + 0.5 * k1dy)
        k2pz = h * (vz + 0.5 * k1dz)
        s2x, s2y, s2z = px + 0.5 * k1px, py + 0.5 * k1py, pz + 0.5 * k1pz
        f2 = accel_factor(s2x, s2y, s2z, neg15_l2)
        k2dx, k2dy, k2dz = h * (f2 * s2x), h * (f2 * s2y), h * (f2 * s2z)
        k3px = h * (vx + 0.5 * k2dx)
        k3py = h * (vy + 0.5 * k2dy)
        k3pz = h * (vz + 0.5 * k2dz)
        s3x, s3y, s3z = px + 0.5 * k2px, py + 0.5 * k2py, pz + 0.5 * k2pz
        f3 = accel_factor(s3x, s3y, s3z, neg15_l2)
        k3dx, k3dy, k3dz = h * (f3 * s3x), h * (f3 * s3y), h * (f3 * s3z)
        k4px, k4py, k4pz = h * (vx + k3dx), h * (vy + k3dy), h * (vz + k3dz)
        s4x, s4y, s4z = px + k3px, py + k3py, pz + k3pz
        f4 = accel_factor(s4x, s4y, s4z, neg15_l2)
        k4dx, k4dy, k4dz = h * (f4 * s4x), h * (f4 * s4y), h * (f4 * s4z)

        npx = px + (k1px + 2.0 * k2px + 2.0 * k3px + k4px) / six
        npy = py + (k1py + 2.0 * k2py + 2.0 * k3py + k4py) / six
        npz = pz + (k1pz + 2.0 * k2pz + 2.0 * k3pz + k4pz) / six
        nvx = vx + (k1dx + 2.0 * k2dx + 2.0 * k3dx + k4dx) / six
        nvy = vy + (k1dy + 2.0 * k2dy + 2.0 * k3dy + k4dy) / six
        nvz = vz + (k1dz + 2.0 * k2dz + 2.0 * k3dz + k4dz) / six

        # r^2-space termination tests, as in the kernel.
        nr2 = npx * npx + npy * npy + npz * npz
        affine_new = affine + h
        captured_now = nr2 < k.rs2
        escaped_now = ~captured_now & ((nr2 > k.r_escape2)
                                       | (affine_new > k.max_affine))
        survive = ~(captured_now | escaped_now)

        captured[ids[captured_now]] = True
        if bool(escaped_now.any()):
            sel = ids[escaped_now]
            ex, ey, ez = nvx[escaped_now], nvy[escaped_now], nvz[escaped_now]
            norm = torch.clamp(torch.sqrt(ex * ex + ey * ey + ez * ez),
                               min=min_norm)
            escaped[sel] = True
            escape_dir[sel] = torch.stack([ex / norm, ey / norm, ez / norm], 1)

        # Tilted-plane crossing test on the surviving segment (the
        # reference breaks on capture/escape before the disk test).
        f_old = pz - py * k.tan_t
        f_new = npz - npy * k.tan_t
        crossing = survive & (f_old * f_new < 0)
        if bool(crossing.any()):
            t_frac = f_old / (f_old - f_new + eps_t)
            hx = px + t_frac * (npx - px)
            hy = py + t_frac * (npy - py)
            hr2 = hx * hx + hy * hy
            record = (crossing & (hr2 >= k.r_in2) & (hr2 <= k.r_out2)
                      & (hc < max_crossings))
            feats = torch.stack([hx, hy, vx, vy, vz, t_frac], dim=0)
            for slot in range(max_crossings):
                m = record & (hc == slot)
                if bool(m.any()):
                    sel = ids[m]
                    hits[slot, 0:5, sel] = feats[0:5, m]
                    hits[slot, 11, sel] = feats[5, m]
            hc = hc + record.to(torch.int32)
            hit_count[ids[record]] = hc[record]

        keep = survive.nonzero().squeeze(1)
        if keep.numel() < ids.numel():
            ids = ids[keep]
            (px, py, pz, vx, vy, vz, affine, hc, neg15_l2) = (
                npx[keep], npy[keep], npz[keep], nvx[keep], nvy[keep],
                nvz[keep], affine_new[keep], hc[keep], neg15_l2[keep])
        else:
            px, py, pz, vx, vy, vz, affine = npx, npy, npz, nvx, nvy, nvz, affine_new

    return TraceResult(captured, escaped, escape_dir, hit_count, hits)
