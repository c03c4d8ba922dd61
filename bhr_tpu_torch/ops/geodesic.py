"""Null-geodesic integration around a Schwarzschild black hole (plain torch).

The port of ``bhr_tpu/ops/geodesic.py``: the Cartesian
equivalent-potential photon equation d^2 x / dlambda^2 =
-1.5 * L^2 * x / r^5 with conserved L^2 = |dir x pos|^2, integrated by
RK4 with an r-adaptive step; disk-plane crossings are recorded into a
fixed (K, 12, N) hit buffer for deferred shading. For anti-aliasing,
two ray differentials (one per pixel axis) ride along, transported by
the acceleration's Jacobian at the main ray's four RK4 stage positions.

This is the plain version of the ray-march kernel
(``geodesic_cuda.trace_geodesics_cuda``, ``csrc/ray_march.cu``): a
lock-step masked loop over all rays that runs on any device. It is the
CPU path and the oracle the kernel is checked against on the card, so
its arithmetic follows the kernel's operation order exactly:

  * every sum of squares and dot product is written x*x + y*y + z*z
    (never a reduction, whose order is unspecified);
  * every division divides by a tensor on the same device: PyTorch's
    CUDA division by a CPU scalar multiplies by its reciprocal instead,
    which rounds differently from the kernel's ``/``.

Rays that terminated are dropped from the working set (compaction):
their state is frozen in the masked formulation anyway, so results are
identical and the loop's cost follows the live rays only.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..constants import MAX_DISK_CROSSINGS, RS

# Hit-record feature layout along axis 1 of `hits` (K, HIT_FEATURES, N):
#   0:2   hit_x, hit_y          (world xy on the tilted disk plane)
#   2:5   ray direction at the crossing step (pre-step, points away from cam)
#   5:8   d(pos)/d(pixel_x) at the crossing (with_differentials; else 0)
#   8:11  d(pos)/d(pixel_y) at the crossing
#   11    t_frac within the step (diagnostics). This plain version writes
#         it in every hit-recording variant, as bhr_tpu's pure-JAX tracer
#         does; the slim kernel writes 0, as the Pallas slim kernel does.
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
    # (N,) int32 RK4 steps each ray was active for, the terminating step
    # included (record_step_counts=True); None otherwise.
    steps: Optional[torch.Tensor] = None


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


def _image_plane_rays(cam_params: torch.Tensor, width: int, height: int,
                      x_off: float, y_off: float, row_start: int = 0,
                      row_count: Optional[int] = None) -> torch.Tensor:
    """(R*W, 3) unit rays through pixel (col + x_off, row + y_off) for
    the rows [row_start, row_start + R) of the frame, R = ``row_count``
    (default: all ``height`` rows).

    Same image-plane arithmetic as the kernel (and the Pallas kernel):
    plane 1 unit ahead, y down, the top-left corner computed in float32
    from the 14 camera floats and the full frame's ``height``, so a band
    gets the same rays as those rows of the whole frame; the
    normalization divides by the correctly rounded norm.
    """
    if row_count is None:
        row_count = height
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
    # Integer rows below 2**24 are exact in float32, as the kernel's
    # float(y + row0) is.
    py = torch.arange(row_start, row_start + row_count, dtype=torch.float32,
                      device=dev)[:, None]
    a = (px + x_off) * pw
    b = (py + y_off) * ph
    dx = tlx + a * rx - b * ux - cx
    dy = tly + a * ry - b * uy - cy
    dz = tlz + a * rz - b * uz - cz
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    d = torch.stack([dx / norm, dy / norm, dz / norm], dim=-1)
    return d.reshape(-1, 3)


def primary_rays_from_params(cam_params: torch.Tensor, width: int,
                             height: int, row_start: int = 0,
                             row_count: Optional[int] = None) -> torch.Tensor:
    """(R*W, 3) unit primary ray directions (pixel centers at +0.5),
    row-major (y, x) pixels of rows [row_start, row_start + R) of the
    ``width`` x ``height`` frame (R = ``row_count``, default all rows)."""
    return _image_plane_rays(cam_params, width, height, 0.5, 0.5,
                             row_start, row_count)


def primary_differentials_from_params(cam_params: torch.Tensor, width: int,
                                      height: int, d0: torch.Tensor,
                                      row_start: int = 0,
                                      row_count: Optional[int] = None):
    """(d_dir_dx0, d_dir_dy0), each (R*W, 3): the one-pixel direction
    deltas normalize(ray at +1.5, +0.5) - d0 and likewise in y, with
    ``d0`` from :func:`primary_rays_from_params` over the same rows (the
    Pallas kernel's formula, ``geodesic_pallas.py:188-191``)."""
    ddx = _image_plane_rays(cam_params, width, height, 1.5, 0.5,
                            row_start, row_count) - d0
    ddy = _image_plane_rays(cam_params, width, height, 0.5, 1.5,
                            row_start, row_count) - d0
    return ddx, ddy


def _diff_rk4(h, stages, dp, dd, six):
    """One RK4 step of a ray differential (d_pos, d_dir) at the main
    ray's stage positions: d'' = J(s) d = f (d - 5 s (s.d) / r^2), with
    each stage's own factor f and r^2 (``bhr_tpu`` geodesic.py:119-133)."""

    def jac(stage, d):
        s, f, r2 = stage
        proj = (s[0] * d[0] + s[1] * d[1] + s[2] * d[2]) / r2
        return [h * (f * (d[c] - 5.0 * s[c] * proj)) for c in range(3)]

    q1p = [h * dd[c] for c in range(3)]
    q1d = jac(stages[0], dp)
    q2p = [h * (dd[c] + 0.5 * q1d[c]) for c in range(3)]
    q2d = jac(stages[1], [dp[c] + 0.5 * q1p[c] for c in range(3)])
    q3p = [h * (dd[c] + 0.5 * q2d[c]) for c in range(3)]
    q3d = jac(stages[2], [dp[c] + 0.5 * q2p[c] for c in range(3)])
    q4p = [h * (dd[c] + q3d[c]) for c in range(3)]
    q4d = jac(stages[3], [dp[c] + q3p[c] for c in range(3)])
    ndp = [dp[c] + (q1p[c] + 2.0 * q2p[c] + 2.0 * q3p[c] + q4p[c]) / six
           for c in range(3)]
    ndd = [dd[c] + (q1d[c] + 2.0 * q2d[c] + 2.0 * q3d[c] + q4d[c]) / six
           for c in range(3)]
    return ndp, ndd


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
    d_dir_dx0: Optional[torch.Tensor] = None,
    d_dir_dy0: Optional[torch.Tensor] = None,
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
        with_differentials: transport two ray differentials and write
            them into hit features 5..10 (AA).
        d_dir_dx0 / d_dir_dy0: (N, 3) initial direction differentials,
            required with ``with_differentials``
            (:func:`primary_differentials_from_params`).
        max_crossings: hit-buffer slots per ray (front-to-back order).
        record_hits: False skips the crossing test (a scene without a
            disk); hit_count and hits stay zero.
        record_step_counts: also return each ray's step count.

    Rays that neither escape nor get captured within the iteration
    budget report neither flag (background renders black, matching the
    reference).
    """
    if with_differentials and (d_dir_dx0 is None or d_dir_dy0 is None):
        raise ValueError("differentials requested but initial deltas missing")
    # Differentials are read only where a crossing is recorded, so
    # without hit recording their transport cannot change any output.
    diffs = with_differentials and record_hits
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
    # Differential state of the live rays: d_pos_dx, d_dir_dx, d_pos_dy,
    # d_dir_dy, three components each.
    diff = []
    if diffs:
        zero = torch.zeros(n, dtype=f32, device=dev)
        ddx0 = d_dir_dx0.to(device=dev, dtype=f32)
        ddy0 = d_dir_dy0.to(device=dev, dtype=f32)
        diff = ([zero] * 3 + [ddx0[:, c].clone() for c in range(3)]
                + [zero] * 3 + [ddy0[:, c].clone() for c in range(3)])

    captured = torch.zeros(n, dtype=torch.bool, device=dev)
    escaped = torch.zeros(n, dtype=torch.bool, device=dev)
    escape_dir = torch.zeros((n, 3), dtype=f32, device=dev)
    hit_count = torch.zeros(n, dtype=torch.int32, device=dev)
    hits = torch.zeros((max_crossings, HIT_FEATURES, n), dtype=f32, device=dev)
    steps = (torch.zeros(n, dtype=torch.int32, device=dev)
             if record_step_counts else None)

    def accel_factor(x, y, z, nl2):
        """(-1.5 L^2 / r^5, r^2) at a stage position."""
        r2 = x * x + y * y + z * z
        r5 = r2 * r2 * torch.sqrt(r2)
        return nl2 / r5, r2

    for it in range(k.max_iter):
        if ids.numel() == 0:
            break
        r = torch.sqrt(px * px + py * py + pz * pz)
        r_safe = torch.clamp(r, min=k.r_floor)
        far = torch.clamp(torch.sqrt(r_safe / rs_t), max=10.0)
        q = rs_t / r_safe
        near = one / (1.0 + 2.0 * (q * q * q))
        h = k.h_base * torch.clamp(far * near, 0.2, 10.0)

        f1, r2_1 = accel_factor(px, py, pz, neg15_l2)
        k1px, k1py, k1pz = h * vx, h * vy, h * vz
        k1dx, k1dy, k1dz = h * (f1 * px), h * (f1 * py), h * (f1 * pz)
        k2px = h * (vx + 0.5 * k1dx)
        k2py = h * (vy + 0.5 * k1dy)
        k2pz = h * (vz + 0.5 * k1dz)
        s2x, s2y, s2z = px + 0.5 * k1px, py + 0.5 * k1py, pz + 0.5 * k1pz
        f2, r2_2 = accel_factor(s2x, s2y, s2z, neg15_l2)
        k2dx, k2dy, k2dz = h * (f2 * s2x), h * (f2 * s2y), h * (f2 * s2z)
        k3px = h * (vx + 0.5 * k2dx)
        k3py = h * (vy + 0.5 * k2dy)
        k3pz = h * (vz + 0.5 * k2dz)
        s3x, s3y, s3z = px + 0.5 * k2px, py + 0.5 * k2py, pz + 0.5 * k2pz
        f3, r2_3 = accel_factor(s3x, s3y, s3z, neg15_l2)
        k3dx, k3dy, k3dz = h * (f3 * s3x), h * (f3 * s3y), h * (f3 * s3z)
        k4px, k4py, k4pz = h * (vx + k3dx), h * (vy + k3dy), h * (vz + k3dz)
        s4x, s4y, s4z = px + k3px, py + k3py, pz + k3pz
        f4, r2_4 = accel_factor(s4x, s4y, s4z, neg15_l2)
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
        if steps is not None:
            steps[ids[~survive]] = it + 1

        new_diff = []
        if diffs:
            stages = (((px, py, pz), f1, r2_1), ((s2x, s2y, s2z), f2, r2_2),
                      ((s3x, s3y, s3z), f3, r2_3), ((s4x, s4y, s4z), f4, r2_4))
            for a in (0, 6):  # the x and the y differential
                ndp, ndd = _diff_rk4(h, stages, diff[a:a + 3],
                                     diff[a + 3:a + 6], six)
                new_diff += ndp + ndd

        # Tilted-plane crossing test on the surviving segment (the
        # reference breaks on capture/escape before the disk test).
        if record_hits:
            f_old = pz - py * k.tan_t
            f_new = npz - npy * k.tan_t
            crossing = survive & (f_old * f_new < 0)
        if record_hits and bool(crossing.any()):
            t_frac = f_old / (f_old - f_new + eps_t)
            hx = px + t_frac * (npx - px)
            hy = py + t_frac * (npy - py)
            hr2 = hx * hx + hy * hy
            record = (crossing & (hr2 >= k.r_in2) & (hr2 <= k.r_out2)
                      & (hc < max_crossings))
            if diffs:
                # Within-step lerp of d_pos (PARITY.md deviation 3).
                dfeat = [diff[a] + t_frac * (new_diff[a] - diff[a])
                         for a in (0, 1, 2, 6, 7, 8)]
            else:
                dfeat = [torch.zeros_like(hx)] * 6
            feats = torch.stack([hx, hy, vx, vy, vz, *dfeat, t_frac], dim=0)
            for slot in range(max_crossings):
                m = record & (hc == slot)
                if bool(m.any()):
                    hits[slot, :, ids[m]] = feats[:, m]
            hc = hc + record.to(torch.int32)
            hit_count[ids[record]] = hc[record]

        keep = survive.nonzero().squeeze(1)
        live = [npx, npy, npz, nvx, nvy, nvz, affine_new, hc, neg15_l2,
                *new_diff]
        if keep.numel() < ids.numel():
            ids = ids[keep]
            live = [x[keep] for x in live]
        (px, py, pz, vx, vy, vz, affine, hc, neg15_l2), diff = live[:9], live[9:]
    if steps is not None:
        # The loop stops early only once no ray is live, so rays live
        # here were active for the whole budget.
        steps[ids] = k.max_iter
    return TraceResult(captured, escaped, escape_dir, hit_count, hits, steps)
