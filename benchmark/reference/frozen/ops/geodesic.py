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
CPU path and the oracle the kernel is checked against on the card. Both
compute what ``bhr_tpu``'s Pallas kernel computes, divide-free: one
rsqrt per RK4 stage gives r^-5 and r^-2, the adaptive step takes
rs/r as rs * min(rsqrt(r^2), 1/(rs + 1e-3)), the updates multiply by
1/6, rays and escape directions are normalised by x * rsqrt(|x|^2 +
1e-18), and reciprocals remain only for the step's ``near`` factor and a
crossing's t_frac. The initial differentials are the Pallas kernel's
one-pixel direction deltas, written without its subtraction of two unit
vectors (:func:`primary_differentials_from_params`). The kernel fuses multiply-adds and this version does
not, so the two agree to tolerances (``trace_compare``), not bit for
bit. Every sum of squares and dot product is written
x*x + y*y + z*z, in the kernel's order.

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
    exactly as ``bhr_tpu`` derives them (squares, reciprocals,
    40 * r_escape and tan(tilt) in double). Each is rounded to float32
    once: where it meets a float32 tensor in the plain version, by
    ``ctypes.c_float`` for the kernel — the same rounding either way."""

    h_base: float
    rs: float
    r_floor: float  # rs + 1e-3, the adaptive step's clamp
    inv_rs: float  # 1 / rs
    inv_r_floor: float  # 1 / (rs + 1e-3)
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
        h_base=float(h_base), rs=float(rs), r_floor=rs + 1e-3,
        inv_rs=1.0 / rs, inv_r_floor=1.0 / (rs + 1e-3), rs2=rs * rs,
        r_escape2=r_escape * r_escape, max_affine=max_affine,
        tan_t=math.tan(math.radians(tilt_deg)),
        r_in2=r_inner * r_inner, r_out2=r_outer * r_outer,
        # Derived from max_affine so the iteration budget and the affine
        # cap can never desynchronize.
        max_iter=int(max_affine / h_base),
    )


def _normalize3(x, y, z):
    """x * rsqrt(|x|^2 + 1e-18) per component (the Pallas kernel's
    ``_normalize3``)."""
    inv = torch.rsqrt(x * x + y * y + z * z + 1e-18)
    return x * inv, y * inv, z * inv


def _stage(x, y, z, neg15_l2):
    """(1/r, -1.5 L^2 / r^5, 1/r^2) at a stage position, from one rsqrt."""
    ir = torch.rsqrt(x * x + y * y + z * z)
    inv_r2 = ir * ir
    return ir, neg15_l2 * (inv_r2 * inv_r2 * ir), inv_r2


def _image_plane(cam_params: torch.Tensor, width: int, height: int,
                 row_start: int = 0, row_count: Optional[int] = None):
    """((dx, dy, dz), c): the unnormalised rays from the camera through
    the pixel centres of rows [row_start, row_start + R) of the frame, R
    = ``row_count`` (default: all ``height`` rows), each (R, W); and the
    14 camera floats as float32.

    Same image-plane arithmetic as the kernel (and the Pallas kernel):
    plane 1 unit ahead, y down, the top-left corner computed in float32
    from the 14 camera floats and the full frame's ``height``, so a band
    gets the same rays as those rows of the whole frame.
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
    a = (px + 0.5) * pw
    b = (py + 0.5) * ph
    return (tlx + a * rx - b * ux - cx, tly + a * ry - b * uy - cy,
            tlz + a * rz - b * uz - cz), c


def primary_rays_from_params(cam_params: torch.Tensor, width: int,
                             height: int, row_start: int = 0,
                             row_count: Optional[int] = None) -> torch.Tensor:
    """(R*W, 3) unit primary ray directions (pixel centers at +0.5),
    row-major (y, x) pixels of rows [row_start, row_start + R) of the
    ``width`` x ``height`` frame (R = ``row_count``, default all rows),
    normalised by :func:`_normalize3`."""
    v, _ = _image_plane(cam_params, width, height, row_start, row_count)
    return torch.stack(_normalize3(*v), dim=-1).reshape(-1, 3)


SIXTH = 1.0 / 6.0


def _diff_rk4(h, stages, dp, dd):
    """One RK4 step of a ray differential (d_pos, d_dir) at the main
    ray's stage positions: d'' = J(s) d = f (d - 5 s (s.d) / r^2), with
    each stage's own factor f and 1/r^2 (``bhr_tpu`` geodesic.py:119-133,
    in geodesic_pallas.py:340-383's divide-free form)."""

    def jac(stage, d):
        s, f, inv_r2 = stage
        proj = (s[0] * d[0] + s[1] * d[1] + s[2] * d[2]) * inv_r2
        return [h * (f * (d[c] - 5.0 * s[c] * proj)) for c in range(3)]

    q1p = [h * dd[c] for c in range(3)]
    q1d = jac(stages[0], dp)
    q2p = [h * (dd[c] + 0.5 * q1d[c]) for c in range(3)]
    q2d = jac(stages[1], [dp[c] + 0.5 * q1p[c] for c in range(3)])
    q3p = [h * (dd[c] + 0.5 * q2d[c]) for c in range(3)]
    q3d = jac(stages[2], [dp[c] + 0.5 * q2p[c] for c in range(3)])
    q4p = [h * (dd[c] + q3d[c]) for c in range(3)]
    q4d = jac(stages[3], [dp[c] + q3p[c] for c in range(3)])
    ndp = [dp[c] + (q1p[c] + 2.0 * q2p[c] + 2.0 * q3p[c] + q4p[c]) * SIXTH
           for c in range(3)]
    ndd = [dd[c] + (q1d[c] + 2.0 * q2d[c] + 2.0 * q3d[c] + q4d[c]) * SIXTH
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

    for it in range(k.max_iter):
        if ids.numel() == 0:
            break
        # r-adaptive step, divide-free with stage 1's rsqrt, and stage 1
        # (geodesic_pallas.py:284-294).
        ir1, f1, i1 = _stage(px, py, pz, neg15_l2)
        r = torch.sqrt(px * px + py * py + pz * pz)
        r_safe = torch.clamp(r, min=k.r_floor)
        far = torch.clamp(torch.sqrt(r_safe * k.inv_rs), max=10.0)
        q = k.rs * torch.clamp(ir1, max=k.inv_r_floor)
        near = torch.reciprocal(1.0 + 2.0 * (q * q * q))
        h = k.h_base * torch.clamp(far * near, 0.2, 10.0)

        k1px, k1py, k1pz = h * vx, h * vy, h * vz
        k1dx, k1dy, k1dz = h * (f1 * px), h * (f1 * py), h * (f1 * pz)
        k2px = h * (vx + 0.5 * k1dx)
        k2py = h * (vy + 0.5 * k1dy)
        k2pz = h * (vz + 0.5 * k1dz)
        s2x, s2y, s2z = px + 0.5 * k1px, py + 0.5 * k1py, pz + 0.5 * k1pz
        _, f2, i2 = _stage(s2x, s2y, s2z, neg15_l2)
        k2dx, k2dy, k2dz = h * (f2 * s2x), h * (f2 * s2y), h * (f2 * s2z)
        k3px = h * (vx + 0.5 * k2dx)
        k3py = h * (vy + 0.5 * k2dy)
        k3pz = h * (vz + 0.5 * k2dz)
        s3x, s3y, s3z = px + 0.5 * k2px, py + 0.5 * k2py, pz + 0.5 * k2pz
        _, f3, i3 = _stage(s3x, s3y, s3z, neg15_l2)
        k3dx, k3dy, k3dz = h * (f3 * s3x), h * (f3 * s3y), h * (f3 * s3z)
        k4px, k4py, k4pz = h * (vx + k3dx), h * (vy + k3dy), h * (vz + k3dz)
        s4x, s4y, s4z = px + k3px, py + k3py, pz + k3pz
        _, f4, i4 = _stage(s4x, s4y, s4z, neg15_l2)
        k4dx, k4dy, k4dz = h * (f4 * s4x), h * (f4 * s4y), h * (f4 * s4z)

        npx = px + (k1px + 2.0 * k2px + 2.0 * k3px + k4px) * SIXTH
        npy = py + (k1py + 2.0 * k2py + 2.0 * k3py + k4py) * SIXTH
        npz = pz + (k1pz + 2.0 * k2pz + 2.0 * k3pz + k4pz) * SIXTH
        nvx = vx + (k1dx + 2.0 * k2dx + 2.0 * k3dx + k4dx) * SIXTH
        nvy = vy + (k1dy + 2.0 * k2dy + 2.0 * k3dy + k4dy) * SIXTH
        nvz = vz + (k1dz + 2.0 * k2dz + 2.0 * k3dz + k4dz) * SIXTH

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
            escaped[sel] = True
            escape_dir[sel] = torch.stack(_normalize3(
                nvx[escaped_now], nvy[escaped_now], nvz[escaped_now]), 1)
        if steps is not None:
            steps[ids[~survive]] = it + 1

        new_diff = []
        if diffs:
            stages = (((px, py, pz), f1, i1), ((s2x, s2y, s2z), f2, i2),
                      ((s3x, s3y, s3z), f3, i3), ((s4x, s4y, s4z), f4, i4))
            for a in (0, 6):  # the x and the y differential
                ndp, ndd = _diff_rk4(h, stages, diff[a:a + 3],
                                     diff[a + 3:a + 6])
                new_diff += ndp + ndd

        # Tilted-plane crossing test on the surviving segment (the
        # reference breaks on capture/escape before the disk test).
        if record_hits:
            f_old = pz - py * k.tan_t
            f_new = npz - npy * k.tan_t
            crossing = survive & (f_old * f_new < 0)
        if record_hits and bool(crossing.any()):
            t_frac = f_old * torch.reciprocal(f_old - f_new + 1e-8)
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
