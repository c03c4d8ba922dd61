"""How far two traces of the same rays differ, and the tolerances the
ray-march kernel is held to against its plain version.

The kernel (``csrc/ray_march.cu``) fuses multiply-adds into FMAs and
takes its rsqrt from the MUFU unit; the plain version
(``geodesic.trace_geodesics``) rounds every operation on its own. Both
compute ``bhr_tpu``'s Pallas kernel's formulas, so they differ by
rounding as that kernel differs from ``bhr_tpu``'s pure-JAX tracer.
``tests/unit/test_pallas_parity.py`` holds those two to exact
categories and step counts, 2e-3 on the escape direction and the hit
position (features 0, 1) and 5e-3 on the differentials, at 128x32 and
128x48 scenes. The checks here keep those bounds and add what a frame
of millions of rays and a stricter differential check need; what is
new to the port is marked so:

* **categories** (captured, escaped, hit_count) and **step counts**:
  exact at the small parity scenes, as there. New to the port: larger
  frames allow a fraction ``TOL_FLIP_FRAC`` (0.1%) of rays to flip or
  change their step count. A ray that grazes the horizon, the escape
  sphere or the disk rim changes category on an ulp, and a frame of 2 M
  rays has some (a few per 10^5 at 1920x1080);
* **escape direction and hit features 0..4** (position on the disk and
  direction, of order 1): ``TOL_FLOAT`` (2e-3) on the rays that agree;
  features 2..4 are new to the port. New to the port: at full frame
  size a ray near the photon ring amplifies an ulp over its orbit into
  a difference of order 1; such rays are counted with the flips toward
  the 0.1%, so the largest difference reported there may be large;
* **differentials** (features 5..10, of the order of a pixel's angle,
  ~1e-3): ``TOL_DIFF`` (5e-3, ``bhr_tpu``'s own bound) absolute. New to
  the port, and stricter: the 99th percentile of the relative
  difference over slots whose value is above ``DIFF_FLOOR`` (1e-6) at
  most ``TOL_DIFF_REL_P99`` (1e-3), on the agreeing rays that no
  absolute tolerance counts as an outlier. An absolute 5e-3 on values
  of ~1e-3 would pass differentials that were swapped or
  mistransported; the relative bound does not (``swap_differentials``
  is the negative control);
* **t_frac** (feature 11): ``TOL_FLOAT``, new to the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .geodesic import TraceResult

TOL_FLIP_FRAC = 1e-3
TOL_FLOAT = 2e-3
TOL_DIFF = 5e-3
TOL_DIFF_REL_P99 = 1e-3
DIFF_FLOOR = 1e-6


class TraceDiff(NamedTuple):
    """Differences of a trace from a reference trace of the same rays."""

    n_rays: int
    flips: int  # rays whose captured, escaped or hit_count differ
    steps_differ: int  # rays with the same category and another step count
    over: int  # agreeing rays with a float output over its tolerance
    float_err: float  # largest on agreeing rays: escape_dir, features 0..4
    diff_err: float  # largest on agreeing rays: features 5..10
    diff_rel_p99: float  # p99 relative difference of features 5..10,
    # over agreeing rays within the absolute tolerances
    tfrac_err: float  # largest on agreeing rays: feature 11


class _Rays(NamedTuple):
    flip: torch.Tensor  # (N,) bool: category differs
    stepped: torch.Tensor  # (N,) bool: same category, another step count
    over: torch.Tensor  # (N,) bool: agreeing, a float over its tolerance
    pos: torch.Tensor  # (N,) largest diff of escape_dir, features 0..4
    diff: torch.Tensor  # (N,) largest diff of features 5..10
    tfrac: torch.Tensor  # (N,) diff of feature 11


def _rays(got: TraceResult, ref: TraceResult, n_feat: int) -> _Rays:
    flip = ((got.captured != ref.captured) | (got.escaped != ref.escaped)
            | (got.hit_count != ref.hit_count))
    stepped = torch.zeros_like(flip)
    if got.steps is not None and ref.steps is not None:
        stepped = ~flip & (got.steps != ref.steps)
    d = (got.hits[:, :n_feat] - ref.hits[:, :n_feat]).abs()  # (K, F, N)
    zero = torch.zeros_like(flip, dtype=d.dtype)
    pos = torch.maximum((got.escape_dir - ref.escape_dir).abs().amax(1),
                        d[:, :5].amax(dim=(0, 1)))
    diff = d[:, 5:11].amax(dim=(0, 1)) if n_feat > 5 else zero
    tfrac = d[:, 11].amax(0) if n_feat > 11 else zero
    over = ~(flip | stepped) & ((pos > TOL_FLOAT) | (diff > TOL_DIFF)
                                | (tfrac > TOL_FLOAT))
    return _Rays(flip, stepped, over, pos, diff, tfrac)


def inlier_rays(got: TraceResult, ref: TraceResult,
                n_feat: int = 12) -> torch.Tensor:
    """(N,) bool: the rays whose category and step count agree and whose
    floats are within the absolute tolerances."""
    r = _rays(got, ref, n_feat)
    return ~(r.flip | r.stepped | r.over)


def diff_rel_p99(got: TraceResult, ref: TraceResult,
                 slots: torch.Tensor) -> float:
    """99th percentile of |got - ref| / |ref| over the differential
    slots (features 5..10, a (K, 6, N) bool mask) that ``slots`` selects
    and whose reference value is above ``DIFF_FLOOR``; 0.0 over none."""
    size = ref.hits[:, 5:11].abs()
    sel = slots & (size > DIFF_FLOOR)
    rel = (got.hits[:, 5:11][sel] - ref.hits[:, 5:11][sel]).abs() / size[sel]
    return p99(rel)


def p99(x: torch.Tensor) -> float:
    """The 99th percentile of ``x`` (the value at rank ceil(0.99 n)); 0.0
    for an empty ``x``."""
    if not x.numel():
        return 0.0
    rank = max(1, math.ceil(0.99 * x.numel()))
    return float(torch.kthvalue(x.flatten().cpu(), rank).values)


def compare_traces(got: TraceResult, ref: TraceResult,
                   n_feat: int = 12) -> TraceDiff:
    """Compare ``got`` to ``ref`` over hit features ``0..n_feat-1``. A
    ray agrees when its category and (where both traces count them) its
    step count are equal; float differences are taken on agreeing rays
    only, and the differentials' relative difference on those of them
    that no absolute tolerance counts as an outlier."""
    r = _rays(got, ref, n_feat)
    agree = ~(r.flip | r.stepped)
    p99 = 0.0
    if n_feat > 5:
        inliers = (agree & ~r.over).expand(got.hits.shape[0], 6, -1)
        p99 = diff_rel_p99(got, ref, inliers)

    def largest(x):
        return float(x[agree].max()) if bool(agree.any()) else 0.0

    return TraceDiff(
        n_rays=r.flip.numel(), flips=int(r.flip.sum()),
        steps_differ=int(r.stepped.sum()), over=int(r.over.sum()),
        float_err=largest(r.pos), diff_err=largest(r.diff), diff_rel_p99=p99,
        tfrac_err=largest(r.tfrac))


def failures(d: TraceDiff, *, exact: bool, outliers_allowed: bool) -> list:
    """What ``d`` breaks of the tolerances above, as messages (none:
    within them). ``exact``: no ray may flip or change its step count
    (the parity scenes); else at most ``TOL_FLIP_FRAC`` of the rays.
    ``outliers_allowed``: agreeing rays over a float tolerance count with
    the flips toward that fraction (a full-size frame); else there may
    be none."""
    bad = d.flips + d.steps_differ + (d.over if outliers_allowed else 0)
    out = []
    if exact and d.flips + d.steps_differ:
        out.append(f"{d.flips} rays flip, {d.steps_differ} change step count")
    if bad > TOL_FLIP_FRAC * d.n_rays:
        out.append(f"{bad} of {d.n_rays} rays flip, change step count"
                   + (" or exceed a float tolerance" if outliers_allowed else "")
                   + f" (limit {TOL_FLIP_FRAC:.1%})")
    if d.over and not outliers_allowed:
        out.append(f"{d.over} agreeing rays over a float tolerance: escape "
                   f"dir / features 0..4 {d.float_err:.3e} (tol {TOL_FLOAT}), "
                   f"differentials {d.diff_err:.3e} (tol {TOL_DIFF}), t_frac "
                   f"{d.tfrac_err:.3e} (tol {TOL_FLOAT})")
    if d.diff_rel_p99 > TOL_DIFF_REL_P99:
        out.append(f"differentials' p99 relative difference {d.diff_rel_p99:.3e} "
                   f"> {TOL_DIFF_REL_P99}")
    return out


def swap_differentials(trace: TraceResult) -> TraceResult:
    """``trace`` with the x and y differentials (features 5..7 and 8..10)
    swapped: a wrong trace the differential checks must reject."""
    hits = trace.hits.clone()
    hits[:, 5:8], hits[:, 8:11] = trace.hits[:, 8:11], trace.hits[:, 5:8]
    return trace._replace(hits=hits)
