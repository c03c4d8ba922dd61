"""The CUDA ray-march kernel vs its plain PyTorch version, on the card.

Marked ``cuda``: the kernel has no CPU mode, so these tests skip on a
host without a GPU (decided inside the test, never at import). On a GPU
machine run them with ``python -m pytest tests/unit/test_torch_kernel.py``;
``chip_smoke.py`` makes the same check at the main path's shapes.

The kernel fuses multiply-adds and takes rsqrt from the MUFU unit, its
plain version does neither, so the two are held to the tolerances of
``bhr_tpu_torch.ops.trace_compare`` (``test_pallas_parity.py``'s bounds
for ``bhr_tpu``'s Pallas kernel and the port's own additions, with their
reasons, in that module's docstring). At these parity scenes:
categorical outputs (captured, escaped, hit_count) and step counts
exactly equal; escape direction and hit features 0..4 (position and
direction, of order 1) within 2e-3; the AA differentials (features
5..10, ~1e-3) within 5e-3 with a p99 relative difference of at most
1e-3 over values above 1e-6, and the same check fed the kernel's trace
with its x and y differentials swapped must fail (the negative
control); t_frac (feature 11) within 2e-3. The slim variant's feature 11
is 0 in the kernel (as in the Pallas slim kernel) and t_frac in the
plain version (as in bhr_tpu's pure-JAX tracer), so it is left out; the
slim and no-disk kernels leave 5..11 zero, and the no-disk variant's
hits are all zero. A row band of every instantiation must equal those
rows of the full-frame kernel trace exactly (the same per-ray code),
and the plain band within the tolerances above.
"""

import pytest
import torch

from bhr_tpu_torch.camera import build_camera
from bhr_tpu_torch.ops.geodesic import (
    primary_differentials_from_params,
    primary_rays_from_params,
    trace_geodesics,
)
from bhr_tpu_torch.ops.geodesic_cuda import (
    camera_params,
    kernel_name,
    trace_geodesics_cuda,
)
from bhr_tpu_torch.ops.trace_compare import (
    compare_traces,
    failures,
    swap_differentials,
)

VARIANTS = {
    "slim": {},
    "aa": {"with_differentials": True},
    "nodisk": {"record_hits": False},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ray-march kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("w,h,tilt", [(128, 32, 15.0), (128, 48, 40.0)])
def test_kernel_matches_plain_version(cuda_device, w, h, tilt, variant, steps):
    cam = torch.as_tensor(camera_params(build_camera([6.0, 0.0, 0.5], 60.0, w, h)),
                          device=cuda_device)
    kw = dict(h_base=0.2, r_escape=12.04, tilt_deg=tilt, r_inner=2.0, r_outer=3.5,
              record_step_counts=steps, **VARIANTS[variant])
    name = kernel_name(with_differentials=kw.get("with_differentials", False),
                       record_hits=kw.get("record_hits", True),
                       record_step_counts=steps)
    before = dict(trace_geodesics_cuda.launches)
    kernel = trace_geodesics_cuda(cam, width=w, height=h, **kw)
    torch.cuda.synchronize()
    assert trace_geodesics_cuda.launches[name] == before[name] + 1
    assert sum(trace_geodesics_cuda.launches.values()) == sum(before.values()) + 1

    dirs = primary_rays_from_params(cam, w, h)
    ddx, ddy = primary_differentials_from_params(cam, w, h)
    plain = trace_geodesics(cam[0:3], dirs, d_dir_dx0=ddx, d_dir_dy0=ddy, **kw)
    n_feat = 11 if variant == "slim" else 12
    diff = compare_traces(kernel, plain, n_feat)
    assert failures(diff, exact=True, outliers_allowed=False) == [], diff
    if variant == "aa":
        assert diff.diff_rel_p99 > 0.0  # the differentials were compared
        control = compare_traces(swap_differentials(kernel), plain)
        assert failures(control, exact=True, outliers_allowed=False), control
    else:
        assert bool((kernel.hits[:, 5:] == 0).all())
    if variant == "nodisk":
        assert not bool(kernel.hits.any()) and not bool(kernel.hit_count.any())
    assert (kernel.steps is not None) == steps


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_band_kernel_matches_full_frame_and_plain(cuda_device, variant, steps):
    """A row band of the kernel equals those rows of the full-frame kernel
    trace exactly (0 flips, 0.0 difference, equal steps) and the plain
    band within the parity scenes' tolerances; the slim plain version's
    t_frac at feature 11 is left out."""
    w, h, row_start, rows = 128, 48, 16, 16
    cam = torch.as_tensor(camera_params(build_camera([6.0, 0.0, 0.5], 60.0, w, h)),
                          device=cuda_device)
    kw = dict(h_base=0.2, r_escape=12.04, tilt_deg=40.0, r_inner=2.0, r_outer=3.5,
              record_step_counts=steps, **VARIANTS[variant])
    name = kernel_name(with_differentials=kw.get("with_differentials", False),
                       record_hits=kw.get("record_hits", True),
                       record_step_counts=steps)
    before = dict(trace_geodesics_cuda.launches)
    full = trace_geodesics_cuda(cam, width=w, height=h, **kw)
    band = trace_geodesics_cuda(cam, row_start, row_count=rows, width=w, height=h,
                                **kw)
    torch.cuda.synchronize()
    assert trace_geodesics_cuda.launches[name] == before[name] + 2
    assert band.captured.shape == (rows * w,)

    dirs = primary_rays_from_params(cam, w, h, row_start, rows)
    ddx, ddy = primary_differentials_from_params(cam, w, h, row_start, rows)
    plain = trace_geodesics(cam[0:3], dirs, d_dir_dx0=ddx, d_dir_dy0=ddy, **kw)
    sel = slice(row_start * w, (row_start + rows) * w)
    n_feat = 11 if variant == "slim" else 12
    for field in ("captured", "escaped", "escape_dir", "hit_count", "steps"):
        got = getattr(band, field)
        if got is None:
            assert not steps and getattr(full, field) is None
            continue
        assert torch.equal(got, getattr(full, field)[sel]), field
    assert torch.equal(band.hits, full.hits[:, :, sel])
    diff = compare_traces(band, plain, n_feat)
    assert failures(diff, exact=True, outliers_allowed=False) == [], diff
