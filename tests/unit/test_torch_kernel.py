"""The CUDA ray-march kernel vs its plain PyTorch version, on the card.

Marked ``cuda``: the kernel has no CPU mode, so these tests skip on a
host without a GPU (decided inside the test, never at import). On a GPU
machine run them with ``python -m pytest tests/unit/test_torch_kernel.py``;
``chip_smoke.py`` makes the same check at the main path's shapes.

The kernel is built with -fmad=false and follows the plain version's
operation order, so categorical outputs must match exactly and float
outputs within 2e-3 (they are expected to agree bit for bit).
"""

import pytest
import torch

from bhr_tpu_torch.camera import build_camera
from bhr_tpu_torch.ops.geodesic import primary_rays_from_params, trace_geodesics
from bhr_tpu_torch.ops.geodesic_cuda import camera_params, trace_geodesics_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ray-march kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,tilt", [(128, 32, 15.0), (128, 48, 40.0)])
def test_kernel_matches_plain_version(cuda_device, w, h, tilt):
    cam = torch.as_tensor(camera_params(build_camera([6.0, 0.0, 0.5], 60.0, w, h)),
                          device=cuda_device)
    kw = dict(h_base=0.2, r_escape=12.04, tilt_deg=tilt, r_inner=2.0, r_outer=3.5)
    before = trace_geodesics_cuda.launches
    kernel = trace_geodesics_cuda(cam, width=w, height=h, **kw)
    torch.cuda.synchronize()
    assert trace_geodesics_cuda.launches == before + 1
    plain = trace_geodesics(cam[0:3], primary_rays_from_params(cam, w, h), **kw)
    for name in ("captured", "escaped", "hit_count"):
        assert torch.equal(getattr(kernel, name), getattr(plain, name)), name
    torch.testing.assert_close(kernel.escape_dir, plain.escape_dir, rtol=0, atol=2e-3)
    torch.testing.assert_close(kernel.hits[:, :5], plain.hits[:, :5], rtol=0, atol=2e-3)
    assert bool((kernel.hits[:, 5:] == 0).all())
