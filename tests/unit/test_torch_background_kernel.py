"""The background-noise router (``ops/background.py``) and its CUDA kernel.

On the CPU: a CPU device runs the plain version and counts a plain pass;
a CUDA device with the kernel library stubbed launches it once per pass
(once per ``MAX_FRAMES`` frames) with the shapes, frame count, scale and
float32-rounded scalars it should get, and a failing launch raises with
no plain pass behind it; the arguments are checked before either route;
the plain version built from ``NOISE_FIELDS`` equals the formulas it was
written from, bit for bit.

Marked ``cuda`` (skips on a host without a GPU, decided inside the
test): the kernel against the plain version on the card, bit for bit on
every plane. ``chip_smoke.py`` makes the same check at the FHD and 4K
grids.
"""

import ctypes
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bhr_tpu_torch.ops import background
from bhr_tpu_torch.ops.background import (
    MAX_FRAMES,
    NOISE_FIELDS,
    KernelParams,
    generate_background_components,
    generate_background_components_plain,
    kernel_params,
)
from bhr_tpu_torch.ops.noise import fbm_3d, simplex_noise_3d
from bhr_tpu_torch.ops.shading import keplerian_omega

ARGS = (3.0, 2.7, 2.0, 15.0)  # az_freq, az_shear, r_inner, r_outer
TIMES = np.asarray([0.0, 7.3, 2.0, 2.1], np.float32)


def formulas(n_r, n_phi, az_freq, az_shear, r_inner, r_outer, t,
             generation_scale=1):
    """The pass as it was written before the coefficient table: the
    thirteen fields spelled out (CPU)."""
    f32 = torch.float32
    gr, gp = n_r // generation_scale, n_phi // generation_scale
    r = torch.arange(gr, dtype=f32)[:, None] * generation_scale / n_r
    phi = (torch.arange(gp, dtype=f32)[None, :] * generation_scale / n_phi
           * (2.0 * math.pi))
    r = r.expand(gr, gp)
    phi = phi.expand(gr, gp)
    az_freq, az_shear, r_inner, r_outer = (
        torch.tensor(v, dtype=f32) for v in (az_freq, az_shear, r_inner, r_outer))
    t = torch.as_tensor(t, dtype=f32)
    if t.ndim == 1:
        t = t[:, None, None]

    r_phys = r_inner + (r_outer - r_inner) * r
    omega = keplerian_omega(r_phys)
    phi_rot = phi + omega * t
    cx = torch.cos(phi_rot)
    cy = torch.sin(phi_rot)

    def unit(v):
        return torch.clamp(0.5 + 0.5 * v, 0.0, 1.0)

    decay = torch.pow(torch.clamp(1.0 - r, min=0.0), 1.3)
    tb_noise = unit(fbm_3d(cx * 8.0, cy * 8.0, r * 8.0 + t * 0.05, 4, 0.6, 2.0))
    temp_base = decay * (0.85 + 0.15 * tb_noise) * 0.25
    zeros = torch.zeros_like(temp_base)
    t_coarse = unit(fbm_3d(cx * 8.0, cy * 8.0, r * 4.0 + t * 0.06, 3, 0.45, 2.0)) * 0.08
    t_mid = unit(fbm_3d(cx * 24.0, cy * 24.0, r * 12.0 + t * 0.08, 4, 0.45, 2.0)) * 0.15
    t_fine = unit(fbm_3d(cx * 80.0, cy * 80.0, r * 40.0 + t * 0.1, 5, 0.45, 2.0)) * 0.25
    t_extra = unit(fbm_3d(cx * 200.0, cy * 200.0, r * 100.0 + t * 0.12, 4, 0.4, 2.0)) * 0.22
    t_ultra = unit(fbm_3d(cx * 400.0, cy * 400.0, r * 200.0 + t * 0.15, 3, 0.35, 2.0)) * 0.18
    t_pixel = torch.clamp(
        simplex_noise_3d(cx * 800.0, cy * 800.0, r * 400.0 + t * 0.2), 0.0, 1.0) * 0.12
    turb = torch.clamp(t_coarse + t_mid + t_fine + t_extra + t_ultra + t_pixel, 0.0, 1.0)
    shear = torch.pow(r, 1.2) * az_shear
    az_wave = 0.5 + 0.5 * torch.sin((phi_rot + shear) * az_freq)
    az_n = unit(fbm_3d(cx * 3.0, cy * 3.0, r * 3.0 + t * 0.04, 3, 0.5, 2.0))
    az_hotspot = az_wave * az_n
    d_coarse = unit(fbm_3d(cx * 8.0, cy * 8.0, r * 4.0 + t * 0.003, 3, 0.5, 2.0)) * 0.05
    d_mid = unit(fbm_3d(cx * 32.0, cy * 32.0, r * 16.0 + t * 0.005, 3, 0.5, 2.0)) * 0.15
    d_fine = unit(fbm_3d(cx * 100.0, cy * 100.0, r * 50.0 + t * 0.006, 4, 0.45, 2.0)) * 0.30
    d_extra = unit(fbm_3d(cx * 250.0, cy * 250.0, r * 125.0 + t * 0.008, 4, 0.4, 2.0)) * 0.30
    d_pixel = torch.clamp(
        simplex_noise_3d(cx * 500.0, cy * 500.0, r * 250.0 + t * 0.01), 0.0, 1.0) * 0.20
    disturb = torch.clamp((d_coarse + d_mid + d_fine + d_extra + d_pixel) * 1.4, 0.05, 1.0)
    disturb = torch.clamp(disturb * (0.6 + 0.4 * r), 0.1, 1.0)
    stack = torch.stack(
        [temp_base, zeros, zeros, turb, 0.05 * turb, az_hotspot, disturb], dim=-3)
    if generation_scale > 1:
        stack = stack.repeat_interleave(generation_scale, dim=-2)
        stack = stack.repeat_interleave(generation_scale, dim=-1)
    return stack


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("t", [0.0, 7.3, TIMES], ids=["t0", "t7.3", "frames"])
@pytest.mark.parametrize("scale", [1, 2, 4])
def test_the_table_gives_the_formulas_bit_for_bit(t, scale):
    got = generate_background_components_plain(32, 128, *ARGS, t, scale, "cpu")
    want = formulas(32, 128, *ARGS, t, scale)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_a_cpu_device_runs_the_plain_version_and_counts_a_plain_pass(monkeypatch):
    def no_kernel():
        raise AssertionError("the kernel library was loaded for a CPU pass")

    monkeypatch.setattr(background, "_kernel_lib", no_kernel)
    monkeypatch.setattr(generate_background_components, "launches", 0)
    monkeypatch.setattr(generate_background_components, "plain_passes", 0)
    for device in ("cpu", torch.device("cpu"), None):
        out = generate_background_components(32, 128, *ARGS, TIMES,
                                             generation_scale=2, device=device)
        assert torch.equal(out, generate_background_components_plain(
            32, 128, *ARGS, TIMES, 2, "cpu"))
    assert generate_background_components.plain_passes == 3
    assert generate_background_components.launches == 0


class FakeLib:
    """The kernel library's C interface, recording each launch's
    parameters and output pointer."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []
        self.bhr_background_noise = self.launch

    def launch(self, params, out, stream):
        self.calls.append((KernelParams.from_buffer_copy(
            (ctypes.c_char * ctypes.sizeof(KernelParams)).from_address(params)),
            out, stream))
        return self.err


@pytest.fixture
def fake_cuda(monkeypatch):
    """A CUDA device on a CPU host: the library stubbed, the output
    allocated on the CPU, the current stream a stand-in."""
    lib = FakeLib()
    real_empty = torch.empty

    def empty(*shape, device=None, **kw):
        if device is not None and torch.device(device).type == "cuda":
            device = "cpu"
        return real_empty(*shape, device=device, **kw)

    class NoDevice:
        def __init__(self, dev):
            assert torch.device(dev).type == "cuda"

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(background, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device", NoDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(generate_background_components, "launches", 0)
    monkeypatch.setattr(generate_background_components, "plain_passes", 0)
    return SimpleNamespace(lib=lib)


def _expect_params(p, n_r, n_phi, times, scale, scalars=ARGS):
    assert (p.n_r, p.n_phi, p.scale, p.frames) == (n_r, n_phi, scale, len(times))
    assert list(p.time)[:len(times)] == [float(np.float32(t)) for t in times]
    assert (p.az_freq, p.az_shear, p.r_inner, p.r_outer) == tuple(
        float(np.float32(v)) for v in scalars)
    assert p.inv_n_r == float(np.float32(1.0) / np.float32(n_r))
    assert p.inv_n_phi == float(np.float32(1.0) / np.float32(n_phi))
    for got, spec in zip(p.field, NOISE_FIELDS):
        assert (got.xy, got.r_freq, got.t_coef, got.weight) == tuple(
            float(np.float32(v)) for v in (spec.xy, spec.r_freq, spec.t_coef,
                                           spec.weight))
        assert got.octaves == spec.octaves
        # fbm_3d's amplitudes: repeated products in double, then float32.
        amplitude, want = 1.0, []
        for _ in range(spec.octaves):
            want.append(float(np.float32(amplitude)))
            amplitude *= spec.persistence
        assert list(got.amp)[:spec.octaves] == want


@pytest.mark.parametrize("t,scale,n_r,n_phi", [
    (7.3, 2, 32, 128),    # a session step
    (TIMES, 2, 48, 80),   # a card's video batch
    (TIMES, 4, 64, 256),  # a card's video batch at 4K's scale
    (0.0, 1, 32, 96),
], ids=["step", "batch", "batch-scale4", "scale1"])
def test_a_cuda_device_launches_the_kernel_once_per_pass(fake_cuda, t, scale, n_r, n_phi):
    out = generate_background_components(n_r, n_phi, *ARGS, t,
                                         generation_scale=scale, device="cuda")
    times = np.atleast_1d(np.asarray(t, np.float32))
    assert out.shape == (*np.shape(t), 7, n_r, n_phi)
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert generate_background_components.launches == 1
    assert generate_background_components.plain_passes == 0
    ((params, ptr, stream),) = fake_cuda.lib.calls
    assert ptr == out.data_ptr() and stream == 1234
    _expect_params(params, n_r, n_phi, times, scale)


def test_more_frames_than_one_launch_takes_launch_again(fake_cuda):
    times = np.arange(MAX_FRAMES + 4, dtype=np.float32) * 0.1
    out = generate_background_components(32, 128, *ARGS, times,
                                         generation_scale=2,
                                         device=torch.device("cuda", 0))
    assert out.shape == (MAX_FRAMES + 4, 7, 32, 128)
    assert generate_background_components.launches == 2
    (p0, ptr0, _), (p1, ptr1, _) = fake_cuda.lib.calls
    _expect_params(p0, 32, 128, times[:MAX_FRAMES], 2)
    _expect_params(p1, 32, 128, times[MAX_FRAMES:], 2)
    assert ptr0 == out.data_ptr()
    assert ptr1 == out[MAX_FRAMES].data_ptr()


def test_a_failing_launch_raises_and_never_falls_back(fake_cuda):
    fake_cuda.lib.err = 700
    with pytest.raises(RuntimeError, match="background_noise launch failed: cudaError 700"):
        generate_background_components(32, 128, *ARGS, TIMES,
                                       generation_scale=2, device="cuda")
    assert len(fake_cuda.lib.calls) == 1
    assert generate_background_components.launches == 0
    assert generate_background_components.plain_passes == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_bad_arguments_raise_before_either_route(fake_cuda, device):
    with pytest.raises(ValueError, match="divisible by generation_scale 3"):
        generate_background_components(32, 128, *ARGS, 0.0,
                                       generation_scale=3, device=device)
    with pytest.raises(ValueError, match="one time or a sequence"):
        generate_background_components(32, 128, *ARGS, TIMES[None],
                                       generation_scale=2, device=device)
    assert fake_cuda.lib.calls == []
    assert generate_background_components.plain_passes == 0
    with pytest.raises(ValueError, match="no background-noise route"):
        generate_background_components(32, 128, *ARGS, 0.0, device="meta")


def test_a_library_of_another_layout_is_refused(monkeypatch):
    class Lib:
        class Fn:
            def __call__(self, which):
                return (ctypes.sizeof(KernelParams) + 4, 13, 5, MAX_FRAMES, 7)[which]

        bhr_background_noise_layout = Fn()

    monkeypatch.setattr(background, "_lib", None)
    monkeypatch.setattr(background._build, "build",
                        lambda name: SimpleNamespace(lib=Lib()))
    with pytest.raises(RuntimeError, match="layout"):
        background._kernel_lib()


def test_kernel_params_take_one_launch_of_frames():
    with pytest.raises(ValueError, match="the kernel takes 1 to"):
        kernel_params(32, 128, ARGS, [0.0] * (MAX_FRAMES + 1), 2)
    with pytest.raises(ValueError, match="the kernel takes 1 to"):
        kernel_params(32, 128, ARGS, [], 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the background-noise kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.0, 7.3, TIMES], ids=["t0", "t7.3", "frames"])
@pytest.mark.parametrize("scale,n_r,n_phi", [(2, 416, 2912), (4, 832, 5824), (1, 32, 96)])
def test_the_kernel_equals_the_plain_version_on_the_card(cuda_device, t, scale, n_r, n_phi):
    launches = generate_background_components.launches
    got = generate_background_components(n_r, n_phi, *ARGS, t,
                                         generation_scale=scale, device=cuda_device)
    want = generate_background_components_plain(n_r, n_phi, *ARGS, t, scale,
                                                 cuda_device)
    torch.cuda.synchronize()
    assert generate_background_components.launches == launches + 1
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0
