"""The bloom router (``ops/bloom.py: bloom_composite``) and its CUDA kernel.

On the CPU: a CPU tensor runs the plain version and counts a plain pass;
a CUDA tensor with the kernel library stubbed launches it twice a call
with the layers, the tables and the shapes it should get, and a failing
launch raises with no plain pass behind it; the layers are checked
before either route; the tables reach the device once a frame size;
``post_process`` without bloom is the plain clamp. The kernel's
arithmetic, written out in torch (sources outside an axis are 0, every
output sums all 2R + 1 taps in ascending order, then divides by the
tables' denominators), equals the plain version bit for bit, also where
2R + 1 exceeds an axis and with NaN, infinity, negative and above-1
values planted.

Marked ``cuda`` (skips on a host without a GPU, decided inside the
test): the kernel against the plain version on the card, bit for bit.
``chip_smoke.py`` makes the same check on rendered FHD and 4K frames.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bhr_tpu_torch import pipeline
from bhr_tpu_torch.ops import bloom
from bhr_tpu_torch.ops.bloom import (
    apply_bloom,
    bloom_composite,
    bloom_composite_plain,
    bloom_tables,
)

# (height, width): a tiny scene (R 1), the default test size (R 1), an
# axis shorter than the kernel (R 6, 13 taps over 7 rows), a single
# column, a segment and a half of the row launch (R 8).
SHAPES = [(16, 32), (36, 64), (7, 330), (5, 1), (9, 432)]


def layers(height, width, seed=0, planted=False):
    rng = np.random.default_rng(seed)
    bg = rng.uniform(-0.1, 0.9, (height, width, 3)).astype(np.float32)
    disk = rng.uniform(-0.2, 1.6, (height, width, 3)).astype(np.float32)
    if planted:
        disk[0, 0] = (np.nan, 0.5, 0.5)        # NaN lum: dropped from the blur
        disk[height // 2, width // 2] = (np.inf, 0.1, 0.1)  # blooms to inf
        disk[-1, -1] = (-3.0, -0.5, 2.0)       # negative lum: dropped
        disk[height - 1, 0] = (4.0, -0.2, 5.0)  # above 1, kept
        bg[0, width - 1] = (np.nan, -1.0, 7.0)
    return torch.from_numpy(bg), torch.from_numpy(disk)


def kernel_arithmetic(bg, disk):
    """csrc/bloom.cu's arithmetic in torch on the CPU."""
    height, width, _ = disk.shape
    radius, *tables = bloom_tables(height, width)
    taps, den_x, den_y = map(torch.from_numpy, tables)
    lum = disk[..., 0] * 0.2126 + disk[..., 1] * 0.7152 + disk[..., 2] * 0.0722
    bright = torch.where((lum > 0.0)[..., None], disk, 0.0)

    def blur(img, axis, den):
        n = img.shape[axis]
        # Zeros on both sides of the axis (F.pad lists the last dim first).
        pad = [0, 0, radius, radius] if axis == 1 else [0, 0, 0, 0, radius, radius]
        src = torch.nn.functional.pad(img, pad)
        acc = torch.zeros_like(img)
        for k in range(2 * radius + 1):
            acc = acc + src.narrow(axis, k, n) * taps[:, k]
        return acc / den

    blurred = blur(blur(bright, 1, den_x[None]), 0, den_y[:, None])
    return torch.clamp(bg + disk + blurred, 0.0, 1.0)


def same(a, b):
    """Equal values, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("planted", [False, True], ids=["plain", "planted"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_the_kernels_arithmetic_gives_the_plain_version_bit_for_bit(shape, planted):
    bg, disk = layers(*shape, planted=planted)
    want = bloom_composite_plain(bg, disk)
    assert same(kernel_arithmetic(bg, disk), want)
    if planted:
        assert torch.isnan(want).any() and (want == 1.0).any()


def test_the_plain_version_is_the_post_layers_composite():
    bg, disk = layers(36, 64)
    blur = apply_bloom(disk, width_ref=64)
    assert torch.equal(bloom_composite_plain(bg, disk),
                       torch.clamp(bg + disk + blur, 0.0, 1.0))


def test_the_tables_are_the_plain_versions_taps():
    radius, taps, den_x, den_y = bloom_tables(1080, 1920)
    assert radius == 38 and taps.shape == (3, 77) and taps.dtype == np.float32
    assert den_x.shape == (1920, 3) and den_y.shape == (1080, 3)
    assert bloom_tables(2160, 3840)[0] == 76
    # Inside the axis every tap counts: the full sum, in order.
    full = np.zeros(3, np.float32)
    for k in range(77):
        full += taps[:, k]
    assert np.array_equal(den_x[500], full) and np.array_equal(den_y[500], full)
    # At the first pixel only the taps from the centre on count.
    first = np.zeros(3, np.float32)
    for k in range(38, 77):
        first += taps[:, k]
    assert np.array_equal(den_x[0], first) and (first < full).all()


def test_a_cpu_tensor_runs_the_plain_version_and_counts_a_plain_pass(monkeypatch):
    def no_kernel():
        raise AssertionError("the kernel library was loaded for a CPU pass")

    monkeypatch.setattr(bloom, "_kernel_lib", no_kernel)
    monkeypatch.setattr(bloom_composite, "launches", 0)
    monkeypatch.setattr(bloom_composite, "plain_passes", 0)
    bg, disk = layers(36, 64)
    assert torch.equal(bloom_composite(bg, disk), bloom_composite_plain(bg, disk))
    assert torch.equal(pipeline.post_process(bg, disk, True, False),
                       bloom_composite_plain(bg, disk))
    assert bloom_composite.plain_passes == 2
    assert bloom_composite.launches == 0


def test_post_process_without_bloom_is_the_plain_clamp(monkeypatch):
    monkeypatch.setattr(bloom_composite, "plain_passes", 0)
    bg, disk = layers(36, 64, planted=True)
    got = pipeline.post_process(bg, disk, False, False)
    assert same(got, torch.clamp(bg + disk, 0.0, 1.0))
    assert bloom_composite.plain_passes == 0


class FakeLib:
    """The kernel library's C interface, recording each call."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []
        self.bhr_bloom = self.launch

    def launch(self, *args):
        self.calls.append(args)
        return self.err


class OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the first card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def fake_cuda(monkeypatch):
    """A CUDA device on a CPU host: the library stubbed, the output and
    the tables allocated on the CPU (copies to the card counted), the
    current stream a stand-in."""
    lib = FakeLib()
    copies = []
    real_empty, real_as_tensor = torch.empty, torch.as_tensor

    def on_cpu(device):
        return "cpu" if device is not None and torch.device(device).type == "cuda" else device

    def empty(*shape, device=None, **kw):
        return real_empty(*shape, device=on_cpu(device), **kw)

    def as_tensor(data, dtype=None, device=None):
        if on_cpu(device) != device:
            copies.append(np.array(data))
        return real_as_tensor(data, dtype=dtype, device=on_cpu(device))

    class NoDevice:
        def __init__(self, dev):
            assert torch.device(dev).type == "cuda"

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(bloom, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(bloom, "_tables", {})
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    monkeypatch.setattr(torch.cuda, "device", NoDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(bloom_composite, "launches", 0)
    monkeypatch.setattr(bloom_composite, "plain_passes", 0)
    return SimpleNamespace(lib=lib, copies=copies)


def cuda_layers(height, width):
    return tuple(t.as_subclass(OnCuda) for t in layers(height, width))


@pytest.mark.parametrize("shape", [(36, 64), (7, 330), (1080, 1920)],
                         ids=["64x36", "330x7", "fhd"])
def test_a_cuda_tensor_launches_the_kernel_twice_a_call(fake_cuda, shape):
    height, width = shape
    bg, disk = cuda_layers(height, width)
    out = bloom_composite(bg, disk)
    assert out.shape == (height, width, 3)
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert bloom_composite.launches == 2
    assert bloom_composite.plain_passes == 0
    ((p_bg, p_disk, p_taps, p_den_x, p_den_y, p_tmp, p_out, h, w, radius, stream),) = (
        fake_cuda.lib.calls)
    assert (p_bg, p_disk, p_out) == (bg.data_ptr(), disk.data_ptr(), out.data_ptr())
    assert p_tmp not in (p_bg, p_disk, p_out)
    assert (h, w, stream) == (height, width, 1234)
    want_radius, *want = bloom_tables(height, width)
    assert radius == want_radius
    got_radius, *tables = bloom._tables[(torch.device("cuda", 0), height, width)]
    assert got_radius == radius
    assert [t.data_ptr() for t in tables] == [p_taps, p_den_x, p_den_y]
    for got, host in zip(tables, want):
        assert np.array_equal(got.numpy(), host.ravel())


def test_the_tables_reach_the_device_once_a_frame_size(fake_cuda):
    for _ in range(3):
        bloom_composite(*cuda_layers(36, 64))
    assert len(fake_cuda.copies) == 1
    bloom_composite(*cuda_layers(36, 96))
    bloom_composite(*cuda_layers(36, 96))
    assert len(fake_cuda.copies) == 2
    assert bloom_composite.launches == 10
    pointers = {call[2] for call in fake_cuda.lib.calls}
    assert len(pointers) == 2


def test_a_failing_launch_raises_and_never_falls_back(fake_cuda):
    fake_cuda.lib.err = 700
    with pytest.raises(RuntimeError, match="bloom launch failed: cudaError 700"):
        bloom_composite(*cuda_layers(36, 64))
    assert len(fake_cuda.lib.calls) == 1
    assert bloom_composite.launches == 0
    assert bloom_composite.plain_passes == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_bad_layers_raise_before_either_route(fake_cuda, device):
    bg, disk = layers(36, 64) if device == "cpu" else cuda_layers(36, 64)
    bad = [
        ((bg.double(), disk), "float32"),
        ((bg, disk.half()), "float32"),
        ((bg[..., :2], disk[..., :2]), r"not \(H, W, 3\)"),
        ((bg.reshape(36, 64 * 3), disk.reshape(36, 64 * 3)), r"not \(H, W, 3\)"),
        ((bg[:0], disk[:0]), r"not \(H, W, 3\)"),
        ((bg.transpose(0, 1), disk.transpose(0, 1)), "not contiguous"),
        ((bg[:, ::2], disk[:, ::2]), "not contiguous"),
        ((bg[:18], disk), "differ"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            bloom_composite(*args)
    assert fake_cuda.lib.calls == []
    assert bloom_composite.plain_passes == 0
    meta = torch.empty((4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="no bloom route"):
        bloom_composite(meta, meta)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bloom kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("planted", [False, True], ids=["plain", "planted"])
@pytest.mark.parametrize("shape", [(1080, 1920), (2160, 3840), (7, 330), (36, 64), (5, 1)],
                         ids=["fhd", "4k", "330x7", "64x36", "1x5"])
def test_the_kernel_equals_the_plain_version_on_the_card(cuda_device, shape, planted):
    bg, disk = (t.to(cuda_device) for t in layers(*shape, seed=7, planted=planted))
    launches = bloom_composite.launches
    got = bloom_composite(bg, disk)
    want = bloom_composite_plain(bg, disk)
    torch.cuda.synchronize()
    assert bloom_composite.launches == launches + 2
    assert got.shape == want.shape
    assert same(got, want)
    if planted:
        assert torch.isnan(got).any() and (got == 1.0).any()
