"""Port dynamic disk vs bhr_tpu: background noise, entity layer, compose,
stats and a whole DynamicDiskSystem step, at n_r 128 x n_phi 256.

Tolerances. Background components: XLA's and torch's float32 cos/sin
differ in the last bits, and the noise multiplies them by up to 800
before taking floor, so a few texels land in a neighbouring simplex
cell: mean |diff| <= 1e-5 with at most 0.1% of texels above 1e-3.
Entity layer: rtol 1e-4 / atol 1e-5 (exp of the same profile
arguments). Stats on an identical component field: the same histogram
bin, up to one bin width where an FMA moves a texel across an edge.
Texture: atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhr_tpu.models import disk_texture as jtex
from bhr_tpu.models import dynamic_disk as jdyn
from bhr_tpu.models import lifecycle as jlife
from bhr_tpu.ops.background import generate_background_components as j_background

from bhr_tpu_torch import interop
from bhr_tpu_torch.models import disk_texture as ttex
from bhr_tpu_torch.models import dynamic_disk as tdyn
from bhr_tpu_torch.models import lifecycle as tlife
from bhr_tpu_torch.ops.background import generate_background_components as t_background

N_R, N_PHI, R_IN, R_OUT = 128, 256, 2.0, 3.5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_system():
    """The JAX system ticked to t=0, its packed entity rows, and its
    exported state."""
    sys_ = jdyn.DynamicDiskSystem(N_R, N_PHI, R_IN, R_OUT, seed=42)
    for f in sys_.factories.values():
        f.tick(now=0.0, dt=0.0)
    packs = tuple(np.asarray(p) for p in sys_._pack(0.0))
    return sys_, packs


def _comp_diff_ok(a, b):
    d = np.abs(a - b)
    assert d.mean() <= 1e-5, d.mean()
    assert (d > 1e-3).mean() <= 1e-3, (d > 1e-3).mean()


@pytest.mark.parametrize("t,scale", [(0.0, 2), (1.5, 2), (0.0, 1)])
def test_background_components_match(t, scale):
    args = (N_R, N_PHI, 3.0, 2.7, R_IN, R_OUT, t)
    ref = np.asarray(j_background(*args[:2], jnp.float32(3.0), jnp.float32(2.7),
                                  jnp.float32(R_IN), jnp.float32(R_OUT),
                                  jnp.float32(t), generation_scale=scale))
    out = t_background(*args, generation_scale=scale).numpy()
    assert out.shape == ref.shape == (7, N_R, N_PHI)
    _comp_diff_ok(out, ref)


@pytest.mark.parametrize("phi_scale", [1, 2])
def test_entity_layer_matches(jax_system, phi_scale):
    sys_, packs = jax_system
    omega = np.asarray(sys_.omega_rows)
    ref = np.asarray(jlife.accumulate_entity_layer(
        *(jnp.asarray(p) for p in packs), jnp.asarray(omega), N_R, N_PHI,
        phi_scale=phi_scale))
    out = tlife.accumulate_entity_layer(
        *(torch.tensor(np.array(p)) for p in packs), torch.tensor(omega), N_R, N_PHI,
        phi_scale=phi_scale).numpy()
    assert ref.max() > 0.1  # the layer is populated
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_stats_and_compose_match_on_identical_comp(jax_system):
    sys_, _ = jax_system
    comp = np.asarray(jdyn._dynamic_step(
        *(jnp.asarray(p) for p in sys_._pack(0.0)), sys_.omega_rows, sys_.edge,
        sys_.density_p98, sys_.struct_scale, sys_.row_stats,
        jnp.float32(sys_.az_freq), jnp.float32(sys_.az_shear),
        jnp.float32(R_IN), jnp.float32(R_OUT), jnp.float32(0.0),
        N_R, N_PHI, True, jnp.float32(sys_.color_temp),
        generation_scale=sys_.generation_scale, compose=False)[0])
    edge = np.asarray(sys_.edge)
    j_stats = [np.asarray(s) for s in jdyn._recompute_stats(
        jnp.asarray(comp), jnp.asarray(edge), True)]
    t_stats = [s.numpy() for s in tdyn._recompute_stats(
        torch.tensor(comp), torch.tensor(edge), True)]
    # One histogram bin: (hi - lo) / bins of each quantile.
    density_bin = float(np.asarray(jtex.density_from_comp(
        jnp.asarray(comp), jnp.asarray(edge), True)).max()) / 512
    np.testing.assert_allclose(t_stats[0], j_stats[0], rtol=0, atol=density_bin)
    np.testing.assert_allclose(t_stats[1], j_stats[1], rtol=0,
                               atol=float(np.asarray(jtex.temp_struct_from_comp(
                                   jnp.asarray(comp))).max()) / 512)
    np.testing.assert_allclose(t_stats[2], j_stats[2], rtol=0, atol=1.2 / 64)

    ref = np.asarray(jtex.compose_from_components(
        jnp.asarray(comp), sys_.omega_rows, jnp.asarray(edge),
        *(jnp.asarray(s) for s in j_stats), 0.0, True,
        jnp.float32(sys_.color_temp)))
    out = ttex.compose_from_components(
        torch.tensor(comp), torch.tensor(edge),
        *(torch.tensor(s) for s in j_stats), True,
        torch.tensor(sys_.color_temp, dtype=torch.float32)).numpy()
    assert out.shape == (N_R, N_PHI, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_dynamic_disk_advance_matches_through_interop(jax_system):
    sys_, packs = jax_system
    port = interop.dynamic_disk_from_state(
        n_r=N_R, n_phi=N_PHI, r_inner=R_IN, r_outer=R_OUT,
        az_freq=sys_.az_freq, az_shear=sys_.az_shear,
        fil_params=packs[0], hs_params=packs[1], rt_params=packs[2],
        omega_rows=np.asarray(sys_.omega_rows), edge=np.asarray(sys_.edge),
        density_p98=np.asarray(sys_.density_p98),
        struct_scale=np.asarray(sys_.struct_scale),
        row_stats=np.asarray(sys_.row_stats),
        generation_scale=sys_.generation_scale,
    )
    ref = np.asarray(sys_.advance(t=0.0, dt=0.0, recompute_stats=True))
    out = port.advance(t=0.0, dt=0.0, recompute_stats=True).numpy()
    assert out.shape == ref.shape == (N_R, N_PHI, 4)
    assert np.isfinite(out).all()
    _comp_diff_ok(port.comp.numpy(), np.asarray(sys_.comp))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_seeded_system_reproduces_jax_entity_state():
    """Built from the same seed (no interop), the port's host control
    plane packs the JAX system's entity rows."""
    port = tdyn.DynamicDiskSystem(N_R, N_PHI, R_IN, R_OUT, seed=7, device="cpu")
    ref = jdyn.DynamicDiskSystem(N_R, N_PHI, R_IN, R_OUT, seed=7)
    assert (port.az_freq, port.az_shear) == (ref.az_freq, ref.az_shear)
    assert port.generation_scale == ref.generation_scale == 2
    for a, b in zip(port._pack(0.0), ref._pack(0.0)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


def test_system_defaults_to_cuda_and_never_falls_back(monkeypatch):
    """Without ``device`` the system asks for the GPU, as SceneConfig
    does: on a host without one it raises instead of using the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        tdyn.DynamicDiskSystem(32, 64, R_IN, R_OUT, seed=3)
    cpu = tdyn.DynamicDiskSystem(32, 64, R_IN, R_OUT, seed=3, device="cpu")
    assert cpu.device == torch.device("cpu")
    assert tdyn.DynamicDiskSystem(32, 64, R_IN, R_OUT, seed=3,
                                  device=torch.device("cpu")).device.type == "cpu"
