"""Port static texture generator (``bhr_tpu_torch/models/disk_texture.py``,
the arc and pixel noise of ``ops/noise.py``) vs ``bhr_tpu``, on the CPU.

Both draw the same streams (``ops/random.py`` ports threefry bit for bit),
so every structure has the same count, position and width, and a field
differs only where XLA and torch round ``exp``, ``cos``, ``pow`` and the
sums differently: each generator field within 1e-5 absolute, the integer
Keplerian shear shifts equal, the normalization stats (exact percentiles)
within 1e-5, the composed RGBA texture within 1e-4 max / 1e-6 mean.
The rest restates ``tests/unit/test_disk_texture.py``'s conditions for
the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhr_tpu.models import disk_texture as jtex
from bhr_tpu.ops import noise as jnoise

from bhr_tpu_torch.models import disk_texture as ttex
from bhr_tpu_torch.ops import noise as tnoise
from bhr_tpu_torch.ops import random as trandom

SHAPES = [(32, 128), (64, 256)]
SCALES = [1, 2, 4]
FIELD_TOL = 1e-5
N_R, N_PHI = 64, 256
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _keys(seed):
    return jax.random.PRNGKey(seed), trandom.prng_key(seed)


def _close(out, ref, atol=FIELD_TOL):
    out, ref = out.numpy(), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


def _texture_close(out, ref):
    d = np.abs(out.numpy().astype(np.float64) - np.asarray(ref))
    assert out.shape == ref.shape
    assert d.max() <= 1e-4 and d.mean() <= 1e-6, (d.max(), d.mean())


@pytest.mark.parametrize("shape", SHAPES)
def test_noise_matches(shape):
    jk, tk = _keys(5)
    _close(tnoise.tileable_noise(tk, shape, device=CPU), jnoise.tileable_noise(jk, shape))
    pix = tnoise.periodic_pixel_noise(tk, shape, device=CPU)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(
        jnoise.periodic_pixel_noise(jk, shape)))
    np.testing.assert_array_equal(pix[:, -1].numpy(), pix[:, 0].numpy())
    for wrap in (True, False):
        _close(tnoise.fbm_noise(tk, shape, 4, 0.6, 2, wrap, device=CPU),
               jnoise.fbm_noise(jk, shape, 4, 0.6, 2, wrap))


@pytest.mark.parametrize("n", [16, 36, 128, 208, 1456, 2912])
def test_polar_axes_match_jnp_linspace(n):
    phi, r = tnoise.polar_axes(n, n, CPU)
    np.testing.assert_array_equal(
        phi[0].numpy(), np.asarray(jnp.linspace(0.0, 2.0 * jnp.pi, n, endpoint=False)))
    np.testing.assert_array_equal(r[:, 0].numpy(), np.asarray(jnp.linspace(0.0, 1.0, n)))


@pytest.mark.parametrize("shape", SHAPES)
def test_temperature_base_matches(shape):
    jk, tk = _keys(21)
    out = ttex.generate_temperature_base(tk, *shape, device=CPU)
    _close(out, jtex.generate_temperature_base(jk, *shape))
    assert 0.0 <= float(out.min()) and float(out.max()) <= 0.25


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES)
def test_spiral_arms_match(shape, scale, enabled):
    jk, tk = _keys(5)
    out = ttex.generate_spiral_arms(tk, *shape, scale, enabled=enabled, device=CPU)
    ref = jtex.generate_spiral_arms(jk, *shape, scale, enabled=enabled)
    for o, r in zip(out, ref):
        _close(o, r)
    assert bool(out[0].any()) == enabled


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES)
def test_turbulence_matches(shape, scale):
    jk, tk = _keys(11)
    turb, shift, temp = ttex.generate_turbulence(tk, *shape, scale, device=CPU)
    j_turb, j_shift, j_temp = jtex.generate_turbulence(jk, *shape, scale)
    _close(turb, j_turb)
    _close(temp, j_temp)
    assert shift.dtype == torch.int32
    np.testing.assert_array_equal(shift.numpy(), np.asarray(j_shift))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES)
def test_filaments_match(shape, scale):
    jk, tk = _keys(12)
    arcs, temp = ttex.generate_filaments(tk, *shape, scale, device=CPU)
    j_arcs, j_temp = jtex.generate_filaments(jk, *shape, scale)
    _close(arcs, j_arcs)
    _close(temp, j_temp)
    assert float(arcs.max()) > 0.1


@pytest.mark.parametrize("enable_rt", [True, False])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rt_spikes_match(shape, scale, enable_rt):
    jk, tk = _keys(7)
    area = (3.5 ** 2 - 2.0 ** 2) / 10.0
    out = ttex.generate_rt_spikes(tk, *shape, area, enable_rt, scale, device=CPU)
    ref = jtex.generate_rt_spikes(jk, *shape, area, enable_rt, scale)
    for o, r in zip(out, ref):
        _close(o, r)
    assert bool(out[0].any()) == enable_rt


@pytest.mark.parametrize("shape", SHAPES)
def test_hotspots_match(shape):
    jk, tk = _keys(13)
    hs, hs_t = ttex.generate_hotspots(tk, *shape, device=CPU)
    j_hs, j_hs_t = jtex.generate_hotspots(jk, *shape)
    _close(hs, j_hs)
    _close(hs_t, j_hs_t)
    np.testing.assert_allclose(hs_t.numpy(), 0.12 * hs.numpy(), atol=1e-6)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES)
def test_azimuthal_hotspot_matches(shape, scale):
    jk, tk = _keys(14)
    _close(ttex.generate_azimuthal_hotspot(tk, *shape, scale, device=CPU),
           jtex.generate_azimuthal_hotspot(jk, *shape, scale))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES)
def test_disturbance_mod_matches(shape, scale):
    jk, tk = _keys(15)
    shift = ttex.generate_turbulence(tk, *shape, scale, device=CPU)[1]
    out = ttex.generate_disturbance_mod(tk, *shape, shift, scale, device=CPU)
    _close(out, jtex.generate_disturbance_mod(jk, *shape, jnp.asarray(shift.numpy()),
                                              scale))
    assert 0.1 <= float(out.min()) and float(out.max()) <= 1.0


def test_rt_spike_count_scales_with_disk_area():
    """The CLI's 2-15 disk pads 531 finger slots (15-30 x disk_area x 0.8
    drawn); the port matches bhr_tpu there, and a cap of 48 covers
    clearly less (test_disk_texture.py's condition)."""
    jk, tk = _keys(7)
    wide = (15.0 ** 2 - 2.0 ** 2) / 10.0
    assert ttex.rt_slot_count(wide) == 531
    spikes, temp = ttex.generate_rt_spikes(tk, 64, 256, wide, device=CPU)
    j_spikes, j_temp = jtex.generate_rt_spikes(jk, 64, 256, wide)
    _close(spikes, j_spikes)
    _close(temp, j_temp)
    capped, _ = ttex.generate_rt_spikes(tk, 64, 256, wide, max_count=48, device=CPU)
    assert float((spikes > 0.05).float().mean()) > 1.3 * float(
        (capped > 0.05).float().mean())
    narrow, _ = ttex.generate_rt_spikes(tk, 64, 256, (3.5 ** 2 - 2.0 ** 2) / 10.0,
                                     device=CPU)
    assert float((narrow > 0.05).float().mean()) < float((spikes > 0.05).float().mean())


@pytest.fixture(scope="module")
def states():
    """bhr_tpu's and the port's parametric state of one scene."""
    kw = dict(n_phi=N_PHI, n_r=N_R, seed=42, r_inner=2.0, r_outer=3.5)
    return (jtex.build_parametric_state(**kw),
            ttex.build_parametric_state(**kw, device="cpu"))


def test_parametric_state_matches(states):
    j, t = states
    _close(t.comp, j.comp)
    np.testing.assert_array_equal(t.omega_rows.numpy(), np.asarray(j.omega_rows))
    np.testing.assert_array_equal(t.edge.numpy(), np.asarray(j.edge))
    for name in ("density_p98", "struct_scale", "row_stats"):
        _close(getattr(t, name), getattr(j, name))
    assert (t.enable_rt, t.color_temp, t.n_r, t.n_phi, t.generation_scale, t.seed) == (
        j.enable_rt, j.color_temp, j.n_r, j.n_phi, j.generation_scale, j.seed)


@pytest.mark.parametrize("t", [0.0, 7.3])
def test_compose_from_state_matches(states, t):
    j, port = states
    _texture_close(ttex.compose_from_state(port, t), jtex.compose_from_state(j, t))


@pytest.mark.parametrize("color_temp", [2700.0, 6500.0])
@pytest.mark.parametrize("seed", [1, 5, 42])
def test_generate_disk_texture_matches(seed, color_temp):
    kw = dict(n_phi=128, n_r=32, seed=seed, color_temp=color_temp)
    _texture_close(ttex.generate_disk_texture(**kw, device="cpu"),
                   jtex.generate_disk_texture(**kw))


def test_compose_matches_on_identical_fields():
    """compose_disk_texture on the same random fields: stats and texture."""
    rng = np.random.default_rng(0)
    fields = [rng.random((32, 128)).astype(np.float32) * s for s in (0.2, 1.0, 1.0)]
    temp_base, temp_struct, density = fields
    edge = np.ones(32, np.float32)
    ref = jtex.compose_disk_texture(*(jnp.asarray(f) for f in (temp_base, temp_struct,
                                                                density)),
                                    jnp.zeros((32, 128)), jnp.asarray(edge), 6000.0)
    out = ttex.compose_disk_texture(*(torch.from_numpy(f) for f in (
        temp_base, temp_struct, density)), torch.zeros((32, 128)),
        torch.from_numpy(edge), 6000.0)
    _close(out, ref)
    alpha = out[..., 3].numpy()
    # P98 normalization: ~2% of the alpha saturates.
    assert alpha.max() <= 1.0 and 0.001 < (alpha >= 0.999).mean() < 0.05


@pytest.mark.parametrize("shape", [(7, 50), (3, 1001), (1, 1), (4097, 4100)])
def test_percentiles_follow_numpy(shape):
    """The sort-based percentiles follow numpy's linear rule, also past
    torch.quantile's 2**24-element limit (the last shape)."""
    rng = np.random.default_rng(shape[1])
    x = rng.random(shape, dtype=np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(float(ttex._percentile(t, 0.98)),
                               np.percentile(x, 98.0), rtol=1e-6)
    mask = x > 0.5
    if mask.any():
        np.testing.assert_allclose(
            float(ttex._masked_percentile(t, torch.from_numpy(mask), 0.95)),
            np.nanpercentile(np.where(mask, x, np.nan), 95.0), rtol=1e-6)
    if shape[0] * shape[1] < 2 ** 20:
        np.testing.assert_allclose(ttex._row_quantile(t, 0.7).numpy(),
                                   np.quantile(x, 0.7, axis=1), rtol=1e-6)


# --- the conditions of tests/unit/test_disk_texture.py, for the port ---


def test_texture_shape_range(states):
    tex = ttex.compose_from_state(states[1], 0.0).numpy()
    assert tex.shape == (N_R, N_PHI, 4) and tex.dtype == np.float32
    assert tex.min() >= 0.0 and tex.max() <= 1.0 and np.isfinite(tex).all()
    assert tex[..., 3].std() > 0.05 and tex[..., 0].std() > 0.05


def test_deterministic_by_seed():
    a = ttex.generate_disk_texture(n_phi=128, n_r=32, seed=5, device="cpu")
    b = ttex.generate_disk_texture(n_phi=128, n_r=32, seed=5, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = ttex.generate_disk_texture(n_phi=128, n_r=32, seed=6, device="cpu")
    assert not np.allclose(a.numpy(), c.numpy())


def test_edge_softening(states):
    tex = ttex.compose_from_state(states[1], 0.0).numpy()
    assert tex[0, :, 3].max() < 0.05
    assert tex[-1, :, 3].max() < 0.2
    assert tex[N_R // 2, :, 3].mean() > tex[0, :, 3].mean()


def test_rotation_is_an_exact_row_roll(states):
    """compose(t) is compose(0) with each row rolled by its whole-pixel
    Keplerian shift: the roll is a gather, so the two are equal."""
    state, t = states[1], 7.3
    a = ttex.compose_from_state(state, 0.0).numpy()
    b = ttex.compose_from_state(state, t).numpy()
    shift = (t * state.omega_rows / (2 * np.pi) * N_PHI).to(torch.int32).numpy()
    assert shift[0] > shift[-1] > 0
    rolled = np.stack([np.roll(a[r], -shift[r], axis=0) for r in range(N_R)])
    np.testing.assert_array_equal(b, rolled)
    assert not np.array_equal(a, b)


def test_generation_scales_and_invalid_scale():
    for scale in SCALES:
        tex = ttex.generate_disk_texture(n_phi=128, n_r=32, seed=3,
                                         generation_scale=scale, device="cpu")
        assert tex.shape == (32, 128, 4) and bool(torch.isfinite(tex).all())
    with pytest.raises(ValueError, match="disk_generation_scale"):
        ttex.generate_disk_texture(n_phi=128, n_r=32, generation_scale=3, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        ttex.generate_disk_texture(n_phi=130, n_r=32, generation_scale=4, device="cpu")


def test_rt_toggle_and_color_temperature():
    kw = dict(n_phi=128, n_r=32, device="cpu")
    with_rt = ttex.generate_disk_texture(seed=9, enable_rt=True, **kw).numpy()
    without = ttex.generate_disk_texture(seed=9, enable_rt=False, **kw).numpy()
    assert not np.allclose(with_rt, without)
    warm = ttex.generate_disk_texture(seed=4, color_temp=2700.0, **kw).numpy()
    cool = ttex.generate_disk_texture(seed=4, color_temp=6500.0, **kw).numpy()
    assert (warm[..., 0].mean() / (warm[..., 2].mean() + 1e-6)
            > cool[..., 0].mean() / (cool[..., 2].mean() + 1e-6))


def test_structure_bounds():
    tk = trandom.prng_key(11)
    turb, shift, temp = ttex.generate_turbulence(tk, 32, 128, 1, device=CPU)
    assert int(shift[0]) >= int(shift[-1]) and int(shift.abs().max()) <= 128 // 4
    assert float(temp.max()) <= 0.05 + 1e-6
    arcs, arcs_t = ttex.generate_filaments(trandom.prng_key(12), 32, 128, 1,
                                           max_count=60, max_subs=4, device=CPU)
    assert 0.0 <= float(arcs.min()) and float(arcs.max()) <= 1.0
    assert bool((arcs_t <= arcs * 0.5 + 1e-5).all())
    sp, sp_t = ttex.generate_spiral_arms(trandom.prng_key(5), 32, 128, device=CPU)
    assert not sp.any() and not sp_t.any()


def test_generator_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        ttex.generate_disk_texture(n_phi=128, n_r=32)
