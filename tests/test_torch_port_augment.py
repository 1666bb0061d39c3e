"""The port's augmentation chain (``unet_bssfp_tpu_torch.data.augment``)
against the JAX package's on the CPU.

Each of the seven transforms is an apply on drawn parameters; the tests
repeat the ``jax.random`` calls of the JAX transform (the same key splits,
JAX's own noise field) and hand those parameters to the port's apply, so the
arithmetic is held to JAX's: within 1e-5·max|ref| for noise, gamma, blur,
bias field and the rotation, 1e-4·max|ref| for spike, ghosting and motion
(two FFT libraries). The draws themselves come from ``torch.Generator``s, so
their parity is distributional: the statistics of
``tests/test_augment_distributions.py``, repeated on the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.data import augment as ja
from unet_bssfp_tpu_torch.data import augment as ta

SHAPES = [(16, 16, 16, 1), (12, 15, 17, 3), (9, 8, 10, 6)]
KEYS = [0, 3, 17]
FFT_TOL, TOL = 1e-4, 1e-5


def _vol(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _both(shape, seed=0):
    v = _vol(shape, seed)
    return v, torch.from_numpy(v), jnp.asarray(v)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", KEYS)
def test_noise_apply_matches_jax(shape, k):
    v, tv, jv = _both(shape, k)
    key = jax.random.PRNGKey(k)
    k_std, k_noise = jax.random.split(key)
    std = jax.random.uniform(k_std, (), minval=0.01, maxval=0.1)
    field = np.array(jax.random.normal(k_noise, v.shape, jnp.float32))
    _close(ta.apply_noise(tv, float(std), torch.from_numpy(field)), ja.random_noise(key, jv), TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", KEYS)
def test_gamma_apply_matches_jax(shape, k):
    v, tv, jv = _both(shape, k)
    tv, jv = tv - 0.3, jv - 0.3  # negative values: sign·|x|^g
    key = jax.random.PRNGKey(k)
    g = jnp.exp(jax.random.uniform(key, (), minval=-0.3, maxval=0.3))
    _close(ta.apply_gamma(tv, float(g)), ja.random_gamma(key, jv), TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("std_range", [(0.01, 0.1), (1.0, 2.0)])
def test_blur_apply_matches_jax(shape, std_range):
    v, tv, jv = _both(shape, 1)
    key = jax.random.PRNGKey(5)
    stds = np.asarray(jax.random.uniform(key, (3,), minval=std_range[0],
                                         maxval=std_range[1])).tolist()
    _close(ta.apply_blur(tv, stds), ja.random_blur(key, jv, std_range=std_range), TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", KEYS)
def test_bias_field_apply_matches_jax(shape, k):
    v, tv, jv = _both(shape, k)
    key = jax.random.PRNGKey(k)
    coeffs = np.asarray(jax.random.uniform(key, (20,), minval=-0.5, maxval=0.5)).tolist()
    _close(ta.apply_bias_field(tv, coeffs), ja.random_bias_field(key, jv), TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", KEYS)
def test_spike_apply_matches_jax(shape, k):
    v, tv, jv = _both(shape, k)
    key = jax.random.PRNGKey(k)
    k_pos, k_int = jax.random.split(key)
    dims = jnp.array(shape[:3], jnp.float32)
    pos = np.asarray(jnp.floor(jax.random.uniform(k_pos, (1, 3)) * dims).astype(jnp.int32))
    r = float(jax.random.uniform(k_int, (), minval=0.01, maxval=0.1))
    _close(ta.apply_spike(tv, pos.tolist(), r), ja.random_spike(key, jv), FFT_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", KEYS + [1, 2])
def test_ghosting_apply_matches_jax(shape, k):
    v, tv, jv = _both(shape, k)
    key = jax.random.PRNGKey(k)
    k_ax, k_n, k_int = jax.random.split(key, 3)
    axis = int(jax.random.randint(k_ax, (), 0, 3))
    n = int(jax.random.randint(k_n, (), 4, 11))
    inten = float(jax.random.uniform(k_int, (), minval=0.5, maxval=1.0))
    _close(ta.apply_ghosting(tv, axis, n, inten), ja.random_ghosting(key, jv), FFT_TOL)


def _jax_motion_params(key, degrees=10.0, translation=10.0, num_transforms=2):
    angles, shifts = [], []
    for kt in jax.random.split(key, num_transforms):
        k_rot, k_shift = jax.random.split(kt)
        lim = degrees * jnp.pi / 180.0
        angles.append(np.asarray(jax.random.uniform(k_rot, (3,), minval=-lim,
                                                     maxval=lim)).tolist())
        shifts.append(np.asarray(jax.random.uniform(k_shift, (3,), minval=-translation,
                                                    maxval=translation)).tolist())
    return angles, shifts


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", KEYS)
def test_motion_apply_matches_jax(shape, k):
    v, tv, jv = _both(shape, k)
    key = jax.random.PRNGKey(k)
    angles, shifts = _jax_motion_params(key)
    _close(ta.apply_motion(tv, angles, shifts), ja.random_motion(key, jv), FFT_TOL)


def test_motion_with_three_transforms_and_large_degrees_matches_jax():
    v, tv, jv = _both((12, 15, 17, 2), 9)
    key = jax.random.PRNGKey(8)
    angles, shifts = _jax_motion_params(key, degrees=30.0, num_transforms=3)
    _close(ta.apply_motion(tv, angles, shifts),
           ja.random_motion(key, jv, degrees=30.0, num_transforms=3), FFT_TOL)


@pytest.mark.parametrize("angles", [(0.3, -0.2, 0.1), (math.pi / 2, 0.0, 0.0),
                                    (0.0, 0.12, 0.0), (-0.17, 0.05, 0.4)])
def test_euler_matrix_matches_jax(angles):
    a = np.asarray(angles, np.float32)
    got = ta._euler_matrix(a)
    _close(got, ja._euler_matrix(jnp.asarray(a)), TOL)
    assert torch.allclose(got @ got.T, torch.eye(3), atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("angles", [(0.3, -0.2, 0.1), (math.pi / 2, 0.0, 0.0),
                                    (-0.17, 0.05, 0.4)])
def test_rotate_trilinear_matches_jax(shape, angles):
    v, tv, jv = _both(shape, 2)
    a = np.asarray(angles, np.float32)
    _close(ta.rotate_trilinear(tv, a), ja.rotate_trilinear(jv, jnp.asarray(a)), TOL)


def test_rotate_trilinear_matches_scipy():
    """As ``tests/test_augment_distributions.py``: the rotation matches
    scipy.ndimage.rotate (order 1) inside the volume; zero is the identity."""
    from scipy.ndimage import rotate as sprot

    vol = np.random.default_rng(42).random((15, 15, 15, 1)).astype(np.float32)
    out = ta.rotate_trilinear(torch.from_numpy(vol), [math.pi / 2, 0.0, 0.0]).numpy()
    ref = sprot(vol[..., 0], 90, axes=(1, 2), reshape=False, order=1, mode="nearest")
    np.testing.assert_allclose(out[2:-2, 2:-2, 2:-2, 0], ref[2:-2, 2:-2, 2:-2], atol=1e-5)
    out = ta.rotate_trilinear(torch.from_numpy(vol), [0.0, math.radians(7), 0.0]).numpy()
    ref = sprot(vol[..., 0], -7, axes=(0, 2), reshape=False, order=1, mode="nearest")
    np.testing.assert_allclose(out[2:-2, 2:-2, 2:-2, 0], ref[2:-2, 2:-2, 2:-2], atol=1e-5)
    np.testing.assert_array_equal(
        ta.rotate_trilinear(torch.from_numpy(vol), [0.0, 0.0, 0.0]).numpy(), vol)


def test_fft_round_trip_casts_like_jax():
    v, tv, jv = _both((6, 7, 8, 2), 3)
    spec = ta._fft3(tv)
    assert spec.dtype == torch.complex64
    _close(spec.real, jnp.real(ja._fft3(jv)), FFT_TOL)
    back = ta._ifft3(spec)
    assert back.dtype == torch.float32
    _close(back, ja._ifft3(ja._fft3(jv)), FFT_TOL)


# -- draws -------------------------------------------------------------------

def test_draws_stay_in_their_ranges():
    g = torch.Generator().manual_seed(0)
    for _ in range(200):
        assert 0.01 <= ta.draw_noise(g)["std"] < 0.1
        assert math.exp(-0.3) <= ta.draw_gamma(g)["g"] <= math.exp(0.3)
        assert all(0.01 <= s < 0.1 for s in ta.draw_blur(g)["stds"])
        coeffs = ta.draw_bias_field(g)["coeffs"]
        assert len(coeffs) == 20 and all(-0.5 <= c < 0.5 for c in coeffs)
        sp = ta.draw_spike(g, (5, 7, 9))
        assert all(0 <= p < n for p, n in zip(sp["positions"][0], (5, 7, 9)))
        assert 0.01 <= sp["r"] < 0.1
        gh = ta.draw_ghosting(g)
        assert gh["axis"] in (0, 1, 2) and 4 <= gh["n"] <= 10 and 0.5 <= gh["intensity"] < 1.0
        mo = ta.draw_motion(g)
        assert len(mo["angles"]) == len(mo["shifts"]) == 2
        assert all(abs(a) <= math.radians(10) for t in mo["angles"] for a in t)
        assert all(abs(s) <= 10 for t in mo["shifts"] for s in t)


def test_chain_order_gates_and_repeatability():
    assert [name for name, _, _ in ta.CHAIN] == [name for name, _ in ja._DEFAULT_CHAIN]
    assert ta.draw_chain(torch.Generator().manual_seed(1), (8, 8, 8), 0.0) == []
    every = ta.draw_chain(torch.Generator().manual_seed(1), (8, 8, 8), 1.0)
    assert [n for n, _ in every] == [n for n, _, _ in ta.CHAIN]
    taken = [len(ta.draw_chain(torch.Generator().manual_seed(s), (8, 8, 8), 0.1))
             for s in range(400)]
    # each of 7 gates at p = 0.1: 0.7 transforms a volume on average
    assert 0.5 < np.mean(taken) < 0.9
    v = torch.from_numpy(_vol((8, 8, 8, 2)))
    a = ta.augment_volume(torch.Generator().manual_seed(3), v, prob=1.0)
    b = ta.augment_volume(torch.Generator().manual_seed(3), v, prob=1.0)
    assert torch.equal(a, b)


def test_augment_volume_prob_zero_is_identity():
    v = torch.from_numpy(_vol((8, 8, 8, 2)))
    assert torch.equal(ta.augment_volume(torch.Generator().manual_seed(0), v, prob=0.0), v)


def test_augment_chain_apply_matches_jax_chain():
    """The whole chain at p = 1 on JAX's drawn parameters (the splits of
    ``augment_volume``), applied in the port, against JAX's chain."""
    v, tv, jv = _both((12, 15, 17, 2), 4)
    key = jax.random.PRNGKey(6)
    draws = []
    k = key
    for name, _ in ja._DEFAULT_CHAIN:
        k, _, k_t = jax.random.split(k, 3)
        if name == "motion":
            angles, shifts = _jax_motion_params(k_t)
            draws.append((name, dict(angles=angles, shifts=shifts)))
        elif name == "ghosting":
            k_ax, k_n, k_int = jax.random.split(k_t, 3)
            draws.append((name, dict(axis=int(jax.random.randint(k_ax, (), 0, 3)),
                                     n=int(jax.random.randint(k_n, (), 4, 11)),
                                     intensity=float(jax.random.uniform(
                                         k_int, (), minval=0.5, maxval=1.0)))))
        elif name == "spike":
            k_pos, k_int = jax.random.split(k_t)
            pos = jnp.floor(jax.random.uniform(k_pos, (1, 3)) * jnp.array(
                [12, 15, 17], jnp.float32)).astype(jnp.int32)
            draws.append((name, dict(positions=np.asarray(pos).tolist(), r=float(
                jax.random.uniform(k_int, (), minval=0.01, maxval=0.1)))))
        elif name == "bias_field":
            draws.append((name, dict(coeffs=np.asarray(jax.random.uniform(
                k_t, (20,), minval=-0.5, maxval=0.5)).tolist())))
        elif name == "blur":
            draws.append((name, dict(stds=np.asarray(jax.random.uniform(
                k_t, (3,), minval=0.01, maxval=0.1)).tolist())))
        elif name == "noise":
            k_std, k_noise = jax.random.split(k_t)
            draws.append((name, dict(std=float(jax.random.uniform(
                k_std, (), minval=0.01, maxval=0.1)), field=np.array(
                jax.random.normal(k_noise, v.shape, jnp.float32)))))
        else:
            draws.append((name, dict(g=float(jnp.exp(jax.random.uniform(
                k_t, (), minval=-0.3, maxval=0.3))))))
    out = tv
    for name, p in draws:
        if name == "noise":
            out = ta.apply_noise(out, p["std"], torch.from_numpy(p["field"]))
        else:
            out = ta._APPLY[name](out, **p)
    _close(out, ja.augment_volume(key, jv, prob=1.0), FFT_TOL)


# -- subject level -----------------------------------------------------------

def test_augment_subject_keeps_the_original_target():
    rng = np.random.default_rng(1)
    subject = {"dwi-tensor": torch.from_numpy(rng.random((8, 8, 8, 6)).astype(np.float32)),
               "pc-bssfp": torch.from_numpy(rng.random((8, 8, 8, 24)).astype(np.float32))}
    out = ta.augment_subject(torch.Generator().manual_seed(0), subject, prob=1.0)
    assert set(out) == {"dwi-tensor", "pc-bssfp", "dwi-tensor_orig"}
    assert torch.equal(out["dwi-tensor_orig"], subject["dwi-tensor"])
    assert not torch.allclose(out["dwi-tensor"], subject["dwi-tensor"])
    assert out["pc-bssfp"].shape == (8, 8, 8, 24)
    # keep={} falls back to the default, as in the JAX package
    again = ta.augment_subject(torch.Generator().manual_seed(0), subject, prob=1.0, keep={})
    assert torch.equal(again["dwi-tensor_orig"], subject["dwi-tensor"])
    assert torch.equal(again["dwi-tensor"], out["dwi-tensor"])


def test_augment_subject_same_params_across_images():
    v = torch.from_numpy(_vol((8, 8, 8, 1), 11))
    out = ta.augment_subject(torch.Generator().manual_seed(11), {"a": v, "b": v.clone()},
                             prob=1.0, keep={"x": "y"})
    assert torch.equal(out["a"], out["b"])
    with pytest.raises(ValueError, match="spatial"):
        ta.augment_subject(torch.Generator(), {"a": v, "b": v[:4]}, prob=1.0)


# -- the distribution tests of tests/test_augment_distributions.py -----------

def _many(fn, vol, n=64, **kw):
    return np.stack([fn(torch.Generator().manual_seed(i), vol, **kw).numpy()
                     for i in range(n)])


def test_noise_std_in_sampled_range():
    outs = _many(ta.random_noise, torch.zeros(8, 8, 8, 1), std_range=(0.01, 0.1))
    stds = outs.reshape(64, -1).std(axis=1)
    assert (stds > 0.005).all() and (stds < 0.13).all()
    assert stds.max() > 2 * stds.min()
    assert np.abs(outs.reshape(64, -1).mean(axis=1)).max() < 0.02


def test_gamma_preserves_range_and_monotonic():
    vol = torch.from_numpy(_vol((8, 8, 8, 1), 42))
    outs = _many(ta.random_gamma, vol, n=16)
    assert outs.min() >= 0 and outs.max() <= 1.0 + 1e-6
    order = np.argsort(vol.numpy().ravel())
    for o in outs[:4]:
        assert (np.diff(o.ravel()[order]) >= -1e-6).all()


def test_bias_field_is_multiplicative_smooth():
    out = ta.random_bias_field(torch.Generator().manual_seed(5),
                               torch.ones(12, 12, 12, 1)).numpy()[..., 0]
    assert (out > 0).all()
    dyn = out.max() - out.min()
    assert dyn > 0.01
    assert np.abs(np.diff(out, axis=0)).max() < 0.5 * dyn + 1e-3


def test_spike_adds_periodic_artifact():
    vol = torch.from_numpy(_vol((16, 16, 16, 1), 42))
    diff = ta.random_spike(torch.Generator().manual_seed(1), vol).numpy() - vol.numpy()
    assert np.abs(diff).mean() > 1e-4
    per_voxel = np.abs(diff[..., 0])
    assert per_voxel.max() < 20 * (per_voxel.mean() + 1e-9)


def test_ghosting_attenuates_offcenter_kspace():
    vol = torch.from_numpy(_vol((16, 16, 16, 1), 42))
    out = ta.random_ghosting(torch.Generator().manual_seed(2), vol).numpy()
    spec_in = np.abs(np.fft.fftn(vol.numpy()[..., 0]))
    spec_out = np.abs(np.fft.fftn(out[..., 0]))
    np.testing.assert_allclose(spec_out[0, 0, 0], spec_in[0, 0, 0], rtol=1e-4)
    assert spec_out.sum() < spec_in.sum()


def test_motion_preserves_dc_and_energy_scale():
    vol = torch.from_numpy(_vol((16, 16, 16, 1), 42))
    out = ta.random_motion(torch.Generator().manual_seed(3), vol).numpy()
    e_in, e_out = float((vol.numpy() ** 2).sum()), float((out ** 2).sum())
    assert 0.5 * e_in < e_out < 1.5 * e_in
    assert not np.allclose(out, vol.numpy())


def test_motion_rotation_sensitivity():
    vol = torch.from_numpy(np.cumsum(_vol((16, 16, 16, 1), 42), axis=1).astype(np.float32))
    outs = {deg: ta.random_motion(torch.Generator().manual_seed(5), vol, degrees=deg,
                                  translation=0.0).numpy() for deg in (0.0, 5.0, 30.0)}
    np.testing.assert_allclose(outs[0.0], vol.numpy(), atol=1e-4)
    d_small = np.abs(outs[5.0] - vol.numpy()).mean()
    d_large = np.abs(outs[30.0] - vol.numpy()).mean()
    assert d_small > 1e-5 and d_large > d_small


def test_augmentations_shapes_and_effect():
    vol = torch.from_numpy(_vol((16, 16, 16, 2), 42))
    for name, draw, apply in ta.CHAIN:
        out = apply(vol, **draw(torch.Generator().manual_seed(3), vol.shape))
        assert out.shape == vol.shape, name
        assert torch.isfinite(out).all(), name
        if name != "blur":  # sub-voxel blur is a near-identity by design
            assert not torch.allclose(out, vol), name
    blurred = ta.random_blur(torch.Generator().manual_seed(3), vol, std_range=(1.0, 2.0))
    assert not torch.allclose(blurred, vol)
    assert float(blurred.std()) < float(vol.std())
