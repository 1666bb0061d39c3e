"""The port's MedicalNet (``models/medicalnet.py``), its FID
(``ops/metrics.py``, ``train/steps.py:make_medicalnet_fid_fn``) and the
perceptual term's wiring (``train/loop.py``) against the JAX package's, on
the CPU: the same weights (JAX's ``init_medicalnet`` draw carried across by
``weights.medicalnet_from_flax``, and a synthetic Med3D ``.npz`` loaded by
both packages) and inputs from a numpy seed, in f32."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import TrainConfig as JaxTrainConfig
from unet_bssfp_tpu.models import medicalnet as jmn
from unet_bssfp_tpu.ops import metrics as jax_metrics
from unet_bssfp_tpu.train import loop as jax_loop
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu.train.steps import make_eval_step as jax_make_eval_step
from unet_bssfp_tpu.train.steps import make_medicalnet_fid_fn as jax_make_fid_fn
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, TrainConfig
from unet_bssfp_tpu_torch.models import medicalnet as mn
from unet_bssfp_tpu_torch.ops import metrics
from unet_bssfp_tpu_torch.train import loop
from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_medicalnet_fid_fn
from test_medicalnet import _synthetic_med3d_state_dict
from test_torch_port_train_models import _cfgs, jax_state, port_state

torch.set_num_threads(1)

# Features: f32 sums in another order through 11 convs, 4 BatchNorms and a
# pool; 1e-4 of the largest feature.
FEAT_TOL = 1e-4
ODD = (2, 17, 16, 19, 1)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_draw():
    """JAX's ``init_medicalnet(seed=0)`` and the port's net on its weights."""
    net, variables = jmn.init_medicalnet(seed=0)
    port = mn.init_medicalnet(seed=1)
    port.load_state_dict(weights.medicalnet_from_flax(jax.tree.map(np.asarray, variables)))
    return net, variables, port


@pytest.fixture(scope="module")
def med3d_npz(tmp_path_factory):
    """A synthetic Med3D file as ``tools/convert_medicalnet.py`` writes it:
    ``module.``-prefixed keys, the segmentation head, provenance entries."""
    sd = _synthetic_med3d_state_dict(torch, seed=7)
    rng = np.random.default_rng(0)
    sd["module.conv_seg.0.weight"] = rng.standard_normal((8, 512, 3, 3, 3)).astype(np.float32)
    path = tmp_path_factory.mktemp("med3d") / "med3d.npz"
    np.savez(path, __source_sha256__=np.asarray("ab" * 32),
             __source_file__=np.asarray("resnet_10_23dataset.pth"), **sd)
    return str(path)


def _apply(net, variables, x):
    return np.asarray(jax.jit(lambda v, a: net.apply(v, a, train=False))(variables, jnp.asarray(x)))


def _fid_tol(fx, fy):
    """The bound on |port − JAX| of ``fid(fx, fy)``: 1e-5 of the scale of its
    terms (tr Sx + tr Sy + |mu_x − mu_y|²), plus the eigen solvers' part.
    The centred Gram matrix CᵀC has rank ≤ N − 1, so one eigenvalue is 0 and
    comes out of either solver as ±k·u·λmax; clamped and square-rooted it
    adds up to sqrt(k·u·λmax)/(N − 1) to tr (Sx Sy)^½, which counts twice
    (k = N here)."""
    n = fx.shape[0]
    mx, my = fx.mean(0), fy.mean(0)
    scale = float(metrics._cov(fx).trace() + metrics._cov(fy).trace() + (mx - my) @ (mx - my))
    a, b = fx - fx.mean(0, keepdim=True), fy - fy.mean(0, keepdim=True)
    lam = float(torch.linalg.eigvalsh((b @ a.T).T @ (b @ a.T)).max())
    return 1e-5 * scale + 2 * n * (n * 2.0 ** -24 * max(lam, 0.0)) ** 0.5 / max(n - 1, 1), scale


def _close(got, ref, tol=FEAT_TOL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("shape", [ODD, (1, 16, 16, 16, 1)])
def test_features_of_the_jax_draw_match_jax(jax_draw, shape):
    """Odd extents (the stem, pool and strides round) and even ones (JAX
    takes its space-to-depth stem and phase-split dilated convs there)."""
    net, variables, port = jax_draw
    x = _x(shape, 1)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), _apply(net, variables, x))


def test_synthetic_med3d_file_loads_alike_in_both_packages(med3d_npz, caplog):
    assert mn.medicalnet_is_pretrained(med3d_npz) and jmn.medicalnet_is_pretrained(med3d_npz)
    with caplog.at_level(logging.INFO, logger=mn.__name__):
        port = mn.load_medicalnet(med3d_npz)
    assert "PRETRAINED" in caplog.text and "resnet_10_23dataset.pth" in caplog.text
    assert not port.training and not any(p.requires_grad for p in port.parameters())
    net, variables = jmn.load_medicalnet(med3d_npz)
    x = _x(ODD, 2)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, _apply(net, variables, x))
    # the keys of the file are the net's own (Med3D's torch names)
    sd = _synthetic_med3d_state_dict(torch, seed=7)
    own = mn.medicalnet_state_dict(sd)
    assert set(own) == {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    assert torch.equal(port.state_dict()["layer4.0.downsample.1.running_var"],
                       own["layer4.0.downsample.1.running_var"])


def test_medicalnet_state_dict_names_a_missing_key():
    sd = _synthetic_med3d_state_dict(torch, seed=1)
    sd.pop("module.layer3.0.bn2.running_mean")
    with pytest.raises(KeyError, match="layer3.0.bn2.running_mean"):
        mn.medicalnet_state_dict(sd)


def test_medicalnet_features_are_channel_major_as_jax(jax_draw):
    net, variables, port = jax_draw
    x = _x((2, 16, 16, 16, 3), 3)
    ref = jmn.medicalnet_features(net, variables, jnp.asarray(x))
    with torch.no_grad():
        got = mn.medicalnet_features(port, torch.from_numpy(x))
    assert got.shape == (2, 2, 2, 2, 3 * 512)
    _close(got.numpy(), ref)


def test_the_net_refuses_more_than_one_channel():
    with pytest.raises(ValueError, match="single-channel"):
        mn.init_medicalnet()(torch.zeros(1, 8, 8, 8, 2))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_fid_cov_and_spatial_average_match_jax(n):
    rng = np.random.default_rng(n)
    fx = rng.standard_normal((n, 2, 3, 2, 64)).astype(np.float32)
    fy = (0.5 * fx + rng.standard_normal(fx.shape)).astype(np.float32)
    ax, ay = (metrics.spatial_average(torch.from_numpy(f)) for f in (fx, fy))
    jx, jy = (jax_metrics.spatial_average(jnp.asarray(f)) for f in (fx, fy))
    np.testing.assert_allclose(ax.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(metrics._cov(ax).numpy(), np.asarray(jax_metrics._cov(jx)),
                               rtol=1e-5, atol=1e-6)
    got = float(metrics.fid(ax, ay))
    ref = float(jax_metrics.fid(jx, jy))
    tol, scale = _fid_tol(ax, ay)
    assert abs(got - ref) <= tol, (got, ref, tol)
    if n == 1:  # both covariances 0: |mu_x - mu_y|² by construction
        mx, my = ax.mean(0), ay.mean(0)
        assert got == pytest.approx(float((mx - my) @ (mx - my)), rel=1e-6)
        assert tol == 1e-5 * scale
    assert float(metrics.fid(ax, ax)) <= _fid_tol(ax, ax)[0]


@pytest.mark.parametrize("chunk", [None, 3, 5])
def test_perceptual_distance_matches_jax(jax_draw, chunk):
    """``chunk`` 3 divides the 6 slabs of a side and runs them in 2 groups; 5
    does not divide them and runs them in one."""
    net, variables, port = jax_draw
    a, b = _x((2, 16, 16, 16, 3), 4), _x((2, 16, 16, 16, 3), 5)
    ref = float(jmn.perceptual_distance(net, variables, jnp.asarray(a), jnp.asarray(b),
                                        chunk=chunk))
    with torch.no_grad():
        got = float(mn.perceptual_distance(port, torch.from_numpy(a), torch.from_numpy(b),
                                           chunk=chunk))
    assert got == pytest.approx(ref, rel=1e-4)
    assert ref > 0


def test_perceptual_gradient_flows_through_pred_only_as_jax(jax_draw):
    net, variables, port = jax_draw
    a, b = _x((1, 16, 16, 16, 2), 6), _x((1, 16, 16, 16, 2), 7)
    ref = np.asarray(jax.jit(jax.grad(
        lambda p, t: jmn.perceptual_distance(net, variables, p, t)))(jnp.asarray(a),
                                                                     jnp.asarray(b)))
    pred, target = (torch.from_numpy(v).requires_grad_(True) for v in (a, b))
    mn.perceptual_distance(port, pred, target).backward()
    got = pred.grad.numpy()
    assert target.grad is None  # the target's features ran without autograd
    assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref)
    assert np.abs(ref).sum() > 0


def test_fingerprint_accepts_the_pinned_inventory_and_rejects_others():
    assert mn.MEDICALNET_FINGERPRINT == jmn.MEDICALNET_FINGERPRINT
    assert mn.MEDICALNET_SOURCE == jmn.MEDICALNET_SOURCE
    mn.check_medicalnet_fingerprint(_synthetic_med3d_state_dict(torch))
    sd = _synthetic_med3d_state_dict(torch)
    sd.pop("module.layer4.0.conv1.weight")
    with pytest.raises(ValueError, match="layer4.0.conv1"):
        mn.check_medicalnet_fingerprint(sd)
    sd = _synthetic_med3d_state_dict(torch)
    sd["module.conv1.weight"] = sd["module.conv1.weight"][:32]
    with pytest.raises(ValueError, match="conv1.weight"):
        mn.check_medicalnet_fingerprint(sd)


def test_resolve_medicalnet_path_order_and_pretrained_check(tmp_path, monkeypatch, caplog):
    monkeypatch.delenv("UNET_BSSFP_MEDICALNET", raising=False)
    # no argument, no variable: the repository's weights/ drop-in, if any
    assert mn.resolve_medicalnet_path(None) == jmn.resolve_medicalnet_path(None)
    stray = tmp_path / "stray.npz"
    np.savez(stray, x=np.zeros(1))
    monkeypatch.setenv("UNET_BSSFP_MEDICALNET", str(stray))
    assert mn.resolve_medicalnet_path(None) == str(stray)
    with caplog.at_level(logging.WARNING, logger=mn.__name__):
        assert not mn.medicalnet_is_pretrained(None)
    assert "failed the pinned fingerprint check" in caplog.text
    assert not jmn.medicalnet_is_pretrained(None)
    good = tmp_path / "good.npz"
    np.savez(good, **_synthetic_med3d_state_dict(torch, seed=3))
    monkeypatch.setenv("UNET_BSSFP_MEDICALNET", str(good))
    assert mn.medicalnet_is_pretrained(None) and jmn.medicalnet_is_pretrained(None)
    assert (str(good.resolve()), good.stat().st_mtime) in mn._pretrained_cache
    # the argument wins over the variable, even where it is missing
    assert mn.resolve_medicalnet_path("/elsewhere.npz") == "/elsewhere.npz"
    assert not mn.medicalnet_is_pretrained("/elsewhere.npz")
    truncated = tmp_path / "truncated.npz"
    truncated.write_bytes(good.read_bytes()[:1000])
    assert not mn.medicalnet_is_pretrained(str(truncated))


def test_random_feature_mode_is_frozen_and_labelled(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger=mn.__name__):
        net = mn.load_medicalnet(str(tmp_path / "missing.npz"), dtype=torch.bfloat16)
    assert "RANDOM-FEATURE mode" in caplog.text
    assert not net.training and net.conv1.weight.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in net.parameters())
    # the seeded draw repeats and is Flax's initialisation in distribution
    a, b = mn.init_medicalnet(0), mn.init_medicalnet(0)
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    w = a.layer4[0].conv2.weight
    std = (1.0 / w[0].numel()) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert float(w.std()) == pytest.approx(std, rel=0.02)
    assert torch.equal(a.bn1.running_var, torch.ones(64))
    assert make_medicalnet_fid_fn(net).label == "FID_random_features"
    assert make_medicalnet_fid_fn(net, pretrained=True).label == "FID"
    assert jax_make_fid_fn(None, None).label == "FID_random_features"


def test_fid_fn_matches_jax(jax_draw):
    net, variables, port = jax_draw
    a, b = _x((2, 16, 16, 16, 6), 8), _x((2, 16, 16, 16, 6), 9)
    ref = float(jax_make_fid_fn(net, variables, pretrained=True)(jnp.asarray(a), jnp.asarray(b)))
    fid_fn = make_medicalnet_fid_fn(port, pretrained=True)
    got = float(fid_fn(torch.from_numpy(a), torch.from_numpy(b)))
    with torch.no_grad():
        fx, fy = (metrics.spatial_average(mn.medicalnet_features(port, metrics.znorm(
            torch.from_numpy(v)))) for v in (a, b))
    tol, scale = _fid_tol(fx, fy)
    # the features themselves differ by FEAT_TOL: 1e-4 of the scale for them
    assert abs(got - ref) <= tol + 1e-4 * scale, (got, ref, tol, scale)


def test_eval_step_with_fid_and_perceptual_matches_jax(jax_draw):
    """``make_eval_step`` with the perceptual term and the FID, against the
    JAX package's on the same generator, discriminator and MedicalNet."""
    net, variables, port = jax_draw
    jcfg, cfg = _cfgs(packed=False)
    jtcfg, tcfg = JaxTrainConfig(), TrainConfig()
    jgen, jdisc = jax_build_models("pc-bssfp", jcfg)
    jstate = jax_state(jgen, jdisc, jtcfg, 5)
    rng = np.random.default_rng(3)
    x = rng.random((2, 16, 16, 16, 24)).astype(np.float32)
    y = rng.random((2, 16, 16, 16, 6)).astype(np.float32)
    ref, _ = jax_make_eval_step(
        jgen, jdisc, jtcfg, perceptual_fn=lambda p, t: jmn.perceptual_distance(
            net, variables, p, t), fid_fn=jax_make_fid_fn(net, variables))(
        jstate, jnp.asarray(x), jnp.asarray(y))
    state = port_state(jstate, cfg, tcfg)
    got, _ = make_eval_step(state.gen, state.disc, tcfg,
                            perceptual_fn=lambda p, t: mn.perceptual_distance(port, p, t),
                            fid_fn=make_medicalnet_fid_fn(port))(
        state, torch.from_numpy(x), torch.from_numpy(y))
    assert got.keys() == ref.keys()
    assert {"val_gen_loss_recon_Perceptual", "val_metric_FID_random_features"} <= set(got)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    bare, _ = make_eval_step(state.gen, state.disc, tcfg, with_metrics=False,
                             fid_fn=make_medicalnet_fid_fn(port))(
        state, torch.from_numpy(x), torch.from_numpy(y))
    assert not any(k.startswith("val_metric_") for k in bare)


def test_auto_gate_stays_off_at_1e3_as_jax(med3d_npz, caplog):
    """Weights that pass the fingerprint never turn the term on at the
    reference's factor 1e3 (tests/test_medicalnet.py:260); an explicit
    True or False wins; auto without weights is off. Each with the JAX
    package's answer."""
    assert loop.PERCEPTUAL_AUTO_MAX_FACTOR == jax_loop.PERCEPTUAL_AUTO_MAX_FACTOR == 0.0
    cases = [dict(with_perceptual=None, medicalnet_weights=med3d_npz, perceptual_factor=1e3),
             dict(with_perceptual=True, medicalnet_weights=med3d_npz, perceptual_factor=1e3),
             dict(with_perceptual=False, medicalnet_weights=med3d_npz, perceptual_factor=0.0),
             dict(with_perceptual=None, medicalnet_weights=med3d_npz, perceptual_factor=0.0),
             dict(with_perceptual=None, medicalnet_weights="/missing.npz"),
             dict(with_perceptual=True, medicalnet_weights="/missing.npz")]
    got = []
    for kw in cases:
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=loop.__name__):
            got.append(loop.resolve_with_perceptual(TrainConfig(**kw)))
        if kw["with_perceptual"] is None and not got[-1]:
            assert "with_perceptual=None (auto)" in caplog.text
    assert got == [jax_loop.resolve_with_perceptual(JaxTrainConfig(**kw)) for kw in cases]
    assert got == [False, True, False, True, False, True]


def test_build_perceptual_fn_takes_the_configured_dtype_and_chunk(med3d_npz, monkeypatch):
    cfg = Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, medicalnet_weights=med3d_npz, perceptual_chunk=2))
    seen = {}
    real = loop.perceptual_distance

    def spy(net, pred, target, chunk=None):
        seen.update(dtype=net.conv1.weight.dtype, device=net.conv1.weight.device, chunk=chunk)
        return real(net, pred, target, chunk=chunk)

    monkeypatch.setattr(loop, "perceptual_distance", spy)
    a = torch.from_numpy(_x((1, 16, 16, 16, 2), 10))
    d = loop.build_perceptual_fn(cfg, "cpu")(a, a + 0.1)
    assert seen == dict(dtype=torch.bfloat16, device=torch.device("cpu"), chunk=2)
    assert torch.isfinite(d) and d.dtype == torch.float32
    f32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, perceptual_dtype="float32"))
    loop.build_perceptual_fn(f32, "cpu")(a, a)
    assert seen["dtype"] == torch.float32
    with pytest.raises(ValueError, match="perceptual dtype"):
        loop.build_perceptual_fn(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, perceptual_dtype="int8")), "cpu")
