"""The training slice's models, losses and metrics against the JAX
package's, on the same weights (``weights.from_flax``) and inputs, in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig
from unet_bssfp_tpu.config import TrainConfig as JaxTrainConfig
from unet_bssfp_tpu.ops import losses as jax_losses
from unet_bssfp_tpu.ops import metrics as jax_metrics
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu.train.state import GANTrainState as JaxGANTrainState
from unet_bssfp_tpu.train.state import make_optimizer as jax_make_optimizer
from unet_bssfp_tpu.train.steps import make_eval_step as jax_make_eval_step
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.ops import losses, metrics
from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_eval_step
from test_torch_port_models import random_variables

torch.set_num_threads(1)

FEATURES = (8, 16, 16, 32, 32, 8)
DISC_FEATURES = (8, 16, 32)
PATCH = 32
# Output tolerance of tests/test_torch_port_models.py (f32, another
# summation order in every conv).
TOL = dict(rtol=2e-4, atol=2e-5)


def _cfgs(**over):
    kw = dict(features=FEATURES, disc_features=DISC_FEATURES,
              compute_dtype="float32", dropout=0.0, **over)
    return JaxModelConfig(folded=False, **kw), ModelConfig(**kw)


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    x = rng.random((n, PATCH, PATCH, PATCH, 24)).astype(np.float32)
    y = rng.random((n, PATCH, PATCH, PATCH, 6)).astype(np.float32)
    return x, y


def jax_state(jgen, jdisc, jtcfg, seed):
    """The JAX package's ``create_gan_state`` with its two inits jitted
    (eager Flax init of the generator takes most of a minute here)."""
    x, y = (np.zeros((1, PATCH, PATCH, PATCH, c), np.float32) for c in (24, 6))
    k_gen, k_disc, k_state = jax.random.split(jax.random.PRNGKey(seed), 3)
    gv = jax.jit(jgen.init, static_argnames="train")(k_gen, x, train=False)
    dv = jax.jit(jdisc.init, static_argnames="train")(k_disc, x, y, train=False)
    opt = jax_make_optimizer(jtcfg)
    return JaxGANTrainState(
        step=jnp.zeros((), jnp.int32), rng=k_state,
        gen_params=gv["params"], gen_batch_stats=gv["batch_stats"],
        disc_params=dv["params"], disc_batch_stats=dv["batch_stats"],
        gen_opt_state=opt.init(gv["params"]), disc_opt_state=opt.init(dv["params"]))


def port_state(jstate, cfg, tcfg):
    """The port's train state holding ``jstate``'s weights and statistics."""
    state = create_gan_state(0, "pc-bssfp", cfg, tcfg, "cpu")
    weights.state_from_flax(state.gen, state.disc, {
        k: jax.tree.map(np.asarray, getattr(jstate, k))
        for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")})
    return state


@pytest.fixture(scope="module")
def discs():
    jcfg, cfg = _cfgs()
    _, jdisc = jax_build_models("pc-bssfp", jcfg)
    x, y = _batch(0)
    variables = random_variables(
        jdisc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y), train=False), 4)
    _, disc = build_models("pc-bssfp", cfg, "cpu")
    disc.load_state_dict(weights.from_flax(variables["params"], variables["batch_stats"]))
    return jdisc, variables, disc


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches_jax(discs, train):
    """Logits in both modes; in train mode also the BatchNorm running
    statistics after one forward (momentum 0.9, biased batch variance)."""
    jdisc, variables, disc = discs
    sd0 = {k: v.clone() for k, v in disc.state_dict().items()}
    x, y = _batch(1)
    if train:
        ref, mut = jdisc.apply(variables, jnp.asarray(x), jnp.asarray(y), train=True,
                               mutable=["batch_stats"])
        disc.train()
        got = disc(torch.from_numpy(x), torch.from_numpy(y))
    else:
        ref = jdisc.apply(variables, jnp.asarray(x), jnp.asarray(y), train=False)
        disc.eval()
        with torch.no_grad():
            got = disc(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == ref.shape == (2, 4, 4, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    if train:
        stats = weights.from_flax({}, jax.tree.map(np.asarray, mut["batch_stats"]))
        assert len(stats) == 2 * (len(DISC_FEATURES) - 1)
        for key, val in stats.items():
            np.testing.assert_allclose(disc.state_dict()[key].numpy(), val.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
            assert not torch.equal(disc.state_dict()[key], sd0[key]), key
    disc.load_state_dict(sd0)


def test_discriminator_rejects_small_patches(discs):
    disc = discs[2]
    with pytest.raises(ValueError, match="too small"):
        disc(torch.zeros(1, 4, 8, 8, 24), torch.zeros(1, 4, 8, 8, 6))


def test_weights_cover_the_discriminator(discs):
    """from_flax consumes every discriminator leaf once (names d1_head24,
    d2.., final); random_state_dict fills every entry of its state_dict."""
    _, variables, disc = discs
    sd = weights.from_flax(variables["params"], variables["batch_stats"])
    assert sd.keys() == disc.state_dict().keys()
    assert len(sd) == len(jax.tree.leaves(variables))
    assert "d1_head24.conv.weight" in sd and "final.weight" in sd
    rnd = weights.random_state_dict(disc, 3)
    assert {k: v.shape for k, v in rnd.items()} == {
        k: v.shape for k, v in disc.state_dict().items()}


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((2, 3, 16, 16, 16, 2)).astype(np.float32)
    z = (rng.standard_normal((4, 2, 2, 2, 1)) * 30).astype(np.float32)  # saturating logits
    for lab in (np.ones_like(z), np.zeros_like(z), rng.random(z.shape).astype(np.float32)):
        np.testing.assert_allclose(
            float(losses.bce_with_logits(torch.from_numpy(z), torch.from_numpy(lab))),
            float(jax_losses.bce_with_logits(jnp.asarray(z), jnp.asarray(lab))), rtol=1e-6)
    np.testing.assert_allclose(float(losses.l1_loss(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jax_losses.l1_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(losses.ssim_loss(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jax_losses.ssim_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16, 16, 16, 6), (1, 8, 10, 9, 3)])
def test_metrics_match_jax(shape):
    """PSNR, MAE and SSIM per item; the second shape shrinks the SSIM window
    to the smallest (odd) spatial dim."""
    rng = np.random.default_rng(6)
    y = rng.random(shape).astype(np.float32)
    p = (y + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    for name in ("psnr", "mae", "ssim3d"):
        got = getattr(metrics, name)(torch.from_numpy(p), torch.from_numpy(y))
        ref = getattr(jax_metrics, name)(jnp.asarray(p), jnp.asarray(y))
        assert got.shape == ref.shape == (shape[0],)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("packed", [False, True])
def test_eval_step_matches_jax(packed):
    """make_eval_step's losses and PSNR/SSIM/L1 on the same weights."""
    jcfg, cfg = _cfgs(packed=packed)
    jtcfg = JaxTrainConfig()
    jgen, jdisc = jax_build_models("pc-bssfp", jcfg)
    jstate = jax_state(jgen, jdisc, jtcfg, 5)
    x, y = _batch(3)
    ref, ref_y = jax_make_eval_step(jgen, jdisc, jtcfg)(jstate, jnp.asarray(x), jnp.asarray(y))

    state = port_state(jstate, cfg, TrainConfig())
    got, y_hat = make_eval_step(state.gen, state.disc, TrainConfig())(
        state, torch.from_numpy(x), torch.from_numpy(y))
    # f32 summation order over the 23 convs of a 32³ patch, relative to the
    # output's scale (tests/test_torch_parity.py's 1e-3 of max, 10× tighter).
    ref_y = np.asarray(ref_y)
    np.testing.assert_allclose(y_hat.numpy(), ref_y, rtol=2e-4,
                               atol=1e-4 * np.abs(ref_y).max())
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
