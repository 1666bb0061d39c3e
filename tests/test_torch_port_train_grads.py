"""One generator-phase backward of the port against ``jax.grad`` of the JAX
package's generator loss, leaf by leaf, on the same weights and batch, with
``packed`` off (plain PyTorch convs) and on (the packed conv's autograd:
dgrad and wgrad launches, pack/unpack backward, first-match pool
backward).

The JAX reference runs in float64 (``jax.enable_x64``), the port in f32.
Measured on this test's net and batch: the JAX package's own f32 gradients
deviate from its float64 ones by up to 2e-2 of a leaf's largest entry
(XLA:CPU), the port's f32 gradients by under 1e-5. So an f32-against-f32
comparison could only hold the port to 5e-2; against float64 it is held to
1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig
from unet_bssfp_tpu.ops.losses import bce_with_logits as jax_bce, l1_loss as jax_l1
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import TrainConfig
from unet_bssfp_tpu_torch.ops.losses import bce_with_logits, l1_loss
from unet_bssfp_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch
from unet_bssfp_tpu_torch.train.state import build_models
from test_torch_port_models import random_variables
from test_torch_port_train_models import DISC_FEATURES, FEATURES, PATCH, _cfgs

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_reference(packed):
    """The batch, the weights and ``jax.grad`` of the JAX package's
    generator loss in float64 (one compile per ``packed``, shared by the
    unsharded and the sharded test)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, PATCH, PATCH, PATCH, 24)).astype(np.float32)
    rf = TrainConfig().recon_factor
    with jax.enable_x64(True):
        jcfg = JaxModelConfig(features=FEATURES, disc_features=DISC_FEATURES,
                              compute_dtype="float64", dropout=0.0, folded=False,
                              packed=packed)
        jgen, jdisc = jax_build_models("pc-bssfp", jcfg)
        x64 = jnp.asarray(x, jnp.float64)
        init = jax.jit(jgen.init, static_argnames="train")
        gvars = random_variables(init(jax.random.PRNGKey(0), x64, train=False), 11)
        y_hat0 = np.asarray(jax.jit(lambda v: jgen.apply(
            v, x64, train=True, mutable=["batch_stats"])[0])(gvars))
        # The target keeps every voxel ≥ 0.05 from the prediction, so no L1
        # sign can flip between the two packages' roundings.
        y = (y_hat0 + np.where(rng.random(y_hat0.shape) < 0.5, -1, 1)
             * (0.05 + 0.2 * rng.random(y_hat0.shape))).astype(np.float32)
        dvars = random_variables(jax.jit(jdisc.init, static_argnames="train")(
            jax.random.PRNGKey(1), x64, jnp.asarray(y, jnp.float64), train=False), 12)
        f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731

        def jax_loss(params):
            y_hat, _ = jgen.apply({"params": params, "batch_stats": f64(gvars["batch_stats"])},
                                  x64, train=True, mutable=["batch_stats"])
            logits, _ = jdisc.apply(f64(dvars), x64, y_hat, train=True, mutable=["batch_stats"])
            return (jax_bce(logits, jnp.ones_like(logits))
                    + jax_l1(y_hat, jnp.asarray(y, jnp.float64)) * rf)

        ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(f64(gvars["params"]))
        ref = {k: v.numpy() for k, v in
               weights.from_flax(jax.tree.map(np.asarray, ref_grads)).items()}
    return x, y, gvars, dvars, float(ref_loss), ref


def check_port_gradients(packed, mesh=None):
    """The port's generator-phase backward on the reference's weights and
    batch, f32, unsharded or on ``mesh`` (G and D on the shards, the loss on
    the gathered outputs), against ``jax_reference``."""
    x, y, gvars, dvars, ref_loss, ref = jax_reference(packed)
    _, cfg = _cfgs(packed=packed)
    rf = TrainConfig().recon_factor
    gen, disc = build_models("pc-bssfp", cfg, "cpu", mesh=mesh)
    gen.load_state_dict(weights.from_flax(gvars["params"], gvars["batch_stats"]))
    disc.load_state_dict(weights.from_flax(dvars["params"], dvars["batch_stats"]))
    gen.train()
    disc.train()
    disc.requires_grad_(False)
    xt = torch.from_numpy(x)
    if mesh is None:
        y_hat = gen(xt)
        logits = disc(xt, y_hat)
    else:
        xs = shard_batch(mesh, xt)
        y_hat = gen(xs)
        logits, y_hat = gather_batch(disc(xs, y_hat)), gather_batch(y_hat)
    loss = (bce_with_logits(logits, torch.ones_like(logits))
            + l1_loss(y_hat, torch.from_numpy(y)) * rf)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    assert all(p.grad is None for p in disc.parameters())

    named = dict(gen.named_parameters())
    assert named.keys() == ref.keys()
    scale = max(float(np.abs(g).max()) for g in ref.values())
    for name, p in named.items():
        if name.endswith(".conv.bias"):
            # A conv bias followed by InstanceNorm (or by the head's
            # train-mode BatchNorm) has a true gradient of exactly 0: the f32
            # result is cancellation noise, bounded against the largest
            # gradient of the net (measured ≤ 6e-6 of it).
            np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                       atol=5e-5 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                       atol=1e-4 * np.abs(ref[name]).max(), err_msg=name)


@pytest.mark.parametrize("packed", [False, True])
def test_generator_phase_gradients_match_jax(packed):
    check_port_gradients(packed)


@pytest.mark.parametrize("packed", [False, True])
def test_sharded_generator_phase_gradients_match_jax(packed):
    """The same backward on a (data, space) = (2, 2) mesh of CPU positions
    (B 1, D 16 a shard: the head's and the discriminator's BatchNorm take
    the global batch's moments, every conv its d halo), held to the same
    bounds against the JAX package's float64 gradients."""
    check_port_gradients(packed, make_mesh(["cpu"] * 4, ("data", "space"), (2, 2)))
