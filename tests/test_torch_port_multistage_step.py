"""One supervised step of each stage of the multi-stage regime
(``train/multistage.py``) against ``jax.grad`` of the JAX package's loss
``L1 + (1 − SSIM)`` on the same weights and batch, as
``test_torch_port_train_grads.py`` holds the GAN step: the JAX reference in
float64, the port in f32, every leaf's gradient to 1e-4 of its largest
entry. PRETRAIN (dwi-tensor) on the plain convs, TRANSFER and FINE_TUNE
(pc-bssfp) on the packed ones; TRANSFER leaves every backbone parameter bit
for bit where it was and moves the head; FINE_TUNE steps at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.models.multi_input_unet import MultiInputUNet as JaxMultiInputUNet
from unet_bssfp_tpu.ops.losses import l1_loss as jax_l1, ssim_loss as jax_ssim_loss
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import MODALITY_CHANNELS, TrainConfig
from unet_bssfp_tpu_torch.models import TrainingState
from unet_bssfp_tpu_torch.train.multistage import (
    create_supervised_state,
    make_supervised_train_step,
)
from test_torch_port_multistage import FEATURES, PATCH, _jax_params, _port_net

torch.set_num_threads(1)

CASES = [(TrainingState.PRETRAIN, "dwi-tensor", False),
         (TrainingState.TRANSFER, "pc-bssfp", True),
         (TrainingState.FINE_TUNE, "pc-bssfp", True)]


def _conv_bias_before_norm(name: str) -> bool:
    """A conv bias followed by InstanceNorm: its true gradient is exactly 0."""
    return name.endswith((".conv.bias", "conv_in.bias", "conv_mid.bias", "conv_out.bias"))


@pytest.mark.parametrize("stage,modality,packed", CASES)
def test_stage_step_matches_jax(stage, modality, packed):
    params = _jax_params(modality, 31)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, PATCH, PATCH, PATCH, MODALITY_CHANNELS[modality])).astype(
        np.float32)
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    with jax.enable_x64(True):
        jnet = JaxMultiInputUNet(modality=modality, features=FEATURES, dropout=0.0,
                                 dtype=jnp.float64, use_fused=False, packed=packed)
        x64 = jnp.asarray(x, jnp.float64)
        apply = jax.jit(lambda p: jnet.apply({"params": p}, x64, train=True))
        y_hat0 = np.asarray(apply(f64(params)))
        # every voxel ≥ 0.05 from the prediction: no L1 sign flips between
        # the two packages' roundings
        y = (y_hat0 + np.where(rng.random(y_hat0.shape) < 0.5, -1, 1)
             * (0.05 + 0.2 * rng.random(y_hat0.shape))).astype(np.float32)
        y64 = jnp.asarray(y, jnp.float64)

        def loss_fn(p):
            y_hat = jnet.apply({"params": p}, x64, train=True)
            terms = {"L1": jax_l1(y_hat, y64), "SSIM": jax_ssim_loss(y_hat, y64)}
            return sum(terms.values()), terms

        (ref_loss, ref_terms), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64(params))
        ref = {k: v.numpy() for k, v in
               weights.from_flax(jax.tree.map(np.asarray, ref_grads)).items()}

    net = _port_net(modality, packed)
    tcfg = TrainConfig()
    state = create_supervised_state(0, net, tcfg, stage, state_dict=weights.from_flax(params))
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    metrics = make_supervised_train_step(net, tcfg)(state, torch.from_numpy(x),
                                                    torch.from_numpy(y))
    assert state.step == 1 and list(metrics) == ["train_loss", "train_loss_L1",
                                                 "train_loss_SSIM"]
    np.testing.assert_allclose(float(metrics["train_loss"]), float(ref_loss), rtol=1e-5)
    for name in ("L1", "SSIM"):
        np.testing.assert_allclose(float(metrics[f"train_loss_{name}"]),
                                   float(ref_terms[name]), rtol=1e-5, err_msg=name)

    named = dict(net.named_parameters())
    assert named.keys() == ref.keys()
    trained = {k for k in named if stage != TrainingState.TRANSFER or k.startswith("head")}
    scale = max(float(np.abs(ref[k]).max()) for k in trained)
    for name, p in named.items():
        if name not in trained:
            # frozen: no gradient taken, and not a bit moved
            assert p.grad is None and not p.requires_grad, name
            assert torch.equal(p.detach(), before[name]), name
            continue
        assert not torch.equal(p.detach(), before[name]), name
        if _conv_bias_before_norm(name):
            # the f32 result is cancellation noise, bounded against the
            # largest gradient of the net (as the GAN step's test does)
            np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                       atol=5e-5 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                       atol=1e-4 * np.abs(ref[name]).max(), err_msg=name)
    lr = {TrainingState.FINE_TUNE: 1e-5}.get(stage, tcfg.lr)
    assert [g["lr"] for g in state.opt.param_groups] == [lr]
    assert sum(len(g["params"]) for g in state.opt.param_groups) == len(trained)
