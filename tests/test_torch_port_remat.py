"""``ModelConfig.remat`` in the port: the generator's blocks recomputed in the
backward (``torch.utils.checkpoint``), as the JAX package wraps them in
``nn.remat`` (``unet_bssfp_tpu/models/unet.py:86-109``). A GAN step with
remat on gives the step with remat off bit for bit: every gradient, every
parameter and BatchNorm buffer, the losses, and the dropout generator's
state after the step (dropout 0.05, drawn from the state's generator)."""

import dataclasses

import pytest
import torch

from unet_bssfp_tpu_torch.config import ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.models import packed_layers
from unet_bssfp_tpu_torch.models import unet as unet_mod
from unet_bssfp_tpu_torch.train.state import create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_train_step

torch.set_num_threads(1)

PATCH = 16
MCFG = ModelConfig(features=(4, 8, 8, 16, 16, 4), disc_features=(8, 8, 16),
                   compute_dtype="float32", dropout=0.05)
# The blocks the JAX package wraps: TwoConv (conv_0), Down (down_1..4), UpCat
# (upcat_4..1); packed: PackedTwoConv, PooledConvs and PackedUpCat in the
# same places.
WRAPPED = ["conv_0", "down_1", "down_2", "down_3", "down_4",
           "upcat_4", "upcat_3", "upcat_2", "upcat_1"]


def _batch(n=2):
    g = torch.Generator().manual_seed(7)
    return (torch.rand(n, PATCH, PATCH, PATCH, 24, generator=g),
            torch.rand(n, PATCH, PATCH, PATCH, 6, generator=g))


def _step(remat, packed, n_steps=1):
    mcfg = dataclasses.replace(MCFG, remat=remat, packed=packed)
    state = create_gan_state(5, "pc-bssfp", mcfg, TrainConfig(), "cpu")
    step = make_train_step(state.gen, state.disc, TrainConfig())
    x, y = _batch()
    metrics = [step(state, x, y) for _ in range(n_steps)]
    return state, metrics


@pytest.mark.parametrize("packed", [False, True])
def test_remat_step_equals_the_plain_step_bit_for_bit(packed):
    ref, ref_m = _step(False, packed, n_steps=2)
    got, got_m = _step(True, packed, n_steps=2)
    assert got.gen.unet.remat and not ref.gen.unet.remat
    assert [{k: float(v) for k, v in m.items()} for m in got_m] == \
        [{k: float(v) for k, v in m.items()} for m in ref_m]
    for name in ("gen", "disc"):
        a, b = getattr(ref, name), getattr(got, name)
        # after the step each model holds its own phase's gradients
        grads = [(k, p.grad) for k, p in a.named_parameters()]
        assert all(g is not None for _, g in grads)
        for (k, ga), (_, gb) in zip(grads, [(k, p.grad) for k, p in b.named_parameters()]):
            assert torch.equal(ga, gb), (name, k)
        sa, sb = a.state_dict(), b.state_dict()  # parameters and BN buffers
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    assert torch.equal(got.rng.get_state(), ref.rng.get_state())


@pytest.mark.parametrize("packed", [False, True])
def test_remat_wraps_the_jax_blocks_and_recomputes_them(packed, monkeypatch):
    """The blocks run under ``layers.remat`` are JAX's; each one's forward
    runs again in the backward (a hook counts conv_0's first conv), and an
    eval step or a ``no_grad`` forward recomputes nothing."""
    wrapped = []
    real = unet_mod.remat

    def spy(module, fn, *args):
        wrapped.append(next(n for n, m in state.gen.unet.named_children() if m is module))
        return real(module, fn, *args)

    monkeypatch.setattr(unet_mod, "remat", spy)
    mcfg = dataclasses.replace(MCFG, remat=True, packed=packed)
    state = create_gan_state(5, "pc-bssfp", mcfg, TrainConfig(), "cpu")
    calls = []
    if packed:  # the packed stages' four convs (K1 on the card)
        conv = packed_layers.conv3x3_packed_auto
        monkeypatch.setattr(packed_layers, "conv3x3_packed_auto",
                            lambda *a: calls.append(1) or conv(*a))
        per_forward = 4
    else:
        state.gen.unet.conv_0.conv_0.conv.register_forward_hook(
            lambda *a: calls.append(1))
        per_forward = 1
    x, y = _batch()
    make_train_step(state.gen, state.disc, TrainConfig())(state, x, y)
    # gen phase forward + its recompute + the disc phase's no_grad forward
    assert len(calls) == 3 * per_forward
    assert wrapped == WRAPPED
    calls.clear()
    make_eval_step(state.gen, state.disc, TrainConfig())(state, x, y)
    assert len(calls) == per_forward


def test_remat_reaches_the_model_from_the_config():
    state = create_gan_state(0, "pc-bssfp", dataclasses.replace(MCFG, remat=True),
                             TrainConfig(), "cpu")
    assert state.gen.unet.remat
    state = create_gan_state(0, "pc-bssfp", MCFG, TrainConfig(), "cpu")
    assert not state.gen.unet.remat
