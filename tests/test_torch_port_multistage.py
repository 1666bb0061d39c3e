"""The port's multi-stage modules (``models/multi_input_unet.py``,
``train/multistage.py``) against the JAX package's on the CPU: the
MultiInputUNet forward on JAX's weights carried across by
``weights.from_flax`` (plain and packed, both head groups, PReLU slopes
drawn away from their 0.25 start), Flax's initialisation of the slopes, the
stages' trainable leaf sets and the TRANSFER graft for all four modalities,
and the eval step's metrics. Widths (4, 8, 8, 16, 16, 4), 16³ patches,
dropout 0, float32."""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import MODALITIES
from unet_bssfp_tpu.config import TrainConfig as JaxTrainConfig
from unet_bssfp_tpu.models.layers import ConvNormAct as JaxConvNormAct
from unet_bssfp_tpu.models.multi_input_unet import MultiInputUNet as JaxMultiInputUNet
from unet_bssfp_tpu.models.multi_input_unet import TrainingState as JaxTrainingState
from unet_bssfp_tpu.models.multi_input_unet import trainable_mask as jax_trainable_mask
from unet_bssfp_tpu.train.multistage import SupervisedState as JaxSupervisedState
from unet_bssfp_tpu.train.multistage import make_supervised_eval_step as jax_eval_step
from unet_bssfp_tpu.train.multistage import transfer_params as jax_transfer_params
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import MODALITY_CHANNELS, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.models import MultiInputUNet, TrainingState, trainable_mask
from unet_bssfp_tpu_torch.models.layers import ConvNormAct
from unet_bssfp_tpu_torch.train.multistage import (
    build_multi_input_unet,
    create_supervised_state,
    make_supervised_eval_step,
    transfer_params,
)
from test_torch_port_models import random_variables

torch.set_num_threads(1)

FEATURES = (4, 8, 8, 16, 16, 4)
PATCH = 16
# tests/test_torch_port_models.py's tolerance: f32, another summation order
# in every conv
TOL = dict(rtol=2e-4, atol=2e-5)


def _jax_net(modality, packed=False):
    return JaxMultiInputUNet(modality=modality, features=FEATURES, dropout=0.0,
                             dtype=jnp.float32, use_fused=False, packed=packed)


class _ShapeInit:
    """A JAX net whose ``init`` gives zeros of the shapes its real ``init``
    would (``jax.eval_shape``: traced, not compiled; an eager Flax init of
    this net compiles for about a minute on the CPU)."""

    def __init__(self, net):
        self.net, self.modality = net, net.modality

    def init(self, rngs, x, train=False):
        shapes = jax.eval_shape(functools.partial(self.net.init, train=train), rngs, x)
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def _jax_params(modality, seed):
    x = jnp.zeros((1, PATCH, PATCH, PATCH, MODALITY_CHANNELS[modality]))
    zeros = _ShapeInit(_jax_net(modality)).init(jax.random.PRNGKey(0), x)
    return random_variables(zeros, seed)["params"]


def _port_net(modality, packed, params=None):
    mcfg = ModelConfig(multistage_features=FEATURES, compute_dtype="float32", dropout=0.0,
                       packed=packed)
    sd = None if params is None else weights.from_flax(params)
    return build_multi_input_unet(modality, mcfg, "cpu", state_dict=sd)


def _port_name(path):
    """A flattened Flax path as the port's parameter name."""
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join(path[:-1] + (leaf,))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("modality", ["dwi-tensor", "pc-bssfp"])
def test_forward_matches_jax(modality, packed):
    params = _jax_params(modality, 21)
    slopes = [np.asarray(v) for k, v in flax.traverse_util.flatten_dict(params).items()
              if k[-1] == "prelu_slope"]
    assert len(slopes) == 18 and all(np.abs(s - 0.25).max() > 0.05 for s in slopes)
    x = np.random.default_rng(2).standard_normal(
        (2, PATCH, PATCH, PATCH, MODALITY_CHANNELS[modality])).astype(np.float32)
    apply = jax.jit(_jax_net(modality, packed).apply, static_argnames="train")
    ref = apply({"params": params}, jnp.asarray(x), train=False)
    net = _port_net(modality, packed, params)
    assert net.unet.packed == packed and net.head_name == f"head_{'head6' if modality == 'dwi-tensor' else 'head24'}"
    net.eval()
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_prelu_slope_is_used_per_channel():
    """One channel's slope moved: the net's output moves; the plain and the
    packed block agree on the moved slope too."""
    params = _jax_params("dwi-tensor", 5)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, PATCH, PATCH, PATCH, 6)).astype(np.float32))
    outs = []
    for packed in (False, True):
        net = _port_net("dwi-tensor", packed, params).eval()
        with torch.no_grad():
            before = net(x)
            net.unet.conv_0.conv_1.prelu_slope[2] += 0.5
            outs.append(net(x))
        assert not torch.equal(before, outs[-1])
    torch.testing.assert_close(outs[0], outs[1], **TOL)


def test_init_matches_flax_and_loads_strictly():
    """The names and shapes of JAX's tree (the head's conv_in/mid/out and
    norm_in/mid/out among them) load strictly; every slope starts at its
    block's negative_slope, 0.25 in the backbone, as Flax's constant
    initialiser draws it (a PReLU ConvNormAct's own init)."""
    for modality in ("t1w", "bssfp"):
        x = jnp.zeros((1, PATCH, PATCH, PATCH, MODALITY_CHANNELS[modality]))
        jparams = _ShapeInit(_jax_net(modality)).init(jax.random.PRNGKey(0), x)["params"]
        flat = flax.traverse_util.flatten_dict(jparams)
        net = _port_net(modality, False)
        sd = weights.init_state_dict(net, 0)
        converted = weights.from_flax(jparams)
        assert {_port_name(k) for k in flat} == set(sd) == set(converted)
        assert all(sd[k].shape == converted[k].shape for k in sd)
        slopes = [k for k in sd if k.endswith("prelu_slope")]
        assert len(slopes) == 18
        assert all(torch.equal(sd[k], torch.full(sd[k].shape, 0.25)) for k in slopes)
        net.load_state_dict(converted, strict=True)
    block = JaxConvNormAct(4, negative_slope=0.3, dtype=jnp.float32, use_fused=False,
                           prelu=True)
    jslope = block.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 2, 3)),
                        train=False)["params"]["prelu_slope"]
    port = ConvNormAct(3, 4, negative_slope=0.3, prelu=True)
    np.testing.assert_array_equal(weights.init_state_dict(port, 0)["prelu_slope"].numpy(),
                                  np.asarray(jslope))


@pytest.mark.parametrize("modality", MODALITIES)
def test_trainable_mask_and_transfer_match_jax(modality):
    """The stages' trainable leaves and TRANSFER's grafted leaves, as sets of
    names, for each target modality from the dwi-tensor pretrain."""
    pre = _jax_params("dwi-tensor", 7)
    jparams = _jax_params(modality, 8)
    net = _port_net(modality, False)
    for stage in TrainingState:
        jmask = flax.traverse_util.flatten_dict(
            jax_trainable_mask(jparams, JaxTrainingState(stage.value)))
        want = {_port_name(k) for k, v in jmask.items() if v}
        mask = trainable_mask(net, stage)
        assert {k for k, v in mask.items() if v} == want
        assert set(mask) == {_port_name(k) for k in jmask}
    jout = flax.traverse_util.flatten_dict(jax_transfer_params(
        pre, _ShapeInit(_jax_net(modality)), jax.random.PRNGKey(1), PATCH))
    jpre = flax.traverse_util.flatten_dict(pre)
    grafted = {_port_name(k) for k, v in jout.items()
               if k in jpre and np.array_equal(np.asarray(v), np.asarray(jpre[k]))}
    pre_sd = weights.from_flax(pre)
    out = transfer_params(pre_sd, net, seed=1)
    assert set(out) == {_port_name(k) for k in jout}
    assert {k for k, v in out.items() if k in pre_sd and torch.equal(v, pre_sd[k])} == grafted
    # the head is grafted exactly where the group is the pretrain's
    assert any(k.startswith("head") for k in grafted) == (modality in ("dwi-tensor", "t1w"))


@pytest.mark.parametrize("modality", ["dwi-tensor", "bssfp"])
def test_eval_step_metrics_match_jax(modality):
    params = _jax_params(modality, 9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, PATCH, PATCH, PATCH, MODALITY_CHANNELS[modality])).astype(
        np.float32)
    y = rng.random((2, PATCH, PATCH, PATCH, 6)).astype(np.float32)
    jnet = _jax_net(modality)
    jstate = JaxSupervisedState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                                params=params, opt_state=None)
    ref, ref_y = jax_eval_step(jnet, JaxTrainConfig())(jstate, jnp.asarray(x), jnp.asarray(y))
    net = _port_net(modality, False, params)
    state = create_supervised_state(0, net, TrainConfig(), TrainingState.PRETRAIN,
                                    state_dict=weights.from_flax(params))
    got, y_hat = make_supervised_eval_step(net, TrainConfig())(
        state, torch.from_numpy(x), torch.from_numpy(y))
    assert set(got) == set(ref)
    # f32 means over 2·16³ voxels summed in another order: SSIM near 0 can
    # differ by a few 1e-7 absolute
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(y_hat.numpy(), np.asarray(ref_y), **TOL)


def test_net_refuses_the_wrong_channel_count():
    net = MultiInputUNet("pc-bssfp", features=FEATURES)
    with pytest.raises(ValueError, match="24 channels"):
        net(torch.zeros(1, PATCH, PATCH, PATCH, 6))
