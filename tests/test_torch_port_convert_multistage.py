"""The converter (``scripts/torch_port_convert_checkpoint.py``) on a JAX
multi-stage step: a TRANSFER state of the JAX package takes one supervised
step and is saved by its Orbax manager under
``multistage-pc-bssfp-transfer``; the converted ``state.pt`` loads with
``load_supervised_checkpoint``, its net reproduces JAX's output, AdamW's
moments sit on the parameters optax's ``"train"`` leaves name (the frozen
backbone has none), and the dropout generator takes the port's stage seed.
A PRETRAIN step (no step taken) converts onto ``dwi-tensor``'s net with every
leaf's moments. Features 8/8/16/16/32/8, f32, 16³, dropout 0."""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import Config as JaxConfig
from unet_bssfp_tpu.models.multi_input_unet import TrainingState as JaxTrainingState
from unet_bssfp_tpu.train import multistage as jax_ms
from unet_bssfp_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
from unet_bssfp_tpu_torch.train import checkpoint as ckpt
from unet_bssfp_tpu_torch.train import multistage as ms
from test_torch_port_models import random_variables

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
import torch_port_convert_checkpoint as converter  # noqa: E402

torch.set_num_threads(1)

MOD = "pc-bssfp"
PATCH = 16
FEATURES = (8, 8, 16, 16, 32, 8)
# tests/test_torch_port_models.py's model tolerance (f32, another summation
# order in every conv)
TOL = dict(rtol=2e-4, atol=2e-5)
CFG = Config(data=DataConfig(patch_size=PATCH, volume_shape=(PATCH,) * 3),
             model=ModelConfig(multistage_features=FEATURES, compute_dtype="float32",
                               dropout=0.0),
             train=TrainConfig(seed=7))


@pytest.fixture(autouse=True)
def _keep_prng_impl():
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


def _jax_cfg():
    jcfg = JaxConfig.from_json(CFG.to_json())
    return dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, folded=False))


def _jax_state(jnet, jcfg, stage, seed):
    """A JAX ``SupervisedState`` of ``stage`` on seeded values over the
    net's variable tree (``jax.eval_shape`` of its init: an eager init of
    this net compiles for about a minute)."""
    x = jnp.zeros((1, PATCH, PATCH, PATCH, 6 if jnet.modality == "dwi-tensor" else 24))
    shapes = jax.eval_shape(functools.partial(jnet.init, train=False), jax.random.PRNGKey(0), x)
    params = random_variables(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                           shapes["params"]), seed)
    opt = jax_ms.make_stage_optimizer(params, jcfg.train, stage)
    return jax_ms.SupervisedState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(seed),
                                  params=params, opt_state=opt.init(params))


def _save(root, jcfg, stage_value, jstate):
    run = root / "jax" / f"multistage-{MOD}-{stage_value}"
    mgr = JaxCheckpointManager(str(run), config_json=jcfg.to_json())
    mgr.save(0, jstate, {"val_loss": 1.0})
    mgr.wait()
    mgr.close()
    return run


def _moments(net, state):
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    sd = state.opt.state_dict()["state"]
    return names, {names[i]: v for i, v in sd.items()}


def test_converted_transfer_step_loads_and_matches_jax(tmp_path):
    jcfg = _jax_cfg()
    jnet = jax_ms.build_multi_input_unet(MOD, jcfg.model)
    jstate = _jax_state(jnet, jcfg, JaxTrainingState.TRANSFER, 31)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, PATCH, PATCH, PATCH, 24)).astype(np.float32)
    y = rng.random((2, PATCH, PATCH, PATCH, 6)).astype(np.float32)
    step = jax_ms.make_supervised_train_step(jnet, jcfg.train, JaxTrainingState.TRANSFER,
                                             jstate.params)
    jstate, _ = step(jstate, jnp.asarray(x), jnp.asarray(y))
    run = _save(tmp_path, jcfg, "transfer", jstate)

    out = tmp_path / "port" / run.name
    assert converter.main([str(run / "0"), str(out)]) == 0
    assert Config.from_json(ckpt.load_config_for_checkpoint(str(out / "0"))).train.seed == 7
    net = ms.build_multi_input_unet(MOD, CFG.model, "cpu")
    state = ms.create_supervised_state(0, net, CFG.train, TrainingState.TRANSFER)
    ckpt.load_supervised_checkpoint(str(out / "0"), state)
    assert state.step == int(jstate.step) == 1
    # the port's TRANSFER seed: train.seed + 3·1, its generator from + 2
    assert torch.equal(state.rng.get_state(),
                       torch.Generator().manual_seed(7 + 3 + 2).get_state())

    # the net: JAX's output on the same input
    ref = np.asarray(jax.jit(lambda p, a: jnet.apply({"params": p}, a, train=False))(
        jstate.params, jnp.asarray(x)))
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)

    # the moments: optax's "train" leaves, on the stage optimizer's
    # parameters; the frozen backbone has no state and no moments
    adam = converter._adam_state(jstate.opt_state.inner_states["train"].inner_state)
    flat = jax.tree_util.tree_flatten_with_path(adam.mu)[0]
    assert flat and all(str(p[0]).find("head") >= 0 for p, _ in flat)
    count, mu, nu = converter._trained_moments(jstate.opt_state)
    mu, nu = weights.from_flax(mu), weights.from_flax(nu)
    names, moments = _moments(net, state)
    assert names == [n for n, _ in net.named_parameters() if n.startswith("head")]
    assert set(names) == set(mu) == set(moments)
    for n in names:
        assert torch.equal(moments[n]["exp_avg"], mu[n]), n
        assert torch.equal(moments[n]["exp_avg_sq"], nu[n]), n
        assert float(moments[n]["step"]) == int(count) == 1
        assert float(moments[n]["exp_avg"].abs().max()) > 0, n
    trained = {id(p) for g in state.opt.param_groups for p in g["params"]}
    for n, p in net.named_parameters():
        assert (id(p) in trained) == n.startswith("head"), n
        assert p.requires_grad == n.startswith("head"), n
    assert [g["lr"] for g in state.opt.param_groups] == [CFG.train.lr]


def test_converted_pretrain_step_holds_every_leafs_moments(tmp_path):
    """PRETRAIN trains every leaf, on ``dwi-tensor``'s net: each parameter
    gets its (here zero) moments and the step count."""
    jcfg = _jax_cfg()
    jnet = jax_ms.build_multi_input_unet("dwi-tensor", jcfg.model)
    jstate = _jax_state(jnet, jcfg, JaxTrainingState.PRETRAIN, 33)
    run = _save(tmp_path, jcfg, "pretrain", jstate)
    path = converter.convert(str(run / "0"), str(tmp_path / "port"))
    net = ms.build_multi_input_unet("dwi-tensor", CFG.model, "cpu")
    state = ms.create_supervised_state(0, net, CFG.train, TrainingState.PRETRAIN)
    ckpt.load_supervised_checkpoint(path, state)
    sd = weights.from_flax(jax.tree.map(np.asarray, jstate.params))
    assert all(torch.equal(v, sd[k]) for k, v in net.state_dict().items())
    names, moments = _moments(net, state)
    assert names == [n for n, _ in net.named_parameters()] and set(moments) == set(names)
    assert all(float(m["step"]) == 0 and not m["exp_avg"].any() for m in moments.values())
    assert torch.equal(state.rng.get_state(), torch.Generator().manual_seed(7 + 2).get_state())
    # a TRANSFER state cannot take a PRETRAIN step
    other = ms.create_supervised_state(0, ms.build_multi_input_unet(MOD, CFG.model, "cpu"),
                                       CFG.train, TrainingState.TRANSFER)
    with pytest.raises(ValueError, match="not a transfer stage's"):
        ckpt.load_supervised_checkpoint(path, other)


def test_converter_reads_the_stage_from_the_run_name():
    assert converter.multistage_run_of("/x/multistage-pc-bssfp-transfer") == (
        "pc-bssfp", TrainingState.TRANSFER)
    assert converter.multistage_run_of("/x/multistage-dwi-tensor-finetune/") == (
        "dwi-tensor", TrainingState.FINE_TUNE)
    assert converter.multistage_run_of("/x/multistage-t1w-pretrain") == (
        "t1w", TrainingState.PRETRAIN)
    assert converter.multistage_run_of("/x/pc-bssfp-20260101-000000") is None
    assert converter.multistage_run_of("/x/multistage-pc-bssfp-warmup") is None
