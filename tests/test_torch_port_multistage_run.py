"""The multi-stage regime end to end on the CPU (``run_multistage``, the
train CLI's ``--multistage``, its checkpoints) on a synthetic BIDS tree
of 16³ volumes at widths (4, 8, 8, 16, 16, 4): one epoch a stage writes
each stage's ``metrics.csv`` with the JAX package's columns (read off its
jitted steps by ``jax.eval_shape``, no compile) and its checkpoint; a
``SupervisedState`` checkpoint restores bit for bit; TRANSFER keeps
PRETRAIN's backbone over its epoch; a GAN ``state.pt`` keeps its layout
and still loads."""

import csv
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import TrainConfig as JaxTrainConfig
from unet_bssfp_tpu.models.multi_input_unet import MultiInputUNet as JaxMultiInputUNet
from unet_bssfp_tpu.models.multi_input_unet import TrainingState as JaxTrainingState
from unet_bssfp_tpu.train import multistage as jax_ms
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
from unet_bssfp_tpu_torch.models import TrainingState
from unet_bssfp_tpu_torch.train import checkpoint
from unet_bssfp_tpu_torch.train.__main__ import main as train_main
from unet_bssfp_tpu_torch.train.multistage import (
    build_multi_input_unet,
    create_supervised_state,
    run_multistage,
)
from unet_bssfp_tpu_torch.train.state import create_gan_state
from test_torch_port_multistage import FEATURES, PATCH, _ShapeInit

torch.set_num_threads(1)

VOL = (16, 16, 16)


@pytest.fixture(scope="module")
def bids_root(tmp_path_factory):
    return make_synthetic_bids(str(tmp_path_factory.mktemp("bids")),
                               subjects=("01", "02", "03", "04"), sessions=("1",),
                               volume_shape=VOL, seed=5)


def _config(tmp_path):
    """A 2/1/1 subject split, 16³ patches, two patches a batch, dropout on."""
    return Config(
        data=DataConfig(batch_size=2, patch_size=PATCH, samples_per_vol=2, volume_shape=VOL,
                        val_split=0.25, test_split=0.25, num_workers=1),
        model=ModelConfig(features=(4, 8, 8, 16, 16, 4), multistage_features=FEATURES,
                          compute_dtype="float32"),
        train=TrainConfig(log_dir=str(tmp_path / "logs"),
                          checkpoint_dir=str(tmp_path / "ckpts"), checkpoint_top_k=2,
                          with_perceptual=False))


def _jax_columns():
    """The JAX package's metrics.csv columns for the regime: ``epoch``, then
    the train step's metrics, then the eval step's, each in the order its
    jitted step returns them."""
    tcfg = JaxTrainConfig()
    net = JaxMultiInputUNet(modality="t1w", features=FEATURES, dropout=0.0,
                            dtype=jnp.float32, use_fused=False)
    x = jnp.zeros((1, PATCH, PATCH, PATCH, 6))
    y = jnp.zeros((1, PATCH, PATCH, PATCH, 6))
    params = _ShapeInit(net).init(jax.random.PRNGKey(0), x)["params"]
    stage = JaxTrainingState.PRETRAIN
    state = jax_ms.create_supervised_state(jax.random.PRNGKey(0), net, tcfg, stage, PATCH,
                                           params=params)
    train = jax_ms.make_supervised_train_step(net, tcfg, stage, params)
    evals = jax_ms.make_supervised_eval_step(net, tcfg)
    _, tm = jax.eval_shape(train, state, x, y)
    vm, _ = jax.eval_shape(evals, state, x, y)
    return ["epoch", *tm, *vm]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_run_multistage_writes_three_stages_and_restores(tmp_path, bids_root):
    cfg = _config(tmp_path)
    data = DoveDataModule(bids_root, config=cfg.data)
    data.prepare_data()
    states, row = run_multistage(data, "pc-bssfp", cfg, epochs_per_stage=dict.fromkeys(
        TrainingState, 1), device="cpu")
    assert list(states) == list(TrainingState)
    columns = _jax_columns()
    for stage, state in states.items():
        name = f"multistage-pc-bssfp-{stage.value}"
        with open(tmp_path / "logs" / name / "metrics.csv") as f:
            assert next(csv.reader(f)) == columns
        (only,) = _rows(tmp_path / "logs" / name / "metrics.csv")
        assert all(math.isfinite(float(only[k])) for k in columns)
        assert os.path.isfile(tmp_path / "ckpts" / name / "0" / checkpoint.STATE_FILE)
        assert os.path.isfile(tmp_path / "ckpts" / name / "config.json")
        assert state.step >= 1 and len(state.epoch_seconds) == 1
        assert state.net.modality == ("dwi-tensor" if stage == TrainingState.PRETRAIN
                                      else "pc-bssfp")
    assert row == {k: pytest.approx(float(v)) for k, v in only.items() if k != "epoch"}
    # TRANSFER trained the head alone: its backbone is PRETRAIN's, bit for bit
    pre, tra = states[TrainingState.PRETRAIN].net, states[TrainingState.TRANSFER].net
    pre_sd = pre.state_dict()
    for k, v in tra.state_dict().items():
        if k.startswith("unet."):
            assert torch.equal(v, pre_sd[k]), k
    assert tra.head_name == "head_head24" and pre.head_name == "head_head6"

    # a stage's checkpoint into a fresh state of that stage: bit for bit
    for stage in (TrainingState.TRANSFER, TrainingState.FINE_TUNE):
        done = states[stage]
        fresh = create_supervised_state(
            99, build_multi_input_unet("pc-bssfp", cfg.model, "cpu"), cfg.train, stage)
        path = tmp_path / "ckpts" / f"multistage-pc-bssfp-{stage.value}" / "0"
        checkpoint.load_supervised_checkpoint(str(path), fresh)
        assert fresh.step == done.step
        assert torch.equal(fresh.rng.get_state(), done.rng.get_state())
        want = done.net.state_dict()
        assert all(torch.equal(v, want[k]) for k, v in fresh.net.state_dict().items())
        a, b = fresh.opt.state_dict(), done.opt.state_dict()
        assert a["param_groups"] == b["param_groups"]
        for i, s in b["state"].items():
            assert all(torch.equal(a["state"][i][n], t) for n, t in s.items())
        with pytest.raises(ValueError, match="stage"):
            other = TrainingState.PRETRAIN
            checkpoint.load_supervised_checkpoint(str(path), dataclasses.replace(
                fresh, stage=other))


def test_cli_multistage_runs_each_stage(tmp_path, bids_root, capsys):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(_config(tmp_path).to_json())
    train_main([bids_root, "--multistage", "--modalities", "t1w", "--config", str(cfg_path),
                "--max-epochs", "1", "--device", "cpu"])
    assert "Multi-stage t1w final metrics: {" in capsys.readouterr().out
    for stage in TrainingState:
        run = tmp_path / "ckpts" / f"multistage-t1w-{stage.value}"
        assert sorted(os.listdir(run)) == ["0", "config.json"]
        assert len(_rows(tmp_path / "logs" / f"multistage-t1w-{stage.value}" / "metrics.csv")) == 1


def test_gan_checkpoint_keeps_its_layout_and_loads(tmp_path):
    """The GAN's step file holds what it always held (no multi-stage key)
    and loads as before; the multi-stage loader refuses it."""
    cfg = _config(tmp_path)
    mcfg = dataclasses.replace(cfg.model, disc_features=(8, 8, 16))
    state = create_gan_state(3, "pc-bssfp", mcfg, cfg.train, "cpu")
    state.step = 7
    mgr = checkpoint.CheckpointManager(str(tmp_path / "gan"), top_k=1)
    mgr.save(0, state, {"val_loss": 1.0})
    payload = torch.load(tmp_path / "gan" / "0" / checkpoint.STATE_FILE, weights_only=True)
    assert set(payload) == {"step", "gen", "disc", "gen_opt", "disc_opt", "rng"}
    fresh = create_gan_state(4, "pc-bssfp", mcfg, cfg.train, "cpu")
    mgr.restore(fresh)
    assert fresh.step == 7
    assert all(torch.equal(v, state.gen.state_dict()[k])
               for k, v in fresh.gen.state_dict().items())
    net = build_multi_input_unet("pc-bssfp", cfg.model, "cpu")
    sup = create_supervised_state(0, net, cfg.train, TrainingState.FINE_TUNE)
    with pytest.raises(ValueError, match="multi-stage"):
        checkpoint.load_supervised_checkpoint(str(tmp_path / "gan" / "0"), sup)
    np.testing.assert_equal(len(mgr.steps), 1)
