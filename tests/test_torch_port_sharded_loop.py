"""The mesh through the port's loops on the CPU: ``Trainer(mesh=…)``
against the JAX package's ``Trainer`` on a mesh of 8 (its virtual CPU
devices, ``tests/conftest.py``) on the same 16³ batches, its checkpoint
loaded into an unsharded state; the multi-stage supervised steps on a
(data, space) mesh against the unsharded steps in float64 (the PReLU
slopes' gradients summed over the shards, TRANSFER's frozen leaves without
gradients); ``run_multistage(mesh=…)`` against ``run_multistage(device=
"cpu")``; and the refusals of a training mesh over two devices."""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import Config as JaxConfig
from unet_bssfp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unet_bssfp_tpu.train.loop import Trainer as JaxTrainer
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
from unet_bssfp_tpu_torch.models import TrainingState
from unet_bssfp_tpu_torch.models.multi_input_unet import MultiInputUNet
from unet_bssfp_tpu_torch.parallel.mesh import Mesh, make_mesh
from unet_bssfp_tpu_torch.train import multistage as ms
from unet_bssfp_tpu_torch.train.checkpoint import load_checkpoint
from unet_bssfp_tpu_torch.train.loop import Trainer
from unet_bssfp_tpu_torch.train.steps import make_eval_step
from test_torch_port_loop import LR, PATCH, StubData, _batches, _config, _jax_state, _read_metrics

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8
MS_FEATURES = (4, 8, 8, 16, 16, 4)


@pytest.fixture(autouse=True)
def _keep_prng_impl():
    """The JAX package's Trainer switches JAX's default PRNG implementation
    for the process; put it back for the next test."""
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


def _rows_close(got, ref):
    """tests/test_torch_port_loop.py's bound: 1e-3 of max(|ref|, 1)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k == "epoch_seconds":
                continue
            rv = float(r[k])
            assert float(g[k]) == pytest.approx(rv, abs=1e-3 * max(abs(rv), 1.0)), k


# ------------------------------------------------------------------ Trainer
def test_trainer_on_a_mesh_matches_the_jax_trainer_and_its_checkpoint_loads_unsharded(
        tmp_path):
    """One epoch of both Trainers on a mesh of 8 from the same weights on
    the same batches (8 × 16³, lr 3e-5, dropout 0): every column of the
    epoch's row within the loop test's bound; the step's checkpoint loads
    into an unsharded state bit for bit, whose eval step gives the same
    metrics as the mesh's."""
    cfg = dataclasses.replace(
        _config(tmp_path / "port", max_epochs=1, lr=LR),
        model=dataclasses.replace(_config(tmp_path).model, dropout=0.0))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, augment_prob=0.0))
    jcfg = JaxConfig.from_json(cfg.to_json())
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, folded=False),
                               train=dataclasses.replace(
                                   jcfg.train, log_dir=str(tmp_path / "jax" / "logs"),
                                   checkpoint_dir=str(tmp_path / "jax" / "ckpts")))
    rng = np.random.default_rng(2025)
    train = [{k: np.concatenate([a[k], b[k], c[k], d[k]]) for k in a}
             for a, b, c, d in [_batches(rng, 4)]]
    val = [{k: np.concatenate([a[k], b[k], c[k], d[k]]) for k in a}
           for a, b, c, d in [_batches(rng, 4)]]
    assert train[0]["pc-bssfp"].shape == (8, PATCH, PATCH, PATCH, 24)

    jtrainer = JaxTrainer(jcfg, "pc-bssfp", mesh=jax_make_mesh(8))
    jstate = _jax_state(jtrainer, 11)
    mesh = make_mesh(CPU8, ("data",))
    trainer = Trainer(cfg, "pc-bssfp", mesh=mesh)
    assert trainer.device == torch.device("cpu") and trainer.batch_divisor == 8
    state = trainer.init_state()
    weights.state_from_flax(state.gen, state.disc, {
        k: jax.tree.map(np.asarray, getattr(jstate, k))
        for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")})

    jtrainer.fit(StubData(train, val, jnp.asarray), jstate)
    jtrainer.logger.finish()
    state, best = trainer.fit(StubData(train, val, torch.from_numpy), state)
    _rows_close(_read_metrics(cfg.train.log_dir), _read_metrics(jcfg.train.log_dir))
    assert state.step == 1

    flat = Trainer(cfg, "pc-bssfp", device="cpu")
    plain = load_checkpoint(best, flat.init_state())
    for mod, twin in ((state.gen, plain.gen), (state.disc, plain.disc)):
        sd = twin.state_dict()
        assert all(torch.equal(v, sd[k]) for k, v in mod.state_dict().items())
    x, y = (torch.from_numpy(val[0][k]) for k in ("pc-bssfp", "dwi-tensor_orig"))
    got, _ = make_eval_step(state.gen, state.disc, cfg.train, mesh=mesh)(state, x, y)
    want, _ = make_eval_step(plain.gen, plain.disc, cfg.train)(plain, x, y)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5, abs=1e-7), k


def test_trainer_refuses_another_device_and_a_mesh_over_two(tmp_path):
    """A device other than the mesh's first, on a mesh of one device and on
    one over two (the host twice: ``cpu`` and ``cpu:0``); on the latter,
    ``use_pallas`` (the fused norm has no sharded route) and a state whose
    models have no replica on its second device."""
    cfg = _config(tmp_path)
    mesh = make_mesh(CPU8, ("data", "space"), (4, 2))
    two = Mesh([[torch.device("cpu")], [torch.device("cpu", 0)]], ("data",))
    for m in (mesh, two):
        with pytest.raises(ValueError, match="is not the first device of"):
            Trainer(cfg, "pc-bssfp", device="meta", mesh=m)
    with pytest.raises(ValueError, match="is not the first device of"):
        ms.run_multistage(None, "t1w", cfg, device="meta", mesh=two)
    pallas = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_pallas=True))
    with pytest.raises(ValueError, match="use_pallas on Mesh"):
        Trainer(pallas, "pc-bssfp", mesh=two).init_state()
    with pytest.raises(ValueError, match="use_pallas on Mesh"):
        ms.build_multi_input_unet("t1w", pallas.model, mesh=two)
    trainer = Trainer(cfg, "pc-bssfp", mesh=two)
    elsewhere = Trainer(cfg, "pc-bssfp", mesh=mesh).init_state()
    x = torch.zeros((2, PATCH, PATCH, PATCH, 24))
    with pytest.raises(ValueError, match="has no replica on cpu:0"):
        trainer.train_step(elsewhere, x, x[..., :6])


# ------------------------------------------------------- multi-stage steps
def _f64_net(modality, seed):
    net = MultiInputUNet(modality=modality, features=MS_FEATURES, dropout=0.0,
                         packed=True).double()
    net.load_state_dict(weights.random_state_dict(net, seed))
    return net


@pytest.mark.parametrize("stage", list(TrainingState))
def test_supervised_step_on_a_space_split_matches_unsharded_in_float64(stage):
    """One supervised step of ``stage`` on a (2, 2) mesh (B 1, D 16 a shard;
    ``packed``, the PReLU backbone, the ResNet head's InstanceNorms over
    the volume's d) against the step unsharded: the loss terms to 1e-12
    relative, every gradient leaf to 1e-9 relative L2 (a conv bias before a
    norm: 1e-9 of the largest), the PReLU slopes' gradients included;
    TRANSFER's frozen leaves take no gradient and keep requires_grad off."""
    mesh = make_mesh(["cpu"] * 4, ("data", "space"), (2, 2))
    modality = "dwi-tensor" if stage == TrainingState.PRETRAIN else "t1w"
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((2, 32, 16, 16, 6)))
    y = torch.from_numpy(rng.random((2, 32, 16, 16, 6)))
    tcfg = TrainConfig()
    out = []
    for m in (None, mesh):
        net = _f64_net(modality, 7)
        state = ms.create_supervised_state(7, net, tcfg, stage,
                                           state_dict=weights.random_state_dict(net, 7))
        metrics = ms.make_supervised_train_step(net, tcfg, mesh=m)(state, x, y)
        out.append((metrics, {n: p.grad for n, p in net.named_parameters()},
                    {n: p.requires_grad for n, p in net.named_parameters()}))
    (ma, ga, ra), (mb, gb, rb) = out
    assert ma.keys() == mb.keys() and ra == rb
    for k in ma:
        assert float(mb[k]) == pytest.approx(float(ma[k]), rel=1e-12), k
    trained = [n for n, r in ra.items() if r]
    assert trained and all((gb[n] is None) == (not ra[n]) for n in ga)
    if stage == TrainingState.TRANSFER:
        assert all(n.startswith("head") for n in trained)
    slopes = [n for n in trained if n.endswith("prelu_slope")]
    assert len(slopes) == (0 if stage == TrainingState.TRANSFER else 18)
    scale = max(float(ga[n].abs().max()) for n in trained)
    for n in trained:
        if n.endswith(("conv.bias", "conv_in.bias", "conv_mid.bias", "conv_out.bias")):
            assert float((gb[n] - ga[n]).abs().max()) <= 1e-9 * scale, n
        else:
            assert float((gb[n] - ga[n]).norm() / ga[n].norm()) <= 1e-9, n
    for n in slopes:
        assert float(ga[n].abs().max()) > 0, n


def test_supervised_eval_step_on_a_mesh_matches_unsharded():
    mesh = make_mesh(["cpu"] * 4, ("data", "space"), (2, 2))
    net = _f64_net("t1w", 2)
    state = ms.create_supervised_state(2, net, TrainConfig(), TrainingState.FINE_TUNE,
                                       state_dict=weights.random_state_dict(net, 2))
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy(rng.random((2, 32, 16, 16, 6))) for _ in range(2))
    want, want_hat = ms.make_supervised_eval_step(net, TrainConfig())(state, x, y)
    got, got_hat = ms.make_supervised_eval_step(net, TrainConfig(), mesh=mesh)(state, x, y)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got_hat.numpy(), want_hat.numpy(), rtol=0, atol=1e-12)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-12), k


# ----------------------------------------------------------- run_multistage
@pytest.fixture(scope="module")
def bids_root(tmp_path_factory):
    return make_synthetic_bids(str(tmp_path_factory.mktemp("bids")),
                               subjects=("01", "02", "03", "04"), sessions=("1",),
                               volume_shape=(16, 16, 16), seed=5)


def test_run_multistage_on_a_mesh_matches_one_device(bids_root, tmp_path):
    """The three stages, one epoch each, on a data split of 2 and on one
    device, from the same seeds (dropout 0): every stage's metrics.csv
    within the loop test's bound, TRANSFER's backbone PRETRAIN's."""
    rows = {}
    for name, kw in (("cpu", dict(device="cpu")),
                     ("mesh", dict(mesh=make_mesh(["cpu"] * 2, ("data",))))):
        cfg = Config(
            data=DataConfig(batch_size=2, patch_size=16, samples_per_vol=2,
                            volume_shape=(16, 16, 16), val_split=0.25, test_split=0.25,
                            num_workers=1),
            model=ModelConfig(features=MS_FEATURES, multistage_features=MS_FEATURES,
                              compute_dtype="float32", dropout=0.0),
            train=TrainConfig(log_dir=str(tmp_path / name / "logs"),
                              checkpoint_dir=str(tmp_path / name / "ckpts"),
                              checkpoint_top_k=2, with_perceptual=False))
        data = DoveDataModule(bids_root, config=cfg.data)
        data.prepare_data()
        states, _ = ms.run_multistage(data, "t1w", cfg, epochs_per_stage=dict.fromkeys(
            TrainingState, 1), **kw)
        pre = states[TrainingState.PRETRAIN].net.state_dict()
        assert all(torch.equal(v, pre[k]) for k, v in
                   states[TrainingState.TRANSFER].net.state_dict().items()
                   if k.startswith("unet."))
        rows[name] = {}
        for stage in TrainingState:
            path = tmp_path / name / "logs" / f"multistage-t1w-{stage.value}" / "metrics.csv"
            with open(path) as f:
                rows[name][stage] = list(csv.DictReader(f))
            assert os.path.isfile(tmp_path / name / "ckpts" / f"multistage-t1w-{stage.value}"
                                  / "0" / "state.pt")
    for stage in TrainingState:
        _rows_close(rows["mesh"][stage], rows["cpu"][stage])
