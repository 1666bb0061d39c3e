"""Training on a mesh whose positions lie on several distinct devices, on
the CPU: the GAN step and the supervised steps with one replica of the
models per device, the replicas' gradients summed onto the master's, one
AdamW step there and the new weights copied back into the replicas.

PyTorch has one CPU device, but ``torch.device("cpu")`` and
``torch.device("cpu", 0)`` are two mesh entries: the replica lookup takes a
position's mesh entry (``parallel.mesh.place``), so a mesh over both holds
two real replicas in one process, each with its own parameters, gradients
and dropout generator. The steps are held against the JAX package's mesh
steps (``tests/test_torch_port_sharded_step.py``'s fixtures and
tolerances), and in float64 against the same step on a mesh of one device,
from which only the order of the gradient sums differs."""

import csv
import dataclasses

import numpy as np
import pytest
import torch

from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.model import bSSFPToDWITensorModel
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
from unet_bssfp_tpu_torch.models.layers import Dropout, bind_dropout_generators
from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
from unet_bssfp_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    make_mesh,
    replica_seed,
    replicas,
    replicate,
)
from unet_bssfp_tpu_torch.train import checkpoint, loop, steps
from unet_bssfp_tpu_torch.train import __main__ as train_cli
from unet_bssfp_tpu_torch.train import multistage as ms
from unet_bssfp_tpu_torch.train.state import GANTrainState, create_gan_state, make_optimizer
from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_predict_fn, make_train_step
from test_torch_port_loop import StubData, _batches, _config, _read_metrics
from test_torch_port_sharded_loop import MS_FEATURES, _f64_net, _rows_close
from test_torch_port_sharded_step import (  # noqa: F401 (jax_setup, jax_steps: fixtures)
    DISC_FEATURES,
    FEATURES,
    LR,
    _batch,
    _check_against_jax,
    _f64_models,
    _mesh,
    _port_state,
    _rel,
    jax_setup,
    jax_steps,
)

torch.set_num_threads(1)
CPU, CPU0 = torch.device("cpu"), torch.device("cpu", 0)


def _two(name):
    """The mesh ``name`` of ``MESHES`` over the two host entries: (8,) with
    its data positions alternating, (4, 2) with each space column on its
    own entry (every d-halo crosses the two)."""
    if name == "8":
        return Mesh([[(CPU, CPU0)[i % 2]] for i in range(8)], ("data",))
    return Mesh([[CPU, CPU0]] * 4, ("data", "space"))


def _models_bit_equal(*modules):
    """Every replica's parameters and buffers bit-equal to its master's."""
    for m in modules:
        master, *rest = replicas(m)
        assert rest, "no replica"
        want = master.state_dict()
        for twin in rest:
            got = twin.state_dict()
            assert got.keys() == want.keys()
            assert all(torch.equal(got[k], v) for k, v in want.items())


@pytest.fixture
def replica_grads(monkeypatch):
    """Spies on the step's reduce: for each reduce, the number of the
    replicas' parameters that came with a gradient."""
    seen = []
    real = steps.reduce_gradients

    def spy(module):
        seen.append(sum(p.grad is not None for twin in replicas(module)[1:]
                        for p in twin.parameters()))
        real(module)

    monkeypatch.setattr(steps, "reduce_gradients", spy)
    return seen


# ------------------------------------------------------- the GAN step vs JAX
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", ["8", "4x2"])
def test_gan_step_over_two_devices_matches_jax_mesh_step(jax_setup, jax_steps, replica_grads,
                                                         name, packed):
    """One GAN step on the mesh over the two host entries against the JAX
    package's ``make_train_step(mesh=…)`` on (8,) and (4, 2), with
    ``_check_against_jax``'s tolerances; every replica bit-equal to its
    master after it; both phases reduced real replica gradients."""
    mesh = _two(name)
    state = _port_state(jax_setup[3], mesh, packed)
    assert len(replicas(state.gen)) == len(replicas(state.disc)) == 2
    step = make_train_step(state.gen, state.disc, TrainConfig(lr=LR), mesh=mesh)
    x, y = _batch()
    got = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert state.step == 1
    _check_against_jax(state, got, jax_steps[name], jax_steps["8"])
    _models_bit_equal(state.gen, state.disc)
    assert len(replica_grads) == 2 and all(n > 0 for n in replica_grads)


def test_ddp_parity_over_two_devices_matches_jax(jax_setup, jax_steps, replica_grads):
    """``ddp_parity`` (per-row BatchNorm moments, the mean of the rows'
    losses) on (8,) over the two entries against JAX's ``shard_map`` step:
    the running statistics' mean over rows is taken once, on the first
    position's device, and every replica takes the same update."""
    mesh = _two("8")
    state = _port_state(jax_setup[3], mesh, packed=False)
    step = make_train_step(state.gen, state.disc, TrainConfig(lr=LR), mesh=mesh,
                           ddp_parity=True)
    x, y = _batch()
    got = step(state, torch.from_numpy(x), torch.from_numpy(y))
    _check_against_jax(state, got, jax_steps["ddp"], jax_steps["ddp"])
    _models_bit_equal(state.gen, state.disc)
    assert all(n > 0 for n in replica_grads)


# ------------------------------------------- float64 against one device's mesh
def _f64_state(mesh, packed):
    """The float64 models of the sharded-step tests on ``mesh``: the
    masters on its first device, a replica on each other one."""
    gen, disc = _f64_models(packed)
    replicate(gen, mesh)
    replicate(disc, mesh)
    rng, *rest = bind_dropout_generators(gen, 2)
    tcfg = TrainConfig(lr=LR)
    return GANTrainState(step=0, rng=rng, gen=gen, disc=disc,
                         gen_opt=make_optimizer(gen.parameters(), tcfg),
                         disc_opt=make_optimizer(disc.parameters(), tcfg),
                         replica_rngs=tuple(rest))


def _grads_close(got, want, rel=1e-10):
    """Each leaf to ``rel`` relative L2; a conv bias before a norm (true
    gradient 0, either side's cancellation noise) to ``rel`` of the
    largest gradient."""
    scale = max(float(g.abs().max()) for g in want.values() if g is not None)
    for name, ref in want.items():
        assert (got[name] is None) == (ref is None), name
        if ref is None:
            continue
        if name.endswith(("conv.bias", "conv_in.bias", "conv_mid.bias", "conv_out.bias")):
            assert float((got[name] - ref).abs().max()) <= rel * scale, name
        else:
            assert _rel(got[name], ref) <= rel, name


@pytest.mark.parametrize("ddp_parity", [False, True], ids=["global", "ddp"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", ["8", "4x2"])
def test_gan_step_gradients_over_two_devices_match_one_device_in_float64(
        replica_grads, name, packed, ddp_parity):
    """The step on the two entries against the step on a mesh of one
    device of the same shape, from the same float64 weights and batch: the
    losses to 1e-12, both phases' gradients (the generator's, the
    discriminator's) to 1e-10 relative, the BatchNorm statistics to 1e-12;
    every replica bit-equal to its master after the step."""
    x, y = (torch.from_numpy(a).double() for a in _batch(3))
    out = {}
    for key, mesh in (("one", _mesh(name)), ("two", _two(name))):
        state = _f64_state(mesh, packed)
        metrics = make_train_step(state.gen, state.disc, TrainConfig(lr=LR), mesh=mesh,
                                  ddp_parity=ddp_parity)(state, x, y)
        out[key] = ({k: float(v) for k, v in metrics.items()},
                    {f"{m}.{n}": p.grad for m, mod in (("gen", state.gen), ("disc", state.disc))
                     for n, p in mod.named_parameters()},
                    {f"{m}.{n}": b for m, mod in (("gen", state.gen), ("disc", state.disc))
                     for n, b in mod.named_buffers()}, state)
    (ma, ga, ba, _), (mb, gb, bb, state) = out["one"], out["two"]
    assert ma.keys() == mb.keys()
    for k in ma:
        assert mb[k] == pytest.approx(ma[k], rel=1e-12), k
    _grads_close(gb, ga)
    for k, v in ba.items():
        np.testing.assert_allclose(bb[k].numpy(), v.numpy(), rtol=1e-12, atol=1e-14, err_msg=k)
    _models_bit_equal(state.gen, state.disc)
    assert replica_grads[:2] == [0, 0] and all(n > 0 for n in replica_grads[2:])


def test_eval_step_over_two_devices_matches_one_device():
    """The GAN eval step on (4, 2) over the two entries: the metrics and
    the gathered output those of one device's mesh."""
    x, y = (torch.from_numpy(a).double() for a in _batch(4))
    got = {}
    for key, mesh in (("one", _mesh("4x2")), ("two", _two("4x2"))):
        state = _f64_state(mesh, packed=True)
        got[key] = make_eval_step(state.gen, state.disc, TrainConfig(lr=LR), mesh=mesh)(
            state, x, y)
    (ma, ya), (mb, yb) = got["one"], got["two"]
    np.testing.assert_allclose(yb.numpy(), ya.numpy(), rtol=0, atol=1e-12)
    for k in ma:
        assert float(mb[k]) == pytest.approx(float(ma[k]), rel=1e-12), k


# --------------------------------------------------------- the supervised step
@pytest.mark.parametrize("stage", list(TrainingState))
def test_supervised_step_over_two_devices_matches_one_device_in_float64(replica_grads, stage):
    """One supervised step of ``stage`` on a (2, 2) mesh whose space
    columns lie on the two entries against the same mesh on one device:
    the loss terms to 1e-12, every gradient leaf to 1e-10, the replicas
    bit-equal to the master after the update; TRANSFER's frozen leaves keep
    requires_grad off and their values bit for bit on every replica."""
    modality = "dwi-tensor" if stage == TrainingState.PRETRAIN else "t1w"
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((2, 32, 16, 16, 6)))
    y = torch.from_numpy(rng.random((2, 32, 16, 16, 6)))
    tcfg = TrainConfig()
    out = {}
    for key, mesh in (("one", make_mesh(["cpu"] * 4, ("data", "space"), (2, 2))),
                      ("two", Mesh([[CPU, CPU0]] * 2, ("data", "space")))):
        net = _f64_net(modality, 7)
        replicate(net, mesh)
        state = ms.create_supervised_state(7, net, tcfg, stage,
                                           state_dict=weights.random_state_dict(net, 7))
        before = {k: v.clone() for k, v in net.state_dict().items()}
        metrics = ms.make_supervised_train_step(net, tcfg, mesh=mesh)(state, x, y)
        out[key] = ({k: float(v) for k, v in metrics.items()},
                    {n: p.grad for n, p in net.named_parameters()}, net, before)
    (ma, ga, _, _), (mb, gb, net, before) = out["one"], out["two"]
    for k in ma:
        assert mb[k] == pytest.approx(ma[k], rel=1e-12), k
    _grads_close(gb, ga)
    _models_bit_equal(net)
    frozen = [n for n, p in net.named_parameters() if not p.requires_grad]
    assert bool(frozen) == (stage == TrainingState.TRANSFER)
    for twin in replicas(net):
        flags = {n: p.requires_grad for n, p in twin.named_parameters()}
        assert [n for n, f in flags.items() if not f] == frozen
        sd = twin.state_dict()
        assert all(torch.equal(sd[n], before[n]) for n in frozen)
    assert replica_grads[0] == 0 and replica_grads[1] > 0


def test_supervised_eval_step_over_two_devices_matches_one_device():
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy(rng.random((2, 32, 16, 16, 6))) for _ in range(2))
    got = {}
    for key, mesh in (("one", make_mesh(["cpu"] * 4, ("data", "space"), (2, 2))),
                      ("two", Mesh([[CPU, CPU0]] * 2, ("data", "space")))):
        net = _f64_net("t1w", 2)
        replicate(net, mesh)
        state = ms.create_supervised_state(2, net, TrainConfig(), TrainingState.FINE_TUNE,
                                           state_dict=weights.random_state_dict(net, 2))
        got[key] = ms.make_supervised_eval_step(net, TrainConfig(), mesh=mesh)(state, x, y)
    (ma, ya), (mb, yb) = got["one"], got["two"]
    np.testing.assert_allclose(yb.numpy(), ya.numpy(), rtol=0, atol=1e-12)
    for k in ma:
        assert float(mb[k]) == pytest.approx(float(ma[k]), rel=1e-12), k


def test_gan_wrapper_on_a_mesh_over_two_devices_matches_one_device():
    """``bSSFPToDWITensorModel(mesh=…)`` over the two entries: after
    ``init``, ``predict`` and a step give the one-device mesh wrapper's
    output and metrics (f32: only the sums' order differs); after the step
    the replicas are bit-equal and the mesh serves what the master alone
    serves."""
    cfg = Config(model=ModelConfig(features=FEATURES, disc_features=DISC_FEATURES,
                                   compute_dtype="float32", dropout=0.0))
    x, y = (torch.from_numpy(a) for a in _batch(10))
    got = {}
    for key, mesh in (("one", _mesh("4x2")), ("two", _two("4x2"))):
        model = bSSFPToDWITensorModel("pc-bssfp", lr=LR, config=cfg, with_perceptual=False,
                                      mesh=mesh)
        model.init(seed=3)
        y_hat = model.predict(x)
        metrics = model.train_step(model.state, x, y)
        got[key] = ({k: float(v) for k, v in metrics.items()}, y_hat, model)
    (ma, ya, _), (mb, yb, model) = got["one"], got["two"]
    np.testing.assert_allclose(yb.numpy(), ya.numpy(), rtol=0, atol=1e-6)
    for k in ma:
        assert mb[k] == pytest.approx(ma[k], rel=1e-5, abs=1e-7), k
    _models_bit_equal(model.gen, model.discr)
    alone = make_predict_fn(model.gen)(x)
    np.testing.assert_allclose(model.predict(x).numpy(), alone.numpy(), rtol=0,
                               atol=1e-5 * float(alone.abs().max()))


# --------------------------------------------------- dropout and checkpoints
def _dropout_state(seed, mesh, **over):
    cfg = ModelConfig(features=FEATURES, disc_features=DISC_FEATURES,
                      compute_dtype="float32", dropout=0.1, packed=True, **over)
    return create_gan_state(seed, "pc-bssfp", cfg, TrainConfig(), "cpu", mesh=mesh)


def _everything(state):
    return {**{f"gen.{k}": v for k, v in state.gen.state_dict().items()},
            **{f"disc.{k}": v for k, v in state.disc.state_dict().items()},
            "rng": state.rng.get_state(),
            **{f"rng{i}": g.get_state() for i, g in enumerate(state.replica_rngs, 1)}}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_dropout_generators_per_device_distinct_seeded_and_rerun_bit_equal():
    """Each device's replica of the generator draws from its own generator,
    on its device, seeded from (seed + 2, its place in the mesh): the
    master's as on one device. Two runs of two steps from one seed are bit
    for bit the same, the replicas bit-equal to the master after them; the
    draws differ from one device's mesh of the same shape (each position
    draws from its device's generator)."""
    mesh = _two("8")
    x, y = (torch.from_numpy(a) for a in _batch(6))
    runs = []
    for _ in range(2):
        state = _dropout_state(5, mesh)
        master, twin = replicas(state.gen)
        assert len(state.replica_rngs) == 1
        assert torch.equal(state.rng.get_state(), torch.Generator().manual_seed(7).get_state())
        assert torch.equal(state.replica_rngs[0].get_state(),
                           torch.Generator().manual_seed(replica_seed(7, 1)).get_state())
        assert not torch.equal(state.rng.get_state(), state.replica_rngs[0].get_state())
        for mod, gen in ((master, state.rng), (twin, state.replica_rngs[0])):
            drops = [m for m in mod.modules() if isinstance(m, Dropout)]
            assert drops and all(m.generator is gen for m in drops)
        step = make_train_step(state.gen, state.disc, TrainConfig(), mesh=mesh)
        metrics = [step(state, x, y) for _ in range(2)]
        _models_bit_equal(state.gen, state.disc)
        runs.append((metrics, _everything(state)))
    (ma, sa), (mb, sb) = runs
    assert all(torch.equal(a[k], b[k]) for a, b in zip(ma, mb) for k in a)
    assert _same(sa, sb)
    one = _dropout_state(5, _mesh("8"))
    m1 = make_train_step(one.gen, one.disc, TrainConfig(), mesh=_mesh("8"))(one, x, y)
    assert float(m1["train_gen_loss"]) != float(ma[0]["train_gen_loss"])
    assert replica_seed(7, 1) != replica_seed(7, 2) != 7


def test_remat_over_two_devices_replays_each_replicas_dropout():
    """``ModelConfig.remat`` on (4, 2) over the two entries, dropout on:
    the recompute replays each replica's own generator, so the step is bit
    for bit the step without remat, generators included."""
    mesh = _two("4x2")
    x, y = (torch.from_numpy(a) for a in _batch(9))
    out = []
    for remat in (False, True):
        state = _dropout_state(4, mesh, remat=remat)
        metrics = make_train_step(state.gen, state.disc, TrainConfig(), mesh=mesh)(state, x, y)
        out.append((metrics, _everything(state)))
    (ma, sa), (mb, sb) = out
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert _same(sa, sb)


def test_checkpoint_on_two_devices_resumes_bit_equal_and_loads_on_one(tmp_path):
    """A step saved on the two entries holds the master's weights and both
    generators' states; loaded into a fresh state on the same mesh it
    resumes bit for bit (weights broadcast into the replica, each
    generator restored), and it loads into a state on one device, the
    generator bit-equal to the master."""
    mesh = _two("8")
    x, y = (torch.from_numpy(a) for a in _batch(8))
    state = _dropout_state(3, mesh)
    step = make_train_step(state.gen, state.disc, TrainConfig(), mesh=mesh)
    step(state, x, y)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpts"), top_k=1)
    mgr.save(0, state, {"val_loss": 1.0})
    payload = torch.load(tmp_path / "ckpts" / "0" / "state.pt", weights_only=True)
    assert len(payload["replica_rngs"]) == 1
    resumed = mgr.restore(_dropout_state(11, mesh))
    assert resumed.step == 1 and _same(_everything(resumed), _everything(state))
    _models_bit_equal(resumed.gen, resumed.disc)
    again = make_train_step(resumed.gen, resumed.disc, TrainConfig(), mesh=mesh)
    ma, mb = step(state, x, y), again(resumed, x, y)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert _same(_everything(resumed), _everything(state))
    flat = checkpoint.load_checkpoint(str(tmp_path / "ckpts" / "0"), _dropout_state(11, None))
    assert flat.replica_rngs == () and replicas(flat.gen) == (flat.gen,)
    gen_sd = flat.gen.state_dict()
    assert all(torch.equal(gen_sd[k], v) for k, v in payload["gen"].items())


# ---------------------------------------------------- the default training mesh
@pytest.mark.parametrize("count,want", [(1, None), (4, 4), (6, 2)])
def test_default_mesh_takes_every_card_the_batch_divides(monkeypatch, capsys, count, want):
    """Batch 8 with 1, 4 and 6 visible cards: no mesh on one card; a data
    axis over cuda:0 … cuda:k-1, k = gcd(8, count), and the JAX package's
    line where k falls short of the count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    mesh = default_mesh(8)
    printed = capsys.readouterr().out
    if want is None:
        assert mesh is None and printed == ""
        return
    assert mesh.axis_names == ("data",) and mesh.shape == (want,)
    assert mesh.distinct == tuple(torch.device("cuda", i) for i in range(want))
    if want == count:
        assert printed == ""
    else:
        assert printed == (f"batch_size 8 not divisible by {count} devices; using a "
                           f"{want}-device mesh (set batch_size to a multiple of the device "
                           f"count to use all devices)\n")


def test_no_default_mesh_without_a_card_or_with_a_device_named(monkeypatch, tmp_path):
    """Without a card there is no default mesh (the loops then ask for
    ``cuda`` and raise); a named device or mesh is never replaced; the
    train CLI passes no device unless ``--device`` names one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_mesh(8) is None
    called = []
    monkeypatch.setattr(loop, "default_mesh", lambda b: called.append(b))
    trainer = loop.Trainer(_config(tmp_path), "pc-bssfp", device="cpu")
    assert trainer.mesh is None and not called
    trainer = loop.Trainer(_config(tmp_path), "pc-bssfp", mesh=_two("8"))
    assert trainer.mesh.devices == _two("8").devices and not called
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        loop.Trainer(_config(tmp_path), "pc-bssfp")
    assert called == [8]
    seen = []
    monkeypatch.setattr(train_cli, "DoveDataModule",
                        lambda root, config: type("D", (), {"prepare_data": lambda self: None})())
    monkeypatch.setattr(train_cli, "train_model",
                        lambda data, modality, **kw: seen.append(kw["device"]))
    train_cli.main([str(tmp_path), "--modalities", "t1w"])
    train_cli.main([str(tmp_path), "--modalities", "t1w", "--device", "cpu"])
    assert seen == [None, torch.device("cpu")]


# ------------------------------------------------------------------ the loops
def test_trainer_fit_on_the_default_mesh_over_two_devices_matches_one_device(
        monkeypatch, tmp_path):
    """``Trainer`` given neither a device nor a mesh takes the default mesh
    (here the two entries, standing for two cards): one epoch of 8 × 16³
    batches matches the one-device Trainer's row within the loop tests'
    bound, the models' replicas end bit-equal, and the epoch's checkpoint
    (the masters) loads into a one-device state bit for bit."""
    monkeypatch.setattr(loop, "default_mesh", lambda batch: _two("8"))
    rng = np.random.default_rng(2026)
    train = [{k: np.concatenate([b[k] for b in _batches(rng, 4)]) for k in
              ("pc-bssfp", "dwi-tensor_orig")}]
    val = [{k: np.concatenate([b[k] for b in _batches(rng, 4)]) for k in
            ("pc-bssfp", "dwi-tensor_orig")}]
    rows, done = {}, {}
    for key, kw in (("one", dict(device="cpu")), ("two", {})):
        cfg = _config(tmp_path / key, max_epochs=1, lr=LR)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0))
        trainer = loop.Trainer(cfg, "pc-bssfp", **kw)
        state, best = trainer.fit(StubData(train, val, torch.from_numpy))
        trainer.logger.finish()
        rows[key], done[key] = _read_metrics(cfg.train.log_dir), (trainer, state, best)
    trainer, state, best = done["two"]
    assert trainer.mesh is not None and trainer.batch_divisor == 8 and state.step == 1
    _rows_close(rows["two"], rows["one"])
    _models_bit_equal(state.gen, state.disc)
    flat = checkpoint.load_checkpoint(best, done["one"][0].init_state())
    for mod, twin in ((state.gen, flat.gen), (state.disc, flat.disc)):
        sd = twin.state_dict()
        assert all(torch.equal(v, sd[k]) for k, v in mod.state_dict().items())


@pytest.fixture(scope="module")
def bids_root(tmp_path_factory):
    return make_synthetic_bids(str(tmp_path_factory.mktemp("bids")),
                               subjects=("01", "02", "03", "04"), sessions=("1",),
                               volume_shape=(16, 16, 16), seed=5)


def test_run_multistage_on_the_default_mesh_over_two_devices_matches_one_device(
        bids_root, tmp_path, monkeypatch):
    """``run_multistage`` given neither a device nor a mesh takes the
    default mesh (the two entries): one epoch a stage matches the
    one-device run's rows within the loop tests' bound, every stage's net
    ends with its replica bit-equal, TRANSFER's backbone PRETRAIN's."""
    monkeypatch.setattr(ms, "default_mesh", lambda batch: Mesh([[CPU], [CPU0]], ("data",)))
    rows = {}
    for key, kw in (("one", dict(device="cpu")), ("two", {})):
        cfg = Config(
            data=DataConfig(batch_size=2, patch_size=16, samples_per_vol=2,
                            volume_shape=(16, 16, 16), val_split=0.25, test_split=0.25,
                            num_workers=1),
            model=ModelConfig(features=MS_FEATURES, multistage_features=MS_FEATURES,
                              compute_dtype="float32", dropout=0.0),
            train=TrainConfig(log_dir=str(tmp_path / key / "logs"),
                              checkpoint_dir=str(tmp_path / key / "ckpts"),
                              checkpoint_top_k=2, with_perceptual=False))
        data = DoveDataModule(bids_root, config=cfg.data)
        data.prepare_data()
        states, _ = ms.run_multistage(data, "t1w", cfg, epochs_per_stage=dict.fromkeys(
            TrainingState, 1), **kw)
        if key == "two":
            for st in states.values():
                assert len(replicas(st.net)) == 2 and len(st.replica_rngs) == 1
                _models_bit_equal(st.net)
        pre = states[TrainingState.PRETRAIN].net.state_dict()
        assert all(torch.equal(v, pre[k]) for k, v in
                   states[TrainingState.TRANSFER].net.state_dict().items()
                   if k.startswith("unet."))
        rows[key] = {s: _stage_rows(tmp_path / key, s) for s in TrainingState}
    for stage in TrainingState:
        _rows_close(rows["two"][stage], rows["one"][stage])


def _stage_rows(root, stage):
    with open(root / "logs" / f"multistage-t1w-{stage.value}" / "metrics.csv") as f:
        return list(csv.DictReader(f))

