"""The port's epoch loop (``train/loop.py``) on the CPU: the mechanics of
the JAX package's ``tests/test_loop.py`` (fit end to end, top-k, restore,
the plateau early stop, ``auto`` resume, ``log_clean_val``) on a tiny
synthetic BIDS tree, the loop's own arithmetic against the JAX ``Trainer``
on the same batches, ``debug``'s trace, and the train CLI."""

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
from unet_bssfp_tpu.train.state import GANTrainState as JaxGANTrainState
from unet_bssfp_tpu.train.state import make_optimizer as jax_make_optimizer
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
from unet_bssfp_tpu_torch.train import loop
from unet_bssfp_tpu_torch.train.__main__ import main as train_main
from unet_bssfp_tpu_torch.train.checkpoint import load_checkpoint
from unet_bssfp_tpu_torch.train.loop import Trainer, train_model

torch.set_num_threads(1)

VOL = (24, 32, 32)
PATCH = 16


@pytest.fixture(autouse=True)
def _keep_prng_impl():
    """The JAX package's Trainer and create_gan_state switch JAX's default
    PRNG implementation for the process; put it back for the next test."""
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


@pytest.fixture(scope="module")
def bids_root(tmp_path_factory):
    return make_synthetic_bids(str(tmp_path_factory.mktemp("bids")), volume_shape=VOL, seed=3)


def _config(tmp_path, **train_kw):
    """tests/test_loop.py's tiny config: a 3/1/1 subject split, 16³
    patches, small nets, f32."""
    return Config(
        data=DataConfig(batch_size=8, patch_size=PATCH, samples_per_vol=2, volume_shape=VOL,
                        val_split=0.2, test_split=0.2, num_workers=2, cache_volumes=True),
        model=ModelConfig(features=(4, 8, 8, 16, 16, 4), disc_features=(8, 8, 16),
                          compute_dtype="float32"),
        train=TrainConfig(log_dir=str(tmp_path / "logs"),
                          checkpoint_dir=str(tmp_path / "ckpts"), checkpoint_top_k=2,
                          **{"with_perceptual": False, **train_kw}))


def _read_metrics(log_dir):
    runs = sorted(os.listdir(log_dir))
    assert runs, f"no runs under {log_dir}"
    with open(os.path.join(log_dir, runs[-1], "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_trainer_fit_end_to_end(bids_root, tmp_path):
    """3 GAN epochs: every column finite, L1 descends, at most top_k steps
    and config.json on disk, the best checkpoint restores into a fresh
    state and drives the eval step (bit for bit the in-memory state where
    the best is the last epoch)."""
    cfg = _config(tmp_path, max_epochs=3)
    data = DoveDataModule(bids_root, config=cfg.data)
    trainer = Trainer(cfg, "dwi-tensor", device="cpu")
    state, best = trainer.fit(data)
    trainer.logger.finish()

    rows = _read_metrics(cfg.train.log_dir)
    assert len(rows) == 3
    for key in ("train_gen_loss", "train_gen_loss_recon_L1", "train_discr_loss",
                "val_gen_loss_recon", "val_loss", "val_metric_PSNR", "epoch_seconds"):
        assert key in rows[0], f"missing {key}"
    assert all(np.isfinite(float(v)) for r in rows for v in r.values())
    first = float(rows[0]["train_gen_loss_recon_L1"])
    last = float(rows[-1]["train_gen_loss_recon_L1"])
    assert last < first, f"L1 did not descend: {first} -> {last}"

    run_dir = os.path.dirname(best)
    steps = sorted(int(d) for d in os.listdir(run_dir) if d.isdigit())
    assert steps == trainer.ckpt.steps and 1 <= len(steps) <= cfg.train.checkpoint_top_k
    assert os.path.exists(os.path.join(run_dir, "config.json"))
    assert all(os.listdir(os.path.join(run_dir, str(s))) == ["state.pt"] for s in steps)

    restored = load_checkpoint(best, trainer.init_state(seed=99))
    assert restored.step > 0
    batch = next(iter(data.val_batches(0, keys=("dwi-tensor", "dwi-tensor"), device="cpu")))
    metrics, _ = trainer.eval_step(restored, batch["dwi-tensor"], batch["dwi-tensor_orig"])
    assert all(np.isfinite(float(v)) for v in metrics.values())
    if trainer.ckpt.best_step == 2:
        ref, _ = trainer.eval_step(state, batch["dwi-tensor"], batch["dwi-tensor_orig"])
        assert {k: float(v) for k, v in metrics.items()} == {k: float(v) for k, v in ref.items()}
        assert torch.equal(restored.rng.get_state(), state.rng.get_state())
        assert restored.step == state.step


def test_trainer_early_stop_on_plateau(bids_root, tmp_path):
    """A constant monitored metric (stubbed eval step) ⇒ patience-1 early
    stopping ends the run after exactly 2 of 5 epochs."""
    cfg = _config(tmp_path, max_epochs=5, early_stop_patience=1)
    data = DoveDataModule(bids_root, config=cfg.data)
    trainer = Trainer(cfg, "dwi-tensor", device="cpu")
    real_eval = trainer.eval_step

    def plateau_eval(state, x, y):
        metrics, y_hat = real_eval(state, x, y)
        return {**metrics, "val_gen_loss_recon": torch.tensor(1.0)}, y_hat

    trainer.eval_step = plateau_eval
    trainer.fit(data)
    trainer.logger.finish()
    assert len(_read_metrics(cfg.train.log_dir)) == 2


def test_train_model_auto_resume(bids_root, tmp_path):
    """``ckpt_path='auto'`` picks up the newest checkpoint and continues
    its step counter, in a new run directory."""
    cfg = _config(tmp_path, max_epochs=1)
    data = DoveDataModule(bids_root, config=cfg.data)
    best1 = train_model(data, "dwi-tensor", config=cfg, max_epochs=1, device="cpu")
    best2 = train_model(data, "dwi-tensor", ckpt_path="auto", config=cfg, max_epochs=1,
                        device="cpu")
    assert os.path.dirname(best1) != os.path.dirname(best2)
    template = Trainer(cfg, "dwi-tensor", device="cpu").init_state()
    s1 = load_checkpoint(best1, template).step
    s2 = load_checkpoint(best2, template).step
    assert s2 > s1 > 0, f"resume did not advance the step counter: {s1} -> {s2}"


def test_log_clean_val(bids_root, tmp_path):
    cfg = _config(tmp_path, max_epochs=1, log_clean_val=True)
    data = DoveDataModule(bids_root, config=cfg.data)
    trainer = Trainer(cfg, "dwi-tensor", device="cpu")
    trainer.fit(data)
    rows = _read_metrics(cfg.train.log_dir)
    for key in ("val_metric_PSNR", "val_clean_metric_PSNR", "val_clean_gen_loss_recon"):
        assert key in rows[0], f"missing {key}"
        assert np.isfinite(float(rows[0][key]))


def test_debug_traces_the_first_steps_under_anomaly_mode(bids_root, tmp_path, monkeypatch):
    cfg = _config(tmp_path, max_epochs=1)
    trainer = Trainer(cfg, "dwi-tensor", device="cpu", debug=True)
    seen = []
    step = trainer.train_step
    monkeypatch.setattr(trainer, "train_step", lambda *a: seen.append(
        torch.is_anomaly_enabled()) or step(*a))
    trainer.fit(DoveDataModule(bids_root, config=cfg.data))
    assert seen and all(seen) and not torch.is_anomaly_enabled()
    traces = os.listdir(os.path.join(cfg.train.log_dir, "trace"))
    assert len(traces) == 1 and traces[0].endswith(".json")


def test_trainer_and_cli_default_to_cuda(tmp_path, bids_root):
    cfg = _config(tmp_path)
    if torch.cuda.is_available():
        assert Trainer(cfg, "dwi-tensor").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, "dwi-tensor")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main([bids_root, "--modalities", "dwi-tensor"])


def test_cli_trains_each_modality_and_refuses_multistage(tmp_path, bids_root, capsys):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(_config(tmp_path).to_json())
    train_main([bids_root, "--modalities", "dwi-tensor", "t1w", "--config", str(cfg_path),
                "--max-epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    for m in ("dwi-tensor", "t1w"):
        assert f"Best checkpoint for {m}: {tmp_path / 'ckpts'}" in out
    # --multistage takes the pretrain → transfer → finetune regime instead
    cfg = _config(tmp_path)
    cfg_path.write_text(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, multistage_features=(4, 8, 8, 16, 16, 4))).to_json())
    train_main([bids_root, "--multistage", "--modalities", "dwi-tensor", "--config",
                str(cfg_path), "--max-epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Multi-stage dwi-tensor final metrics" in out and "Best checkpoint" not in out
    assert {d for d in os.listdir(tmp_path / "ckpts") if d.startswith("multistage-")} == {
        f"multistage-dwi-tensor-{s}" for s in ("pretrain", "transfer", "finetune")}


def test_perceptual_tristate(tmp_path):
    """Off where asked and where auto finds no Med3D weights (the JAX
    package's bound 0.0 keeps auto off at any positive factor); an explicit
    True builds the term into the Trainer (random features here)."""
    tcfg = _config(tmp_path).train
    assert not loop.resolve_with_perceptual(tcfg)
    assert not loop.resolve_with_perceptual(dataclasses.replace(tcfg, with_perceptual=None))
    assert not loop.resolve_with_perceptual(dataclasses.replace(
        tcfg, with_perceptual=None, perceptual_factor=0.0))
    assert loop.PERCEPTUAL_AUTO_MAX_FACTOR == 0.0
    assert loop.resolve_with_perceptual(dataclasses.replace(tcfg, with_perceptual=True))
    trainer = Trainer(dataclasses.replace(_config(tmp_path), train=dataclasses.replace(
        tcfg, with_perceptual=True)), "dwi-tensor", device="cpu")
    assert trainer.perceptual_fn is not None
    assert Trainer(_config(tmp_path), "dwi-tensor", device="cpu").perceptual_fn is None


def test_trainer_with_perceptual_trains_an_epoch(bids_root, tmp_path):
    """``with_perceptual: true`` (random features, f32): one epoch of
    ``Trainer.fit`` logs a finite Perceptual term for train and val
    (tests/test_loop.py:227-278 in the JAX package)."""
    cfg = _config(tmp_path, max_epochs=1, with_perceptual=True)
    trainer = Trainer(cfg, "dwi-tensor", device="cpu")
    trainer.fit(DoveDataModule(bids_root, config=cfg.data))
    trainer.logger.finish()
    (row,) = _read_metrics(cfg.train.log_dir)
    for key in ("train_gen_loss_recon_Perceptual", "val_gen_loss_recon_Perceptual"):
        assert np.isfinite(float(row[key])) and float(row[key]) > 0, key
    # the recon loss is the mean of L1 and the scaled term, times recon_factor
    l1, perc = (float(row[f"train_gen_loss_recon_{k}"]) for k in ("L1", "Perceptual"))
    assert float(row["train_gen_loss_recon"]) == pytest.approx(
        (l1 + perc) / 2 * cfg.train.recon_factor, rel=1e-5)


def test_epoch_seeds_differ_by_epoch_and_stream():
    seeds = [loop.epoch_seeds(43, e) for e in range(4)]
    assert len({s for pair in seeds for s in pair}) == 8
    assert loop.epoch_seeds(43, 2) == seeds[2]


# ---- the loop's own arithmetic against the JAX Trainer ---------------------

# lr 3e-5 and dropout 0 (tests/test_torch_port_train_step.py:22-26); the
# same tolerance as that test's losses
LR = 3e-5


class StubData:
    """The same numpy batches every epoch, as each package's loop takes
    them: the JAX loop's ``train_batches(key, keys=, batch_divisor=)``, the
    port's ``train_batches(seed, keys=, device=)``."""

    def __init__(self, train, val, convert):
        self.train, self.val, self.convert = train, val, convert

    def setup(self):
        pass

    def _out(self, batches):
        return [{k: self.convert(v) for k, v in b.items()} for b in batches]

    def train_batches(self, seed, keys, **kw):
        return self._out(self.train)

    def val_batches(self, seed, keys, augment=True, **kw):
        return self._out(self.val if augment else self.val[::-1])


def _batches(rng, n):
    return [{"pc-bssfp": rng.random((2, PATCH, PATCH, PATCH, 24), dtype=np.float32),
             "dwi-tensor_orig": rng.random((2, PATCH, PATCH, PATCH, 6), dtype=np.float32)}
            for _ in range(n)]


def _jax_state(trainer, seed):
    """The JAX package's initial state with its inits jitted (eager Flax
    init is slow here)."""
    x, y = (np.zeros((1, PATCH, PATCH, PATCH, c), np.float32) for c in (24, 6))
    k_gen, k_disc, k_state = jax.random.split(jax.random.PRNGKey(seed), 3)
    gv = jax.jit(trainer.gen.init, static_argnames="train")(k_gen, x, train=False)
    dv = jax.jit(trainer.disc.init, static_argnames="train")(k_disc, x, y, train=False)
    opt = jax_make_optimizer(trainer.config.train)
    return JaxGANTrainState(
        step=jnp.zeros((), jnp.int32), rng=k_state,
        gen_params=gv["params"], gen_batch_stats=gv["batch_stats"],
        disc_params=dv["params"], disc_batch_stats=dv["batch_stats"],
        gen_opt_state=opt.init(gv["params"]), disc_opt_state=opt.init(dv["params"]))


def test_loop_matches_the_jax_trainer_on_the_same_batches(tmp_path):
    cfg = dataclasses.replace(
        _config(tmp_path / "port", max_epochs=2, log_clean_val=True, lr=LR),
        model=dataclasses.replace(_config(tmp_path).model, dropout=0.0))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, augment_prob=0.0))
    jcfg = JaxConfig.from_json(cfg.to_json())
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, folded=False),
                               train=dataclasses.replace(
                                   jcfg.train, log_dir=str(tmp_path / "jax" / "logs"),
                                   checkpoint_dir=str(tmp_path / "jax" / "ckpts")))
    rng = np.random.default_rng(2024)
    train, val = _batches(rng, 2), _batches(rng, 2)

    jtrainer = JaxTrainer(jcfg, "pc-bssfp", mesh=jax_make_mesh(1))
    jstate = _jax_state(jtrainer, 11)
    trainer = Trainer(cfg, "pc-bssfp", device="cpu")
    state = trainer.init_state()
    weights.state_from_flax(state.gen, state.disc, {
        k: jax.tree.map(np.asarray, getattr(jstate, k))
        for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")})

    jtrainer.fit(StubData(train, val, jnp.asarray), jstate)
    jtrainer.logger.finish()
    trainer.fit(StubData(train, val, torch.from_numpy), state)

    ref, got = _read_metrics(jcfg.train.log_dir), _read_metrics(cfg.train.log_dir)
    assert len(got) == len(ref) == 2
    assert set(got[0]) == set(ref[0])
    assert any(k.startswith("val_clean_") for k in got[0])
    for g, r in zip(got, ref):
        for k in r:
            if k == "epoch_seconds":
                continue
            rv = float(r[k])
            assert float(g[k]) == pytest.approx(rv, abs=1e-3 * max(abs(rv), 1.0)), k
    assert state.step == 4
