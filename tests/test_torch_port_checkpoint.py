"""The port's checkpoints (``train/checkpoint.py``) on the CPU: top-k
retention against the JAX package's Orbax ``CheckpointManager`` on the same
metric rows, a step's file restoring the whole train state bit for bit
(the next step included), the atomic write, strict loading, and the
converter from a JAX Orbax checkpoint (``scripts/torch_port_convert_checkpoint.py``)."""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_bssfp_tpu.config import Config as JaxConfig
from unet_bssfp_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu.train.steps import make_train_step as jax_make_train_step
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.train import checkpoint as ckpt
from unet_bssfp_tpu_torch.train.state import create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
import torch_port_convert_checkpoint as converter  # noqa: E402

torch.set_num_threads(1)

PATCH = 16
MCFG = ModelConfig(features=(4, 8, 8, 16, 16, 4), disc_features=(8, 8, 16),
                   compute_dtype="float32", dropout=0.05)
INF = math.inf


@pytest.fixture(autouse=True)
def _keep_prng_impl():
    """The JAX package's Trainer and create_gan_state switch JAX's default
    PRNG implementation for the process; put it back for the next test."""
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


# Metric rows, one a step: ties (at the best, at the cut and everywhere),
# rows without val_loss (ranked worst), improvement and decline.
ROWS = {
    "improving": [3.0, 2.0, 1.0, 0.5, 0.25],
    "declining": [0.25, 0.5, 1.0, 2.0, 3.0],
    "ties_at_the_cut": [1.0, 2.0, 2.0, 2.0, 3.0, 2.0],
    "all_equal": [1.0, 1.0, 1.0, 1.0],
    "missing_monitor": [None, 2.0, None, 1.0, None, 3.0],
    "only_missing": [None, None, None, None],
    "mixed": [2.0, None, 1.0, 1.0, 4.0, None, 0.5, 1.0],
}


def _tiny_state(seed=0, mcfg=MCFG):
    return create_gan_state(seed, "pc-bssfp", mcfg, TrainConfig(), "cpu")


def _kept(directory):
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_retention_matches_orbax(tmp_path, name, top_k):
    """After every row both managers keep the same steps on disk. The best
    step is the JAX package's wherever that one is still on disk; where it
    was retired (a later row tied it at the best, Orbax keeping the later),
    the JAX package names a deleted directory and the port the first kept
    step of the best value."""
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), top_k=top_k)
    mgr = ckpt.CheckpointManager(str(tmp_path / "port"), top_k=top_k)
    state = _tiny_state()
    jtree = {"w": jnp.zeros(2)}
    for step, value in enumerate(ROWS[name]):
        row = {"val_gen_loss_recon": 0.0} if value is None else {"val_loss": value}
        jmgr.save(step, jtree, row)
        mgr.save(step, state, row)
        jmgr.wait()
        assert _kept(jmgr.directory) == _kept(mgr.directory) == mgr.steps, (step, value)
        jbest = jmgr.best_path()
        if os.path.isdir(jbest):
            assert mgr.best_step == jmgr.best_step
        else:
            values = [INF if v is None else v for v in ROWS[name][:step + 1]]
            assert mgr.best_step == min(s for s in mgr.steps if values[s] == min(values))
        assert os.path.isfile(os.path.join(mgr.best_path(), ckpt.STATE_FILE))
    jmgr.close()


def test_best_step_of_the_jax_package_can_be_retired(tmp_path):
    """The case above written out: three equal rows at top_k 2."""
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), top_k=2)
    mgr = ckpt.CheckpointManager(str(tmp_path / "port"), top_k=2)
    for step in range(3):
        jmgr.save(step, {"w": jnp.zeros(2)}, {"val_loss": 1.0})
        mgr.save(step, _tiny_state(), {"val_loss": 1.0})
    assert jmgr.best_step == 0 and not os.path.exists(jmgr.best_path())
    assert mgr.steps == [1, 2] and mgr.best_step == 1
    jmgr.close()


def _train(state, n, seed=3):
    step = make_train_step(state.gen, state.disc, TrainConfig())
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.rand(2, PATCH, PATCH, PATCH, 24, generator=g)
        y = torch.rand(2, PATCH, PATCH, PATCH, 6, generator=g)
        out.append({k: float(v) for k, v in step(state, x, y).items()})
    return out


def _assert_same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    for m in ("gen", "disc"):
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    for o in ("gen_opt", "disc_opt"):
        sa, sb = getattr(a, o).state_dict(), getattr(b, o).state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        assert sa["state"].keys() == sb["state"].keys()
        for i in sa["state"]:
            for k, v in sa["state"][i].items():
                assert torch.equal(v, sb["state"][i][k]), (o, i, k)


def test_save_and_load_restore_the_whole_state(tmp_path):
    """Two steps (dropout on), saved; a fresh state from another seed loads
    it, equals it bit for bit (weights, BatchNorm buffers, both AdamW
    states, step, the dropout generator) and takes the next step as the
    original does."""
    state = _tiny_state(0)
    _train(state, 2)
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), config_json=Config().to_json())
    mgr.save(1, state, {"val_loss": 0.5})
    restored = ckpt.load_checkpoint(mgr.best_path(), _tiny_state(7))
    _assert_same_state(restored, state)
    assert _train(restored, 1, seed=9) == _train(state, 1, seed=9)
    _assert_same_state(restored, state)
    again = mgr.restore(_tiny_state(8))  # the manager's own restore: the best
    assert again.step == 2
    assert ckpt.load_config_for_checkpoint(
        os.path.join(mgr.best_path(), ckpt.STATE_FILE)) == Config().to_json()


def test_a_crash_mid_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    """A save that dies while writing leaves neither ``state.pt`` nor its
    temporary file, and ``find_latest_checkpoint`` skips the step for the
    last whole one (a half-written file at the temporary name too)."""
    root = tmp_path / "ckpts"
    mgr = ckpt.CheckpointManager(str(root / "pc-bssfp-20260101-000000"))
    state = _tiny_state()
    mgr.save(0, state, {"val_loss": 1.0})

    def dies(obj, f):
        f.write(b"partial")
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError, match="disk gone"):
        mgr.save(1, state, {"val_loss": 0.5})
    assert os.listdir(os.path.join(mgr.directory, "1")) == []
    (root / "pc-bssfp-20260101-000000" / "2").mkdir()
    (root / "pc-bssfp-20260101-000000" / "2" / "state.pt.tmp-1").write_bytes(b"x")
    assert ckpt.find_latest_checkpoint(str(root), "pc-bssfp") == os.path.join(mgr.directory, "0")
    assert ckpt.find_latest_checkpoint(str(root), "t1w") is None
    assert ckpt.find_latest_checkpoint(str(tmp_path / "none")) is None


def test_find_latest_takes_the_newest_run_and_step(tmp_path):
    root = tmp_path / "ckpts"
    for run, steps in (("pc-bssfp-20260101-000000", (0, 5)),
                       ("pc-bssfp-20260102-000000", (1, 3)),
                       ("dwi-tensor-20260103-000000", (9,))):
        for s in steps:
            (root / run / str(s)).mkdir(parents=True)
            (root / run / str(s) / "state.pt").write_bytes(b"x")
    assert ckpt.find_latest_checkpoint(str(root), "pc-bssfp").endswith(
        os.path.join("pc-bssfp-20260102-000000", "3"))
    assert ckpt.find_latest_checkpoint(str(root)).endswith(
        os.path.join("pc-bssfp-20260102-000000", "3"))
    assert ckpt.find_latest_checkpoint(str(root), "dwi-tensor").endswith("9")


def test_loading_is_strict(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    mgr.save(0, _tiny_state(), {"val_loss": 1.0})
    other = _tiny_state(mcfg=dataclasses.replace(MCFG, features=(4, 8, 8, 16, 16, 8)))
    with pytest.raises(RuntimeError, match="size mismatch"):
        ckpt.load_checkpoint(mgr.best_path(), other)
    path = os.path.join(mgr.best_path(), ckpt.STATE_FILE)
    payload = torch.load(path, weights_only=True)
    payload["rng"]["device_type"] = "cuda"
    torch.save(payload, path)
    with pytest.raises(ValueError, match="generator"):
        ckpt.load_checkpoint(mgr.best_path(), _tiny_state())


# ---- the converter ---------------------------------------------------------

LR = 3e-5  # tests/test_torch_port_train_step.py:22-26


def _jax_state(jgen, jdisc, jtcfg, seed):
    from unet_bssfp_tpu.train.state import GANTrainState, make_optimizer

    x, y = (np.zeros((1, PATCH, PATCH, PATCH, c), np.float32) for c in (24, 6))
    k_gen, k_disc, k_state = jax.random.split(jax.random.PRNGKey(seed), 3)
    gv = jax.jit(jgen.init, static_argnames="train")(k_gen, x, train=False)
    dv = jax.jit(jdisc.init, static_argnames="train")(k_disc, x, y, train=False)
    opt = make_optimizer(jtcfg)
    return GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=k_state,
        gen_params=gv["params"], gen_batch_stats=gv["batch_stats"],
        disc_params=dv["params"], disc_batch_stats=dv["batch_stats"],
        gen_opt_state=opt.init(gv["params"]), disc_opt_state=opt.init(dv["params"]))


def test_converted_jax_checkpoint_continues_training(tmp_path):
    """A JAX state takes one step and is saved by the JAX package's manager;
    the converter writes the port's ``state.pt``. Then:
    - the converted moments and step are optax's, leaf for leaf;
    - torch AdamW's next update from them, on the gradients optax is given,
      is optax's update (this is what reads exp_avg, exp_avg_sq and step);
    - the next GAN step runs in both packages and agrees within the train
      step test's tolerance."""
    cfg = Config(model=dataclasses.replace(MCFG, dropout=0.0),
                 train=TrainConfig(lr=LR, with_perceptual=False))
    jcfg = JaxConfig.from_json(cfg.to_json())
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, folded=False))
    jgen, jdisc = jax_build_models("pc-bssfp", jcfg.model)
    jstate = _jax_state(jgen, jdisc, jcfg.train, 5)
    jstep = jax_make_train_step(jgen, jdisc, jcfg.train, donate=False)
    rng = np.random.default_rng(77)
    batches = [(rng.random((2, PATCH, PATCH, PATCH, 24), dtype=np.float32),
                rng.random((2, PATCH, PATCH, PATCH, 6), dtype=np.float32)) for _ in range(2)]
    jstate, _ = jstep(jstate, *map(jnp.asarray, batches[0]))
    jrun = tmp_path / "jax" / "pc-bssfp-20260101-000000"
    jmgr = JaxCheckpointManager(str(jrun), config_json=jcfg.to_json())
    jmgr.save(0, jstate, {"val_loss": 1.0})
    jmgr.wait()

    out = tmp_path / "port" / "pc-bssfp-20260101-000000"
    assert converter.main([str(jrun / "0"), str(out)]) == 0
    assert ckpt.find_latest_checkpoint(str(tmp_path / "port"), "pc-bssfp") == str(out / "0")
    assert Config.from_json(ckpt.load_config_for_checkpoint(str(out / "0"))).train.lr == LR
    state = ckpt.load_checkpoint(str(out / "0"), create_gan_state(
        0, "pc-bssfp", cfg.model, cfg.train, "cpu"))
    assert state.step == 1
    assert torch.equal(state.rng.get_state(),
                       torch.Generator().manual_seed(cfg.train.seed + 2).get_state())

    # the moments, leaf for leaf
    adam = converter._adam_state(jstate.gen_opt_state)
    mu = weights.from_flax(jax.tree.map(np.asarray, adam.mu))
    nu = weights.from_flax(jax.tree.map(np.asarray, adam.nu))
    opt_state = state.gen_opt.state_dict()["state"]
    names = [n for n, _ in state.gen.named_parameters()]
    assert len(opt_state) == len(names) == len(mu)
    for i, n in enumerate(names):
        assert torch.equal(opt_state[i]["exp_avg"], mu[n])
        assert torch.equal(opt_state[i]["exp_avg_sq"], nu[n])
        assert float(opt_state[i]["step"]) == int(adam.count) == 1

    # torch AdamW's next update on optax's gradients is optax's update
    g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                     jstate.gen_params)
    opt = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    updates, _ = opt.update(g, jstate.gen_opt_state, jstate.gen_params)
    ref = weights.from_flax(jax.tree.map(np.asarray, optax.apply_updates(
        jstate.gen_params, updates)))
    grads = weights.from_flax(jax.tree.map(np.asarray, g))
    probe = ckpt.load_checkpoint(str(out / "0"), create_gan_state(
        0, "pc-bssfp", cfg.model, cfg.train, "cpu"))
    before = {n: p.detach().clone() for n, p in probe.gen.named_parameters()}
    for n, p in probe.gen.named_parameters():
        p.grad = grads[n]
    probe.gen_opt.step()
    # The two part by an ulp or so of the leaf's largest entry (p·(1 - lr·wd)
    # and the step rounded in f32, in other orders) and by ~1e-5 of the
    # update (optax takes its bias corrections 1 - b^t with b in f32, torch
    # in f64). A wrong step count or moment moves the update by a third or
    # more.
    for n, p in probe.gen.named_parameters():
        update = float((ref[n] - before[n]).abs().max())
        atol = 4 * 2.0 ** -23 * float(ref[n].abs().max()) + 1e-4 * update
        assert float((p.detach() - ref[n]).abs().max()) <= atol, n

    # the next GAN step in both packages
    jstate, jm = jstep(jstate, *map(jnp.asarray, batches[1]))
    got = make_train_step(state.gen, state.disc, cfg.train)(
        state, *map(torch.from_numpy, batches[1]))
    assert got.keys() == jm.keys()
    for k in jm:
        r = float(jm[k])
        assert float(got[k]) == pytest.approx(r, abs=1e-3 * max(abs(r), 1.0)), k
    assert state.step == int(jstate.step) == 2
    jmgr.close()


def test_converter_reads_the_modality_from_the_run_name():
    assert converter.modality_of("/x/pc-bssfp-20260101-000000") == "pc-bssfp"
    assert converter.modality_of("/x/bssfp-20260101-000000/") == "bssfp"
    assert converter.modality_of("/x/dwi-tensor-20260101-000000") == "dwi-tensor"
    with pytest.raises(ValueError, match="--modality"):
        converter.modality_of("/x/run-1")
