"""Training across processes (``parallel/distributed.py``) on the CPU: the
port's counterpart of ``tests/test_multihost.py``.

Every group of workers runs as fresh interpreters (``subprocess``, one
thread each, a ``file://`` rendezvous under the test's directory), all
groups at once, while the pytest process computes the JAX package's GAN
step on a 4-device mesh (``tests/conftest.py``'s virtual devices) over the
same 4 samples:

- ``2x2`` / ``2x1``: 2 processes × 2 local mesh positions (``cpu`` and
  ``cpu:0``, two real replicas) or × 1, each on its ``process_split``
  stride-slice of the 8-subject tree's train samples (the JAX test's
  geometry: 16³, features (4, 4, 4, 4, 8, 4), disc (4, 8), dropout 0, f32,
  lr 1e-6), the weights of ``PRNGKey(0)`` carried by ``weights.from_flax``;
- ``f64_2`` / ``f64_1``: 2 processes × 2 positions against 1 process × 4
  in float64: two GAN steps, a ``ddp_parity`` step and one FINE_TUNE step;
- ``cli`` / ``odd``: the train CLI with ``--num-processes 2`` on a split
  that gives both processes the same steps, and on one that does not.
"""

import csv
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import DataConfig as JaxDataConfig
from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig
from unet_bssfp_tpu.config import TrainConfig as JaxTrainConfig
from unet_bssfp_tpu.data.datamodule import DoveDataModule as JaxDoveDataModule
from unet_bssfp_tpu.data.synthetic import make_synthetic_bids
from unet_bssfp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unet_bssfp_tpu.parallel.mesh import shard_batch as jax_shard_batch
from unet_bssfp_tpu.train.state import GANTrainState as JaxGANTrainState
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu.train.state import make_optimizer as jax_make_optimizer
from unet_bssfp_tpu.train.steps import make_train_step as jax_make_train_step
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
from unet_bssfp_tpu_torch.parallel import distributed
from unet_bssfp_tpu_torch.train import checkpoint
from unet_bssfp_tpu_torch.train.logging import MetricLogger
from unet_bssfp_tpu_torch.train.state import create_gan_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_port_multiprocess_step.py")
FEATURES, DISC_FEATURES = (4, 4, 4, 4, 8, 4), (4, 8)
LR = 1e-6  # tests/test_multihost.py's: AdamW's sign descent kept small
CLI_CONFIG = {
    "data": {"batch_size": 2, "samples_per_vol": 2, "patch_size": 16,
             "volume_shape": [16, 16, 16], "num_workers": 1, "test_split": 0.25,
             "val_split": 0.25},
    "model": {"features": list(FEATURES), "disc_features": list(DISC_FEATURES),
              "compute_dtype": "float32"},
    "train": {"max_epochs": 1}}


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _group(work, name, n, argv):
    """``n`` processes of ``argv`` (a list, or a function of the rank)
    joined at ``file://work/name.rdv``."""
    address = f"file://{work}/{name}.rdv"
    return [subprocess.Popen(
        (argv(r) if callable(argv) else argv)
        + ["--coordinator-address", address, "--num-processes", str(n), "--process-id", str(r)],
        env=_env(), cwd=str(work), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]


def _wait(procs, timeout=400):
    """Each process's ``(returncode, output)``; a process that outlives
    ``timeout`` is killed and fails the test."""
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append((p.returncode, text.decode(errors="replace")))
    return out


def _jax_state():
    """``create_gan_state(PRNGKey(0), "dwi-tensor", …, patch_size=16)`` of
    the JAX package, its two inits jitted (eager, they take ~45 s): the
    same keys, split as it splits them."""
    jcfg = JaxModelConfig(features=FEATURES, disc_features=DISC_FEATURES, dropout=0.0,
                          compute_dtype="float32", packed=False, folded=False)
    jtcfg = JaxTrainConfig(rng_impl="", lr=LR)
    jgen, jdisc = jax_build_models("dwi-tensor", jcfg)
    x, y = jnp.zeros((1, 16, 16, 16, 6)), jnp.zeros((1, 16, 16, 16, 6))
    k_gen, k_disc, k_state = jax.random.split(jax.random.PRNGKey(0), 3)
    gv = jax.jit(lambda kp, kd: jgen.init({"params": kp, "dropout": kd}, x, train=False))(
        k_gen, k_state)
    dv = jax.jit(lambda kp: jdisc.init({"params": kp}, x, y, train=False))(k_disc)
    opt = jax_make_optimizer(jtcfg)
    state = JaxGANTrainState(
        step=jnp.zeros((), jnp.int32), rng=k_state, gen_params=gv["params"],
        gen_batch_stats=gv["batch_stats"], disc_params=dv["params"],
        disc_batch_stats=dv["batch_stats"], gen_opt_state=opt.init(gv["params"]),
        disc_opt_state=opt.init(dv["params"]))
    return (jgen, jdisc), jtcfg, jax.tree_util.tree_map(np.asarray, state)


def _save_port_weights(jstate, path):
    """The JAX state's weights in the port's models (``weights.from_flax``)."""
    mcfg = ModelConfig(features=FEATURES, disc_features=DISC_FEATURES, dropout=0.0,
                       compute_dtype="float32", packed=False)
    state = create_gan_state(0, "dwi-tensor", mcfg, TrainConfig(lr=LR), "cpu")
    weights.state_from_flax(state.gen, state.disc, {
        k: getattr(jstate, k)
        for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")})
    torch.save({"gen": state.gen.state_dict(), "disc": state.disc.state_dict()}, path)


def _train_x(bids):
    """The JAX data module's 4 train samples' DT volumes (one process)."""
    dcfg = JaxDataConfig(data_dir=bids, volume_shape=(16, 16, 16), test_split=0.25,
                         val_split=0.25)
    data = JaxDoveDataModule(bids, config=dcfg)
    data.prepare_data()
    assert len(data.train_samples) == 4
    return data, np.stack([data.load_subject(s, ("dwi-tensor",))["dwi-tensor"]
                           for s in data.train_samples])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multiprocess")
    bids = make_synthetic_bids(str(work / "bids"), subjects=tuple(f"{i:02d}" for i in range(1, 9)),
                               sessions=("1",), volume_shape=(16, 16, 16))
    for name, val_split in (("cli", 0.25), ("odd", 0.125)):  # odd: 5 train samples
        cfg = json.loads(json.dumps(CLI_CONFIG))
        cfg["data"]["val_split"] = val_split
        cfg["train"].update(log_dir=str(work / name / "logs"),
                            checkpoint_dir=str(work / name / "ckpts"))
        (work / f"{name}.json").write_text(json.dumps(cfg))
    step = [sys.executable, WORKER, "--device", "cpu", "--data", f"bids:{bids}", "--timeout", "300"]
    f64 = ["--run", "float64:2:1e-3:0", "--run", "float64:1:1e-3:0:ddp", "--finetune", "float64"]
    cli = lambda name: [sys.executable, "-m", "unet_bssfp_tpu_torch.train", bids,  # noqa: E731
                        "--modalities", "pc-bssfp", "--config", str(work / f"{name}.json"),
                        "--device", "cpu"]
    # the groups that need no JAX weights start first
    groups = {
        "f64_2": _group(work, "f64_2", 2, step + ["--positions", "2", "--save", "f64_2.pt",
                                                  "--out", "f64_2"] + f64),
        "f64_1": _group(work, "f64_1", 1, step + ["--positions", "4", "--save", "f64_1.pt",
                                                  "--out", "f64_1"] + f64),
        "cli": _group(work, "cli", 2, cli("cli")),
        "odd": _group(work, "odd", 2, cli("odd")),
    }
    jmodels, jtcfg, jstate = _jax_state()
    _save_port_weights(jstate, work / "w.pt")
    groups.update({
        "2x2": _group(work, "2x2", 2, step + ["--positions", "2", "--weights", "w.pt",
                                              "--run", f"float32:2:{LR}:0", "--out", "2x2"]),
        "2x1": _group(work, "2x1", 2, step + ["--weights", "w.pt", "--run", f"float32:1:{LR}:0",
                                              "--out", "2x1"]),
    })
    # the JAX package's step on 4 devices over the same 4 samples, meanwhile
    jdata, x = _train_x(bids)
    mesh = jax_make_mesh(4)
    jstep = jax_make_train_step(*jmodels, jtcfg, mesh=mesh, donate=False)
    xg = jax_shard_batch(mesh, {"x": x})["x"]
    _, jmetrics = jstep(jstate, xg, xg)
    out = {"work": work, "bids": bids, "x": x, "jax_data": jdata,
           "jax": {k: float(v) for k, v in jmetrics.items()}}
    for name, procs in groups.items():
        done = _wait(procs)
        out[name] = {"procs": done}
        if name in ("cli", "odd"):
            continue
        for rc, text in done:
            assert rc == 0, f"{name} worker failed:\n{text}"
        out[name]["ranks"] = [json.loads((work / name / f"rank{r}.json").read_text())
                              for r in range(len(procs))]
    return out


def _step_metrics(rank, run=0, step=0):
    return rank["runs"][run]["steps"][step]["metrics"]


# ------------------------------------------------------------- against JAX
@pytest.mark.parametrize("group", ["2x2", "2x1"])
def test_two_process_step_matches_jax_four_device_step(runs, group):
    """Every process's global metrics after one step against the JAX
    package's step on 4 devices, at ``tests/test_multihost.py``'s
    tolerances; both processes hold the same bits."""
    ranks = runs[group]["ranks"]
    assert _step_metrics(ranks[0]) == _step_metrics(ranks[1])
    got, want = _step_metrics(ranks[0]), runs["jax"]
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = 2e-2 if k == "train_discr_loss" else 2e-5
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("group", ["2x2", "2x1"])
def test_global_batch_fingerprint_and_local_samples(runs, group):
    """The union of the processes' stride-slices is the whole train set:
    the global batch's sum and sum of squares (an ``all_reduce``) are the
    4 samples'; each process holds 2."""
    x = runs["x"].astype(np.float64)
    for rank in runs[group]["ranks"]:
        assert rank["local_samples"] == 2 and rank["world"] == 2
        assert rank["backend"] == "gloo"
        np.testing.assert_allclose(rank["batch_sum"], float(x.sum()), rtol=1e-6)
        np.testing.assert_allclose(rank["batch_sumsq"], float((x * x).sum()), rtol=1e-6)


def test_weights_and_buffers_bit_equal_across_processes_after_two_steps(runs):
    """Every process takes the same AdamW step on the same summed
    gradients, and BatchNorm's statistics come from the same global
    moments: after two steps (2 × 2 in f32; 2 × 2 in f64 after three GAN
    steps and a FINE_TUNE step) every weight and buffer is bit-equal."""
    for group in ("2x2", "f64_2"):
        a, b = runs[group]["ranks"]
        assert [r["digest"] for r in a["runs"]] == [r["digest"] for r in b["runs"]]
        assert len(a["runs"][0]["steps"]) == 2
    a, b = runs["f64_2"]["ranks"]
    assert a["finetune"]["digest"] == b["finetune"]["digest"]


def test_process_split_stride_slices_train_val_and_test(runs):
    """``process_split`` keeps ``samples[rank::world]`` of each list, as the
    JAX package's ``datamodule.py:127-135`` does, and the port's lists
    before the slice are the JAX package's."""
    jdata = runs["jax_data"]
    port = DoveDataModule(runs["bids"], config=DataConfig(
        data_dir=runs["bids"], volume_shape=(16, 16, 16), test_split=0.25, val_split=0.25))
    port.prepare_data()
    for split in ("train", "val", "test"):
        whole = [s.subject for s in getattr(jdata, f"{split}_samples")]
        assert [s.subject for s in getattr(port, f"{split}_samples")] == whole
        for pid, rank in enumerate(runs["2x1"]["ranks"]):
            assert rank["subjects"][split] == whole[pid::2], split


# ------------------------------------------------------ 2 processes against 1
def _close(a, b, what, rtol=1e-9, atol=1e-12):
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def test_two_processes_match_one_in_float64(runs):
    """2 processes × 2 positions against 1 process × 4 positions in
    float64: the metrics of two GAN steps, then of a ``ddp_parity`` step
    (per-row moments over every process's rows), to 1e-9 relative; the
    final weights and BatchNorm statistics to 1e-9 relative, 1e-12
    absolute (only the order of the sums differs)."""
    two, one = runs["f64_2"]["ranks"][0], runs["f64_1"]["ranks"][0]
    for i, run in enumerate(one["runs"]):
        for s, row in enumerate(run["steps"]):
            _close(two["runs"][i]["steps"][s]["metrics"], row["metrics"], f"{run['spec']} {s}")
    a = torch.load(runs["work"] / "f64_2.pt", weights_only=True)
    b = torch.load(runs["work"] / "f64_1.pt", weights_only=True)
    for model in ("gen", "disc"):
        assert a[model].keys() == b[model].keys()
        _close({k: v.numpy() for k, v in a[model].items()},
               {k: v.numpy() for k, v in b[model].items()}, model)


def test_finetune_step_two_processes_match_one(runs):
    """One FINE_TUNE step (L1 + (1 − SSIM), MultiInputUNet) in float64:
    each process backpropagates its share of the global batch's loss; the
    metrics and the updated net against one process's."""
    two, one = runs["f64_2"]["ranks"][0], runs["f64_1"]["ranks"][0]
    _close(two["finetune"]["metrics"], one["finetune"]["metrics"], "finetune")
    a = torch.load(runs["work"] / "f64_2.pt", weights_only=True)["net"]
    b = torch.load(runs["work"] / "f64_1.pt", weights_only=True)["net"]
    _close({k: v.numpy() for k, v in a.items()}, {k: v.numpy() for k, v in b.items()}, "net")


# -------------------------------------------------------------- the CLI
def test_cli_two_processes_one_run_name_and_one_writer(runs):
    """``python -m unet_bssfp_tpu_torch.train --num-processes 2`` on the
    CPU: both processes name the same run (process 0's pick, broadcast) and
    the same best checkpoint; one log directory with one epoch's row, one
    checkpoint directory with its config and step 0."""
    done = runs["cli"]["procs"]
    for rc, text in done:
        assert rc == 0, text
        assert "backend gloo" in text
    best = [next(line for line in text.splitlines() if line.startswith("Best checkpoint"))
            for _, text in done]
    assert best[0] == best[1]
    root = runs["work"] / "cli"
    logs, ckpts = os.listdir(root / "logs"), os.listdir(root / "ckpts")
    assert len(logs) == 1 and logs == ckpts
    with open(root / "logs" / logs[0] / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["epoch"] == "0"
    assert sorted(os.listdir(root / "ckpts" / ckpts[0])) == ["0", "config.json"]
    assert os.listdir(root / "ckpts" / ckpts[0] / "0") == ["state.pt"]


def test_unequal_step_counts_raise_on_every_process(runs):
    """5 train samples over 2 processes: 3 and 2 samples, 3 and 2 steps.
    Both processes raise at the epoch's start, naming each one's plan,
    instead of one waiting on a collective the other never reaches."""
    for rc, text in runs["odd"]["procs"]:
        assert rc != 0
        assert "train batches (full batches, last batch) differ between processes" in text
        assert "{0: [3, 0], 1: [2, 0]}" in text


# ------------------------------------------------------- without a group
def test_writers_other_than_process_0_write_nothing(tmp_path, monkeypatch):
    """As process 1 of 2, the logger and the checkpoint manager write no
    file and no directory, yet keep the rows and the top-k bookkeeping;
    the manager waits at the barrier after each save."""
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    waits = []
    monkeypatch.setattr(distributed, "barrier", lambda: waits.append(1))
    logger = MetricLogger(str(tmp_path / "logs"))
    logger.log_step({"val_loss": torch.tensor(2.0)})
    assert logger.end_epoch(0) == {"val_loss": 2.0}
    assert logger.write_table("t.csv", {"a": 1.0}) == str(tmp_path / "logs" / "t.csv")
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpts"), top_k=1, config_json="{}")
    state = create_gan_state(0, "pc-bssfp", dataclasses.replace(
        ModelConfig(), features=FEATURES, disc_features=DISC_FEATURES), TrainConfig(), "cpu")
    mgr.save(0, state, {"val_loss": 2.0})
    mgr.save(1, state, {"val_loss": 1.0})
    assert mgr.steps == [1] and mgr.best_step == 1 and len(waits) == 2
    assert os.listdir(tmp_path) == []


def test_backend_rule_and_device_refusals(monkeypatch):
    """NCCL only where every process has a card of its own; more processes
    than cards without a named device raises, and so does no card."""
    rule = distributed._backend_rule
    assert rule(["h|cuda:0", "h|cuda:1"]) == ("nccl", "one card per process")
    assert rule(["h|cuda:0", "h|cuda:0"])[0] == "gloo"
    assert rule(["a|cuda:0", "b|cuda:0"])[0] == "nccl"
    assert rule(["h|cpu", "h|cpu"])[0] == "gloo"
    assert rule(["h|cuda:0", "h|cpu"])[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed._process_device(None, 0, 2) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="no card of its own: 1 card"):
        distributed._process_device(None, 1, 2)
    assert distributed._process_device("cpu", 1, 2) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed._process_device(None, 0, 2)
    with pytest.raises(ValueError, match="coordinator address"):
        distributed._store("nowhere", 2, 0, None)
    assert distributed.process_count() == 1 and distributed.process_index() == 0
